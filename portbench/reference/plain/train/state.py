# Frozen copy of cips3dpp_torch/train/state.py at commit af17e715d5a8,
# the plain path only: the yardstick keeps this copy whatever the program
# becomes. Edits from the source are marked "portbench:".
"""Train state and per-module optimizers (counterpart of
cips3dpp_tpu/train/state.py; contract train_v10.py:1091-1132).

Adam with per-module groups, each clipped by its own global norm first:

  G renderer + style mapping : lr g_lr_render (2e-5), betas (0, 0.9)
  G decoder + style_decoder  : lr g_lr_decoder (2e-3), betas (0, 0.99)
  D (image)                  : lr d_lr_decoder * r, betas (0, 0.99^r),
                               r = d_reg_every / (d_reg_every + 1)
  D (pose)                   : lr d_lr_render (2e-4), betas (0, 0.9)

and an EMA copy of the generator. The clip is optax's
`clip_by_global_norm`: a group whose norm is at least `grad_clip` is scaled
by grad_clip / norm, with no epsilon (torch's clip_grad_norm_ divides by
norm + 1e-6). Adam is torch's, whose update with b1 = 0 is optax's
g / (sqrt(nu / (1 - b2^t)) + eps), eps 1e-8.
"""

from __future__ import annotations

import copy
import dataclasses

import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    # optim (train_cips3d_ffhq_v10.yaml:169-176)
    g_lr_render: float = 2e-5
    g_lr_decoder: float = 2e-3
    d_lr_render: float = 2e-4
    d_lr_decoder: float = 2e-3
    grad_clip: float = 20.0
    # schedule
    batch: int = 4
    total_iters: int = 800_000
    ema_start: int = 1000
    ema_decay: float = 0.5 ** (32 / (10 * 1000))
    d_reg_every: int = 15
    g_reg_every: int = 5
    fade_steps: int = 10_000
    warmup_iters: int = 10_000
    # loss weights (train_cips3d_ffhq_v10.yaml:205-210)
    lambda_gp: float = 10.0
    lambda_pose: float = 15.0
    lambda_eikonal: float = 0.1
    lambda_min_surf: float = 0.05
    min_surf_beta: float = 100.0
    path_regularize: float = 2.0
    path_batch_shrink: int = 2
    # sizes: pixel sub-sampling when gen_img_size < cam_img_size
    # (train_v10.py:177-199); sample_mode 'default' (sorted random subset)
    # or 'patch' (contiguous window)
    cam_img_size: int = 64
    gen_img_size: int = 1024
    data_img_size: int = 1024
    sample_mode: str = "default"
    # toggles
    eikonal_reg: bool = True
    sdf_reg: bool = True
    init_renderer: bool = True
    init_iters: int = 10_000
    # the SIREN render kernel (K1) for the D step's generator forward (no
    # grad) and, with fused_renderer_g, in the G step (the kernel forward +
    # replayed backward). Taken only on the card and where K1 takes the
    # renderer's geometry (kernels/siren_render.py:default_kernel_route),
    # as JAX's flags are inert off the TPU; off the card the steps render
    # plainly, at a geometry K1 does not take they say so once.
    fused_renderer_d: bool = True
    fused_renderer_g: bool = False
    # The image D's options (cips3dpp_tpu/train/steps.py:144-400).
    # remat_d: recompute the image D's activations in the backward
    # (torch.utils.checkpoint); the same result.
    remat_d: bool = False
    # compute dtype of the image D: "bfloat16" casts its input to bf16 at
    # entry and its logit back to f32, so every layer computes in bf16 (a
    # different result, at the bf16 floor). Only the image D: the JAX
    # TrainConfig's comment says "both discriminators", but its steps cast
    # only the image D (dd_apply); the port follows the code.
    d_dtype: str = "float32"
    # lazy R1 over real-batch chunks of this size, the mean of the chunk
    # means; the minibatch stddev then runs over each chunk, as in JAX
    d_r1_chunk: int | None = None
    # the fake and real image-D passes one after the other, their
    # gradients summed (same result, one pass's activations alive at once)
    d_seq: bool = False
    # one batch-2n image-D pass over [fake; real] with a per-half minibatch
    # stddev and sign-split loss (same result with diffaug off; takes
    # precedence over d_seq)
    d_cat: bool = False


D_DTYPES = ("float32", "bfloat16")


def check_config(cfg: TrainConfig) -> None:
    """Raise on option values the steps do not take."""
    if cfg.d_dtype not in D_DTYPES:
        raise ValueError(f"TrainConfig.d_dtype={cfg.d_dtype!r}: one of {D_DTYPES}")
    if cfg.d_r1_chunk is not None and cfg.d_r1_chunk < 1:
        raise ValueError(f"TrainConfig.d_r1_chunk={cfg.d_r1_chunk}: a positive chunk "
                         f"size or None")


def g_param_groups(g: nn.Module) -> dict[str, list[nn.Parameter]]:
    """renderer | decoder groups by top-level module name (the reference
    split, train_v10.py:1104-1113): decoder and style_decoder are the
    decoder group; renderer, style (mapping) and the rest the renderer's."""
    groups = {"renderer": [], "decoder": []}
    for name, p in g.named_parameters():
        top = name.split(".")[0]
        groups["decoder" if top in ("decoder", "style_decoder") else "renderer"].append(p)
    return groups


class ClippedAdam:
    """Adam over named parameter groups, each clipped by its own global
    norm (optax.multi_transform of clip_by_global_norm + adam). Under a
    data `mesh` the gradients are first averaged over the ranks by one
    all-reduce, so the clip sees the global gradient on every rank."""

    def __init__(self, groups: dict[str, list[nn.Parameter]], lrs: dict, b2s: dict,
                 max_norm: float, mesh=None):
        self.groups = groups
        self.max_norm = max_norm
        self.mesh = mesh
        self.adam = torch.optim.Adam(
            [{"params": ps, "lr": lrs[k], "betas": (0.0, b2s[k]), "name": k}
             for k, ps in groups.items()], eps=1e-8)

    def clip(self, grads: list[torch.Tensor]) -> list[torch.Tensor]:
        norm = torch.sqrt(sum(g.float().square().sum() for g in grads))
        keep = norm < self.max_norm
        return [torch.where(keep, g, g / norm * self.max_norm) for g in grads]

    def step(self, grads: dict[str, list[torch.Tensor | None]]) -> None:
        """One update from per-group gradient lists aligned with the
        groups' parameters. A missing gradient is a zero, which still
        advances Adam's state, as in optax."""
        gs = {k: [torch.zeros_like(p) if g is None else g for p, g in zip(ps, grads[k])]
              for k, ps in self.groups.items()}
        if self.mesh is not None:
            raise ValueError("portbench: one process, no mesh")

            flat = sync_grads([g for k in gs for g in gs[k]], self.mesh)
            for k in gs:
                gs[k], flat = flat[:len(gs[k])], flat[len(gs[k]):]
        for k, ps in self.groups.items():
            for p, g in zip(ps, self.clip(gs[k])):
                p.grad = g
        self.adam.step()
        for ps in self.groups.values():
            for p in ps:
                p.grad = None

    def state_dict(self) -> dict:
        """Adam's moments and step counts by group (torch.optim's layout)."""
        return self.adam.state_dict()

    def load_state_dict(self, sd: dict) -> None:
        """Restore the moments and step counts of `state_dict()`. The
        learning rates and betas stay this optimizer's, as an optax state
        holds no hyperparameters."""
        names = [g["name"] for g in sd["param_groups"]]
        if names != list(self.groups):
            raise ValueError(f"optimizer groups {names}, expected {list(self.groups)}")
        keep = [{k: v for k, v in g.items() if k != "params"} for g in self.adam.param_groups]
        self.adam.load_state_dict(sd)
        for group, hyper in zip(self.adam.param_groups, keep):
            group.update(hyper)


def make_g_optimizer(cfg: TrainConfig, g: nn.Module, mesh=None) -> ClippedAdam:
    return ClippedAdam(g_param_groups(g),
                       {"renderer": cfg.g_lr_render, "decoder": cfg.g_lr_decoder},
                       {"renderer": 0.9, "decoder": 0.99}, cfg.grad_clip, mesh)


def make_d_optimizer(cfg: TrainConfig, d: nn.Module, mesh=None) -> ClippedAdam:
    # lazy-R1 ratio; d_reg_every <= 0 turns lazy regularisation off
    r = 1.0 if cfg.d_reg_every <= 0 else cfg.d_reg_every / (cfg.d_reg_every + 1)
    return ClippedAdam({"d": list(d.parameters())}, {"d": cfg.d_lr_decoder * r},
                       {"d": 0.99**r}, cfg.grad_clip, mesh)


def make_d_render_optimizer(cfg: TrainConfig, d_render: nn.Module, mesh=None) -> ClippedAdam:
    return ClippedAdam({"d": list(d_render.parameters())}, {"d": cfg.d_lr_render},
                       {"d": 0.9}, cfg.grad_clip, mesh)


@dataclasses.dataclass
class TrainState:
    """Everything a training run carries from step to step. The modules
    and optimizers are updated in place."""

    g: nn.Module
    d: nn.Module
    d_render: nn.Module
    g_ema: nn.Module
    opt_g: ClippedAdam
    opt_d: ClippedAdam
    opt_d_render: ClippedAdam
    mean_path_length: torch.Tensor
    step: int = 0

    MODULES = ("g", "g_ema", "d", "d_render")
    OPTIMIZERS = ("opt_g", "opt_d", "opt_d_render")

    def state_dict(self) -> dict:
        """Every tensor and counter of the run, by name: the modules' state
        dicts, the optimizers', mean_path_length and step."""
        out = {k: getattr(self, k).state_dict() for k in self.MODULES + self.OPTIMIZERS}
        out["mean_path_length"] = self.mean_path_length
        out["step"] = self.step
        return out

    def load_state_dict(self, sd: dict) -> "TrainState":
        """Copy `sd` (from `state_dict()`, on any device) into this state's
        modules and optimizers, on their own devices."""
        for k in self.MODULES:
            getattr(self, k).load_state_dict(sd[k])
        for k in self.OPTIMIZERS:
            getattr(self, k).load_state_dict(sd[k])
        self.mean_path_length = sd["mean_path_length"].to(
            self.mean_path_length.device, copy=True)
        self.step = int(sd["step"])
        return self


def create_train_state(cfg: TrainConfig, g: nn.Module, d: nn.Module,
                       d_render: nn.Module, mesh=None) -> TrainState:
    """A state around built modules (weights already drawn or loaded); the
    EMA generator starts as a copy of `g`. Under a data `mesh` the
    optimizers average the gradients over the ranks (the state is made
    equal on every rank by `parallel.replicate`)."""
    check_config(cfg)
    g_ema = copy.deepcopy(g).requires_grad_(False)
    return TrainState(
        g=g, d=d, d_render=d_render, g_ema=g_ema,
        opt_g=make_g_optimizer(cfg, g, mesh), opt_d=make_d_optimizer(cfg, d, mesh),
        opt_d_render=make_d_render_optimizer(cfg, d_render, mesh),
        mean_path_length=torch.zeros((), device=g.device),
    )
