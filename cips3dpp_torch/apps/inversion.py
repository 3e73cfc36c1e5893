"""Flip-inversion: joint (w, camera-pose) GAN inversion (counterpart of
cips3dpp_tpu/apps/inversion.py; contract exp/cips3d/models/
projector_v10.py, StyleGAN2Projector_Flip.project_wplus :915-1280).

The target is [img, hflip(img)]. Optimised: the camera (azim, elev), the
renderer's w+ and the decoder's w+ (one each, shared by the pair), the
decoder's parameters and its per-layer noise buffers, against a VGG
feature loss at full resolution (rgb_weight) and on the 64^2 thumbnail
(thumb_weight), with an optional MSE, the noise autocorrelation penalty
and, after the pose phase, background masking by the NeRF mask. Three
phases (pose, appearance, multiview) gate the learning rate of each group,
under a cosine ramp (:174-186); every `flip_w_decoder_every` appearance
steps the decoder styles are detached and batch-flipped, so only the
decoder's parameters fit the mirrored view (:1086-1091).

What is optimised is a copy: the state holds its own tensors (the decoder's
parameters enter `Generator.forward` through `torch.func.functional_call`),
so the caller's model never changes, as JAX's functional params do not.
Adam updates the moments of every leaf at every step, as optax does, with
a zero gradient where none flows (the detached decoder styles of a flip
step). By default the render is fused where JAX's is (on the card, for a
geometry K1 takes: `default_kernel_route`): `SirenRender` (K1's forward,
the plain render replayed in the backward), one launch per batch item.
Elsewhere it is the plain f32 renderer; at a geometry K1 does not take on
the card the Projector says so once. `fused=True` asks for K1 (its plain
version on the CPU).

Random draws come from a `torch.Generator` (default seed 123, as JAX's
PRNGKey(123)), or are passed in as `InversionDraws`: the mean latents
(`w_avg_samples` z's), the initial azimuth, the noise buffers (seed 0, as
JAX's PRNGKey(0)) and the perturbation offsets of every step and of the
final render (seed 0). `optim_decoder_params` is read by nothing, as in
the JAX package: the decoder's parameters are always optimised.
"""

from __future__ import annotations

import copy
import dataclasses
import math
import sys

import numpy as np
import torch
from torch.func import functional_call

from ..core.camera import camera2world_from_axis_angle, camera_from_angles
from ..kernels.siren_render import default_kernel_route
from ..models.vgg import LOSS_W_1024, perceptual_features
from ..ops.resize import resize
from ..utils.metrics import psnr, ssim

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


@dataclasses.dataclass(frozen=True)
class InversionConfig:
    # schedule (config defaults: train_cips3d_ffhq_v10.yaml:485-500)
    n_steps_pose: int = 200
    n_steps_app: int = 1000
    n_steps_multiview: int = 0
    lr_cam: float = 0.01
    lr_render_w: float = 0.05
    lr_decoder_w: float = 0.05
    lr_decoder_params: float = 1e-4
    lr_noise: float = 0.05
    rgb_weight: float = 1.0
    thumb_weight: float = 50.0
    truncation_psi: float = 0.7
    mse_weight: float = 0.0
    regularize_noise_weight: float = 1e5
    mask_background: bool = True
    flip_w_decoder_every: int = 5
    optim_noise_bufs: bool = True
    optim_decoder_params: bool = True
    w_avg_samples: int = 10_000
    # "angles": (azim, elev) look-at (projector_v10.py:211-277);
    # "axis_angle": a free camera, rot (2, 3) axis-angle and trans (2, 3)
    # projected to the unit sphere (projector_axis_angle.py:191-278)
    cam_param: str = "angles"


@dataclasses.dataclass
class InversionState:
    # cam_param "angles": azim, elev (2, 1); "axis_angle": azim holds rot
    # (2, 3), elev holds trans (2, 3)
    azim: torch.Tensor
    elev: torch.Tensor
    w_render: torch.Tensor  # (1, n_render_layers + 1, style_dim)
    w_decoder: torch.Tensor  # (1, n_latent, decoder style_dim)
    decoder_params: dict  # the Decoder's named parameters
    noise_bufs: list  # (1, h, w, 1) each
    opt: dict  # Adam: {"count": int, "mu": {leaf: tensor}, "nu": {leaf: tensor}}


@dataclasses.dataclass
class InversionDraws:
    """The random inputs of a projection; each one left None is drawn.
    means: (w_render mean (1, style_dim), w_decoder mean (1, decoder
    style_dim)); azim: (2, 1) initial azimuth (angles mode without an
    azim_init); noise: (1, h, w, 1) buffers; t_rand: (n_steps + 1, 2, H,
    W, 1) perturbation offsets in [0, 1) of every step and of the final
    render (zeros give the unperturbed z-values)."""

    means: tuple | None = None
    azim: torch.Tensor | None = None
    noise: list | None = None
    t_rand: torch.Tensor | None = None


def cosine_lr_mul(step, num_steps, rampdown=0.25, rampup=0.05):
    """StyleGAN2 projector ramp (projector_v10.py:174-186)."""
    t = step / num_steps
    ramp = min(1.0, (1.0 - t) / rampdown)
    ramp = 0.5 - 0.5 * np.cos(ramp * np.pi)
    return ramp * min(1.0, t / rampup)


def phase_lr_muls(step: int, cfg: InversionConfig):
    """Per-group lr multipliers of this step (projector_v10.py:1061-1099):
    dict(cam, render, decoder), each a phase gate times the cosine ramp."""
    p, a, m = cfg.n_steps_pose, cfg.n_steps_app, cfg.n_steps_multiview
    if step < p:
        mul = cosine_lr_mul(step, p)
        gates = dict(cam=1.0, render=1.0, decoder=0.0)
    elif step < p + a:
        mul = cosine_lr_mul(step - p, a, rampup=0.25)
        gates = dict(cam=1.0, render=1.0, decoder=1.0)
    else:
        mul = cosine_lr_mul(step - p - a, max(m, 1), rampup=0.25)
        gates = dict(cam=0.0, render=0.0, decoder=1.0)
    return {k: v * mul for k, v in gates.items()}


def step_plan(step: int, cfg: InversionConfig):
    """(lr multipliers, flip_w_decoder, mask_bg) of one step: the decoder
    styles flip every `flip_w_decoder_every` appearance steps but never
    on the last step (inversion.py:390-394); background masking starts
    after the pose phase."""
    n_steps = cfg.n_steps_pose + cfg.n_steps_app + cfg.n_steps_multiview
    every = cfg.flip_w_decoder_every
    in_app = cfg.n_steps_pose <= step < cfg.n_steps_pose + cfg.n_steps_app
    flip = in_app and (step + every - 1) % every == 0 and step != n_steps - 1
    mask_bg = cfg.mask_background and step >= cfg.n_steps_pose
    return phase_lr_muls(step, cfg), flip, mask_bg


def noise_regularization(noise_bufs):
    """Multi-scale autocorrelation penalty (projector_v10.py:1184-1195) of
    NHWC buffers (1|B, h, w, 1)."""
    reg = 0.0
    for noise in noise_bufs:
        while True:
            reg = reg + torch.square(torch.mean(noise * torch.roll(noise, 1, dims=2)))
            reg = reg + torch.square(torch.mean(noise * torch.roll(noise, 1, dims=1)))
            if noise.shape[1] <= 8:
                break
            b, h, w, c = noise.shape
            noise = noise.reshape(b, h // 2, 2, w // 2, 2, c).mean(dim=(2, 4))
    return reg


def _leaves(state: InversionState) -> dict:
    """The optimised tensors by name, in a fixed order."""
    out = {"azim": state.azim, "elev": state.elev, "w_render": state.w_render,
           "w_decoder": state.w_decoder}
    out.update({f"decoder.{k}": v for k, v in state.decoder_params.items()})
    out.update({f"noise.{i}": v for i, v in enumerate(state.noise_bufs)})
    return out


def _from_leaves(state: InversionState, leaves: dict, opt: dict) -> InversionState:
    n = len("decoder.")
    return dataclasses.replace(
        state, azim=leaves["azim"], elev=leaves["elev"], w_render=leaves["w_render"],
        w_decoder=leaves["w_decoder"],
        decoder_params={k[n:]: v for k, v in leaves.items() if k.startswith("decoder.")},
        noise_bufs=[leaves[f"noise.{i}"] for i in range(len(state.noise_bufs))], opt=opt)


class Projector:
    """The flip-inversion projector. `model` is a Generator; `vgg` a
    VGG16Features; `lpips` the report's (LPIPS, provenance) pair, as
    `load_lpips` returns it (None: `load_lpips` is called, which consults
    $CIPS3DPP_WEIGHTS_DIR and falls back to the tagged random metric).
    `fused` renders through the SIREN render kernel; None (the default)
    decides as JAX's Projector does, from the model's device and geometry
    (`default_kernel_route`)."""

    def __init__(self, model, vgg, cfg: InversionConfig, lpips=None,
                 fused: bool | None = None):
        self.model = copy.deepcopy(model).requires_grad_(False)
        self.vgg = vgg
        self.lpips = lpips
        self.cfg = cfg
        self.gcfg = model.cfg
        if fused is None:
            r = model.cfg.renderer
            fused, why = default_kernel_route(r.n_layers, r.hidden_dim, model.cfg.n_samples,
                                              r.with_sdf, model.device)
            if why is not None and model.device.type == "cuda":
                print(f"[invert] the projector renders with the plain renderer, not K1: "
                      f"{why}", file=sys.stderr)
        self.fused = fused
        self.means = None

    @property
    def device(self) -> torch.device:
        return self.model.device

    # ----- state ---------------------------------------------------------

    @torch.no_grad()
    def init_state(self, generator: torch.Generator | None = None, azim_init=(0.0, 0.0),
                   draws: InversionDraws | None = None) -> InversionState:
        cfg, gcfg, dev = self.cfg, self.gcfg, self.device
        draws = draws or InversionDraws()
        gdev = generator.device if generator is not None else "cpu"
        means = draws.means
        if means is None:
            means = self.model.mean_latents(generator, cfg.w_avg_samples)
        wr_mean, wd_mean = (m.to(dev, torch.float32) for m in means)
        if cfg.cam_param == "axis_angle":
            # identity rotation, the camera at +z on the unit sphere
            # (projector_axis_angle.py:259-262)
            azim = torch.zeros((2, 3), device=dev)
            elev = torch.zeros((2, 3), device=dev)
            elev[:, 2] = 1.0
        else:
            if any(azim_init):
                azim = torch.tensor(azim_init, dtype=torch.float32).reshape(2, 1)
            elif draws.azim is not None:
                azim = draws.azim
            else:
                azim = -math.pi + torch.rand((2, 1), generator=generator, device=gdev) * (
                    2 * math.pi)
            azim = azim.to(dev, torch.float32)
            elev = torch.zeros((2, 1), device=dev)
        n_render = gcfg.renderer.n_layers + 1
        n_latent = self.model.decoder.n_latent
        noise = draws.noise
        if noise is None:
            noise = self.model.decoder.make_noise(torch.Generator().manual_seed(0),
                                                  gcfg.img_size, device=dev)
        state = InversionState(
            azim=azim, elev=elev,
            w_render=wr_mean[:, None, :].repeat(1, n_render, 1),
            w_decoder=wd_mean[:, None, :].repeat(1, n_latent, 1),
            decoder_params={k: v.detach().clone()
                            for k, v in self.model.decoder.named_parameters()},
            noise_bufs=[b.to(dev, torch.float32).clone() for b in noise],
            opt={})
        zeros = {k: torch.zeros_like(v) for k, v in _leaves(state).items()}
        state.opt = {"count": 0, "mu": zeros, "nu": {k: v.clone() for k, v in zeros.items()}}
        self.means = (wr_mean, wd_mean)
        return state

    @torch.no_grad()
    def prepare_targets(self, target_img) -> dict:
        """target_img (H, W, 3) in [-1, 1] -> the pair [img, hflip(img)],
        its lanczos3 thumbnail and both feature vectors."""
        target = torch.as_tensor(np.asarray(target_img, np.float32)).to(self.device)
        target = torch.stack([target, target.flip(1)])
        s = self.gcfg.img_size
        thumb = resize(target, (s, s), "lanczos3")
        return {"target": target, "thumb": thumb,
                "feats": perceptual_features(self.vgg, target),
                "feats_thumb": perceptual_features(self.vgg, thumb, LOSS_W_1024)}

    # ----- forward -------------------------------------------------------

    def forward(self, leaves: dict, t_rand, flip_w_decoder: bool):
        """Generator forward from the optimised tensors (projector
        _G_forward :211-277): the camera from (azim, elev), the styles and
        noise repeated to batch 2."""
        g = self.gcfg
        azim, elev = leaves["azim"], leaves["elev"]
        if self.cfg.cam_param == "axis_angle":
            trans = elev / torch.clamp(torch.linalg.norm(elev, dim=-1, keepdim=True), min=1e-8)
            ext = camera2world_from_axis_angle(azim, trans)
            fov = torch.full((2, 1, 1), g.fov_ang * math.pi / 180.0, device=azim.device)
            focal = 0.5 * g.img_size / torch.tan(fov)
            near = torch.full((2, 1, 1), 1.0 - g.dist_radius, device=azim.device)
            far = torch.full((2, 1, 1), 1.0 + g.dist_radius, device=azim.device)
        else:
            cam = camera_from_angles(azim[:, 0], elev[:, 0], g.img_size,
                                     fov_ang=g.fov_ang, dist_radius=g.dist_radius)
            ext, focal, near, far = cam.extrinsics, cam.focal, cam.near, cam.far
        style_render = leaves["w_render"].repeat(2, 1, 1)
        style_decoder = leaves["w_decoder"].repeat(2, 1, 1)
        if flip_w_decoder:
            style_decoder = style_decoder.detach().flip(0)
        n = len("decoder.")
        params = {f"decoder.{k[n:]}": v for k, v in leaves.items() if k.startswith("decoder.")}
        noise = [v.repeat(2, 1, 1, 1) if v.shape[0] == 1 else v
                 for k, v in leaves.items() if k.startswith("noise.")]
        return functional_call(self.model, params, (), dict(
            style_render=style_render, style_decoder=style_decoder, cam_poses=ext,
            focals=focal, near=near, far=far, noise_bufs=noise, perturb=True,
            renderer_detach=False, fused_renderer=self.fused, t_rand=t_rand))

    def loss(self, leaves: dict, targets: dict, t_rand, flip_w_decoder: bool, mask_bg: bool):
        cfg = self.cfg
        out = self.forward(leaves, t_rand, flip_w_decoder)
        synth, synth_thumb = out["rgb"], out["thumb_rgb"]
        if mask_bg:
            # foreground = 1 - background probability (projector :268-276);
            # gradients flow through the foreground only
            mask_thumb = 1.0 - out["mask"].detach()
            mask = resize(mask_thumb, synth.shape[1:3], "cubic")
            synth = synth * mask + synth.detach() * (1 - mask)
        sf = perceptual_features(self.vgg, synth)
        sft = perceptual_features(self.vgg, synth_thumb, LOSS_W_1024)
        percep = (torch.sum(torch.square(targets["feats"] - sf)) * cfg.rgb_weight
                  + torch.sum(torch.square(targets["feats_thumb"] - sft)) * cfg.thumb_weight)
        zero = torch.zeros((), device=percep.device)
        mse = (cfg.mse_weight * torch.mean(torch.square(synth - targets["target"]))
               if cfg.mse_weight > 0 else zero)
        noise = [v for k, v in leaves.items() if k.startswith("noise.")]
        reg = (cfg.regularize_noise_weight * noise_regularization(noise)
               if cfg.optim_noise_bufs and cfg.regularize_noise_weight > 0 else zero)
        loss = percep + mse + reg
        return loss, {"percep": percep, "mse": mse, "noise_reg": reg, "loss": loss}

    # ----- step ----------------------------------------------------------

    def loss_and_grads(self, state: InversionState, targets: dict, t_rand,
                       flip_w_decoder: bool, mask_bg: bool):
        """(metrics, gradient of the loss by leaf name); a leaf that the
        loss does not reach gets a zero gradient."""
        leaves = {k: v.detach().requires_grad_(True) for k, v in _leaves(state).items()}
        with torch.enable_grad():
            loss, metrics = self.loss(leaves, targets, t_rand, flip_w_decoder, mask_bg)
            grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
        grads = {k: torch.zeros_like(v) if g is None else g
                 for (k, v), g in zip(leaves.items(), grads)}
        return {k: v.detach() for k, v in metrics.items()}, grads

    def _base_lr(self, leaf: str, lrs: dict) -> float:
        cfg = self.cfg
        if leaf in ("azim", "elev"):
            return lrs["cam"] * cfg.lr_cam
        if leaf == "w_render":
            return lrs["render"] * cfg.lr_render_w
        if leaf == "w_decoder":
            return lrs["decoder"] * cfg.lr_decoder_w
        if leaf.startswith("noise."):
            return lrs["decoder"] * cfg.lr_noise
        return lrs["decoder"] * cfg.lr_decoder_params

    @torch.no_grad()
    def step(self, state: InversionState, targets: dict, t_rand, lrs: dict,
             flip_w_decoder: bool, mask_bg: bool):
        """One optimisation step: the loss and its gradients, then Adam
        (0.9, 0.999, eps 1e-8 outside the root) on every leaf, each scaled
        by its base lr x phase gate x cosine ramp. Returns (state, metrics)."""
        metrics, grads = self.loss_and_grads(state, targets, t_rand, flip_w_decoder, mask_bg)
        count = state.opt["count"] + 1
        c1, c2 = 1.0 - ADAM_B1 ** count, 1.0 - ADAM_B2 ** count
        mu, nu, new = {}, {}, {}
        for k, p in _leaves(state).items():
            g = grads[k]
            mu[k] = (1.0 - ADAM_B1) * g + ADAM_B1 * state.opt["mu"][k]
            nu[k] = (1.0 - ADAM_B2) * (g * g) + ADAM_B2 * state.opt["nu"][k]
            update = (mu[k] / c1) / (torch.sqrt(nu[k] / c2) + ADAM_EPS)
            new[k] = p + (-self._base_lr(k, lrs)) * update
        return _from_leaves(state, new, {"count": count, "mu": mu, "nu": nu}), metrics

    # ----- projection ----------------------------------------------------

    def project(self, target_img, generator: torch.Generator | None = None,
                azim_init=(0.0, 0.0), draws: InversionDraws | None = None,
                log_every: int = 100, logger=None):
        """target_img: (H, W, 3) in [-1, 1]. Returns (state, the final
        render (2, H, W, 3) as numpy, report)."""
        cfg = self.cfg
        draws = draws or InversionDraws()
        gen = torch.Generator().manual_seed(123) if generator is None else generator
        state = self.init_state(gen, azim_init, draws)
        targets = self.prepare_targets(target_img)
        s = self.gcfg.img_size

        def t_rand(i, g):
            if draws.t_rand is not None:
                return draws.t_rand[i]
            return torch.rand((2, s, s, 1), generator=g, device=g.device)

        n_steps = cfg.n_steps_pose + cfg.n_steps_app + cfg.n_steps_multiview
        metrics = {}
        for step_i in range(n_steps):
            lrs, flip, mask_bg = step_plan(step_i, cfg)
            if step_i == cfg.n_steps_pose:
                # truncate w_render toward the mean (projector :1081-1084)
                wr_mean = self.means[0][:, None, :]
                state.w_render = wr_mean + cfg.truncation_psi * (state.w_render - wr_mean)
            state, metrics = self.step(state, targets, t_rand(step_i, gen), lrs, flip, mask_bg)
            if logger is not None and step_i % log_every == 0:
                logger(step_i, {k: float(v) for k, v in metrics.items()})

        # the final render and the quality report (projector_v10.py:1266-1275)
        with torch.no_grad():
            out = self.forward(_leaves(state), t_rand(n_steps, torch.Generator().manual_seed(0)),
                               False)
        proj = out["rgb"]
        if self.lpips is None:
            from ..io.weights import load_lpips

            self.lpips = load_lpips(torch.Generator().manual_seed(0), device=self.device)
        lp, lpips_prov = self.lpips
        target = targets["target"]
        with torch.no_grad():
            report = {
                "psnr": float(psnr(proj[0], target[0])),
                "ssim": float(ssim(proj[0], target[0])),
                "lpips": float(lp(proj[:1], target[:1])),
                "lpips_weights": lpips_prov,
                "loss": float(metrics["loss"]) if metrics else float("nan"),
                "azim": state.azim.flatten().tolist(),
                "elev": state.elev.flatten().tolist(),
            }
        return state, proj.float().cpu().numpy(), report

    # ----- artifacts -----------------------------------------------------

    def save_inversion(self, path: str, state: InversionState) -> str:
        """The inversion artifact (projector :1046-1055): the fitted decoder
        and the renderer the inversion ran against, so inverted views
        restore the same graph whatever base checkpoint is loaded later
        (render_video_web_v10.py:1039-1048); torch.save under the port's
        state-dict names, read back with weights_only=True."""
        cpu = lambda x: x.detach().cpu()
        torch.save({
            "azim": cpu(state.azim), "elev": cpu(state.elev),
            "w_render_opt": cpu(state.w_render), "w_decoder_opt": cpu(state.w_decoder),
            "decoder_params": {k: cpu(v) for k, v in state.decoder_params.items()},
            "renderer_params": {k: cpu(v) for k, v in self.model.renderer.state_dict().items()},
            "noise_bufs": [cpu(b) for b in state.noise_bufs],
        }, path)
        return path

    @staticmethod
    def load_inversion(path: str) -> dict:
        return torch.load(path, map_location="cpu", weights_only=True)


def restore_inverted(model, blob: dict):
    """Load an inversion artifact's fitted decoder and, where it holds
    one, its renderer into `model` (a Generator), in place."""
    sd = {f"decoder.{k}": v for k, v in blob["decoder_params"].items()}
    if "renderer_params" in blob:
        sd.update({f"renderer.{k}": v for k, v in blob["renderer_params"].items()})
    res = model.load_state_dict(sd, strict=False)
    if res.unexpected_keys:
        raise KeyError(f"inversion artifact: unknown keys {res.unexpected_keys[:5]}")
    missing = [k for k in res.missing_keys if k.startswith("decoder.")]
    if missing:
        raise KeyError(f"inversion artifact: decoder keys missing, e.g. {missing[:5]}")
    return model
