"""The training cell's reference: the first iterations of the training
loop on the plain modules in f32 with TF32 off, from the weights of the
seed's pool, the same real batches and the same draws (a generator of
the same seed, drawn from in the program's order by the copied steps).

`iterate` is a frozen copy of the body of
cips3dpp_torch/train/train_loop.py:Trainer.train's loop at commit
af17e715d5a8 (one iteration: D step, G step, path regularisation every
g_reg_every, EMA after ema_start), over the copied steps of
`plain/train/steps.py` (the plain renderer in the D step's fakes, where the
program takes K1)."""

from __future__ import annotations

import copy

import torch

from .plain.models.discriminator import DStyleGANProgressive
from .plain.models.discriminator_pose import DVolumeRenderProgressive
from .plain.models.generator import Generator
from .plain.train.state import TrainConfig, create_train_state
from .plain.train.steps import ema_update, fade_alpha, make_train_steps
from .precision import f32_no_tf32
from .serve import generator_config


def modules(config: dict, device, seed=None):
    """(G, image D, pose D) of the reference, weights unset unless `seed`."""
    g = Generator(generator_config(config["model"]), device=device, seed=seed)
    d = DStyleGANProgressive(device=device, seed=seed, **config["d"])
    dr = DVolumeRenderProgressive(device=device, seed=seed, **config["d_render"])
    return g, d, dr


def build(config: dict, device, weights_fn, precision: str = "float32"):
    """(state, steps, train config) of the reference: modules from
    `weights_fn`, fresh optimizers; precision "tf32" is the control,
    "decoder_bf16" the decoder's convolutions computed in bf16 (the
    lower precision a faster recipe would take for G alone)."""
    f32_no_tf32()
    if precision == "tf32":
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
    elif precision == "decoder_bf16":
        config = copy.deepcopy(config)
        config["model"]["decoder"]["dtype"] = "bfloat16"
    elif precision != "float32":
        raise ValueError(f"reference precision {precision!r}: float32, tf32 or decoder_bf16")
    g, d, dr = modules(config, device)
    weights_fn([g, d, dr])
    tcfg = TrainConfig(**config["train"])
    state = create_train_state(tcfg, g, d, dr)
    return state, make_train_steps(g.cfg, tcfg), tcfg


def iterate(state, steps, cfg, idx: int, real, generator, sphere_init_done: bool = True):
    """One iteration at index `idx` on the batch `real` (B, H, W, 3) in
    [-1, 1]; returns its metrics (0-d tensors)."""
    d_step, g_step, path_step, _ = steps
    alpha = fade_alpha(idx, cfg.fade_steps, True)
    renderer_detach = True if (idx < cfg.warmup_iters and sphere_init_done) else None
    d_regularize = cfg.d_reg_every > 0 and (idx + 1) % cfg.d_reg_every == 0
    state, dm = d_step(state, real, generator, alpha, d_regularize=d_regularize)
    state, gm = g_step(state, generator, alpha, renderer_detach=renderer_detach)
    g_regularize = cfg.g_reg_every > 0 and (idx + 1) % cfg.g_reg_every == 0
    pm = path_step(state, generator)[1] if g_regularize else {}
    decay = cfg.ema_decay if idx >= cfg.ema_start else 0.0
    ema_update(state, decay)
    return {**dm, **gm, **pm}
