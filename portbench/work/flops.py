"""Model FLOPs from a configuration's shapes: the matrix products and
convolutions of the plain reference at those shapes, counted by
torch.utils.flop_counter's formulas on the meta device (no data, no device), so
the count is the model's and not any implementation's."""

from __future__ import annotations

import functools
import json

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry


class FlopCount(TorchDispatchMode):
    """The FLOPs of the matrix products and convolutions dispatched while
    it is on (torch.utils.flop_counter's formulas; no module hooks, so
    double backward through a leaf input, as R1 takes it, is counted)."""

    def __init__(self):
        super().__init__()
        self.total = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        count = flop_registry.get(func._overloadpacket)
        if count is not None:
            self.total += count(*args, **kwargs, out_val=out)
        return out


@functools.lru_cache(maxsize=8)
def _frame_flops(model_json: str) -> int:
    from ..reference import serve as ref
    from ..reference.plain.core.camera import camera_from_angles

    model = json.loads(model_json)
    meta = torch.device("meta")
    g = ref.G.Generator(ref.generator_config(model, "float32"), device=meta, seed=None)
    zero = torch.zeros(1, device=meta)
    cam = camera_from_angles(zero, zero, model["img_size"])
    zs = [torch.zeros(1, model["mapping"]["z_dim"], device=meta)] * 2
    noise = [torch.zeros(s, device=meta) for s in g.decoder.noise_shapes(model["img_size"])]
    with FlopCount() as fc, torch.no_grad():
        g(zs=zs, cam_poses=cam.extrinsics, focals=cam.focal, near=cam.near, far=cam.far,
          noise_bufs=noise, perturb=False)
    return fc.total


def frame_flops(model: dict) -> int:
    """FLOPs of one frame of the generator of config "model": mapping,
    SIREN over every ray and sample, decoder through the last ToRGB."""
    return _frame_flops(json.dumps(model, sort_keys=True))


@functools.lru_cache(maxsize=16)
def _iteration_flops(config_json: str, d_reg: bool, g_reg: bool) -> int:
    from ..reference import train as ref
    from ..reference.plain.train.state import TrainConfig, create_train_state
    from ..reference.plain.train.steps import make_train_steps

    config = json.loads(config_json)
    meta = torch.device("meta")
    g, d, dr = ref.modules(config, meta)
    tcfg = TrainConfig(**config["train"])
    state = create_train_state(tcfg, g, d, dr)
    for opt in (state.opt_g, state.opt_d, state.opt_d_render):
        opt.step = lambda grads: None  # the update is no model FLOP
    d_step, g_step, path_step, _ = make_train_steps(g.cfg, tcfg)
    size = tcfg.data_img_size
    real = torch.zeros((tcfg.batch, size, size, 3), device=meta)
    with FlopCount() as fc:
        d_step(state, real, None, 1.0, d_regularize=d_reg)
        g_step(state, None, 1.0)
        if g_reg:
            path_step(state, None)
    return fc.total


def iteration_flops(config: dict, d_reg: bool, g_reg: bool) -> int:
    """FLOPs of one training iteration of a config's model and batch: the
    D step (with lazy R1 when `d_reg`), the G step and (when `g_reg`) the
    path-length step, forward and backward; the optimizer's update and
    EMA are no model FLOPs."""
    key = {k: config[k] for k in ("model", "d", "d_render", "train")}
    return _iteration_flops(json.dumps(key, sort_keys=True), d_reg, g_reg)
