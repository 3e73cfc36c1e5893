"""The reference's precisions: f32 with TF32 off, and the control's
lower ones (the reference computed with every layer's weight and inputs
rounded to a lower format, per-tensor scaled, products summed in f32)."""

from __future__ import annotations

import torch
from torch import nn

FP8_MAX = 448.0  # largest finite float8_e4m3fn


def f32_no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8_e4m3fn under a per-tensor scale (amax to the
    format's largest value), back in x's dtype."""
    if not x.is_floating_point():
        return x
    scale = x.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale


def _round_inputs(module, args):
    return tuple(fp8_round(a) if isinstance(a, torch.Tensor) else a for a in args)


@torch.no_grad()
def to_fp8(module: nn.Module) -> list:
    """Round every weight of `module` to fp8 and round the tensor inputs
    of every layer that holds one, at each call; returns the hooks."""
    hooks = []
    for m in module.modules():
        w = getattr(m, "weight", None)
        if isinstance(w, nn.Parameter):
            w.copy_(fp8_round(w))
            hooks.append(m.register_forward_pre_hook(_round_inputs))
    return hooks
