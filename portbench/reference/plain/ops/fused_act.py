# Frozen copy of cips3dpp_torch/ops/fused_act.py at commit af17e715d5a8,
# the plain path only: the yardstick keeps this copy whatever the program
# becomes. Edits from the source are marked "portbench:".
"""Fused bias + leaky-ReLU (+ gain), the StyleGAN2 `fused_bias_act` op
(counterpart of cips3dpp_tpu/ops/fused_act.py). Channels last."""

from __future__ import annotations

import torch

SQRT2 = 1.4142135623730951


def scalar_as(v: float, x: torch.Tensor):
    """`v` as a factor of x: the Python float for f32 tensors, else a 0-d
    tensor of x's dtype, so the product rounds `v` to that dtype first, as
    JAX's weakly typed scalars do (bf16(sqrt 2) = 1.4140625)."""
    if x.dtype == torch.float32:
        return v
    return torch.tensor(v, dtype=x.dtype, device=x.device)


def fused_leaky_relu(
    x: torch.Tensor,
    bias: torch.Tensor | None = None,
    negative_slope: float = 0.2,
    scale: float = SQRT2,
    channel_axis: int = -1,
) -> torch.Tensor:
    """y = leaky_relu(x + bias) * scale, bias broadcast along `channel_axis`,
    all in the dtype of x: for bf16 the slope and scale are rounded to bf16
    before they multiply, as JAX rounds its weakly typed scalars."""
    if bias is not None:
        shape = [1] * x.ndim
        shape[channel_axis] = bias.shape[0]
        x = x + bias.reshape(shape).to(x.dtype)
    y = torch.where(x >= 0, x, x * scalar_as(negative_slope, x))
    if scale != 1.0:
        y = y * scalar_as(scale, x)
    return y
