"""Fused bias + leaky-ReLU (+ gain), the StyleGAN2 `fused_bias_act` op
(counterpart of cips3dpp_tpu/ops/fused_act.py). Channels last."""

from __future__ import annotations

import torch

SQRT2 = 1.4142135623730951


def fused_leaky_relu(
    x: torch.Tensor,
    bias: torch.Tensor | None = None,
    negative_slope: float = 0.2,
    scale: float = SQRT2,
    channel_axis: int = -1,
) -> torch.Tensor:
    """y = leaky_relu(x + bias) * scale, bias broadcast along `channel_axis`
    in the dtype of x."""
    if bias is not None:
        shape = [1] * x.ndim
        shape[channel_axis] = bias.shape[0]
        x = x + bias.reshape(shape).to(x.dtype)
    y = torch.where(x >= 0, x, x * negative_slope)
    if scale != 1.0:
        y = y * scale
    return y
