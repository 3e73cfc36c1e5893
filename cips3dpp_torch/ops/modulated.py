"""Style-modulated 1x1 convolutions as batched matmuls
(counterpart of cips3dpp_tpu/ops/modulated.py, kernel_size 1 only)."""

from __future__ import annotations

import torch


def modulate_weights_1x1(
    weight: torch.Tensor,  # (Cin, Cout) base weight
    style: torch.Tensor,  # (B, Cin) modulation (EqualLinear output)
    demodulate: bool = True,
    scale: float | None = None,
) -> torch.Tensor:
    """Per-sample modulated weights (B, Cin, Cout) (model_v3.py:264-277):
    w = scale * W * s_in, then w /= sqrt(sum_in w^2 + 1e-8) per output."""
    cin = weight.shape[0]
    if scale is None:
        scale = 1.0 / (cin**0.5)
    w = scale * weight[None, :, :] * style[:, :, None]
    if demodulate:
        w = w * torch.rsqrt(torch.sum(w * w, dim=1, keepdim=True) + 1e-8)
    return w


def modulated_matmul(
    x: torch.Tensor,  # (B, N, Cin) pixels as rows
    weight: torch.Tensor,  # (Cin, Cout)
    style: torch.Tensor,  # (B, Cin)
    demodulate: bool = True,
) -> torch.Tensor:
    """1x1 modulated conv (B, N, Cout), in the dtype of x."""
    w = modulate_weights_1x1(weight, style, demodulate=demodulate)
    return torch.bmm(x, w.to(x.dtype))
