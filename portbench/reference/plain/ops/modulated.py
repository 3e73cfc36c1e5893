# Frozen copy of cips3dpp_torch/ops/modulated.py at commit af17e715d5a8,
# the plain path only: the yardstick keeps this copy whatever the program
# becomes. Edits from the source are marked "portbench:".
"""Style-modulated convolutions (counterpart of cips3dpp_tpu/ops/modulated.py):
the 1x1 form as a batched matmul, the k x k form as one grouped convolution
with the batch folded into the channels (groups = batch, model_v3.py:
308-312). Weights are in torch's layout, (Cout, Cin, k, k)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


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


def modulate_weights_kxk(
    weight: torch.Tensor,  # (Cout, Cin, k, k) base weight
    style: torch.Tensor,  # (B, Cin)
    demodulate: bool = True,
) -> torch.Tensor:
    """Per-sample modulated weights (B, Cout, Cin, k, k): scale
    1/sqrt(Cin k k), demodulated over (Cin, kh, kw) per output."""
    cout, cin, kh, kw = weight.shape
    scale = 1.0 / ((cin * kh * kw) ** 0.5)
    w = scale * weight[None] * style[:, None, :, None, None]
    if demodulate:
        w = w * torch.rsqrt(torch.sum(w * w, dim=(2, 3, 4), keepdim=True) + 1e-8)
    return w


def grouped_conv(x: torch.Tensor, wmod: torch.Tensor, stride: int = 1, padding: int = 0,
                 transpose: bool = False) -> torch.Tensor:
    """x (B, Cin, H, W) through per-sample weights wmod (B, Cout, Cin, k, k)
    as one convolution with groups = B, in x's dtype: (B, Cout, H', W').
    `transpose` runs the transposed convolution (its weight (B*Cin, Cout,
    k, k), not flipped: conv_transpose2d flips it itself)."""
    b, cin, h, w = x.shape
    cout, k = wmod.shape[1], wmod.shape[-1]
    xin = x.reshape(1, b * cin, h, w)
    wmod = wmod.to(x.dtype)
    if transpose:
        out = F.conv_transpose2d(xin, wmod.transpose(1, 2).reshape(b * cin, cout, k, k),
                                 stride=stride, padding=padding, groups=b)
    else:
        out = F.conv2d(xin, wmod.reshape(b * cout, cin, k, k), stride=stride,
                       padding=padding, groups=b)
    return out.reshape(b, cout, *out.shape[2:])


def modulated_conv2d(
    x: torch.Tensor,  # (B, H, W, Cin)
    weight: torch.Tensor,  # (Cout, Cin, k, k)
    style: torch.Tensor,  # (B, Cin)
    demodulate: bool = True,
    padding: int | None = None,  # default k // 2 ("SAME" at odd k)
) -> torch.Tensor:
    """k x k modulated conv, NHWC in and out: (B, H', W', Cout)."""
    wmod = modulate_weights_kxk(weight, style, demodulate)
    pad = weight.shape[-1] // 2 if padding is None else padding
    return grouped_conv(x.permute(0, 3, 1, 2), wmod, padding=pad).permute(0, 2, 3, 1)
