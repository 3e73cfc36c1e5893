# Frozen copy of cips3dpp_torch/ops/upfirdn2d.py at commit af17e715d5a8,
# the plain path only: the yardstick keeps this copy whatever the program
# becomes. Edits from the source are marked "portbench:".
"""upfirdn2d -- upsample, FIR filter, downsample -- and the StyleGAN2
blur, downsample and upsample built on it (counterpart of
cips3dpp_tpu/ops/upfirdn2d.py).

`upfirdn2d`, `blur` and `downsample2x` take NCHW, the reference's torch
layout (exp/op/upfirdn2d.py), and serve the discriminators, which run
NCHW; `blur` and `downsample2x` run separably, axis by axis. `upsample2x` takes NHWC and serves the decoder: for up=2 with the
[1,3,3,1] kernel and the Upsample pad schedule, even/odd output rows are
2-tap blends of input rows
    even[t] = k0*x[t-1] + k2*x[t]     odd[t] = k1*x[t] + k3*x[t+1]
with zero edges; the same along columns.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def make_blur_kernel(kernel=(1, 3, 3, 1), upsample_factor: int = 1) -> torch.Tensor:
    """Normalised 2-D blur kernel (model_v3.py:73-81)."""
    k = np.asarray(kernel, dtype=np.float32)
    if k.ndim == 1:
        k = np.outer(k, k)
    k = k / k.sum()
    if upsample_factor > 1:
        k = k * (upsample_factor**2)
    return torch.from_numpy(k)


def _up_axis(y: torch.Tensor, dim: int, k1d) -> torch.Tensor:
    k0, k1, k2, k3 = k1d
    n = y.shape[dim]
    zero = torch.zeros_like(y.narrow(dim, 0, 1))
    prev = torch.cat([zero, y.narrow(dim, 0, n - 1)], dim=dim)
    nxt = torch.cat([y.narrow(dim, 1, n - 1), zero], dim=dim)
    even = k0 * prev + k2 * y
    odd = k1 * y + k3 * nxt
    stacked = torch.stack([even, odd], dim=dim + 1)
    shape = list(y.shape)
    shape[dim] *= 2
    return stacked.reshape(shape)


def _upsample2x_separable_4tap(x: torch.Tensor, k1d) -> torch.Tensor:
    """2x zero-stuff + 4-tap FIR as shift-adds + interleave, rows then
    columns. x (B, H, W, C)."""
    k1d = [float(v) for v in np.asarray(k1d)]
    return _up_axis(_up_axis(x, 1, k1d), 2, k1d)


def upsample2x(x: torch.Tensor, blur_kernel=(1, 3, 3, 1)) -> torch.Tensor:
    """StyleGAN2 Upsample (model_v3.py:84-102): 2x zero-stuff + 4x-gain blur,
    x (B, H, W, C). A 4-tap kernel runs as shift-adds; any other through
    upfirdn2d with the Upsample pads (pad0 = (p + 1) // 2 + 1, pad1 = p //
    2, p = len(kernel) - 2), as cips3dpp_tpu/ops/upfirdn2d.py:164-175."""
    if len(blur_kernel) == 4:
        k1d = np.asarray(blur_kernel, np.float32)
        k1d = k1d / k1d.sum() * 2  # sqrt of the 4x 2-D gain per axis
        return _upsample2x_separable_4tap(x, k1d)
    k = make_blur_kernel(blur_kernel, upsample_factor=2)
    p = k.shape[0] - 2
    out = upfirdn2d(x.permute(0, 3, 1, 2), k, up=2, pad=((p + 1) // 2 + 1, p // 2))
    return out.permute(0, 2, 3, 1)


def upfirdn2d(x: torch.Tensor, kernel: torch.Tensor, up: int = 1, down: int = 1,
              pad: tuple = (0, 0)) -> torch.Tensor:
    """NCHW upfirdn (exp/op/upfirdn2d.py:160-201): insert up-1 zeros after
    every sample, zero-pad both spatial axes by pad = (pad0, pad1),
    convolve (a true convolution) with the 2-D FIR `kernel` shared by all
    channels, keep every down-th sample. Per axis
    out = (in * up + pad0 + pad1 - k) // down + 1. Pads are >= 0."""
    b, c, h, w = x.shape
    pad0, pad1 = pad
    if up > 1:
        x = F.pad(x.reshape(b, c, h, 1, w, 1), (0, up - 1, 0, 0, 0, up - 1))
        x = x.reshape(b, c, h * up, w * up)
    x = F.pad(x, (pad0, pad1, pad0, pad1))
    k = torch.flip(kernel, (0, 1)).to(device=x.device, dtype=x.dtype)
    weight = k[None, None].expand(c, 1, *k.shape)
    return F.conv2d(x, weight, stride=down, groups=c)


def separable_taps(blur_kernel, upsample_factor: int = 1) -> tuple:
    """1-D taps whose outer product is make_blur_kernel(blur_kernel,
    upsample_factor): k / sum(k) * upsample_factor per axis."""
    k = np.asarray(blur_kernel, np.float64)
    return tuple(float(v) for v in k / k.sum() * upsample_factor)


def _fir_axis(x: torch.Tensor, dim: int, taps, pad0: int, pad1: int,
              down: int = 1) -> torch.Tensor:
    """1-D FIR along `dim` with zero pads and decimation: a true
    convolution (the taps reversed), as shifted slices times taps."""
    x = F.pad(x, [0, 0] * (x.ndim - dim - 1) + [pad0, pad1])
    n = (x.shape[dim] - len(taps)) // down + 1
    step = (slice(None),) * dim + (slice(None, None, down),)
    out = None
    for j, tap in enumerate(reversed(taps)):
        part = x.narrow(dim, j, down * (n - 1) + 1)[step]
        out = tap * part if out is None else out + tap * part
    return out


def blur(x: torch.Tensor, taps, pad: tuple) -> torch.Tensor:
    """Blur module (model_v3.py:126-142): the separable FIR filter of 1-D
    `taps` (separable_taps) with given pads, NCHW, axis by axis as shifted
    slices; in exact arithmetic upfirdn2d with the 2-D kernel. Not one
    depthwise convolution: its double backward, which the discriminator's
    R1 penalty takes, runs on the card as one cuDNN convolution per channel
    group (`python -m cips3dpp_torch.tools.blur_r1_ab` times both)."""
    return _fir_axis(_fir_axis(x, 2, taps, *pad), 3, taps, *pad)


def downsample2x(x: torch.Tensor, blur_kernel=(1, 3, 3, 1)) -> torch.Tensor:
    """StyleGAN2 Downsample (model_v3.py:105-123): blur + stride-2
    decimation, NCHW, axis by axis."""
    taps = separable_taps(blur_kernel)
    p = len(taps) - 2
    pads = ((p + 1) // 2, p // 2)
    return _fir_axis(_fir_axis(x, 2, taps, *pads, down=2), 3, taps, *pads, down=2)
