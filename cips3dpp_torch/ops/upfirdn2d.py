"""StyleGAN2 2x upsample as separable 4-tap shift-adds
(counterpart of the upsample half of cips3dpp_tpu/ops/upfirdn2d.py). NHWC.

For up=2 with the [1,3,3,1] kernel and the Upsample pad schedule, even/odd
output rows are 2-tap blends of input rows:
    even[t] = k0*x[t-1] + k2*x[t]     odd[t] = k1*x[t] + k3*x[t+1]
with zero edges; the same along columns.
"""

from __future__ import annotations

import numpy as np
import torch


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
    """StyleGAN2 Upsample (model_v3.py:84-102): 2x zero-stuff + 4x-gain blur.
    Only the 4-tap separable case, the one the decoder uses."""
    if len(blur_kernel) != 4:
        raise NotImplementedError("upsample2x: only 4-tap blur kernels")
    k1d = np.asarray(blur_kernel, np.float32)
    k1d = k1d / k1d.sum() * 2  # sqrt of the 4x 2-D gain per axis
    return _upsample2x_separable_4tap(x, k1d)
