"""Image resizes of the inversion path and of the training thumbnails.

`resize` is `jax.image.resize` for the "cubic" (Keys, a = -0.5) and
"lanczos3" methods (jax/_src/image/scale.py): one (in, out) weight matrix
per resized axis, built in f32 as `compute_weight_mat` builds it with
JAX's default antialias=True (the kernel widened by the downscale factor,
weights renormalised by their sum, zero weight for samples wholly outside
the input), applied as one product along H and one along W. torch's
`interpolate` is another function: its bicubic kernel has a = -0.75, it
has no Lanczos kernel, and its edges differ.

`pil_lanczos_resize` is PIL's `Image.resize(size, Image.LANCZOS)` on a
uint8 image (Resample.c): support 3, each window clipped to the image,
fixed-point coefficients with 22 fractional bits, the horizontal pass
first, rounded to uint8 between the passes. `center_crop` is PIL's crop
of a centred window, the square the `invert` command takes before the
resize or the window of `prepare-data --crop-size`.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def _keys_cubic(x):
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def _lanczos3(x):
    radius = 3.0
    y = radius * torch.sin(math.pi * x) * torch.sin(math.pi * x / radius)
    den = torch.where(x != 0, (math.pi ** 2) * x * x, torch.ones_like(x))
    out = torch.where(x > 1e-3, y / den, torch.ones_like(x))
    return torch.where(x > radius, torch.zeros_like(x), out)


_KERNELS = {"cubic": _keys_cubic, "lanczos3": _lanczos3}


def resize_weights(in_size: int, out_size: int, method: str, device=None) -> torch.Tensor:
    """(in_size, out_size) f32 weights of one axis (compute_weight_mat)."""
    kernel = _KERNELS[method]
    f32 = dict(dtype=torch.float32, device=device)
    # the scale is a Python float; JAX rounds 1 / scale to f32 and goes on in f32
    inv_scale = torch.tensor(1.0 / (out_size / in_size), **f32)
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    sample_f = (torch.arange(out_size, **f32) + 0.5) * inv_scale - 0.5
    x = torch.abs(sample_f[None, :] - torch.arange(in_size, **f32)[:, None]) / kernel_scale
    w = kernel(x)
    total = torch.sum(w, dim=0, keepdim=True)
    eps = 1000.0 * float(np.finfo(np.float32).eps)
    w = torch.where(torch.abs(total) > eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def resize(image: torch.Tensor, size, method: str) -> torch.Tensor:
    """jax.image.resize of an NHWC image to spatial `size` (H, W); an axis
    whose size does not change is left as it is, as in JAX."""
    h, w = size
    out = image
    if h != image.shape[1]:
        wh = resize_weights(image.shape[1], h, method, image.device)
        out = torch.einsum("bhwc,hk->bkwc", out, wh.to(out.dtype))
    if w != image.shape[2]:
        ww = resize_weights(image.shape[2], w, method, image.device)
        out = torch.einsum("bhwc,wk->bhkc", out, ww.to(out.dtype))
    return out


# ------------------------------------------------ PIL's Lanczos on uint8 --

_PRECISION_BITS = 32 - 8 - 2


def _sinc(x: float) -> float:
    if x == 0.0:
        return 1.0
    x *= math.pi
    return math.sin(x) / x


def _pil_lanczos(x: float) -> float:
    return _sinc(x) * _sinc(x / 3.0) if -3.0 <= x < 3.0 else 0.0


def _pil_coeffs(in_size: int, out_size: int):
    """(first input index (out,), fixed-point coefficients (out, k)) of one
    axis, as Resample.c's precompute_coeffs and normalize_coeffs_8bpc."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 3.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    ss = 1.0 / filterscale
    first = np.zeros(out_size, np.int64)
    coeffs = np.zeros((out_size, ksize), np.int64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        k = [_pil_lanczos((x + xmin - center + 0.5) * ss) for x in range(xmax)]
        ww = sum(k)
        if ww != 0.0:
            k = [v / ww for v in k]
        first[xx] = xmin
        coeffs[xx, :xmax] = [int(v * (1 << _PRECISION_BITS) + (-0.5 if v < 0 else 0.5))
                             for v in k]
    return first, coeffs


def _pil_pass(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One pass of PIL's 8-bit resample along `axis` (0 rows, 1 columns)."""
    first, coeffs = _pil_coeffs(img.shape[axis], out_size)
    src = np.moveaxis(img, axis, 0).astype(np.int64)
    acc = np.full((out_size,) + src.shape[1:], 1 << (_PRECISION_BITS - 1), np.int64)
    last = src.shape[0] - 1
    for j in range(coeffs.shape[1]):
        # taps past a window's end have coefficient 0; clamp their index
        rows = src[np.minimum(first + j, last)]
        acc += rows * coeffs[:, j].reshape((-1,) + (1,) * (src.ndim - 1))
    out = np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def pil_lanczos_resize(img: np.ndarray, size) -> np.ndarray:
    """PIL's `Image.resize((width, height), Image.LANCZOS)` of an (H, W, C)
    uint8 image: the horizontal pass, then the vertical one."""
    width, height = size
    out = np.asarray(img, np.uint8)
    if width != out.shape[1]:
        out = _pil_pass(out, width, 1)
    if height != out.shape[0]:
        out = _pil_pass(out, height, 0)
    return out


def center_crop(img: np.ndarray, size=None) -> np.ndarray:
    """The centred (crop_h, crop_w) window of an (H, W, C) image, as PIL's
    `crop((left, upper, left + crop_w, upper + crop_h))` with left =
    (W - crop_w) // 2, upper = (H - crop_h) // 2 gives it (zeros where the
    window leaves the image). `size` is (crop_w, crop_h), an int for a
    square, or None for the largest square."""
    h, w = img.shape[:2]
    if size is None:
        size = min(w, h)
    cw, ch = (size, size) if isinstance(size, int) else size
    left, upper = (w - cw) // 2, (h - ch) // 2
    out = np.zeros((ch, cw) + img.shape[2:], img.dtype)
    y0, x0 = max(upper, 0), max(left, 0)
    y1, x1 = min(upper + ch, h), min(left + cw, w)
    if y1 > y0 and x1 > x0:
        out[y0 - upper:y1 - upper, x0 - left:x1 - left] = img[y0:y1, x0:x1]
    return out
