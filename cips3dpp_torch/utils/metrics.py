"""PSNR and SSIM of the inversion report (counterpart of
cips3dpp_tpu/utils/metrics.py; the reference pulls skimage,
projector_v10.py:1266-1275)."""

from __future__ import annotations

import torch


def psnr(a: torch.Tensor, b: torch.Tensor, data_range: float = 2.0) -> torch.Tensor:
    """Peak SNR; data_range 2 for [-1, 1] images."""
    mse = torch.mean(torch.square(a - b))
    return 10.0 * torch.log10(data_range ** 2 / torch.clamp(mse, min=1e-12))


def _gaussian_kernel(size: int = 11, sigma: float = 1.5, device=None):
    x = torch.arange(size, dtype=torch.float32, device=device) - (size - 1) / 2.0
    g = torch.exp(-0.5 * (x / sigma) ** 2)
    g = g / g.sum()
    return torch.outer(g, g)


def ssim(a: torch.Tensor, b: torch.Tensor, data_range: float = 2.0, size: int = 11,
         sigma: float = 1.5) -> torch.Tensor:
    """Mean SSIM over an NHWC batch (or one HWC image), Wang et al.'s
    constants, an 11x11 Gaussian (sigma 1.5) applied per channel with
    VALID padding."""
    if a.ndim == 3:
        a, b = a[None], b[None]
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    ch = a.shape[-1]
    k = _gaussian_kernel(size, sigma, a.device).to(a.dtype)
    weight = k.expand(ch, 1, size, size)

    def filt(x):
        return torch.nn.functional.conv2d(x.permute(0, 3, 1, 2), weight, groups=ch)

    mu_a, mu_b = filt(a), filt(b)
    mu_aa, mu_bb, mu_ab = mu_a * mu_a, mu_b * mu_b, mu_a * mu_b
    s_aa = filt(a * a) - mu_aa
    s_bb = filt(b * b) - mu_bb
    s_ab = filt(a * b) - mu_ab
    num = (2 * mu_ab + c1) * (2 * s_ab + c2)
    den = (mu_aa + mu_bb + c1) * (s_aa + s_bb + c2)
    return torch.mean(num / den)
