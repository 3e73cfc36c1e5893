"""LPIPS perceptual metric with the VGG backbone (counterpart of
cips3dpp_tpu/utils/lpips.py; the reference reports it after every
inversion through the `lpips` package, projector_v10.py:1266-1275).

VGG16 relu{1_2,2_2,3_3,4_3,5_3} features, unit-normalised over channels,
squared difference, a non-negative per-channel "lin" weight per layer,
spatial mean, summed over layers (Zhang et al. 2018). Real weights are the
torchvision trunk and the lpips package's `vgg.pth` lin weights
(`lin{k}.model.1.weight`); without them `init_lpips` gives a random trunk
and uniform 1/C lin weights, which callers tag "random".
"""

from __future__ import annotations

from typing import Mapping

import torch
from torch import nn

from ..device import resolve_device
from ..models.vgg import VGG16Features, init_vgg

LPIPS_TAPS = (2, 7, 14, 21, 28)  # torchvision features index of the tapped convs
LPIPS_CHANNELS = {2: 64, 7: 128, 14: 256, 21: 512, 28: 512}


def _unit_normalize(x, eps: float = 1e-10):
    """normalize_tensor: unit L2 norm over the channel axis (NHWC)."""
    return x / torch.sqrt(torch.sum(torch.square(x), dim=-1, keepdim=True) + eps)


class LPIPS(nn.Module):
    """`lpips(a, b)`: mean LPIPS distance over an NHWC batch in [-1, 1].
    State-dict names: the trunk's `vgg.features.{i}.*` and `lin.{i}`, the
    (C,) lin weight of tap i."""

    def __init__(self):
        super().__init__()
        self.vgg = VGG16Features()
        self.lin = nn.ParameterDict({
            str(i): nn.Parameter(torch.full((c,), 1.0 / c), requires_grad=False)
            for i, c in LPIPS_CHANNELS.items()})

    def forward(self, a, b):
        fa = self.vgg(a, LPIPS_TAPS, post_relu=True)
        fb = self.vgg(b, LPIPS_TAPS, post_relu=True)
        total = 0.0
        for idx in LPIPS_TAPS:
            d = torch.square(_unit_normalize(fa[idx]) - _unit_normalize(fb[idx]))
            total = total + torch.mean(torch.sum(d * self.lin[str(idx)], dim=-1), dim=(1, 2))
        return total.mean()


def init_lpips(generator: torch.Generator | None = None, device=None) -> LPIPS:
    """The random fallback: `init_vgg`'s trunk and uniform lin weights, so
    it is a channel-normalised squared feature distance."""
    net = LPIPS().requires_grad_(False)
    net.vgg = init_vgg(generator, device="cpu")
    return net.to(resolve_device(device))


def import_lpips_torch(vgg_state_dict: Mapping[str, torch.Tensor],
                       lpips_state_dict: Mapping[str, torch.Tensor], device=None) -> LPIPS:
    """LPIPS from the torchvision vgg16 state dict and the lpips package's
    `vgg.pth` (lin weights `lin{k}.model.1.weight`, (1, C, 1, 1))."""
    net = LPIPS().requires_grad_(False)
    net.vgg.load_state_dict({k: v for k, v in vgg_state_dict.items()
                             if k.startswith("features.")})
    with torch.no_grad():
        for k, idx in enumerate(LPIPS_TAPS):
            net.lin[str(idx)].copy_(lpips_state_dict[f"lin{k}.model.1.weight"].reshape(-1))
    return net.to(resolve_device(device))
