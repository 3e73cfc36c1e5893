"""VGG16 perceptual features for inversion (counterpart of
cips3dpp_tpu/models/vgg.py; contract exp/cips3d/models/vgg_per_loss.py:
200-340, VGG16ConvLoss with model_name 'vgg16_conv').

ImageNet-normalised input, the conv outputs features.{2,7,14,21,28}
(conv1_2, conv2_2, conv3_3, conv4_3, conv5_3) tapped before their ReLU
(the projector's loss) or after it (LPIPS), each flattened in NHWC order
and scaled by a per-layer weight, concatenated. The module is
torchvision's `vgg16().features` up to conv5_3, so its state-dict names
are torchvision's `features.{i}.weight/bias` and a `vgg16-397923af.pth`
loads as it is. Without weights `init_vgg` draws flax's default conv init,
the reference's 'vgg16_conv_random' mode.
"""

from __future__ import annotations

import math
from typing import Mapping

import torch
from torch import nn

from ..device import resolve_device

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

# (features index, out channels, max pool before)
_VGG16_PLAN = [
    (0, 64, False), (2, 64, False),
    (5, 128, True), (7, 128, False),
    (10, 256, True), (12, 256, False), (14, 256, False),
    (17, 512, True), (19, 512, False), (21, 512, False),
    (24, 512, True), (26, 512, False), (28, 512, False),
]

# per-layer loss weights, 'vgg16_conv_1024' (vgg_per_loss.py:258-266)
LOSS_W_1024 = {2: 0.0002, 7: 0.0001, 14: 0.0001, 21: 0.0002, 28: 0.0005}
LOSS_W_256 = {2: 0.001, 7: 0.0006, 14: 0.0005, 21: 0.0005, 28: 0.001}

TAP_LAYERS = (2, 7, 14, 21, 28)


def _max_pool(x):
    """2x2 max pool, stride 2, VALID, as flax's: a map smaller than 2
    pools to an empty one (torch's max_pool2d raises there)."""
    b, c, h, w = x.shape
    if h < 2 or w < 2:
        return x.new_zeros((b, c, h // 2, w // 2))
    return nn.functional.max_pool2d(x, 2, 2)


class VGG16Features(nn.Module):
    """torchvision's VGG16 conv trunk; `forward(x, taps, post_relu)` gives
    {features index: (B, H, W, C) tap}. One set of weights serves the
    perceptual loss (post_relu=False) and LPIPS (post_relu=True)."""

    def __init__(self):
        super().__init__()
        layers, cin = [], 3
        for idx, ch, pool_before in _VGG16_PLAN:
            if pool_before:
                layers.append(nn.MaxPool2d(2, 2))
            layers += [nn.Conv2d(cin, ch, 3, padding=1), nn.ReLU()]
            cin = ch
        self.features = nn.Sequential(*layers)

    def forward(self, x, taps=TAP_LAYERS, post_relu: bool = False):
        """x: NHWC in [-1, 1]. The ImageNet normalisation is also exactly
        LPIPS's ScalingLayer (shift mean*2-1, scale std*2)."""
        mean = torch.tensor(IMAGENET_MEAN, dtype=x.dtype, device=x.device)
        std = torch.tensor(IMAGENET_STD, dtype=x.dtype, device=x.device)
        x = ((x + 1.0) / 2.0 - mean) / std
        # channels-last strides: cuDNN keeps them, and a tap permuted back
        # to NHWC is contiguous
        x = x.permute(0, 3, 1, 2)
        feats = {}
        for i, layer in enumerate(self.features):
            if isinstance(layer, nn.MaxPool2d):
                x = _max_pool(x)
            elif isinstance(layer, nn.Conv2d):
                if x.shape[2] == 0 or x.shape[3] == 0:
                    x = x.new_zeros((x.shape[0], layer.out_channels) + x.shape[2:])
                else:
                    x = layer(x)
                if i in taps and not post_relu:
                    feats[i] = x.permute(0, 2, 3, 1)
            else:
                x = torch.relu(x)
                if i - 1 in taps and post_relu:
                    feats[i - 1] = x.permute(0, 2, 3, 1)
            if len(feats) == len(taps):
                break
        return feats


def perceptual_features(vgg: VGG16Features, x, loss_w: Mapping[int, float] | None = None,
                        taps=TAP_LAYERS):
    """Weighted flattened feature vector (vgg_per_loss.py:300-334), (B, F)."""
    if loss_w is None:
        loss_w = LOSS_W_1024
    feats = vgg(x, taps)
    return torch.cat([(feats[i] * loss_w[i]).reshape(x.shape[0], -1)
                      for i in sorted(feats)], dim=1)


def perceptual_distance(vgg: VGG16Features, a, b, loss_w=None):
    """Squared feature distance (projector_v10.py:1170-1174)."""
    fa = perceptual_features(vgg, a, loss_w)
    fb = perceptual_features(vgg, b, loss_w)
    return torch.sum(torch.square(fa - fb), dim=1).mean()


@torch.no_grad()
def init_vgg(generator: torch.Generator | None = None, device=None) -> VGG16Features:
    """Random weights (the reference's 'vgg16_conv_random' mode) drawn as
    flax's default nn.Conv init: lecun_normal (a normal truncated at 2
    standard deviations, rescaled to variance 1 / fan_in), zero biases. The
    draws come from `generator` on the CPU in layer order; the module is
    frozen (requires_grad False) and moved to `device` (default: the card)."""
    vgg = VGG16Features()
    # flax's variance_scaling: stddev of the untruncated normal
    # sqrt(1 / fan_in) / .87962566103423978 (the truncation's correction)
    for conv in vgg.features:
        if isinstance(conv, nn.Conv2d):
            fan_in = conv.in_channels * 9
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            w = torch.empty(conv.weight.shape)
            nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
            conv.weight.copy_(w)
            conv.bias.zero_()
    return vgg.requires_grad_(False).to(resolve_device(device))
