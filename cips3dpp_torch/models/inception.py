"""InceptionV3 feature extractor for FID and KID (counterpart of
cips3dpp_tpu/models/inception.py).

The reference computes FID and KID with torch-fidelity's pt_inception
(eval_fid.py:52-63): torchvision's InceptionV3 with the FID variant's
changes (Mixed_7c pools by max in its pool branch; the inputs resized to
299^2 by TF1's bilinear resize). Module names are pt_inception's state-dict
names (`Conv2d_1a_3x3.conv.weight`, `Mixed_5b.branch1x1.bn.running_mean`,
...), so the released `pt_inception-2015-12-05-6726825d.pth` loads as it
is. Without it a seeded random init gives a relative metric only, tagged
"random" by `io.weights.load_inception`.

NCHW inside, on cuDNN with TF32 off; the public function takes NHWC as
the JAX package's does. BatchNorm always runs on its running statistics
(eps 1e-3).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device


class _BatchNorm(nn.Module):
    """Inference BatchNorm with pt_inception's names (no num_batches_tracked)."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x):
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                            training=False, eps=1e-3)


class BasicConv(nn.Module):
    """conv (no bias) -> BatchNorm (eps 1e-3) -> relu."""

    def __init__(self, cin: int, cout: int, kernel, stride=1, padding=0):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride=stride, padding=padding, bias=False)
        self.bn = _BatchNorm(cout)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


def _tf1_resize_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out, in) weights of TF1's ResizeBilinear (align_corners=False,
    half_pixel_centers=False), torch-fidelity's
    interpolate_bilinear_2d_like_tensorflow1x: src = dst * in / out,
    clamped, no half-pixel offset and no antialiasing."""
    src = np.arange(out_size, dtype=np.float64) * (in_size / out_size)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, in_size - 1)
    t = (src - lo).astype(np.float32)
    m = np.zeros((out_size, in_size), np.float32)
    m[np.arange(out_size), lo] += 1.0 - t
    m[np.arange(out_size), hi] += t
    return m


def tf1_bilinear_resize(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """TF1-style bilinear resize of an NHWC image: one product per axis
    (`interpolate` is another function: it offsets by half a pixel)."""
    mh = torch.from_numpy(_tf1_resize_matrix(x.shape[1], out_h)).to(x.device)
    mw = torch.from_numpy(_tf1_resize_matrix(x.shape[2], out_w)).to(x.device)
    x = torch.einsum("oh,bhwc->bowc", mh, x)
    return torch.einsum("pw,bowc->bopc", mw, x)


def _avg_pool3(x):
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=False)


def _max_pool3s2(x):
    return F.max_pool2d(x, 3, stride=2)


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv(cin, 64, 1)
        self.branch5x5_1 = BasicConv(cin, 48, 1)
        self.branch5x5_2 = BasicConv(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv(96, 96, 3, padding=1)
        self.branch_pool = BasicConv(cin, pool_features, 1)

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch1x1(x), b5, b3, self.branch_pool(_avg_pool3(x))], 1)


class InceptionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3 = BasicConv(cin, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv(96, 96, 3, stride=2)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, _max_pool3s2(x)], 1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, c7: int):
        super().__init__()
        self.branch1x1 = BasicConv(cin, 192, 1)
        self.branch7x7_1 = BasicConv(cin, c7, 1)
        self.branch7x7_2 = BasicConv(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv(cin, c7, 1)
        self.branch7x7dbl_2 = BasicConv(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv(cin, 192, 1)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        for conv in (self.branch7x7dbl_2, self.branch7x7dbl_3, self.branch7x7dbl_4,
                     self.branch7x7dbl_5):
            bd = conv(bd)
        return torch.cat([self.branch1x1(x), b7, bd, self.branch_pool(_avg_pool3(x))], 1)


class InceptionD(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3_1 = BasicConv(cin, 192, 1)
        self.branch3x3_2 = BasicConv(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv(cin, 192, 1)
        self.branch7x7x3_2 = BasicConv(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv(192, 192, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = x
        for conv in (self.branch7x7x3_1, self.branch7x7x3_2, self.branch7x7x3_3,
                     self.branch7x7x3_4):
            b7 = conv(b7)
        return torch.cat([b3, b7, _max_pool3s2(x)], 1)


class InceptionE(nn.Module):
    """pool "avg" (Mixed_7b) or "max" (Mixed_7c, the FID variant)."""

    def __init__(self, cin: int, pool: str):
        super().__init__()
        self.pool = pool
        self.branch1x1 = BasicConv(cin, 320, 1)
        self.branch3x3_1 = BasicConv(cin, 384, 1)
        self.branch3x3_2a = BasicConv(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv(cin, 448, 1)
        self.branch3x3dbl_2 = BasicConv(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv(cin, 192, 1)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], 1)
        pooled = (F.max_pool2d(x, 3, stride=1, padding=1) if self.pool == "max"
                  else _avg_pool3(x))
        return torch.cat([self.branch1x1(x), b3, bd, self.branch_pool(pooled)], 1)


class InceptionV3Features(nn.Module):
    """The 2048-d pool3 feature of FID. `forward(x, fidelity_u8)`: x NHWC.
    fidelity_u8=True is torch-fidelity's input protocol (the reference
    computes FID over directories of uint8 images): x holds u8-valued
    floats in [0, 255], TF1-resized to 299^2 first, then (x - 128) / 128.
    False takes [-1, 1] floats (resize only)."""

    def __init__(self, device=None):
        super().__init__()
        self.Conv2d_1a_3x3 = BasicConv(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280, "avg")
        self.Mixed_7c = InceptionE(2048, "max")
        self.requires_grad_(False)
        self.to(resolve_device(device))

    def forward(self, x: torch.Tensor, fidelity_u8: bool = False) -> torch.Tensor:
        cudnn = torch.backends.cudnn
        with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                         deterministic=cudnn.deterministic, allow_tf32=False):
            return self._features(x, fidelity_u8)

    def _features(self, x, fidelity_u8):
        x = tf1_bilinear_resize(x.float(), 299, 299)
        if fidelity_u8:
            x = (x - 128.0) / 128.0
        x = x.permute(0, 3, 1, 2)
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(_max_pool3s2(x)))
        x = _max_pool3s2(x)
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a", "Mixed_6b", "Mixed_6c",
                     "Mixed_6d", "Mixed_6e", "Mixed_7a", "Mixed_7b", "Mixed_7c"):
            x = getattr(self, name)(x)
        return x.mean(dim=(2, 3))  # (B, 2048)


def init_inception(generator: torch.Generator | None = None, device=None) -> InceptionV3Features:
    """A seeded random Inception (default seed 0): each convolution
    LeCun-normal (a normal truncated at two standard deviations, variance
    1 / fan_in, as flax's default init), BatchNorm the identity. Drawn on
    the CPU, then moved to `device` (default: the card)."""
    gen = torch.Generator().manual_seed(0) if generator is None else generator
    model = InceptionV3Features(device="cpu")
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Conv2d):
                fan_in = m.weight[0].numel()
                # the truncated normal's std is 0.8796 of the normal's
                std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
                nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std, generator=gen)
    return model.to(resolve_device(device))
