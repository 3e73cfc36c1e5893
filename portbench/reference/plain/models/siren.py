# Frozen copy of cips3dpp_torch/models/siren.py at commit af17e715d5a8,
# the plain path only: the yardstick keeps this copy whatever the program
# becomes. Edits from the source are marked "portbench:".
"""FiLM-SIREN MLP, the NeRF backbone (counterpart of cips3dpp_tpu/models/siren.py).

Sine layers whose frequency (gamma) and phase (beta) are style-modulated,
a linear SDF head after the point stack, and a view-conditioned final sine
layer feeding linear RGB / feature heads (volume_renderer.py:14-160).
Module names follow the reference state dict: pts_linears, views_linears,
rgb_linear, sigma_linear.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from .layers import kaiming_normal_leaky_, matmul_in, uniform_bound_


class SirenLinear(nn.Module):
    """y = std * (x W + b) + shift (volume_renderer.py:15-35). init 'first'
    U(+-1/in), 'freq' U(+-sqrt(6/in)/25), else 0.25 * kaiming normal."""

    def __init__(self, in_dim, out_dim, std=1.0, shift=0.0, init="kaiming"):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_dim, in_dim))
        self.bias = nn.Parameter(torch.empty(out_dim))
        self.std, self.shift, self.init = std, shift, init

    def reset_parameters(self, gen):
        n = self.weight.shape[1]
        if self.init == "first":
            uniform_bound_(self.weight, gen, 1.0 / n)
        elif self.init == "freq":
            uniform_bound_(self.weight, gen, math.sqrt(6.0 / n) / 25.0)
        else:
            kaiming_normal_leaky_(self.weight, gen, n, mul=0.25)
        uniform_bound_(self.bias, gen, math.sqrt(1.0 / n))

    def forward(self, x):
        # the f32 weight promotes the product to f32 (JAX type promotion),
        # rounded back to the storage dtype before the bias
        y = (x.float() @ self.weight.t()).to(x.dtype) + self.bias
        return self.std * y + self.shift


class FiLMSiren(nn.Module):
    """sin(gamma(w) * (x W + b) + beta(w)) (volume_renderer.py:39-85);
    gamma = 15*linear + 30, beta = 0.25*linear. Matmul inputs in the
    storage dtype, accumulation and phase in f32."""

    def __init__(self, in_dim, out_dim, style_dim, is_first=False):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_dim, in_dim))
        self.bias = nn.Parameter(torch.empty(out_dim))
        self.gamma = SirenLinear(style_dim, out_dim, std=15.0, shift=30.0)
        self.beta = SirenLinear(style_dim, out_dim, std=0.25, shift=0.0)
        self.is_first = is_first

    def reset_parameters(self, gen):
        n = self.weight.shape[1]
        bound = 1.0 / 3.0 if self.is_first else math.sqrt(6.0 / n) / 25.0
        uniform_bound_(self.weight, gen, bound)
        uniform_bound_(self.bias, gen, math.sqrt(1.0 / n))

    def forward(self, x, style):
        lin = matmul_in(x, self.weight.t()) + self.bias  # f32
        gamma = self.gamma(style)
        beta = self.beta(style)
        extra = lin.ndim - gamma.ndim
        shape = gamma.shape[:1] + (1,) * extra + gamma.shape[1:]
        return torch.sin(gamma.reshape(shape) * lin + beta.reshape(shape)).to(x.dtype)


class SirenGenerator(nn.Module):
    """D FiLM-SIREN layers -> sdf head; + viewdirs -> final FiLM-SIREN ->
    features -> rgb head. styles: (B, D+1, style_dim); x = concat(pts,
    viewdirs) (B, ..., 6)."""

    def __init__(self, depth=8, width=256, input_ch=3, view_ch=3, style_dim=256):
        super().__init__()
        self.input_ch, self.view_ch = input_ch, view_ch
        self.pts_linears = nn.ModuleList(
            [FiLMSiren(input_ch, width, style_dim, is_first=True)]
            + [FiLMSiren(width, width, style_dim) for _ in range(depth - 1)]
        )
        self.sigma_linear = SirenLinear(width, 1, init="freq")
        self.views_linears = FiLMSiren(width + view_ch, width, style_dim)
        self.rgb_linear = SirenLinear(width, 3, init="freq")

    def forward(self, x, styles):
        pts = x[..., : self.input_ch]
        views = x[..., self.input_ch : self.input_ch + self.view_ch]
        h = pts
        for i, layer in enumerate(self.pts_linears):
            h = layer(h, styles[:, i])
        sdf = self.sigma_linear(h)
        features = self.views_linears(torch.cat([h, views], dim=-1), styles[:, -1])
        rgb = self.rgb_linear(features)
        return rgb, sdf, features
