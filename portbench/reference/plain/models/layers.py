# Frozen copy of cips3dpp_torch/models/layers.py at commit af17e715d5a8,
# the plain path only: the yardstick keeps this copy whatever the program
# becomes. Edits from the source are marked "portbench:".
"""StyleGAN2-style layers (counterpart of cips3dpp_tpu/models/layers.py).

The generator's layers take NHWC; the discriminators' conv layers
(EqualConv2d, Blur, ConvLayer) take NCHW, the layout of torch's
convolutions and of the reference's modules. Parameters are stored under the reference's torch state-dict names and
layouts (Linear (out, in), modulated conv (1, out, in, 1, 1)), so a
reference `G_ema.pth` maps onto these modules by name. Every module that
owns parameters has `reset_parameters(gen)`, which draws them from the
same distributions as the JAX initialisers (model_v3.py:32-519) with an
explicit `torch.Generator`; `init_parameters` walks a model.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import blur, fused_leaky_relu, modulated_matmul, upsample2x
from ..ops.modulated import grouped_conv, modulate_weights_kxk, modulated_conv2d
from ..ops.upfirdn2d import separable_taps


# ---------------------------------------------------------------------------
# initialisers (layers.py:32-60; fan_in = in_dim)
# ---------------------------------------------------------------------------


def _randn(shape, gen):
    """portbench: N(0, 1) draws from a torch.Generator, or from the slices of
    a device pool (`portbench/lib/weights.py:Pool`)."""
    if isinstance(gen, torch.Generator):
        return torch.randn(shape, generator=gen)
    return gen.randn(shape)


def _rand(shape, gen):
    """portbench: U(0, 1) draws, as `_randn`."""
    if isinstance(gen, torch.Generator):
        return torch.rand(shape, generator=gen)
    return gen.rand(shape)


def kaiming_normal_leaky_(t, gen, fan_in, a=0.2, mul=1.0):
    std = math.sqrt(2.0 / (1.0 + a * a)) / math.sqrt(fan_in) * mul
    with torch.no_grad():
        t.copy_(std * _randn(t.shape, gen))
    return t


def uniform_bound_(t, gen, bound):
    with torch.no_grad():
        t.copy_((_rand(t.shape, gen) * 2.0 - 1.0) * bound)
    return t


def normal_div_(t, gen, lr_mul=1.0):
    with torch.no_grad():
        t.copy_(_randn(t.shape, gen) / lr_mul)
    return t


def init_parameters(module: nn.Module, gen: torch.Generator) -> nn.Module:
    """Draw every parameter of `module` from its initialiser, in module
    order, from `gen` (a CPU generator, so a seed gives the same weights on
    every device). torch's own modules (nn.Conv2d) are drawn by their owner."""
    for m in module.modules():
        if hasattr(m, "reset_parameters") and not type(m).__module__.startswith("torch."):
            m.reset_parameters(gen)
    return module


@torch.no_grad()
def randomize_zero_init_(module: nn.Module, gen: torch.Generator) -> nn.Module:
    """Set the parameters that start at zero (NoiseInjection weights,
    activation biases, ToRGB biases) to nonzero draws from `gen`. A fresh
    model tests none of the noise and bias paths; checks against a
    reference call this first."""
    for m in module.modules():
        if isinstance(m, NoiseInjection):
            m.weight.copy_(0.2 + 0.4 * _rand(m.weight.shape, gen))
        elif isinstance(m, (FusedLeakyReLU, ToRGB)):
            m.bias.copy_(0.1 * _randn(m.bias.shape, gen))
    return module


def matmul_in(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w with f32 accumulation: when x is bf16 both operands are
    rounded to bf16 and multiplied in f32, as JAX's dot with
    preferred_element_type=f32 does."""
    if x.dtype == torch.bfloat16:
        return x.float() @ w.to(torch.bfloat16).float()
    return x @ w.to(x.dtype)


# ---------------------------------------------------------------------------
# basic layers
# ---------------------------------------------------------------------------


def pixel_norm(x: torch.Tensor) -> torch.Tensor:
    """x * rsqrt(mean(x^2) + 1e-8) over channels (model_v3.py:32-37)."""
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + 1e-8)


class PixelNorm(nn.Module):
    def forward(self, x):
        return pixel_norm(x)


class EqualLinear(nn.Module):
    """Equalised-lr linear (model_v3.py:183-215): weight ~ N(0,1)/lr_mul,
    runtime scale lr_mul/sqrt(in); bias times lr_mul at use."""

    def __init__(self, in_dim, out_dim, bias=True, bias_init=0.0, lr_mul=1.0,
                 activation=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_dim, in_dim))
        self.bias = nn.Parameter(torch.empty(out_dim)) if bias else None
        self.bias_init = bias_init
        self.lr_mul = lr_mul
        self.scale = (1.0 / math.sqrt(in_dim)) * lr_mul
        self.activation = activation

    def reset_parameters(self, gen):
        normal_div_(self.weight, gen, self.lr_mul)
        if self.bias is not None:
            with torch.no_grad():
                self.bias.fill_(self.bias_init)

    def forward(self, x):
        w = (self.weight * self.scale).t()
        if x.dtype == w.dtype:
            out = x @ w
        else:  # JAX's dot promotes both operands to f32, then rounds to x's dtype
            out = (x.float() @ w).to(x.dtype)
        b = self.bias * self.lr_mul if self.bias is not None else None
        if self.activation == "fused_lrelu":
            return fused_leaky_relu(out, b)
        return out if b is None else out + b


class MappingLinear(nn.Module):
    """NeRF-mapping linear (model_v3.py:40-65): kaiming-normal weights, no
    runtime scaling, lrelu with scale 1."""

    def __init__(self, in_dim, out_dim, use_bias=True, activation=None,
                 is_last=False):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_dim, in_dim))
        self.bias = nn.Parameter(torch.empty(out_dim)) if use_bias else None
        self.activation = activation
        self.std_mul = 0.25 if is_last else 1.0

    def reset_parameters(self, gen):
        in_dim = self.weight.shape[1]
        kaiming_normal_leaky_(self.weight, gen, in_dim, mul=self.std_mul)
        if self.bias is not None:
            uniform_bound_(self.bias, gen, math.sqrt(1.0 / in_dim))

    def forward(self, x):
        out = x @ self.weight.t().to(x.dtype)
        if self.activation is not None:
            return fused_leaky_relu(out, self.bias, scale=1.0)
        return out if self.bias is None else out + self.bias


# ---------------------------------------------------------------------------
# modulated conv stack
# ---------------------------------------------------------------------------


class ModulatedConv2d(nn.Module):
    """Style-modulated conv, NHWC (model_v3.py:218-314). Weight stored
    (1, out, in, k, k). At k = 1 (the v10 decoder) a batched matmul; with
    upsample, the transposed stride-2 conv + gain-4 blur of k = 1 is
    modulate-then-upsample2x. At k > 1 one grouped conv (groups = batch):
    padding k // 2; with upsample a stride-2 transposed conv, then the
    gain-4 blur; with downsample the blur, then a stride-2 conv
    (cips3dpp_tpu/models/layers.py:316-405). `blur_kernel`: the 1-D taps
    of those blurs."""

    def __init__(self, in_channel, out_channel, style_dim, demodulate=True,
                 upsample=False, kernel_size=1, downsample=False,
                 blur_kernel=(1, 3, 3, 1)):
        super().__init__()
        self.blur_kernel = tuple(blur_kernel)
        self.weight = nn.Parameter(
            torch.empty(1, out_channel, in_channel, kernel_size, kernel_size))
        self.modulation = EqualLinear(style_dim, in_channel, bias_init=1.0)
        self.demodulate = demodulate
        self.upsample = upsample
        self.downsample = downsample
        self.kernel_size = kernel_size

    def reset_parameters(self, gen):
        with torch.no_grad():
            self.weight.copy_(_randn(self.weight.shape, gen))

    def base_weight(self) -> torch.Tensor:
        """(Cin, Cout) view of the stored (1, out, in, 1, 1) weight."""
        return self.weight[0, :, :, 0, 0].t()

    def forward(self, x, style):
        b, h, w, cin = x.shape
        s = self.modulation(style)
        k = self.kernel_size
        if k == 1 and not self.downsample:
            y = modulated_matmul(
                x.reshape(b, -1, cin), self.base_weight(), s, self.demodulate
            ).reshape(b, h, w, -1)
            return upsample2x(y, self.blur_kernel) if self.upsample else y
        if not (self.upsample or self.downsample):
            return modulated_conv2d(x, self.weight[0], s, self.demodulate)
        wmod = modulate_weights_kxk(self.weight[0], s, self.demodulate)
        x = x.permute(0, 3, 1, 2)
        taps = len(self.blur_kernel)
        if self.upsample:
            # (2h + k - 2)^2 out of the transposed conv, brought back to
            # (2h)^2 by the blur's pads
            p = taps - 2 - (k - 1)
            out = grouped_conv(x, wmod, stride=2, transpose=True)
            out = blur(out, separable_taps(self.blur_kernel, 2), ((p + 1) // 2 + 1, p // 2 + 1))
        else:
            p = taps - 2 + (k - 1)
            x = blur(x, separable_taps(self.blur_kernel), ((p + 1) // 2, p // 2))
            out = grouped_conv(x, wmod, stride=2)
        return out.permute(0, 2, 3, 1)


class NoiseInjection(nn.Module):
    """x + weight * noise, one learned scalar (model_v3.py:317-341). The
    noise map (B|1, H, W, 1) is always supplied by the caller."""

    def __init__(self):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(1))

    def reset_parameters(self, gen):
        with torch.no_grad():
            self.weight.zero_()

    def forward(self, x, noise):
        return x + self.weight.to(x.dtype) * noise.to(x.dtype)


class FusedLeakyReLU(nn.Module):
    """Holds the activation bias under the reference name `activate.bias`.
    channel_axis -1 for NHWC, 1 for NCHW."""

    def __init__(self, channel, channel_axis=-1):
        super().__init__()
        self.bias = nn.Parameter(torch.zeros(channel))
        self.channel_axis = channel_axis

    def reset_parameters(self, gen):
        with torch.no_grad():
            self.bias.zero_()

    def forward(self, x):
        return fused_leaky_relu(x, self.bias, channel_axis=self.channel_axis)


class StyledConv(nn.Module):
    """ModulatedConv -> NoiseInjection -> fused lrelu (model_v3.py:418-454).
    `bias` is the reference's unused StyledConv.bias, kept so the
    state-dict keys match; it takes no part in the forward."""

    def __init__(self, in_channel, out_channel, style_dim, upsample=False,
                 kernel_size=1, blur_kernel=(1, 3, 3, 1)):
        super().__init__()
        self.conv = ModulatedConv2d(in_channel, out_channel, style_dim,
                                    upsample=upsample, kernel_size=kernel_size,
                                    blur_kernel=blur_kernel)
        self.noise = NoiseInjection()
        self.activate = FusedLeakyReLU(out_channel)
        self.bias = nn.Parameter(torch.zeros(1, out_channel, 1, 1))

    def reset_parameters(self, gen):
        with torch.no_grad():
            self.bias.zero_()

    def forward(self, x, style, noise):
        return self.activate(self.noise(self.conv(x, style), noise))


class ToRGB(nn.Module):
    """1x1 modulated conv (no demod) to RGB + upsampled skip
    (model_v3.py:457-482). Bias stored (1, 3, 1, 1). `blur_kernel`: the
    skip's upsample blur."""

    def __init__(self, in_channel, style_dim, upsample=True,
                 skip_dtype=torch.float32, blur_kernel=(1, 3, 3, 1)):
        super().__init__()
        self.conv = ModulatedConv2d(in_channel, 3, style_dim, demodulate=False)
        self.bias = nn.Parameter(torch.zeros(1, 3, 1, 1))
        self.upsample = upsample
        self.skip_dtype = skip_dtype
        self.blur_kernel = tuple(blur_kernel)

    def reset_parameters(self, gen):
        with torch.no_grad():
            self.bias.zero_()

    def forward(self, x, style, skip=None):
        dt = self.skip_dtype
        out = self.conv(x, style).to(dt) + self.bias.reshape(3).to(dt)
        if skip is not None:
            skip = skip.to(dt)
            if self.upsample:
                skip = upsample2x(skip, self.blur_kernel)
            out = out + skip
        return out


def channel_table(channel_multiplier: int) -> dict:
    """StyleGAN2 channel table (model_v3.py:564-574)."""
    return {
        4: 512, 8: 512, 16: 512, 32: 512,
        64: 256 * channel_multiplier,
        128: 128 * channel_multiplier,
        256: 64 * channel_multiplier,
        512: 32 * channel_multiplier,
        1024: 16 * channel_multiplier,
    }


# ---------------------------------------------------------------------------
# discriminator convolutions (NCHW)
# ---------------------------------------------------------------------------


class EqualConv2d(nn.Module):
    """Equalised-lr conv (model_v3.py:145-180): weight (out, in, k, k) ~
    N(0,1), runtime scale 1/sqrt(in*k*k), bias zero-initialised."""

    def __init__(self, in_channel, out_channel, kernel_size, stride=1, padding=0,
                 bias=True):
        super().__init__()
        self.weight = nn.Parameter(
            torch.empty(out_channel, in_channel, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_channel)) if bias else None
        self.scale = 1.0 / math.sqrt(in_channel * kernel_size * kernel_size)
        self.stride, self.padding = stride, padding

    def reset_parameters(self, gen):
        with torch.no_grad():
            self.weight.copy_(_randn(self.weight.shape, gen))
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x):
        w = self.weight * self.scale
        if x.dtype == w.dtype:
            return F.conv2d(x, w, self.bias, stride=self.stride, padding=self.padding)
        # a bf16 input: the weight rounded to its dtype, the f32 bias added
        # after (the sum promotes to f32, as in JAX)
        out = F.conv2d(x, w.to(x.dtype), stride=self.stride, padding=self.padding)
        return out if self.bias is None else out + self.bias[:, None, None]


class Blur(nn.Module):
    """FIR blur with fixed pads (model_v3.py:126-142), separable: the 1-D
    taps of a 1-D blur_kernel run axis by axis (ops.upfirdn2d.blur). No
    state-dict entry, as the JAX package's exporter leaves the reference's
    `.kernel` out."""

    def __init__(self, pad, blur_kernel=(1, 3, 3, 1), upsample_factor=1):
        super().__init__()
        self.pad = tuple(pad)
        self.taps = separable_taps(blur_kernel, upsample_factor)

    def forward(self, x):
        if x.dtype != torch.float32:
            # one rounding to x's dtype, as the JAX package's depthwise
            # convolution (the taps are exact in bf16)
            return blur(x.float(), self.taps, self.pad).to(x.dtype)
        return blur(x, self.taps, self.pad)


class ConvLayer(nn.Sequential):
    """[Blur] -> EqualConv2d -> [FusedLeakyReLU] (model_v3.py:485-519),
    indexed as the reference's Sequential (`.0`, `.1`, `.2`)."""

    def __init__(self, in_channel, out_channel, kernel_size, downsample=False,
                 blur_kernel=(1, 3, 3, 1), bias=True, activate=True):
        layers = []
        if downsample:
            p = (len(blur_kernel) - 2) + (kernel_size - 1)
            layers.append(Blur(((p + 1) // 2, p // 2), blur_kernel))
            stride, padding = 2, 0
        else:
            stride, padding = 1, kernel_size // 2
        layers.append(EqualConv2d(in_channel, out_channel, kernel_size, stride,
                                  padding, bias=bias and not activate))
        if activate:
            layers.append(FusedLeakyReLU(out_channel, channel_axis=1))
        super().__init__(*layers)


def torch_bilinear_downsample(x: torch.Tensor, out_size: int) -> torch.Tensor:
    """The discriminators' fade-path resize (discriminator.py:231-236):
    torch bilinear, align_corners=False, not antialiased, NCHW."""
    if x.shape[-1] == out_size:
        return x
    if x.dtype == torch.float32:
        return F.interpolate(x, size=(out_size, out_size), mode="bilinear",
                             align_corners=False)
    # another dtype: the JAX package's two-tap form axis by axis, rounding
    # where it rounds (cips3dpp_tpu/models/layers.py:489-521)
    f = x.shape[-1] // out_size
    src = (torch.arange(out_size, dtype=torch.float64) + 0.5) * f - 0.5
    i0 = src.floor().clamp(0, x.shape[-1] - 1).long()
    i1 = (i0 + 1).clamp(max=x.shape[-1] - 1)
    tt = (src - src.floor()).to(x.dtype).to(x.device)

    def axis(arr, dim):
        shape = [1] * arr.ndim
        shape[dim] = out_size
        t = tt.reshape(shape)
        a0 = arr.index_select(dim, i0.to(arr.device))
        a1 = arr.index_select(dim, i1.to(arr.device))
        return a0 * (1 - t) + a1 * t

    return axis(axis(x, 2), 3)
