"""StyleGAN2 image discriminator, flat and progressive
(counterpart of cips3dpp_tpu/models/discriminator.py; contract
exp/cips3d/models/discriminator.py).

The modules take NHWC images, as the JAX package's do, and run NCHW inside
(torch's convolution layout). Module names follow the reference state
dict (`conv_in.{res}`, `blocks.{res}`, `final_conv`, `final_linear`), the
names the JAX package's exporter writes (`io/torch_import.py:
export_d_stylegan_state_dict`), so `io/jax_params.py` carries JAX
weights across by name.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..device import resolve_device
from ..ops.fused_act import scalar_as
from ..parallel.mesh import all_gather_batch, shard_batch
from .diffaug import diff_augment
from .layers import ConvLayer, EqualLinear, channel_table, init_parameters, \
    torch_bilinear_downsample

SQRT2 = math.sqrt(2.0)


class ResBlock(nn.Module):
    """conv3 -> conv3(down) + 1x1 skip(down), / sqrt(2) (discriminator.py:14-34)."""

    def __init__(self, in_channel, out_channel):
        super().__init__()
        self.conv1 = ConvLayer(in_channel, in_channel, 3)
        self.conv2 = ConvLayer(in_channel, out_channel, 3, downsample=True)
        self.skip = ConvLayer(in_channel, out_channel, 1, downsample=True,
                              activate=False, bias=False)

    def forward(self, x):
        out = self.conv2(self.conv1(x)) + self.skip(x)
        return out / scalar_as(SQRT2, out)


def minibatch_stddev(x, group_size: int = 4, num_features: int = 1,
                     split: int | None = None, mesh=None):
    """Append the per-group feature stddev as an extra channel
    (discriminator.py:106-118), NCHW. With `split=k` the statistic is taken
    over x[:k] and x[k:] apart (the concatenated fake/real pass). Under a
    data mesh the statistic is taken over the global batch, as under the
    JAX package's mesh: the features are gathered from every rank (a group
    holds samples j, j + B/group, ... of the global batch) and each rank
    keeps its rows of the channel; with `split` each half's statistic is
    its global half's."""
    if split is not None:
        return torch.cat([minibatch_stddev(x[:split], group_size, num_features, mesh=mesh),
                          minibatch_stddev(x[split:], group_size, num_features, mesh=mesh)])
    xg = all_gather_batch(x, mesh)
    b, c, h, w = xg.shape
    group = min(b, group_size)
    if b % group != 0:
        group = 3 if b % 3 == 0 else 2
    y = xg.reshape(group, b // group, num_features, c // num_features, h, w)
    # the variance and the mean in f32, each rounded once to x's dtype (JAX
    # upcasts bf16 inside jnp.var and jnp.mean), so a bf16 backward rounds
    # where JAX's does
    var = y.float().var(dim=0, unbiased=False).to(y.dtype)
    std = torch.sqrt(var + scalar_as(1e-8, var))
    std = std.float().mean(dim=(2, 3, 4)).to(y.dtype).reshape(b // group, num_features, 1, 1)
    return torch.cat([x, shard_batch(std.repeat(group, 1, h, w), mesh)], dim=1)


class _DHead(nn.Module):
    """minibatch-stddev -> conv3 -> flatten -> two EqualLinears -> logit."""

    def __init__(self, channel):
        super().__init__()
        self.final_conv = ConvLayer(channel + 1, channel, 3)
        self.final_linear = nn.Sequential(
            EqualLinear(channel * 4 * 4, channel, activation="fused_lrelu"),
            EqualLinear(channel, 1),
        )

    def head(self, out, stddev_split=None, mesh=None):
        out = self.final_conv(minibatch_stddev(out, split=stddev_split, mesh=mesh))
        return self.final_linear(out.reshape(out.shape[0], -1))


class DStyleGAN(_DHead):
    """Flat discriminator (discriminator.py:37-126): one input conv and a
    ResBlock per resolution from input_size down to 8."""

    def __init__(self, input_size=1024, channel_multiplier=2, device=None, seed=0):
        channels = channel_table(channel_multiplier)
        super().__init__(channels[4])
        self.conv_in = ConvLayer(3, channels[input_size], 1)
        self.blocks = nn.ModuleDict()
        in_ch = channels[input_size]
        for i in range(int(math.log2(input_size)), 2, -1):
            self.blocks[str(2**i)] = ResBlock(in_ch, channels[2 ** (i - 1)])
            in_ch = channels[2 ** (i - 1)]
        init_parameters(self, torch.Generator().manual_seed(seed))
        self.to(resolve_device(device))

    def forward(self, x):
        out = self.conv_in(x.permute(0, 3, 1, 2))
        for block in self.blocks.values():
            out = block(out)
        return self.head(out)


class DStyleGANProgressive(_DHead):
    """Progressive discriminator (discriminator.py:129-261): an input conv
    and a ResBlock per resolution up to input_size, and a fade-in branch
    that alpha-blends the bilinear-downsampled input. pretrained_size:
    None fades across the top block, -1 never fades, > 0 fades from that
    resolution. The fade branch is computed whenever it exists (alpha = 1
    gives the same value), as in the JAX package."""

    def __init__(self, input_size=1024, channel_multiplier=2, pretrained_size=None,
                 diffaug=False, device=None, seed=0):
        channels = channel_table(channel_multiplier)
        super().__init__(channels[4])
        self.input_size = input_size
        self.pretrained_size = pretrained_size
        self.diffaug = diffaug
        log_max = int(math.log2(input_size))
        self.conv_in = nn.ModuleDict()
        self.blocks = nn.ModuleDict()
        for ls in range(log_max, 2, -1):
            res = 2**ls
            self.conv_in[str(res)] = ConvLayer(3, channels[res], 1)
            self.blocks[str(res)] = ResBlock(channels[res], channels[res // 2])
        init_parameters(self, torch.Generator().manual_seed(seed))
        self.to(resolve_device(device))

    def forward(self, x, alpha=1.0, stddev_split: int | None = None,
                aug: dict | None = None, mesh=None, skip_augment: bool = False):
        """x (B, H, W, 3), H a power of two <= input_size. With diffaug the
        augmentation draws `aug` (models/diffaug.py) are required, unless
        `skip_augment` (the caller augmented x, as the concatenated
        fake/real pass does per half). Under a data `mesh` x holds this
        rank's rows and the minibatch stddev is the global batch's. Every
        layer computes in x's dtype (bf16 for TrainConfig.d_dtype) with its
        parameters rounded to it, and the JAX package's rounding points."""
        if self.diffaug and not skip_augment:
            if aug is None:
                raise ValueError("a diffaug discriminator needs its draws (aug=)")
            x = diff_augment(x, aug)
        x = x.permute(0, 3, 1, 2)
        h = x.shape[2]
        log_in = int(math.log2(h))
        if self.pretrained_size is None:
            log_pre = log_in - 1
        elif self.pretrained_size > 0:
            log_pre = int(math.log2(self.pretrained_size))
            if log_pre == log_in:
                log_pre = log_in - 1
        else:
            alpha, log_pre = 1.0, log_in
        out = self.conv_in[str(2**log_in)](x)
        for ls in range(log_in, log_pre, -1):
            out = self.blocks[str(2**ls)](out)
        if log_pre < log_in and str(2**log_pre) in self.conv_in:
            x_down = torch_bilinear_downsample(x, h // 2 ** (log_in - log_pre))
            x_down = self.conv_in[str(2**log_pre)](x_down)
            out = scalar_as(1.0 - alpha, x_down) * x_down + scalar_as(alpha, out) * out
        for ls in range(log_pre, 2, -1):
            out = self.blocks[str(2**ls)](out)
        return self.head(out, stddev_split, mesh)
