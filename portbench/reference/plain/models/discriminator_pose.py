# Frozen copy of cips3dpp_torch/models/discriminator_pose.py at commit af17e715d5a8,
# the plain path only: the yardstick keeps this copy whatever the program
# becomes. Edits from the source are marked "portbench:".
"""Pose-aware volume-render discriminator at the thumbnail resolution
(counterpart of cips3dpp_tpu/models/discriminator_pose.py; contract
exp/cips3d/models/discriminator_pose.py).

CoordConv blocks with average-pool downsampling and a two-part head: the
GAN logit and an (azim, elev) regression that supervises the generator's
pose distribution. NHWC in, NCHW inside; module names follow the
reference state dict (`io/torch_import.py:export_d_pose_state_dict`).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from ..ops import fused_leaky_relu
from .layers import init_parameters, torch_bilinear_downsample, uniform_bound_

SQRT2 = math.sqrt(2.0)

# channel table (discriminator_pose.py:245-256)
POSE_CHANNELS = {2: 400, 4: 400, 8: 400, 16: 400, 32: 256, 64: 128, 128: 64,
                 256: 64, 512: 64, 1024: 32}


class _Activation(nn.Module):
    """Scale-1 fused lrelu holding its bias (`activation.bias`); the owner
    draws the bias."""

    def __init__(self, channel):
        super().__init__()
        self.bias = nn.Parameter(torch.zeros(channel))

    def forward(self, x):
        return fused_leaky_relu(x, self.bias, scale=1.0, channel_axis=1)


class PlainConv(nn.Module):
    """nn.Conv2d + optional scale-1 fused lrelu (VolumeRenderDiscConv2d,
    model_v3.py:1494-1518), torch's default init U(+-1/sqrt(fan_in)) for
    weight and bias (`_torch_conv_init`). Activated, the bias lives in
    `activation.bias`; otherwise in `conv.bias`."""

    def __init__(self, in_channel, out_channel, kernel_size, padding=0,
                 activate=False, bias=True):
        super().__init__()
        self.conv = nn.Conv2d(in_channel, out_channel, kernel_size, padding=padding,
                              bias=bias and not activate)
        self.activation = _Activation(out_channel) if activate else None

    def reset_parameters(self, gen):
        bound = 1.0 / math.sqrt(self.conv.weight[0].numel())
        uniform_bound_(self.conv.weight, gen, bound)
        for b in (self.conv.bias, self.activation and self.activation.bias):
            if b is not None:
                uniform_bound_(b, gen, bound)

    def forward(self, x):
        out = self.conv(x)
        return out if self.activation is None else self.activation(out)


def add_coords(x):
    """Append normalised (y, x) coordinate channels (model_v3.py:1521-1545), NCHW."""
    b, _, h, w = x.shape
    yy = torch.linspace(-1.0, 1.0, h, dtype=x.dtype, device=x.device)
    xx = torch.linspace(-1.0, 1.0, w, dtype=x.dtype, device=x.device)
    return torch.cat([x, yy[None, None, :, None].expand(b, 1, h, w),
                      xx[None, None, None, :].expand(b, 1, h, w)], dim=1)


class CoordConvLayer(nn.Module):
    """AddCoords -> conv3 -> scale-1 fused lrelu (model_v3.py:1548-1592):
    `conv.conv.weight`, `activation.bias`."""

    def __init__(self, in_channel, out_channel, kernel_size=3):
        super().__init__()
        pad = kernel_size // 2 if kernel_size > 2 else 0
        self.conv = PlainConv(in_channel + 2, out_channel, kernel_size, pad, bias=False)
        self.activation = _Activation(out_channel)

    def reset_parameters(self, gen):
        bound = 1.0 / math.sqrt(self.conv.conv.weight[0].numel())
        uniform_bound_(self.activation.bias, gen, bound)

    def forward(self, x):
        return self.activation(self.conv(add_coords(x)))


class PoseResBlock(nn.Module):
    """2x CoordConv -> avgpool, + avgpool(1x1 skip), / sqrt(2)
    (model_v3.py:1595-1621)."""

    def __init__(self, in_channel, out_channel):
        super().__init__()
        self.conv1 = CoordConvLayer(in_channel, out_channel)
        self.conv2 = CoordConvLayer(out_channel, out_channel)
        self.skip = (PlainConv(in_channel, out_channel, 1)
                     if in_channel != out_channel else None)

    def forward(self, x):
        out = F.avg_pool2d(self.conv2(self.conv1(x)), 2)
        skip = F.avg_pool2d(x, 2)
        if self.skip is not None:
            skip = self.skip(skip)
        return (out + skip) / SQRT2


def _head(out, viewpoint_loss):
    gan = out[:, 0].reshape(-1, 1)
    view = out[:, 1:].permute(0, 2, 3, 1).reshape(-1, 2) if viewpoint_loss else None
    return gan, view


class DVolumeRender(nn.Module):
    """Flat pose discriminator (discriminator_pose.py:152-217)."""

    def __init__(self, input_size=64, viewpoint_loss=True, device=None, seed=0):
        super().__init__()
        self.viewpoint_loss = viewpoint_loss
        self.conv_in = PlainConv(3, POSE_CHANNELS[input_size], 1, activate=True)
        self.blocks = nn.ModuleDict({
            str(2 ** (i + 1)): PoseResBlock(POSE_CHANNELS[2 ** (i + 1)], POSE_CHANNELS[2**i])
            for i in range(int(math.log2(input_size)) - 1, 0, -1)})
        self.final_conv = PlainConv(POSE_CHANNELS[2], 3 if viewpoint_loss else 1, 2)
        if seed is not None:  # portbench: None leaves the weights to the caller
            init_parameters(self, torch.Generator().manual_seed(seed))
        self.to(resolve_device(device))

    def forward(self, x):
        out = self.conv_in(x.permute(0, 3, 1, 2))
        for block in self.blocks.values():
            out = block(out)
        return _head(self.final_conv(out), self.viewpoint_loss)


class DVolumeRenderProgressive(nn.Module):
    """Progressive pose discriminator (discriminator_pose.py:220-325);
    pretrained_size and the fade branch as in DStyleGANProgressive.
    Returns (gan (B, 1), view (B, 2) | None)."""

    def __init__(self, input_size=1024, viewpoint_loss=True, pretrained_size=None,
                 device=None, seed=0):
        super().__init__()
        self.viewpoint_loss = viewpoint_loss
        self.pretrained_size = pretrained_size
        self.conv_in = nn.ModuleDict()
        self.blocks = nn.ModuleDict()
        for ls in range(int(math.log2(input_size)), 1, -1):
            res = 2**ls
            self.conv_in[str(res)] = PlainConv(3, POSE_CHANNELS[res], 1, activate=True)
            self.blocks[str(res)] = PoseResBlock(POSE_CHANNELS[res], POSE_CHANNELS[res // 2])
        self.final_conv = PlainConv(POSE_CHANNELS[2], 3 if viewpoint_loss else 1, 2)
        if seed is not None:  # portbench: None leaves the weights to the caller
            init_parameters(self, torch.Generator().manual_seed(seed))
        self.to(resolve_device(device))

    def forward(self, x, alpha=1.0):
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
        if log_pre < log_in:
            x_down = torch_bilinear_downsample(x, h // 2 ** (log_in - log_pre))
            out = (1.0 - alpha) * self.conv_in[str(2**log_pre)](x_down) + alpha * out
        for ls in range(log_pre, 1, -1):
            out = self.blocks[str(2**ls)](out)
        return _head(self.final_conv(out), self.viewpoint_loss)
