"""Multi-scale discriminator: one set of parameters for any power-of-two
input size (counterpart of cips3dpp_tpu/models/discriminator_multi_scale.py;
contract exp/cips3d/models/discriminator_multi_scale.py:405-577).

A 1x1 input conv for every resolution of the channel table, a ResBlock
per resolution from max_size down to 8 shared by every input size; below
alpha = 1 the top block's output is blended with the half-resolution
input's branch; then the minibatch stddev, a 3x3 conv and two linears.
No shipped config builds it. The modules take NHWC images and run NCHW
inside, as the image D does; their names follow the JAX tree
(`conv_in.{res}`, `blocks.{res}`, `final_conv`, `space_linear`,
`out_linear`), which `io/jax_params.py:jax_ms_d_params_to_state_dict` maps.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..device import resolve_device
from .diffaug import diff_augment
from .discriminator import ResBlock, minibatch_stddev
from .layers import ConvLayer, EqualLinear, channel_table, init_parameters, \
    torch_bilinear_downsample


class DiscriminatorMultiScale(nn.Module):
    def __init__(self, max_size=1024, channel_multiplier=2, diffaug=False,
                 stddev_group=4, first_downsample=False, device=None, seed=0):
        super().__init__()
        channels = channel_table(channel_multiplier)
        self.max_size = max_size
        self.diffaug = diffaug
        self.stddev_group = stddev_group
        self.first_downsample = first_downsample  # read by nothing, as in JAX
        self.conv_in = nn.ModuleDict(
            {str(res): ConvLayer(3, channels[res], 1) for res in channels})
        self.blocks = nn.ModuleDict({
            str(2**i): ResBlock(channels[2**i], channels[2 ** (i - 1)])
            for i in range(int(math.log2(max_size)), 2, -1)})
        c4 = channels[4]
        self.final_conv = ConvLayer(c4 + (1 if stddev_group > 0 else 0), c4, 3)
        self.space_linear = EqualLinear(c4 * 4 * 4, c4, activation="fused_lrelu")
        self.out_linear = EqualLinear(c4, 1)
        init_parameters(self, torch.Generator().manual_seed(seed))
        self.to(resolve_device(device))

    def forward(self, x, alpha=1.0, aug: dict | None = None):
        """x (B, H, W, 3), H a power of two in [8, max_size]. Returns
        (logit (B, 1), None, None): the latent and position heads of the
        reference's _Aux variant are None, as in the base class. With
        diffaug the augmentation draws `aug` (models/diffaug.py) are
        required."""
        if self.diffaug:
            if aug is None:
                raise ValueError("a diffaug discriminator needs its draws (aug=)")
            x = diff_augment(x, aug)
        x = x.permute(0, 3, 1, 2)
        size = x.shape[2]
        out = self.blocks[str(size)](self.conv_in[str(size)](x))
        if str(size // 2) in self.conv_in:
            # the reference's F.interpolate (discriminator_multi_scale.py:515)
            down = self.conv_in[str(size // 2)](torch_bilinear_downsample(x, size // 2))
            out = alpha * out + (1.0 - alpha) * down
        for i in range(int(math.log2(size)) - 1, 2, -1):
            out = self.blocks[str(2**i)](out)
        if self.stddev_group > 0:
            out = minibatch_stddev(out, self.stddev_group)
        out = self.final_conv(out)
        out = self.space_linear(out.reshape(out.shape[0], -1))
        return self.out_linear(out), None, None
