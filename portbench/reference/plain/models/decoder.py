# Frozen copy of cips3dpp_torch/models/decoder.py at commit af17e715d5a8,
# the plain path only: the yardstick keeps this copy whatever the program
# becomes. Edits from the source are marked "portbench:".
"""CIPS super-resolution decoder, StyleGAN2 synthesis with k x k modulated
convs, 1x1 in the shipped configs (counterpart of
cips3dpp_tpu/models/decoder.py; contract model_v3.py:522-729).

conv1 + to_rgb1 at the feature resolution, then one block per resolution
from 2*size_start to size_end: StyledConv (upsampling when the resolution
is in `upsample_list`) -> StyledConv -> ToRGB with skip. Submodule names
follow the reference state dict (conv1, to_rgb1, convs.{i}, to_rgbs.{i}).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .layers import StyledConv, ToRGB, channel_table


class Decoder(nn.Module):
    def __init__(
        self,
        size_start: int = 4,
        size_end: int = 1024,
        in_channel: int = 256,
        style_dim: int = 512,
        channel_multiplier: int = 2,
        upsample_list: Sequence[int] = (),
        dtype=torch.float32,
        skip_dtype=torch.float32,
        remat: bool = False,
        kernel_size: int = 1,
        blur_kernel: Sequence[int] = (1, 3, 3, 1),
    ):
        super().__init__()
        self.remat = remat
        self.kernel_size = kernel_size
        self.blur_kernel = tuple(blur_kernel)
        self.size_start, self.size_end = size_start, size_end
        self.channel_multiplier = channel_multiplier
        self.upsample_list = tuple(upsample_list)
        self.dtype = dtype
        ch = channel_table(channel_multiplier)
        # the StyledConvs take blur_kernel, the ToRGBs keep (1, 3, 3, 1) for
        # the skip's upsample: JAX's Decoder passes it so
        # (cips3dpp_tpu/models/decoder.py:108, 125, 131)
        self.conv1 = StyledConv(in_channel, ch[size_start], style_dim,
                                kernel_size=kernel_size, blur_kernel=blur_kernel)
        self.to_rgb1 = ToRGB(ch[size_start], style_dim, upsample=False,
                             skip_dtype=skip_dtype)
        self.convs = nn.ModuleList()
        self.to_rgbs = nn.ModuleList()
        cin = ch[size_start]
        for i in range(self.log_in_size + 1, self.log_size + 1):
            res = 2**i
            up = res in self.upsample_list
            self.convs.append(StyledConv(cin, ch[res], style_dim, upsample=up,
                                         kernel_size=kernel_size, blur_kernel=blur_kernel))
            self.convs.append(StyledConv(ch[res], ch[res], style_dim,
                                         kernel_size=kernel_size, blur_kernel=blur_kernel))
            self.to_rgbs.append(ToRGB(ch[res], style_dim, upsample=up,
                                      skip_dtype=skip_dtype))
            cin = ch[res]

    @property
    def log_in_size(self):
        return int(math.log2(self.size_start))

    @property
    def log_size(self):
        return int(math.log2(self.size_end))

    @property
    def num_layers(self):
        """Number of noise-consuming conv layers (model_v3.py:726)."""
        return (self.log_size - self.log_in_size) * 2 + 1

    @property
    def n_latent(self):
        """Number of per-layer styles (model_v3.py:728)."""
        return (self.log_size - self.log_in_size) * 2 + 2

    def noise_shapes(self, start_size: int):
        """(1, h, w, 1) shapes of the per-layer noise buffers: one at
        start_size, then a pair per block, doubling at upsample blocks."""
        shapes = [(1, start_size, start_size, 1)]
        cur = start_size
        for i in range(self.log_in_size + 1, self.log_size + 1):
            if 2**i in self.upsample_list:
                cur *= 2
            shapes += [(1, cur, cur, 1)] * 2
        return shapes

    def make_noise(self, generator: torch.Generator | None, start_size: int,
                   batch: int = 1, device=None):
        """N(0,1) noise buffers drawn from `generator` (on its own device,
        the CPU for None), then moved to `device`."""
        gdev = generator.device if generator is not None else "cpu"
        return [
            torch.randn((batch,) + s[1:], generator=generator, device=gdev).to(device)
            for s in self.noise_shapes(start_size)
        ]

    def hash_noise(self, seed: int, start_size: int, device=None):
        """The buffers of one noise seed's realization: layer i's buffer is
        hash_noise_map of layer_seed(seed, i), as the block kernels make it
        (kernels/decoder_block.py)."""
        raise ValueError("portbench: hash noise is the kernels'; pass noise buffers")

    def forward(self, features, styles, noise):
        """features (B,H,W,in_channel); styles (B, n_latent, style_dim);
        noise: list of num_layers (B|1, h, w, 1) buffers. Returns rgb
        (B, H*up, W*up, 3) f32."""
        if styles.shape[1] != self.n_latent:
            raise ValueError(f"styles {tuple(styles.shape)}: want n_latent={self.n_latent}")
        if len(noise) != self.num_layers:
            raise ValueError(f"{len(noise)} noise buffers, want {self.num_layers}")
        features = features.to(self.dtype)
        noise = [n.to(self.dtype) for n in noise]
        if self.remat and torch.is_grad_enabled():
            # StyledConv remat: the backward recomputes each conv layer's
            # insides (upsample, noise, pre-activation)
            def run(layer, *args):
                return checkpoint(layer, *args, use_reentrant=False)
        else:
            def run(layer, *args):
                return layer(*args)
        out = run(self.conv1, features, styles[:, 0], noise[0])
        skip = self.to_rgb1(out, styles[:, 1])
        layer_i = 1
        for block, to_rgb in enumerate(self.to_rgbs):
            out = run(self.convs[2 * block], out, styles[:, layer_i], noise[layer_i])
            out = run(self.convs[2 * block + 1], out, styles[:, layer_i + 1],
                      noise[layer_i + 1])
            skip = to_rgb(out, styles[:, layer_i + 2], skip)
            layer_i += 2
        return skip.float()
