"""Serving-path CIPS decoder with every upsample block in one kernel
(counterpart of cips3dpp_tpu/kernels/decoder_fused.py).

Runs the Decoder for one identity (batch-1 styles; F frames of it) from
its modules: the non-upsampling 1x1 modulated convs, conv1/to_rgb1 and
each block's conv_a are plain matmuls (`torch.matmul`), every upsample
block goes through `decoder_block_packed` (the CUDA kernel on the card).
With fold_rgb, ToRGB is folded into the kernel and the final block's
feature store is skipped. The 3-channel RGB skip chain stays plain f32.

Split prepare/render: `decoder_fused_prepare` computes everything that
depends only on styles and noise (modulated weights, noise casts) once
per trajectory; `decoder_fused_render` consumes it per frame.

Noise comes from buffers or from one `noise_seed`: then layer i's noise
is the hash realization of `layer_seed(noise_seed, i)`, made by the block
kernel for the upsample blocks and made once at prepare time as
`hash_noise_map` buffers for the plain layers. Explicit buffers win.

A block whose C no built kernel runs is run at the next count that one
does (`kernel_channels`), padded at prepare time, never a frame: conv_a's
output columns (so y1 comes at the kernel's C), the block's operands
(`decoder_block_prepare`), and the input rows of whatever reads its feat
next (the next conv_a, a plain layer's conv, the unfolded ToRGB), all
with zeros. A frame launches what it launches at any other C.
"""

from __future__ import annotations

import math

import torch

from ..ops.fused_act import fused_leaky_relu
from ..ops.modulated import modulate_weights_1x1
from ..ops.upfirdn2d import upsample2x
from ..utils.profiling import span
from .decoder_block import (
    _pad_to, decoder_block_packed, decoder_block_prepare, hash_noise_map, kernel_channels,
    layer_seed,
)

# the blur the block kernels and the skip's upsample2x apply
BLUR = (1, 3, 3, 1)


def _mod_style(mod, style):
    """EqualLinear(modulation) forward: scale 1/sqrt(in), bias_init 1."""
    return style @ (mod.weight * (1.0 / math.sqrt(mod.weight.shape[1]))).t() + mod.bias


def _conv_weight(conv, style, demodulate=True):
    """(Cin, Cout) modulated weight of one sample from a ModulatedConv2d."""
    s = _mod_style(conv.modulation, style)
    return modulate_weights_1x1(conv.base_weight(), s, demodulate=demodulate)[0]


def _matmul_img(x, w, dtype):
    """(F, H, W, Cin) @ (Cin, Cout) -> f32; bf16 inputs with f32
    accumulation when dtype is bf16."""
    if dtype == torch.bfloat16:
        return x.to(dtype).float() @ w.to(dtype).float()
    return x.float() @ w.float()


def _plan(upsample_list, size_start, size_end):
    """Per-resolution schedule [(res, kind)], kind "fused" (upsample block,
    one kernel) or "plain" (same resolution, plain matmuls)."""
    return [
        (2**i, "fused" if 2**i in upsample_list else "plain")
        for i in range(int(math.log2(size_start)) + 1, int(math.log2(size_end)) + 1)
    ]


@span("decoder.prepare")
@torch.no_grad()
def decoder_fused_prepare(decoder, styles, noise, *, fold_rgb=True,
                          noise_seed=None, feat_size=None):
    """Trajectory-invariant half. decoder: models.Decoder; styles
    (1, n_latent, style_dim); noise: list of num_layers (1, h, w, 1), or
    None with `noise_seed` (a uint32; then `feat_size`, the feature map's
    side, is required). The kernels take the 1x1 decoder with the (1, 3,
    3, 1) blur only (JAX's fused path applies that blur whatever the
    decoder's field says; this one raises)."""
    if decoder.kernel_size != 1:
        raise ValueError(f"the decoder block kernels take 1x1 modulated convs, this decoder "
                         f"has kernel_size {decoder.kernel_size}")
    if tuple(decoder.blur_kernel) != BLUR:
        raise ValueError(f"the decoder block kernels blur with {BLUR}, this decoder has "
                         f"blur_kernel {tuple(decoder.blur_kernel)}")
    if styles.shape[0] != 1 or styles.shape[1] != decoder.n_latent:
        raise ValueError(f"styles {tuple(styles.shape)}: want (1, {decoder.n_latent}, D)")
    if noise is None and noise_seed is None:
        raise ValueError("pass noise buffers or a noise_seed")
    if noise is not None and len(noise) != decoder.num_layers:
        raise ValueError(f"want {decoder.num_layers} noise buffers")
    if noise is None:
        if feat_size is None:
            raise ValueError("feat_size is required with noise_seed")
        noise = [None] * decoder.num_layers
    dt = decoder.dtype
    dev = styles.device

    def get_noise(idx, size):
        if noise[idx] is not None:
            return noise[idx]
        return hash_noise_map(size, size, layer_seed(noise_seed, idx), dev)[None]

    # the channels of the activations a step reads: a fused block's feat
    # comes at its kernel's C, whose extra rows of the next weight are zero
    cin = decoder.conv1.conv.weight.shape[1]

    def conv_rec(sc, style, nbuf, rows=None):
        w = _conv_weight(sc.conv, style)
        return {
            "w": _pad_to(w, rows or w.shape[0], w.shape[1]).to(dt),
            "n": nbuf,
            "nw": sc.noise.weight.reshape(()),
            "b": sc.activate.bias,
        }

    def rgb_rec(tr, style, rows=None):
        w = _conv_weight(tr.conv, style, demodulate=False)
        return {"w": _pad_to(w, rows or w.shape[0], 3).to(dt), "b": tr.bias.reshape(3)}

    cur = feat_size if feat_size is not None else noise[0].shape[1]
    prep = {
        "head": conv_rec(decoder.conv1, styles[:, 0], get_noise(0, cur)),
        "rgb1": rgb_rec(decoder.to_rgb1, styles[:, 1]),
        "blocks": [],
    }
    steps = _plan(decoder.upsample_list, decoder.size_start, decoder.size_end)
    layer_i = 1
    for block, (res, kind) in enumerate(steps):
        ca, cb = decoder.convs[2 * block], decoder.convs[2 * block + 1]
        tr = decoder.to_rgbs[block]
        if kind == "fused":
            cur *= 2
            wrgb = (_conv_weight(tr.conv, styles[:, layer_i + 2], demodulate=False)
                    if fold_rgb else None)
            if noise[layer_i] is None:  # hash noise, made in the kernel
                bufs = (None, None)
                seeds = (layer_seed(noise_seed, layer_i),
                         layer_seed(noise_seed, layer_i + 1))
            else:
                bufs, seeds = (noise[layer_i][0], noise[layer_i + 1][0]), None
            rec = {
                "bp": decoder_block_prepare(
                    *bufs, _conv_weight(cb.conv, styles[:, layer_i + 1]),
                    ca.activate.bias, cb.activate.bias,
                    ca.noise.weight, cb.noise.weight, wrgb, dtype=dt,
                    noise_seeds=seeds,
                ),
            }
            # y1 made at the kernel's C (decoder_block_prepare has refused a
            # C JAX's block does not admit)
            ck = kernel_channels(ca.conv.weight.shape[1])
            rec["wa"] = _pad_to(_conv_weight(ca.conv, styles[:, layer_i]), cin, ck).to(dt)
            if fold_rgb:
                rec["rgb_b"] = tr.bias.reshape(3)
            else:
                rec["rgb"] = rgb_rec(tr, styles[:, layer_i + 2], rows=ck)
            cin = ck
        else:
            rec = {
                "a": conv_rec(ca, styles[:, layer_i], get_noise(layer_i, cur), rows=cin),
                "b": conv_rec(cb, styles[:, layer_i + 1], get_noise(layer_i + 1, cur)),
                "rgb": rgb_rec(tr, styles[:, layer_i + 2]),
            }
            cin = ca.conv.weight.shape[1]
        prep["blocks"].append(rec)
        layer_i += 2
    return prep


@span("decoder.render")
@torch.no_grad()
def decoder_fused_render(decoder, prep, features, *, fold_rgb=True):
    """Per-frame half. features (F, H, W, in_channel): F frames of the
    prepared identity, rendered with one kernel launch per upsample block.
    Returns rgb (F, H*up, W*up, 3) f32."""
    f = features.shape[0]
    dt = decoder.dtype

    def styled_conv(rec, x):
        y = _matmul_img(x, rec["w"], dt) + rec["nw"] * rec["n"]
        return fused_leaky_relu(y, rec["b"])

    def to_rgb(rec, x, skip, up):
        out = _matmul_img(x, rec["w"], dt) + rec["b"]
        if skip is not None:
            out = out + (upsample2x(skip) if up else skip)
        return out

    x = styled_conv(prep["head"], features.float())
    skip = to_rgb(prep["rgb1"], x, None, False)
    steps = _plan(decoder.upsample_list, decoder.size_start, decoder.size_end)
    for (res, kind), rec in zip(steps, prep["blocks"]):
        if kind == "fused":
            last = res == decoder.size_end
            y1 = _matmul_img(x, rec["wa"], dt).to(dt)  # (F, Hp, Wp, C)
            hp, wp, c = y1.shape[1:]
            out = decoder_block_packed(
                y1.reshape(f * hp, wp, c), prepared=rec["bp"],
                emit_feat=(not last) or not fold_rgb, frames=f,
            )
            unstack = lambda a: a.reshape(f, 2 * hp, 2 * wp, a.shape[-1])
            if fold_rgb:
                feat, rgb = (None, out) if last else out
                x = None if last else unstack(feat)
                skip = unstack(rgb) + rec["rgb_b"] + upsample2x(skip)
            else:
                x = unstack(out)
                skip = to_rgb(rec["rgb"], x, skip, True)
        else:
            x = styled_conv(rec["a"], x)
            x = styled_conv(rec["b"], x)
            skip = to_rgb(rec["rgb"], x, skip, False)
    return skip.float()


@torch.no_grad()
def decoder_fused_apply(decoder, features, styles, noise, *, fold_rgb=False,
                        noise_seed=None):
    """decoder_fused_prepare + decoder_fused_render in one call; mirrors
    Decoder.forward for batch 1 with explicit noise (or a noise seed)."""
    prep = decoder_fused_prepare(decoder, styles, noise, fold_rgb=fold_rgb,
                                 noise_seed=noise_seed,
                                 feat_size=features.shape[1])
    return decoder_fused_render(decoder, prep, features, fold_rgb=fold_rgb)
