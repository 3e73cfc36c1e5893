"""Fused CIPS-decoder upsample block (counterpart of the packed block in
cips3dpp_tpu/kernels/decoder_block.py).

One decoder block at resolution r, after conv_a's matmul at r/2 (y1):

    2x separable [1,3,3,1] upsample of y1, taps (.25, .75, .75, .25), zero
    edges (per frame) -> + nw1*noise1 + b1 -> lrelu*sqrt2
    -> 1x1 conv_b (bf16 inputs, f32 accumulation) -> + nw2*noise2 + b2
    -> lrelu*sqrt2 = feat  [-> rgb = feat @ wrgb, ToRGB before bias/skip]

`decoder_block_packed` launches the CUDA kernel `csrc/decoder_block.cu`
for tensors on the card (bf16 storage, the serving dtype) and runs
`decoder_block_plain` for tensors on the CPU. The storage dtype `dtype`
fixes the rounding points, as the serving path of the JAX package has
them: y1 and the noise maps are stored in it, the row-upsampled values
are rounded to it before the column blend, feat is stored in it, and
ToRGB multiplies the stored feat by wrgb rounded to it. The upsample,
noise, bias and activation arithmetic is f32.
"""

from __future__ import annotations

import ctypes

import torch

from . import _lib
from ..ops.upfirdn2d import _up_axis

# normalized [1,3,3,1]/8 * 2 gain (per-axis sqrt of the 4x 2-D gain)
K4 = (0.25, 0.75, 0.75, 0.25)
SQRT2 = 1.4142135623730951
KERNEL_CHANNELS = (32, 64, 128, 256)


def _lrelu(v):
    return torch.where(v >= 0, v, 0.2 * v) * SQRT2


@torch.no_grad()
def decoder_block_prepare(noise1, noise2, w2, b1, b2, noise_w1, noise_w2,
                          wrgb=None, *, dtype=torch.bfloat16):
    """y1-independent operands, fixed for a whole trajectory.

    noise1/noise2 (H, W[, 1]) per-pixel maps, w2 (C, C) (in, out) modulated
    conv_b weight, b1/b2 (C,), noise_w1/noise_w2 scalars, wrgb (C, 3)
    modulated ToRGB weight or None (no rgb output)."""
    h, w = noise1.shape[:2]
    c = w2.shape[0]
    prep = {
        "dtype": dtype,
        "n1": noise1.reshape(h, w).to(dtype).contiguous(),
        "n2": noise2.reshape(h, w).to(dtype).contiguous(),
        "w2": w2.float().contiguous(),
        # (out, in) bf16: the tensor-core B operand
        "w2t": w2.t().contiguous().to(torch.bfloat16),
        "b1": b1.reshape(c).float().contiguous(),
        "b2": b2.reshape(c).float().contiguous(),
        "nw": torch.stack([
            torch.as_tensor(v, dtype=torch.float32, device=w2.device).reshape(())
            for v in (noise_w1, noise_w2)
        ]),
    }
    if wrgb is not None:
        prep["wrgbt"] = wrgb.t().contiguous().to(dtype)  # (3, C)
    return prep


def decoder_block_plain(y1, prepared, emit_feat=True, frames=1):
    """Plain PyTorch version of the kernel, same rounding points.
    y1 (F*Hp, Wp, C) with F frames stacked on rows."""
    dt = prepared["dtype"]
    rows, wp, c = y1.shape
    x = y1.to(dt).float().reshape(frames, rows // frames, wp, c)
    x = _up_axis(x, 1, K4)  # rows, f32
    x = x.to(dt).float()  # rounded before the column blend
    x = _up_axis(x, 2, K4)
    nw = prepared["nw"]
    n1 = prepared["n1"].float()[..., None]
    n2 = prepared["n2"].float()[..., None]
    h = _lrelu(x + nw[0] * n1 + prepared["b1"])
    h2 = h.to(torch.bfloat16).float() @ prepared["w2t"].float().t()
    h2 = _lrelu(h2 + nw[1] * n2 + prepared["b2"])
    stored = h2.to(dt)
    out_rows = 2 * rows
    res = []
    if emit_feat:
        res.append(stored.reshape(out_rows, 2 * wp, c))
    if "wrgbt" in prepared:
        rgb = stored.float() @ prepared["wrgbt"].float().t()
        res.append(rgb.reshape(out_rows, 2 * wp, 3))
    return tuple(res) if len(res) > 1 else res[0]


def _launch(y1, prepared, emit_feat, frames):
    dev = y1.device
    rows, wp, c = y1.shape
    bf16 = torch.bfloat16
    if prepared["dtype"] != bf16:
        raise ValueError("decoder_block kernel stores bf16; got dtype "
                         f"{prepared['dtype']}")
    if c not in KERNEL_CHANNELS or wp % 16 or rows % frames:
        raise ValueError(f"decoder_block kernel: unsupported y1 {tuple(y1.shape)} "
                         f"for {frames} frames (C in {KERNEL_CHANNELS}, Wp % 16 == 0)")
    hp = rows // frames
    emit_rgb = "wrgbt" in prepared
    _lib.check(y1, "y1", (rows, wp, c), bf16, dev)
    _lib.check(prepared["n1"], "noise1", (2 * hp, 2 * wp), bf16, dev)
    _lib.check(prepared["n2"], "noise2", (2 * hp, 2 * wp), bf16, dev)
    _lib.check(prepared["w2t"], "w2t", (c, c), bf16, dev)
    _lib.check(prepared["b1"], "b1", (c,), torch.float32, dev)
    _lib.check(prepared["b2"], "b2", (c,), torch.float32, dev)
    _lib.check(prepared["nw"], "nw", (2,), torch.float32, dev)
    if emit_rgb:
        _lib.check(prepared["wrgbt"], "wrgbt", (3, c), bf16, dev)
    feat = (torch.empty((2 * rows, 2 * wp, c), dtype=bf16, device=dev)
            if emit_feat else None)
    rgb = (torch.empty((2 * rows, 2 * wp, 3), dtype=torch.float32, device=dev)
           if emit_rgb else None)
    lib = _lib.load("decoder_block")
    fn = lib.decoder_block_forward
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    p = _lib.ptr
    code = fn(
        p(y1), p(prepared["n1"]), p(prepared["n2"]), p(prepared["w2t"]),
        p(prepared["b1"]), p(prepared["b2"]), p(prepared["nw"]),
        p(prepared.get("wrgbt")), p(feat), p(rgb),
        frames, hp, wp, c, _lib.stream_ptr(dev),
    )
    _lib.raise_on_error(code, "decoder_block")
    _lib.LAUNCHES["decoder_block"] += 1
    res = [t for t in (feat, rgb) if t is not None]
    return tuple(res) if len(res) > 1 else res[0]


def decoder_block_packed(y1, noise1=None, noise2=None, w2=None, b1=None,
                         b2=None, noise_w1=None, noise_w2=None, wrgb=None, *,
                         dtype=torch.bfloat16, emit_feat=True, frames=1,
                         prepared=None):
    """One fused upsample block. y1 (F*Hp, Wp, C): conv_a's matmul output at
    the previous resolution, F frames stacked on rows (the upsample halo is
    zero at each frame's edges; noise, weights and biases are shared).

    Returns feat (2F*Hp, 2Wp, C) in `dtype` when there is no wrgb;
    (feat, rgb) with rgb (2F*Hp, 2Wp, 3) f32 (before ToRGB bias and skip)
    when there is; rgb alone when additionally emit_feat=False.
    `prepared` (decoder_block_prepare) replaces the operand arguments."""
    if prepared is None:
        prepared = decoder_block_prepare(noise1, noise2, w2, b1, b2, noise_w1,
                                         noise_w2, wrgb, dtype=dtype)
    if not (emit_feat or "wrgbt" in prepared):
        raise ValueError("decoder_block_packed: nothing to emit")
    if y1.device.type == "cuda":
        return _launch(y1.contiguous(), prepared, emit_feat, frames)
    if y1.device.type == "cpu":
        return decoder_block_plain(y1, prepared, emit_feat, frames)
    raise ValueError(f"decoder_block: no kernel for device {y1.device}")


def decoder_block_packed_reference(y1, noise1, noise2, w2, b1, b2, noise_w1,
                                   noise_w2):
    """f32 oracle of the feature part (bf16 only in the conv_b inputs)."""
    from ..ops.upfirdn2d import _upsample2x_separable_4tap

    up = _upsample2x_separable_4tap(y1[None].float(), K4)[0]
    h = _lrelu(up + noise_w1 * noise1 + b1)
    hh, ww, c = h.shape
    h2 = (h.reshape(-1, c).to(torch.bfloat16).float()
          @ w2.to(torch.bfloat16).float()).reshape(hh, ww, c)
    return _lrelu(h2 + noise_w2 * noise2 + b2)
