"""Fused CIPS-decoder upsample block (counterpart of the packed block and
of the v1 block in cips3dpp_tpu/kernels/decoder_block.py).

One decoder block at resolution r, after conv_a's matmul at r/2 (y1):

    2x separable [1,3,3,1] upsample of y1, taps (.25, .75, .75, .25), zero
    edges (per frame) -> + nw1*noise1 + b1 -> lrelu*sqrt2
    -> 1x1 conv_b (bf16 inputs, f32 accumulation) -> + nw2*noise2 + b2
    -> lrelu*sqrt2 = feat  [-> rgb = feat @ wrgb, ToRGB before bias/skip]

`decoder_block_packed` (K2, the serving block) launches the CUDA kernel
`csrc/decoder_block.cu` for tensors on the card and runs
`decoder_block_plain` for tensors on the CPU. The storage dtype `dtype`
(bf16 or f32) fixes the rounding points, as the serving path of the JAX
package has them: y1 and the noise buffers are stored in it, the
row-upsampled values are rounded to it before the column blend, feat is
stored in it, and ToRGB multiplies the stored feat by wrgb rounded to it.
The upsample, noise, bias and activation arithmetic is f32.

Noise comes from two buffers or, with `noise_seeds`, from the hash
generator (`hash_normal`): a fixed N(0,1) realization per seed, made in
the kernel from each output pixel's id. Hash noise is f32 in either
storage dtype: it is never stored, so it is never rounded.

`decoder_block_fused` (K3, the v1 block) takes f32 in and out, adds the
ToRGB bias and the 2x-upsampled RGB skip, and rounds only the matmul
operands to bf16: the same CUDA kernel with that epilogue on the card
(`decoder_block_fused_forward` in `csrc/decoder_block.cu`),
`decoder_block_fused_plain` on the CPU.
"""

from __future__ import annotations

import ctypes

import torch

from . import _lib
from ..ops.upfirdn2d import _up_axis
from .siren_render import fast_sin

# normalized [1,3,3,1]/8 * 2 gain (per-axis sqrt of the 4x 2-D gain)
K4 = (0.25, 0.75, 0.75, 0.25)
SQRT2 = 1.4142135623730951
KERNEL_CHANNELS = (32, 64, 128, 256)
STORAGE = (torch.bfloat16, torch.float32)
_M32 = 0xFFFFFFFF
_2PI = 6.283185307179586
_HALF_PI = 1.5707963267948966


def _lrelu(v):
    return torch.where(v >= 0, v, 0.2 * v) * SQRT2


# ---- hash noise (decoder_block.py:_hash_u32, hash_normal, layer_seed,
# hash_noise_map). uint32 arithmetic on Python ints or int64 tensors,
# masked to 32 bits after every product and sum (a wrapping int64 product
# keeps its low 32 bits), so both give the kernel's bits.


def hash_u32(x):
    """lowbias32-style avalanche hash of uint32 values."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x846CA68B) & _M32
    return x ^ (x >> 16)


def hash_normal(pix: torch.Tensor, seed: int) -> torch.Tensor:
    """N(0,1) from uint32 pixel ids (an int64 tensor) and a uint32 seed:
    Box-Muller over two avalanche hashes; 24-bit uniforms, f32 math."""
    seed = int(seed) & _M32
    h1 = hash_u32(pix ^ seed)
    h2 = hash_u32((pix + 0x9E3779B9 + ((seed * 0x85EBCA6B) & _M32)) & _M32)
    u1 = (h1 >> 8).float() * (1.0 / 16777216.0) + (1.0 / 33554432.0)
    u2 = (h2 >> 8).float() * (1.0 / 16777216.0)
    r = torch.sqrt(-2.0 * torch.log(u1))
    return r * fast_sin(_2PI * u2 + _HALF_PI)  # cos(2*pi*u2)


def layer_seed(base_seed: int, layer_idx: int) -> int:
    """Per-noise-layer uint32 seed from a base seed."""
    return hash_u32((int(base_seed) & _M32) ^ ((0xABC00000 + int(layer_idx)) & _M32))


def hash_noise_map(height: int, width: int, seed: int, device=None) -> torch.Tensor:
    """(height, width, 1) f32 map equal to the kernel's in-kernel hash
    realization (pixel id = row * width + col)."""
    rows = torch.arange(height, dtype=torch.int64, device=device)[:, None]
    cols = torch.arange(width, dtype=torch.int64, device=device)[None, :]
    return hash_normal(rows * width + cols, seed)[..., None]


# ---- K2: the serving block


@torch.no_grad()
def decoder_block_prepare(noise1, noise2, w2, b1, b2, noise_w1, noise_w2,
                          wrgb=None, *, dtype=torch.bfloat16, noise_seeds=None):
    """y1-independent operands, fixed for a whole trajectory.

    noise1/noise2 (H, W[, 1]) per-pixel maps, or `noise_seeds` (two uint32
    seeds, hash noise; the maps may then be None); w2 (C, C) (in, out)
    modulated conv_b weight, b1/b2 (C,), noise_w1/noise_w2 scalars, wrgb
    (C, 3) modulated ToRGB weight or None (no rgb output)."""
    if dtype not in STORAGE:
        raise ValueError(f"decoder block storage dtype {dtype}: want one of {STORAGE}")
    c = w2.shape[0]
    prep = {
        "dtype": dtype,
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
    if noise_seeds is not None:
        prep["seeds"] = tuple(int(s) & _M32 for s in noise_seeds)
    else:
        h, w = noise1.shape[:2]
        prep["n1"] = noise1.reshape(h, w).to(dtype).contiguous()
        prep["n2"] = noise2.reshape(h, w).to(dtype).contiguous()
    if wrgb is not None:
        prep["wrgbt"] = wrgb.t().contiguous().to(dtype)  # (3, C)
    return prep


def launch_name(prepared) -> str:
    """The launch-count name of the K2 variant that `prepared` runs:
    "decoder_block" (bf16 storage, noise buffers), with "_hash" when the
    kernel makes the noise and "_f32" for f32 storage."""
    return ("decoder_block" + ("_hash" if "seeds" in prepared else "")
            + ("_f32" if prepared["dtype"] == torch.float32 else ""))


def _noise_maps(prepared, hp, wp, device):
    """The block's two (2Hp, 2Wp, 1) f32 noise maps."""
    if "seeds" in prepared:
        return tuple(hash_noise_map(2 * hp, 2 * wp, s, device)
                     for s in prepared["seeds"])
    return prepared["n1"].float()[..., None], prepared["n2"].float()[..., None]


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
    n1, n2 = _noise_maps(prepared, rows // frames, wp, y1.device)
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


def _check_block_shape(what, rows, wp, c, frames):
    if c not in KERNEL_CHANNELS or wp % 16 or rows % frames:
        raise ValueError(f"{what} kernel: unsupported y1 {(rows, wp, c)} for "
                         f"{frames} frames (C in {KERNEL_CHANNELS}, Wp % 16 == 0)")


def _launch(y1, prepared, emit_feat, frames):
    dev = y1.device
    rows, wp, c = y1.shape
    dt = prepared["dtype"]
    _check_block_shape("decoder_block", rows, wp, c, frames)
    hp = rows // frames
    emit_rgb = "wrgbt" in prepared
    hashed = "seeds" in prepared
    _lib.check(y1, "y1", (rows, wp, c), dt, dev)
    if not hashed:
        _lib.check(prepared["n1"], "noise1", (2 * hp, 2 * wp), dt, dev)
        _lib.check(prepared["n2"], "noise2", (2 * hp, 2 * wp), dt, dev)
    _lib.check(prepared["w2t"], "w2t", (c, c), torch.bfloat16, dev)
    _lib.check(prepared["b1"], "b1", (c,), torch.float32, dev)
    _lib.check(prepared["b2"], "b2", (c,), torch.float32, dev)
    _lib.check(prepared["nw"], "nw", (2,), torch.float32, dev)
    if emit_rgb:
        _lib.check(prepared["wrgbt"], "wrgbt", (3, c), dt, dev)
    feat = (torch.empty((2 * rows, 2 * wp, c), dtype=dt, device=dev)
            if emit_feat else None)
    rgb = (torch.empty((2 * rows, 2 * wp, 3), dtype=torch.float32, device=dev)
           if emit_rgb else None)
    seed1, seed2 = prepared["seeds"] if hashed else (0, 0)
    lib = _lib.load("decoder_block")
    fn = lib.decoder_block_forward
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 6
                   + [ctypes.c_uint32] * 2 + [ctypes.c_void_p])
    p = _lib.ptr
    code = fn(
        p(y1), p(prepared.get("n1")), p(prepared.get("n2")), p(prepared["w2t"]),
        p(prepared["b1"]), p(prepared["b2"]), p(prepared["nw"]),
        p(prepared.get("wrgbt")), p(feat), p(rgb),
        frames, hp, wp, c, int(dt == torch.float32), int(hashed), seed1, seed2,
        _lib.stream_ptr(dev),
    )
    _lib.raise_on_error(code, "decoder_block")
    _lib.LAUNCHES[launch_name(prepared)] += 1
    res = [t for t in (feat, rgb) if t is not None]
    return tuple(res) if len(res) > 1 else res[0]


def decoder_block_packed(y1, noise1=None, noise2=None, w2=None, b1=None,
                         b2=None, noise_w1=None, noise_w2=None, wrgb=None, *,
                         dtype=torch.bfloat16, emit_feat=True, frames=1,
                         noise_seeds=None, prepared=None):
    """One fused upsample block. y1 (F*Hp, Wp, C): conv_a's matmul output at
    the previous resolution, F frames stacked on rows (the upsample halo is
    zero at each frame's edges; noise, weights and biases are shared, and
    with hash noise every frame takes the same realization).

    Returns feat (2F*Hp, 2Wp, C) in `dtype` when there is no wrgb;
    (feat, rgb) with rgb (2F*Hp, 2Wp, 3) f32 (before ToRGB bias and skip)
    when there is; rgb alone when additionally emit_feat=False.
    `prepared` (decoder_block_prepare) replaces the operand arguments."""
    if prepared is None:
        prepared = decoder_block_prepare(noise1, noise2, w2, b1, b2, noise_w1,
                                         noise_w2, wrgb, dtype=dtype,
                                         noise_seeds=noise_seeds)
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


# ---- K3: the v1 block (f32 in and out, bias and skip epilogue)


def _bf16(x):
    return x.to(torch.bfloat16).float()


def decoder_block_fused_plain(y1, skip, noise1, noise2, w2, wrgb, b1, b2, brgb,
                              noise_w1, noise_w2):
    """Plain PyTorch version of the K3 kernel: the upsample in f32 (rows,
    then columns, no rounding between), h and h2 rounded to bf16 only as
    matmul operands, rgb = bf16(h2) @ bf16(wrgb) + brgb + up2(skip) in f32."""
    hp, wp, c = y1.shape
    up = _up_axis(_up_axis(y1.float()[None], 1, K4), 2, K4)[0]
    h = _lrelu(up + noise_w1 * noise1.reshape(2 * hp, 2 * wp, 1).float()
               + b1.reshape(c).float())
    h2 = _bf16(h) @ _bf16(w2)
    h2 = _lrelu(h2 + noise_w2 * noise2.reshape(2 * hp, 2 * wp, 1).float()
                + b2.reshape(c).float())
    skip_up = _up_axis(_up_axis(skip.float()[None], 1, K4), 2, K4)[0]
    rgb = _bf16(h2) @ _bf16(wrgb) + brgb.reshape(3).float() + skip_up
    return h2, rgb


def _launch_fused(y1, skip, noise1, noise2, w2, wrgb, b1, b2, brgb, noise_w1,
                  noise_w2):
    dev = y1.device
    hp, wp, c = y1.shape
    _check_block_shape("decoder_block_fused", hp, wp, c, 1)
    f32, bf16 = torch.float32, torch.bfloat16
    ops = {
        "y1": y1.float().contiguous(),
        "skip": skip.float().contiguous(),
        "noise1": noise1.reshape(2 * hp, 2 * wp).float().contiguous(),
        "noise2": noise2.reshape(2 * hp, 2 * wp).float().contiguous(),
        "w2t": w2.t().contiguous().to(bf16),
        "b1": b1.reshape(c).float().contiguous(),
        "b2": b2.reshape(c).float().contiguous(),
        "nw": torch.stack([torch.as_tensor(v, dtype=f32, device=dev).reshape(())
                           for v in (noise_w1, noise_w2)]),
        "wrgbt": wrgb.t().contiguous().to(bf16),
        "brgb": brgb.reshape(3).float().contiguous(),
    }
    shapes = {"y1": ((hp, wp, c), f32), "skip": ((hp, wp, 3), f32),
              "noise1": ((2 * hp, 2 * wp), f32), "noise2": ((2 * hp, 2 * wp), f32),
              "w2t": ((c, c), bf16), "b1": ((c,), f32), "b2": ((c,), f32),
              "nw": ((2,), f32), "wrgbt": ((3, c), bf16), "brgb": ((3,), f32)}
    for name, (shape, dtype) in shapes.items():
        _lib.check(ops[name], name, shape, dtype, dev)
    feat = torch.empty((2 * hp, 2 * wp, c), dtype=f32, device=dev)
    rgb = torch.empty((2 * hp, 2 * wp, 3), dtype=f32, device=dev)
    lib = _lib.load("decoder_block")
    fn = lib.decoder_block_fused_forward
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    p = _lib.ptr
    code = fn(
        p(ops["y1"]), p(ops["skip"]), p(ops["noise1"]), p(ops["noise2"]),
        p(ops["w2t"]), p(ops["b1"]), p(ops["b2"]), p(ops["nw"]),
        p(ops["wrgbt"]), p(ops["brgb"]), p(feat), p(rgb), hp, wp, c,
        _lib.stream_ptr(dev),
    )
    _lib.raise_on_error(code, "decoder_block_fused")
    _lib.LAUNCHES["decoder_block_fused"] += 1
    return feat, rgb


def decoder_block_fused(y1, skip, noise1, noise2, w2, wrgb, b1, b2, brgb,
                        noise_w1, noise_w2):
    """The v1 block: y1 (Hp, Wp, C) conv_a's matmul output, skip (Hp, Wp, 3)
    incoming rgb, noise1/noise2 (2Hp, 2Wp[, 1]), w2 (C, C) and wrgb (C, 3)
    modulated weights, b1/b2 (C,), brgb (3,), noise weights. Returns
    (feat (2Hp, 2Wp, C), rgb (2Hp, 2Wp, 3)), both f32."""
    args = (y1, skip, noise1, noise2, w2, wrgb, b1, b2, brgb, noise_w1, noise_w2)
    if y1.device.type == "cuda":
        return _launch_fused(*args)
    if y1.device.type == "cpu":
        return decoder_block_fused_plain(*args)
    raise ValueError(f"decoder_block_fused: no kernel for device {y1.device}")
