"""Fused CIPS-decoder upsample block (counterpart of the packed block and
of the v1 block in cips3dpp_tpu/kernels/decoder_block.py).

One decoder block at resolution r, after conv_a's matmul at r/2 (y1):

    2x separable [1,3,3,1] upsample of y1, taps (.25, .75, .75, .25), zero
    edges (per frame) -> + nw1*noise1 + b1 -> lrelu*sqrt2
    -> 1x1 conv_b (bf16 inputs, f32 accumulation) -> + nw2*noise2 + b2
    -> lrelu*sqrt2 = feat  [-> rgb = feat @ wrgb, ToRGB before bias/skip]

`decoder_block_packed` (K2, the serving block) launches the CUDA kernel
`csrc/decoder_block.cu` for tensors on the card and runs
`decoder_block_plain` for tensors on the CPU. K2 takes every (C, Wp) the
packed Pallas block admits (`check_k2`: C = 1, 2, 4, ..., 64 and every C
>= 128, Wp a multiple of p = max(1, 128 // C)), K3 every C (`check_k3`),
with no ceiling: device memory alone limits C. The built kernels run the
channel counts `is_kernel_channels` names: at 16, 32, 64, 128 and 256
conv_b's weight stays in shared memory (`block_kernel`), at 192 and
every multiple of 64
from 320 up it is streamed from L2 in swizzled chunks of 64 input
channels (`chunk_weight`: 128 output channels a pass, and a tail pass of
64 where C % 128 == 64), shared by a thread-block cluster
(`block_kernel_wide`, its tile by C: `tile_pixels`); past C = 2048
(`is_staged`) the activation tile goes through a scratch in device
memory in the same chunked layout, so the kernel's shared memory does
not grow with C.
Any other C runs at the count `kernel_channels` gives (the next multiple
of 64 past 256, and 192 for C = 129-192): the prepare
functions pad w2's rows and columns, wrgb's rows and b1 / b2 with zeros,
so the padded channels hold lrelu(noise * nw), finite, and meet only zero
weights (exact but for the order of f32 sums). y1 arrives padded from
the serving path (decoder_fused pads conv_a's columns at prepare time) or
is padded by one copy here; feat comes back at y1's C. The kernels take Wp
in steps of 16 (`kernel_width`): a y1 of another width is padded with zero
columns, which are the upsample's zero edge, the outputs are sliced back,
and hash noise counts its pixel ids in the caller's width. The storage
dtype `dtype` (bf16 or f32) fixes the rounding points, as the serving
path of the JAX package has them: y1 and the noise buffers are stored in
it, the row-upsampled values are rounded to it before the column blend,
feat is stored in it, and ToRGB multiplies the stored feat by wrgb
rounded to it.
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
import torch.nn.functional as F

from . import _lib
from ..ops.upfirdn2d import _up_axis
from .siren_render import fast_sin, wide_activation_layout

# normalized [1,3,3,1]/8 * 2 gain (per-axis sqrt of the 4x 2-D gain)
K4 = (0.25, 0.75, 0.75, 0.25)
SQRT2 = 1.4142135623730951
# The channel counts the built kernels run at (is_kernel_channels): the
# powers of two 16-256 with the weight resident, and the streamed ones, 192 (WIDE_FROM) and
# every multiple of 64 from 320 up (is_streamed); past STAGED_FROM the
# streamed kernel stages a tile's activations through a scratch of
# STAGED_TILE_PIXELS x C bf16 a CTA (is_staged). Every other C is run at
# the count kernel_channels gives.
RESIDENT_CHANNELS = (16, 32, 64, 128, 256)
WIDE_FROM = 192
STAGED_FROM = 2048
STAGED_TILE_PIXELS = 64
# the kernels' Wp step: a tile's input columns divide it at every C
WIDTH_STEP = 16
# JAX's admission rules, quoted in the errors
K2_RULE = ("JAX's packed block asserts (c * p) % 128 == 0 or c >= 128 and wp % p == 0, "
           "p = max(1, 128 // c) (cips3dpp_tpu/kernels/decoder_block.py:754-756)")
STORAGE = (torch.bfloat16, torch.float32)
# block_kernel_wide's weight chunk: 128 output channels x 64 input channels
# (a tail pass's: 64 x 64)
CHUNK_ROWS, CHUNK_K = 128, 64
_M32 = 0xFFFFFFFF
# f32 operations of one hash_normal value: two avalanche hashes (2 x 7
# integer ops), two int->float uniforms (4), log, sqrt and -2x (3), the
# sin polynomial with its range reduction (14), the phase and product (3)
HASH_OPS = 38
# f32 instructions a K2 output value needs with every product and sum
# rounded as decoder_block_plain rounds it. A blend .25*a + .75*b is one
# multiply (.75*b, shared by the two outputs that take b as their centre)
# and one fused multiply-add (.25*a is exact): 1.5 an output of a pass. The
# row pass makes half as many values as the column pass (0.75), the column
# pass 1.5; then noise1 and b1 adds (2), lrelu (x0.2, x sqrt2: 2), noise2
# and b2 adds (2), lrelu (2). The lrelu max and the bf16 conversions are
# not counted.
K2_APART_PER_VALUE = 10.25
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


def hash_noise_map(height: int, width: int, seed: int, device=None,
                   row_len: int | None = None) -> torch.Tensor:
    """(height, width, 1) f32 map equal to the kernel's in-kernel hash
    realization (pixel id = row * row_len + col; row_len is the map's
    width unless the map runs past the caller's width, which the ids
    count in)."""
    rows = torch.arange(height, dtype=torch.int64, device=device)[:, None]
    cols = torch.arange(width, dtype=torch.int64, device=device)[None, :]
    return hash_normal(rows * (width if row_len is None else row_len) + cols, seed)[..., None]


# ---- what the kernels take


def is_streamed(c: int) -> bool:
    """Whether a built kernel at C = c streams conv_b's weight
    (block_kernel_wide): 192 and every multiple of 64 from 320 up, the
    last pass a tail of 64 output channels where c % 128 == 64."""
    return c >= WIDE_FROM and c % CHUNK_K == 0 and c not in RESIDENT_CHANNELS


def is_staged(c: int) -> bool:
    """Whether the streamed kernel at C = c stages its activation tile
    through the scratch (its staged build): past STAGED_FROM."""
    return is_streamed(c) and c > STAGED_FROM


def is_kernel_channels(c: int) -> bool:
    """Whether a built kernel runs C = c as it is: 16, 32, 64, 128 and 256
    with the weight resident, 192 and every multiple of 64 from 320 up
    with it streamed."""
    return c in RESIDENT_CHANNELS or is_streamed(c)


def check_k2(c: int, wp: int | None = None) -> None:
    """Raise ValueError where JAX's packed block (K2) refuses C = c (and,
    given, Wp = wp). There is no upper limit."""
    p = max(1, 128 // c) if c >= 1 else 1
    if c < 1 or not ((c * p) % 128 == 0 or c >= 128):
        raise ValueError(f"decoder_block: C = {c} is not admitted ({K2_RULE})")
    if wp is not None and wp % p:
        raise ValueError(f"decoder_block: Wp = {wp} at C = {c} is not admitted (p = {p}; "
                         f"{K2_RULE})")


def check_k3(c: int) -> None:
    """Raise ValueError where K3 cannot take C = c: JAX's v1 block takes
    every C (it asserts only hp % t_rows == 0, cips3dpp_tpu/kernels/
    decoder_block.py:127; the port's entry point has no row tile), so only
    C < 1."""
    if c < 1:
        raise ValueError(f"decoder_block_fused: C = {c}: want C >= 1")


def kernel_channels(c: int) -> int:
    """The channel count of the built kernel that runs a block at C = c:
    the least count is_kernel_channels takes at or above it, the next of
    16, 32, 64, 128, 192 and 256, and past 256 the next multiple of 64.
    C = 129-192 (the 1024^2 blocks at channel multipliers 9-12) run on the
    streamed kernel at 192 (its build with C fixed), not block_kernel at
    256: at y1 (512, 512, 144) 0.8810-0.8851 / 0.8434-0.8480 /
    0.9353-0.9394 / 0.8889-0.8891 ms against 0.9925-0.9953 /
    1.0042-1.0051 / 0.9931-0.9960 / 1.0121-1.0290 (bf16 / hash / f32 /
    hash f32, `k2_times` parent / change / change / parent on an NVIDIA
    H100 80GB HBM3 at 700 W)."""
    if c < 1:
        raise ValueError(f"C = {c}: want C >= 1")
    for r in sorted(RESIDENT_CHANNELS + (WIDE_FROM,)):
        if c <= r:
            return r
    return -(-c // CHUNK_K) * CHUNK_K


def kernel_width(wp: int) -> int:
    """The y1 width the kernels run a block of width wp at."""
    return -(-wp // WIDTH_STEP) * WIDTH_STEP


def _pad_to(x, *size):
    """x zero-padded at the end of its trailing dims to `size`."""
    pads = []
    for have, want in zip(reversed(x.shape[-len(size):]), reversed(size)):
        pads += [0, want - have]
    return F.pad(x, pads) if any(pads) else x


# ---- K2: the serving block


@torch.no_grad()
def decoder_block_prepare(noise1, noise2, w2, b1, b2, noise_w1, noise_w2,
                          wrgb=None, *, dtype=torch.bfloat16, noise_seeds=None):
    """y1-independent operands, fixed for a whole trajectory.

    noise1/noise2 (H, W[, 1]) per-pixel maps, or `noise_seeds` (two uint32
    seeds, hash noise; the maps may then be None); w2 (C, C) (in, out)
    modulated conv_b weight, b1/b2 (C,), noise_w1/noise_w2 scalars, wrgb
    (C, 3) modulated ToRGB weight or None (no rgb output).

    Raises where JAX's packed block refuses C (check_k2). The operands are
    kept at the kernel's channel count (kernel_channels(C), "c" holds C):
    w2 padded with zero rows and columns, b1, b2 and wrgb with zeros; the
    noise maps at the kernel's width (kernel_width), zero past W."""
    if dtype not in STORAGE:
        raise ValueError(f"decoder block storage dtype {dtype}: want one of {STORAGE}")
    c = w2.shape[0]
    check_k2(c)
    ck = kernel_channels(c)
    prep = {
        "dtype": dtype,
        "c": c,
        # (out, in) bf16: the tensor-core B operand
        "w2t": _pad_to(w2.t(), ck, ck).contiguous().to(torch.bfloat16),
        "b1": _pad_to(b1.reshape(c).float(), ck).contiguous(),
        "b2": _pad_to(b2.reshape(c).float(), ck).contiguous(),
        "nw": torch.stack([
            torch.as_tensor(v, dtype=torch.float32, device=w2.device).reshape(())
            for v in (noise_w1, noise_w2)
        ]),
    }
    if is_streamed(ck):
        prep["w2c"] = chunk_weight(prep["w2t"])
    if noise_seeds is not None:
        prep["seeds"] = tuple(int(s) & _M32 for s in noise_seeds)
    else:
        h, w = noise1.shape[:2]
        wk = 2 * kernel_width(w // 2)
        prep["n1"] = _pad_to(noise1.reshape(h, w).to(dtype), h, wk).contiguous()
        prep["n2"] = _pad_to(noise2.reshape(h, w).to(dtype), h, wk).contiguous()
    if wrgb is not None:
        prep["wrgbt"] = _pad_to(wrgb.t().to(dtype), 3, ck).contiguous()  # (3, C)
    return prep


def chunk_weight(w2t):
    """conv_b's (C out, C in) bf16 weight as block_kernel_wide reads it
    (C a multiple of 64): C // 128 passes x (C / 64) chunks of 128 output
    x 64 input channels, 16 KB each, then where C % 128 == 64 a tail pass
    of C / 64 chunks of 64 output x 64 input channels, 8 KB each,
    contiguous in that order; within a chunk row n, the 16-byte group j of
    8 input channels sits at j ^ (n % 8), the 128-byte swizzle wgmma reads.
    One 1-D bulk copy then fills a ring slot (half of one in the tail).
    Returns a flat bf16 tensor of C * C values."""
    c = w2t.shape[0]
    full = c // CHUNK_ROWS * CHUNK_ROWS
    passes = [_swizzled_chunks(w2t[:full], CHUNK_ROWS)] if full else []
    if c > full:
        passes.append(_swizzled_chunks(w2t[full:], c - full))
    return torch.cat(passes)


def _swizzled_chunks(w, rows):
    """Passes of `rows` rows of w (out, in) as chunk_weight lays them out."""
    w = w.reshape(-1, rows, w.shape[1] // CHUNK_K, 8, 8).permute(0, 2, 1, 3, 4)
    n = torch.arange(rows, device=w.device)[:, None]
    swizzle = torch.arange(8, device=w.device)[None, :] ^ (n % 8)
    return torch.gather(w, 3, swizzle[None, None, :, :, None].expand(w.shape)).reshape(-1)


def launch_name(prepared) -> str:
    """The launch-count name of the K2 variant that `prepared` runs:
    "decoder_block" (bf16 storage, noise buffers), with "_hash" when the
    kernel makes the noise, "_f32" for f32 storage and "_staged" where its
    channel count runs on the staged build (is_staged)."""
    return ("decoder_block" + ("_hash" if "seeds" in prepared else "")
            + ("_f32" if prepared["dtype"] == torch.float32 else "")
            + ("_staged" if is_staged(prepared["w2t"].shape[0]) else ""))


def fused_launch_name(c: int) -> str:
    """The launch-count name of K3 at the caller's C = c: "decoder_block_fused",
    with "_staged" where its channel count runs on the staged build."""
    return "decoder_block_fused" + ("_staged" if is_staged(kernel_channels(c)) else "")


def staged_scratch_bytes(c: int) -> int:
    """Bytes of scratch one CTA of the staged build uses at kernel C = c:
    its activation tile, STAGED_TILE_PIXELS pixels x c bf16, in the layout
    of K1's run-time-width scratch (siren_render.wide_activation_layout:
    64-channel K-chunks of 64 pixels, each pixel's 16-byte groups swizzled
    by pixel % 8, as chunk_weight swizzles a weight chunk's rows)."""
    return STAGED_TILE_PIXELS * c * 2


def _scratch(c, dev, scratch=None):
    """The staged build's scratch at kernel C = c: `scratch` (uint8 on the
    card, from a caller that reads it back), or one of staged_scratch_bytes
    a CTA, one CTA an SM, allocated here; None where C is not staged."""
    if not is_staged(c):
        return None
    if scratch is None:
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        return torch.empty(sms * staged_scratch_bytes(c), dtype=torch.uint8, device=dev)
    _lib.check(scratch, "scratch", (scratch.numel(),), torch.uint8, dev)
    return scratch


def staged_tiles_plain(y1, prepared, frames=1, width=None):
    """What the staged build's scratch holds of each tile of a launch on
    y1 (F*Hp, Wp, C) at the kernel's shape, by the plain version: the tile's
    conv_b input (decoder_block_activation_plain; 2 output rows x 32
    columns, row by row) in the scratch's layout (staged_scratch_bytes),
    tiles in the kernel's order (frame rows, then 16-column segments).
    Returns (tiles, STAGED_TILE_PIXELS * C) bf16; a launch over at most as
    many tiles as its grid has CTAs leaves tile i in CTA i's scratch."""
    rows, wp, c = y1.shape
    h = decoder_block_activation_plain(y1, prepared, frames, width)  # (F, 2Hp, 2Wp, C)
    tw = STAGED_TILE_PIXELS // 2  # output columns a tile
    tiles = (h.reshape(rows, 2, 2 * wp // tw, tw, c).transpose(1, 2)
             .reshape(-1, STAGED_TILE_PIXELS, c))
    return torch.stack([wide_activation_layout(t) for t in tiles])


def decoder_block_work(hp, wp, c, dtype, hashed, emit_feat, emit_rgb=True, frames=1):
    """The least work of one K2 call on y1 (frames*hp, wp, c): bytes (each
    input read once, each output written once), bf16 tensor-core FLOPs
    (conv_b), f32 operations that may contract to FMA (`f32_dot`: ToRGB, the
    hash generator) and f32 operations kept rounded apart (`f32_apart`:
    K2_APART_PER_VALUE an output value, plus the two noise-weight products
    a pixel). Noise maps and their hash realization are shared by the
    frames."""
    es = torch.finfo(dtype).bits // 8
    px = 4 * frames * hp * wp  # output pixels
    map_px = 4 * hp * wp  # pixels of one noise map
    nbytes = (es * frames * hp * wp * c + (0 if hashed else 2 * es * map_px)
              + (es * px * c if emit_feat else 0) + (4 * px * 3 if emit_rgb else 0)
              + 2 * c * c + 4 * (2 * c + 2) + (es * 3 * c if emit_rgb else 0))
    f32_dot = (2 * px * 3 * c if emit_rgb else 0) + (2 * map_px * HASH_OPS if hashed else 0)
    return {"bytes": nbytes, "bf16_flops": 2 * px * c * c, "f32_dot": f32_dot,
            "f32_apart": K2_APART_PER_VALUE * px * c + 2 * px}


def decoder_block_intake(hp, wp, c, frames=1, cluster=2):
    """The bytes the streamed-weight kernel takes into the SMs in one call
    on y1 (frames*hp, wp, c) with clusters of `cluster` CTAs, at its
    kernel's C (ck = kernel_channels(c)) and width: the weight, 2 ck^2
    bytes (a tail pass's chunks are half a full pass's), once for each
    tile group of a cluster (multicast to its CTAs), and past C = 2048 the
    staged activations, each of a tile's ceil(ck / 128) passes, the tail
    pass too, reading its whole tile (STAGED_TILE_PIXELS x ck bf16) back
    from the scratch: ck^2 bytes a tile at ck % 128 == 0, and 64 ck more
    a tile with a tail. Returns {"tile_pixels", "tiles", "weight_bytes",
    "activation_bytes", "bytes"}; raises where the weight is resident."""
    ck = kernel_channels(c)
    if not is_streamed(ck):
        raise ValueError(f"C = {c} runs at {ck}: the weight stays in shared memory")
    tm = tile_pixels(c)
    tiles = frames * hp * kernel_width(wp) * 4 // tm
    weight = -(-tiles // cluster) * 2 * ck * ck
    act = tiles * -(-ck // CHUNK_ROWS) * tm * ck * 2 if is_staged(ck) else 0
    return {"tile_pixels": tm, "tiles": tiles, "weight_bytes": weight,
            "activation_bytes": act, "bytes": weight + act}


def _noise_map(prepared, k, hp, wp, device, width):
    """The block's noise map k (0: noise1, 1: noise2), (2Hp, 2Wp, 1) f32;
    hash noise counts its pixel ids in rows of 2 * width."""
    if "seeds" in prepared:
        return hash_noise_map(2 * hp, 2 * wp, prepared["seeds"][k], device, row_len=2 * width)
    return prepared[("n1", "n2")[k]].float()[..., None]


def decoder_block_plain(y1, prepared, emit_feat=True, frames=1, width=None):
    """Plain PyTorch version of the kernel, same rounding points.
    y1 (F*Hp, Wp, C) with F frames stacked on rows, at the kernel's C;
    `width`: the caller's Wp where y1 was padded past it (the hash's
    pixel ids count in it)."""
    rows, wp, c = y1.shape
    h = decoder_block_activation_plain(y1, prepared, frames, width)
    n2 = _noise_map(prepared, 1, rows // frames, wp, y1.device, width or wp)
    h2 = h.float() @ prepared["w2t"].float().t()
    h2 = _lrelu(h2 + prepared["nw"][1] * n2 + prepared["b2"])
    stored = h2.to(prepared["dtype"])
    out_rows = 2 * rows
    res = []
    if emit_feat:
        res.append(stored.reshape(out_rows, 2 * wp, c))
    if "wrgbt" in prepared:
        rgb = stored.float() @ prepared["wrgbt"].float().t()
        res.append(rgb.reshape(out_rows, 2 * wp, 3))
    return tuple(res) if len(res) > 1 else res[0]


def decoder_block_activation_plain(y1, prepared, frames=1, width=None):
    """The plain version's conv_b input on y1 (F*Hp, Wp, C): the 2x
    upsample (rows, rounded to the storage type, then columns), + noise1 +
    b1, lrelu, in bf16. Returns (F, 2Hp, 2Wp, C)."""
    dt = prepared["dtype"]
    rows, wp, c = y1.shape
    x = y1.to(dt).float().reshape(frames, rows // frames, wp, c)
    x = _up_axis(x, 1, K4)  # rows, f32
    x = x.to(dt).float()  # rounded before the column blend
    x = _up_axis(x, 2, K4)
    n1 = _noise_map(prepared, 0, rows // frames, wp, y1.device, width or wp)
    return _lrelu(x + prepared["nw"][0] * n1 + prepared["b1"]).to(torch.bfloat16)


def tile_pixels(c) -> int:
    """Output pixels of the tile of the kernel that runs C = c (2 output
    rows x half as many columns), at its channel count ck =
    kernel_channels(c): 8192 / ck with the weight resident; with it
    streamed, 64 at ck <= 1024 and 32 to 2048 (the bf16 activation tile in
    at most 128 KB of shared memory, beside the weight ring), and 64 past
    2048, where the staged build keeps the tile in its scratch."""
    ck = kernel_channels(c)
    if ck in RESIDENT_CHANNELS:
        return 8192 // ck
    return 32 if 1024 < ck <= STAGED_FROM else 64


def _check_kernel_shape(what, rows, wp, c, frames):
    """The shape a launch takes: y1 padded to a built kernel's C and to a
    multiple of WIDTH_STEP columns (the entry points pad)."""
    if not is_kernel_channels(c) or wp % WIDTH_STEP or rows % frames:
        raise ValueError(f"{what} kernel: y1 {(rows, wp, c)} for {frames} frames: the "
                         f"kernel runs C = 16, 32, 64, 128, 192, 256 or a multiple of 64 from "
                         f"320 up, "
                         f"and Wp % {WIDTH_STEP} == 0")


def _check_aligned(**tensors):
    """The kernel moves 16 bytes at a time: every operand starts 16-byte aligned."""
    for name, t in tensors.items():
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"{name}: data not 16-byte aligned")


INFO_KEYS = ("smem_bytes", "blocks_per_sm", "registers", "local_bytes",
             "tile_input_columns", "tile_pixels", "cluster", "clusters_on_card")


def decoder_block_info(c, dtype=torch.bfloat16, hashed=False, k3=False, defines=()):
    """Resources of one instantiation of the kernel on the current card:
    shared memory a block (bytes), blocks an SM, registers a thread, local
    (spill) bytes a thread, input columns and output pixels of a tile, CTAs
    a cluster, and the clusters the card holds at once (blocks, for the
    resident kernel, whose cluster is 1). K3 (`k3=True`) is the f32
    instantiation with the bias and skip epilogue. C is the caller's: the
    instantiation is the one that runs it, at kernel_channels(c); raises
    where check_k2 (check_k3) refuses C, before any build. Kernel C of 192
    and of 320 and up is the streamed-weight kernel (block_kernel_wide):
    one instantiation a tile size (`tile_pixels`) and mode with C at run
    time (a tail pass where C % 128 == 64), one each with C fixed at 192,
    320, 384, 512, 1024 and 2048, and past 2048 the
    staged build, whose shared memory is the same at every C; raises if
    the card cannot place its cluster. `defines`: of the library built with
    those extra flags (the cluster size is a build's,
    -DDBLOCK_WIDE_CLUSTER)."""
    check_k3(c) if k3 else check_k2(c)
    ck = kernel_channels(c)
    info = (ctypes.c_int * len(INFO_KEYS))()
    lib = _lib.load("decoder_block", defines)
    fn = lib.decoder_block_info
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    _lib.raise_on_error(fn(ck, int(dtype == torch.float32), int(hashed), int(k3),
                           ctypes.cast(info, ctypes.c_void_p)), "decoder_block_info")
    return dict(zip(INFO_KEYS, list(info)))


def _launch(y1, prepared, emit_feat, frames, defines=(), width=None, scratch=None):
    """Launch K2 (the library built with the extra flags `defines`) on y1
    at the kernel's shape; `width`: the caller's Wp where y1 was padded
    past it (hash noise counts its pixel ids in it). Past C = 2048 the
    staged build takes a scratch of `staged_scratch_bytes` a CTA, one CTA
    an SM at most: allocated here, or `scratch` (uint8 on the card, from a
    caller that reads the tiles back: staged_tiles_plain)."""
    dev = y1.device
    rows, wp, c = y1.shape
    dt = prepared["dtype"]
    _check_kernel_shape("decoder_block", rows, wp, c, frames)
    hp = rows // frames
    emit_rgb = "wrgbt" in prepared
    hashed = "seeds" in prepared
    _lib.check(y1, "y1", (rows, wp, c), dt, dev)
    if not hashed:
        _lib.check(prepared["n1"], "noise1", (2 * hp, 2 * wp), dt, dev)
        _lib.check(prepared["n2"], "noise2", (2 * hp, 2 * wp), dt, dev)
    _lib.check(prepared["w2t"], "w2t", (c, c), torch.bfloat16, dev)
    w2c = prepared.get("w2c")
    if is_streamed(c):
        _lib.check(w2c, "w2c", (c * c,), torch.bfloat16, dev)
    _lib.check(prepared["b1"], "b1", (c,), torch.float32, dev)
    _lib.check(prepared["b2"], "b2", (c,), torch.float32, dev)
    _lib.check(prepared["nw"], "nw", (2,), torch.float32, dev)
    if emit_rgb:
        _lib.check(prepared["wrgbt"], "wrgbt", (3, c), dt, dev)
    feat = (torch.empty((2 * rows, 2 * wp, c), dtype=dt, device=dev)
            if emit_feat else None)
    rgb = (torch.empty((2 * rows, 2 * wp, 3), dtype=torch.float32, device=dev)
           if emit_rgb else None)
    scratch = _scratch(c, dev, scratch)
    _check_aligned(y1=y1, noise1=prepared.get("n1"), noise2=prepared.get("n2"),
                   w2t=prepared["w2t"], w2c=w2c, scratch=scratch)
    seed1, seed2 = prepared["seeds"] if hashed else (0, 0)
    hash_wo = 2 * (wp if width is None else width)
    lib = _lib.load("decoder_block", defines)
    fn = lib.decoder_block_forward
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 7
                   + [ctypes.c_uint32] * 2 + [ctypes.c_void_p] * 2 + [ctypes.c_longlong])
    p = _lib.ptr
    code = fn(
        p(y1), p(prepared.get("n1")), p(prepared.get("n2")), p(prepared["w2t"]), p(w2c),
        p(prepared["b1"]), p(prepared["b2"]), p(prepared["nw"]),
        p(prepared.get("wrgbt")), p(feat), p(rgb),
        frames, hp, wp, c, int(dt == torch.float32), int(hashed), hash_wo, seed1, seed2,
        _lib.stream_ptr(dev), p(scratch), 0 if scratch is None else scratch.numel(),
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
    `prepared` (decoder_block_prepare) replaces the operand arguments.

    C is the block's, or the kernel's (kernel_channels) where the caller
    made y1 at it, as the serving path does; feat comes back at y1's C.
    Raises where JAX's packed block refuses (C, Wp) (check_k2), before
    any build or launch. y1 at another C or Wp than the kernel runs is
    padded by one copy and the outputs sliced back (both devices take the
    same route)."""
    if prepared is None:
        prepared = decoder_block_prepare(noise1, noise2, w2, b1, b2, noise_w1,
                                         noise_w2, wrgb, dtype=dtype,
                                         noise_seeds=noise_seeds)
    if y1.device.type == "cuda":
        run = _launch
    elif y1.device.type == "cpu":
        run = decoder_block_plain
    else:
        raise ValueError(f"decoder_block: no kernel for device {y1.device}")
    return _padded(run, y1, prepared, emit_feat, frames)


def decoder_block_packed_plain(y1, prepared, emit_feat=True, frames=1):
    """decoder_block_packed's route with the plain version in the kernel's
    place, on any device: what the kernel's launch is held against."""
    return _padded(decoder_block_plain, y1, prepared, emit_feat, frames)


def _padded(run, y1, prepared, emit_feat, frames):
    """run(x, prepared, emit_feat, frames, width=Wp) on y1 padded to the
    kernel's C and width, the outputs sliced back to y1's."""
    if not (emit_feat or "wrgbt" in prepared):
        raise ValueError("decoder_block_packed: nothing to emit")
    rows, wp, cy = y1.shape
    c, ck = prepared["c"], prepared["w2t"].shape[0]
    check_k2(c, wp)
    if cy not in (c, ck) or rows % frames:
        raise ValueError(f"decoder_block_packed: y1 {tuple(y1.shape)} for {frames} frames: "
                         f"want C = {c} (or the kernel's {ck}) and rows a multiple of F")
    wk = kernel_width(wp)
    out = run(_pad_to(y1, rows, wk, ck).contiguous(), prepared, emit_feat, frames, width=wp)
    if (cy, wp) == (ck, wk):
        return out
    res = [out] if isinstance(out, torch.Tensor) else list(out)
    if emit_feat:
        res[0] = res[0][:, :2 * wp, :cy]
    if "wrgbt" in prepared:
        res[-1] = res[-1][:, :2 * wp]
    res = [r.contiguous() for r in res]
    return tuple(res) if len(res) > 1 else res[0]


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
                  noise_w2, defines=()):
    """Launch K3 (the library built with the extra flags `defines`) on
    operands at the kernel's shape; past C = 2048 with a scratch allocated
    as K2's `_launch` allocates it."""
    dev = y1.device
    hp, wp, c = y1.shape
    _check_kernel_shape("decoder_block_fused", hp, wp, c, 1)
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
    if is_streamed(c):
        ops["w2c"] = chunk_weight(ops["w2t"])
    shapes = {"y1": ((hp, wp, c), f32), "skip": ((hp, wp, 3), f32),
              "noise1": ((2 * hp, 2 * wp), f32), "noise2": ((2 * hp, 2 * wp), f32),
              "w2t": ((c, c), bf16), "b1": ((c,), f32), "b2": ((c,), f32),
              "nw": ((2,), f32), "wrgbt": ((3, c), bf16), "brgb": ((3,), f32)}
    if is_streamed(c):
        shapes["w2c"] = ((c * c,), bf16)
    for name, (shape, dtype) in shapes.items():
        _lib.check(ops[name], name, shape, dtype, dev)
    scratch = _scratch(c, dev)
    _check_aligned(scratch=scratch, **ops)
    feat = torch.empty((2 * hp, 2 * wp, c), dtype=f32, device=dev)
    rgb = torch.empty((2 * hp, 2 * wp, 3), dtype=f32, device=dev)
    lib = _lib.load("decoder_block", defines)
    fn = lib.decoder_block_fused_forward
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 13 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
                   + [ctypes.c_longlong])
    p = _lib.ptr
    code = fn(
        p(ops["y1"]), p(ops["skip"]), p(ops["noise1"]), p(ops["noise2"]),
        p(ops["w2t"]), p(ops.get("w2c")), p(ops["b1"]), p(ops["b2"]), p(ops["nw"]),
        p(ops["wrgbt"]), p(ops["brgb"]), p(feat), p(rgb), hp, wp, c,
        _lib.stream_ptr(dev), p(scratch), 0 if scratch is None else scratch.numel(),
    )
    _lib.raise_on_error(code, "decoder_block_fused")
    _lib.LAUNCHES[fused_launch_name(c)] += 1
    return feat, rgb


def decoder_block_fused(y1, skip, noise1, noise2, w2, wrgb, b1, b2, brgb,
                        noise_w1, noise_w2):
    """The v1 block: y1 (Hp, Wp, C) conv_a's matmul output, skip (Hp, Wp, 3)
    incoming rgb, noise1/noise2 (2Hp, 2Wp[, 1]), w2 (C, C) and wrgb (C, 3)
    modulated weights, b1/b2 (C,), brgb (3,), noise weights. Returns
    (feat (2Hp, 2Wp, C), rgb (2Hp, 2Wp, 3)), both f32.

    Takes every C (check_k3) and Wp: operands at another C or Wp than the
    kernel runs (kernel_channels, kernel_width) are zero-padded, one copy
    each, and the outputs sliced back (both devices take the same route)."""
    hp, wp, c = y1.shape
    check_k3(c)
    ck, wk = kernel_channels(c), kernel_width(wp)
    if (ck, wk) != (c, wp):
        noise1, noise2 = (_pad_to(n.reshape(2 * hp, 2 * wp, 1), 2 * hp, 2 * wk, 1)
                          for n in (noise1, noise2))
        y1, skip = _pad_to(y1, hp, wk, ck), _pad_to(skip, hp, wk, 3)
        w2, wrgb = _pad_to(w2, ck, ck), _pad_to(wrgb, ck, 3)
        b1, b2 = _pad_to(b1.reshape(c), ck), _pad_to(b2.reshape(c), ck)
    args = (y1, skip, noise1, noise2, w2, wrgb, b1, b2, brgb, noise_w1, noise_w2)
    if y1.device.type == "cuda":
        feat, rgb = _launch_fused(*args)
    elif y1.device.type == "cpu":
        feat, rgb = decoder_block_fused_plain(*args)
    else:
        raise ValueError(f"decoder_block_fused: no kernel for device {y1.device}")
    if (ck, wk) != (c, wp):
        feat, rgb = feat[:, :2 * wp, :c].contiguous(), rgb[:, :2 * wp].contiguous()
    return feat, rgb
