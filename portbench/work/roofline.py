"""Frozen copies of the port's roofline arithmetic, kept with the
yardstick so that a change to the program cannot move it: the H100's
published peaks and `bound` and `k1_work` (chip_smoke.py at commit
af17e715d5a8), `decoder_block_work` with its constants
(cips3dpp_torch/kernels/decoder_block.py at the same commit)."""

from __future__ import annotations

PEAK_BF16 = 989e12  # H100 SXM dense bf16 FLOP/s (NVIDIA data sheet)
PEAK_F32 = 67e12  # f32 FLOP/s outside the tensor cores
# f32 operations a second where products and sums are rounded apart (no FMA
# contraction): one operation an instruction, half the FMA peak
PEAK_F32_APART = PEAK_F32 / 2
PEAK_BYTES = 3.35e12  # HBM3 bytes/s
# f32 operations of one hash_normal value (decoder_block.py HASH_OPS)
HASH_OPS = 38
# f32 instructions a K2 output value needs, products and sums rounded apart
# (decoder_block.py K2_APART_PER_VALUE)
K2_APART_PER_VALUE = 10.25


def bound(nbytes, bf16_flops=0.0, f32_flops=0.0, f32_apart=0.0):
    """Least time in ms for the work: the larger of bytes over the memory
    rate and operations over the peak rate of their type. f32 operations
    that may contract to FMA count at PEAK_F32, those whose products and
    sums stay rounded apart (`f32_apart`) at PEAK_F32_APART; both issue on
    the one f32 pipe, so their times add."""
    times = {"bytes": nbytes / PEAK_BYTES,
             "operations": max(bf16_flops / PEAK_BF16,
                               f32_flops / PEAK_F32 + f32_apart / PEAK_F32_APART)}
    by = max(times, key=times.get)
    return times[by] * 1e3, by


def k1_work(r, s, width):
    """(bytes, bf16 FLOP, f32 dot-product operations, f32 operations kept
    apart) of K1 over r rays x s samples at `width`: each input read once,
    each output written once, the operations of the rows there are."""
    rows = r * s
    nbytes = 4 * (rows * 3 + r * 3 + rows + r  # pts, viewdirs, z, |d|
                  + r * (3 + width + 3 + 2) + rows)  # thumb, feat, xyz, maskd, sdf
    nbytes += 2 * 2 * width * width + 4 * (width * 17 + 4)  # weights
    bf16 = rows * 2 * (2 * width * width)  # layer 1 + view layer
    # dot products (layer 0, sdf and rgb heads) and operations kept apart
    # (three phases and sines, the feat sum)
    dot = rows * width * (6 + 2 + 6)
    apart = rows * width * (3 * (2 + 13) + 2)
    return nbytes, bf16, dot, apart


def k1_bound_ms(r, s, width):
    nbytes, bf16, dot, apart = k1_work(r, s, width)
    return bound(nbytes, bf16, dot, apart)[0]


def decoder_block_work(hp, wp, c, bytes_per_value, hashed, emit_feat, emit_rgb=True,
                       frames=1):
    """The least work of one K2 call on y1 (frames*hp, wp, c): bytes (each
    input read once, each output written once), bf16 tensor-core FLOPs
    (conv_b), f32 operations that may contract to FMA (ToRGB, the hash
    generator) and f32 operations kept rounded apart. Noise maps are
    shared by the frames. (The source takes the storage dtype; this copy
    its size in bytes.)"""
    es = bytes_per_value
    px = 4 * frames * hp * wp  # output pixels
    map_px = 4 * hp * wp  # pixels of one noise map
    nbytes = (es * frames * hp * wp * c + (0 if hashed else 2 * es * map_px)
              + (es * px * c if emit_feat else 0) + (4 * px * 3 if emit_rgb else 0)
              + 2 * c * c + 4 * (2 * c + 2) + (es * 3 * c if emit_rgb else 0))
    f32_dot = (2 * px * 3 * c if emit_rgb else 0) + (2 * map_px * HASH_OPS if hashed else 0)
    return {"bytes": nbytes, "bf16_flops": 2 * px * c * c, "f32_dot": f32_dot,
            "f32_apart": K2_APART_PER_VALUE * px * c + 2 * px}


def decoder_block_bound_ms(hp, wp, c, bytes_per_value, hashed, emit_feat, frames=1):
    w = decoder_block_work(hp, wp, c, bytes_per_value, hashed, emit_feat, frames=frames)
    return bound(w["bytes"], w["bf16_flops"], w["f32_dot"], w["f32_apart"])[0]
