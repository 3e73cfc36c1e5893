"""Where K2's time goes, phase by phase, on the card.

    python -m cips3dpp_torch.tools.decoder_block_phase_split [--dtype bfloat16] [--hash] [--iters 20]
        [--streamed]

Builds `csrc/decoder_block.cu` a second time with -DDBLOCK_PHASE_CLOCKS, in
which every warp adds the SM clock cycles of each phase of a tile (the
prologue, the wait for the tile's copies and the first barrier, the last
tile's rgb, starting the next tile's copies, the upsample, the second
barrier, conv_b, the epilogue, the last rgb) to its own counts, summed over
the warps at the end; no barrier is added. Runs K2 at the four block shapes
of the r1024 decoder (random operands from a seed; the last block stores no
feat, as in a frame) and prints one JSON line: each shape's phase shares of
the warps' cycles and the device time a launch (torch.profiler) of the
plain and the instrumented builds, so the cost of the marks can be read
beside the split.

With --streamed the same is done for the streamed-weight kernel
(block_kernel_wide) at y1 (64, 64, 1024) and (64, 64, 2048), with a tail
pass at (512, 512, 272) (run at 320) and (64, 64, 1088), and its staged
build at (64, 64, 4096) and (64, 64, 8320), with feat stored, whose
phases are the producer's waits for an empty ring slot, the consumers'
waits for a full one, wgmma (issue and group waits), the tile's noise and
upsample (in the staged build into the scratch, with the ready barrier's
arrival), the epilogue, and the staged build's producer waits for a
tile's ready barrier before it copies the tile's activation chunks.
"""

from __future__ import annotations

import argparse
import ctypes
import json

import torch

from ..kernels import _lib
from ..kernels import decoder_block as kdb

DEFINES = ("-DDBLOCK_PHASE_CLOCKS",)
PHASES = ("prologue", "wait_copies_barrier", "last_tile_rgb", "start_next_copies",
          "upsample", "barrier", "conv_b", "epilogue", "last_rgb")
WIDE_PHASES = ("producer_wait_empty", "consumer_wait_full", "wgmma", "upsample", "epilogue",
               "producer_wait_ready")
# (Hp, C) of the four upsample blocks of the r1024 decoder (64^2 feature map)
SHAPES = ((64, 256), (128, 128), (256, 64), (512, 32))
# the streamed kernel's: the 128^2 blocks of decoders at multipliers 8 and
# 16, the 1024^2 and 256^2 blocks at 17 (a tail pass of 64 channels), and
# the staged build's 128^2 blocks at 32 and 65
STREAMED_SHAPES = ((64, 1024), (64, 2048), (512, 272), (64, 1088), (64, 4096), (64, 8320))


def block_inputs(hp, c, dtype, hashed, device, seed=0):
    """A seeded prepared block and y1 (hp, hp, C) on `device`, C the
    kernel's (kernel_channels(c): zero-padded operands where c is not)."""
    gen = torch.Generator().manual_seed(seed + c)
    rnd = lambda *shape: torch.randn(shape, generator=gen).to(device)
    prep = kdb.decoder_block_prepare(
        rnd(2 * hp, 2 * hp, 1), rnd(2 * hp, 2 * hp, 1), rnd(c, c) / c**0.5,
        0.1 * rnd(c), 0.1 * rnd(c), 0.3, -0.2, rnd(c, 3) / c**0.5, dtype=dtype,
        noise_seeds=(123, 456) if hashed else None)
    return prep, rnd(hp, hp, kdb.kernel_channels(c)).to(dtype)


def phase_cycles(reset: bool, streamed: bool = False) -> list[int]:
    """The instrumented build's cycle counts by phase (of block_kernel, or
    of block_kernel_wide with `streamed`), set to 0 after with `reset`."""
    lib = _lib.load("decoder_block", DEFINES)
    fn = lib.decoder_block_wide_phase_cycles if streamed else lib.decoder_block_phase_cycles
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
    names = WIDE_PHASES if streamed else PHASES
    out = (ctypes.c_ulonglong * len(names))()
    n = ctypes.c_int(0)
    _lib.raise_on_error(fn(out, ctypes.byref(n), int(reset)), "decoder_block_phase_cycles")
    if n.value != len(names):
        raise RuntimeError(f"the kernel counts {n.value} phases, want {len(names)}")
    return list(out)


def measure(dtype: torch.dtype, hashed: bool, iters: int, device: torch.device,
            shapes=None, streamed: bool = False) -> dict:
    """The split at `shapes` ((Hp, C) pairs; SHAPES, or STREAMED_SHAPES
    with `streamed`). Of the resident kernel's shapes the last skips its
    feat store, as in a frame; the streamed ones all store it."""
    if device.type != "cuda":
        raise RuntimeError("the phase split runs on the card only")
    shapes = shapes or (STREAMED_SHAPES if streamed else SHAPES)
    names = WIDE_PHASES if streamed else PHASES
    out = {"dtype": str(dtype), "hash": hashed, "iters": iters, "streamed": streamed,
           "device": torch.cuda.get_device_name(device), "shapes": []}
    for i, (hp, c) in enumerate(shapes):
        prep, y1 = block_inputs(hp, c, dtype, hashed, device)
        emit_feat = streamed or i < len(shapes) - 1
        plain_build = lambda k: kdb.decoder_block_packed(y1, prepared=prep, emit_feat=emit_feat)
        marked = lambda k: kdb._launch(y1, prep, emit_feat, 1, DEFINES)
        # the instrumented build computes what the plain build computes
        got, want = marked(0), plain_build(0)
        for g, w in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            if not torch.equal(g, w):
                raise AssertionError("the instrumented build differs from the plain build")
        ms = _lib.device_ms(plain_build, iters, "block_kernel")
        marked_ms = _lib.device_ms(marked, iters, "block_kernel")
        torch.cuda.synchronize()
        phase_cycles(reset=True, streamed=streamed)
        for k in range(iters):
            marked(k)
        torch.cuda.synchronize()
        cycles = phase_cycles(reset=False, streamed=streamed)
        total = sum(cycles)
        out["shapes"].append({
            "y1": [hp, hp, c], "ms": ms, "instrumented_ms": marked_ms,
            "share": {p: v / total for p, v in zip(names, cycles)},
            "warp_cycles_per_launch": total / iters,
        })
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dtype", default="bfloat16", choices=("bfloat16", "float32"))
    ap.add_argument("--hash", action="store_true", help="noise hashed in the kernel")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--streamed", action="store_true",
                    help="the streamed-weight kernel at C = 1024, 2048, 272, 1088, 4096 "
                         "and 8320")
    args = ap.parse_args(argv)
    with torch.inference_mode():
        print(json.dumps(measure(getattr(torch, args.dtype), args.hash, args.iters,
                                 torch.device("cuda", 0), streamed=args.streamed)))


if __name__ == "__main__":
    main()
