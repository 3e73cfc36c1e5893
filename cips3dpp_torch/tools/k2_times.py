"""K2's device time at given y1 shapes, in its four modes, on the card.

    python -m cips3dpp_torch.tools.k2_times [--shapes 64x64x1024 64x64x8192]
        [--root DIR] [--label L] [--cluster 2 4]

Each shape HpxWpxC is a y1 of one frame with feat stored and ToRGB folded,
on seeded random operands (at the kernel's channel count where C is
padded to one; Wp a multiple of 16); each mode (bf16 / f32 storage x noise buffers /
hash noise) is timed by the profiler's device time over 50 launches
(`_lib.device_ms`). `--root` times the package under another checkout
instead of this one (its kernels built from its own sources there), so two
versions compare in one call on one card: run parent, change, change,
parent. `--cluster` times the streamed-weight kernel (is_streamed) once at
each cluster size given, each in a library of its own built with
-DDBLOCK_WIDE_CLUSTER=n (`cluster_defines`; the packages since the
cluster kernel), the keys then ending in " CL=n". Prints one JSON line:
the label, the package's path, the card's name and {"C=c y1=hp x wp
mode": ms}.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def cluster_defines(cluster: int) -> tuple[str, ...]:
    """The extra nvcc flags of a decoder_block library whose streamed-weight
    kernel runs clusters of `cluster` CTAs."""
    return (f"-DDBLOCK_WIDE_CLUSTER={int(cluster)}",)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shapes", nargs="+", default=["64x64x1024", "64x64x2048", "64x64x2176",
                                                    "64x64x4096", "64x64x8192"])
    ap.add_argument("--root", default=None, help="a checkout whose package is timed")
    ap.add_argument("--label", default="")
    ap.add_argument("--cluster", type=int, nargs="+", default=None,
                    help="cluster sizes of the streamed-weight kernel to time")
    args = ap.parse_args(argv)
    if args.root is not None:
        root = os.path.abspath(args.root)
        sys.path.insert(0, root)
        for name in [m for m in sys.modules if m.split(".")[0] == "cips3dpp_torch"]:
            del sys.modules[name]
    import torch

    from cips3dpp_torch.kernels import _lib
    from cips3dpp_torch.kernels import decoder_block as kdb

    if not torch.cuda.is_available():
        raise SystemExit("k2_times: needs a CUDA device")
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(5)
    rnd = lambda *shape: torch.randn(shape, generator=gen).to(dev)
    out = {"label": args.label, "package": os.path.dirname(os.path.dirname(kdb.__file__)),
           "card": torch.cuda.get_device_name(dev), "ms": {}}
    with torch.inference_mode():
        for spec in args.shapes:
            hp, wp, c = (int(v) for v in spec.split("x"))
            for dt in (torch.bfloat16, torch.float32):
                for hashed in (False, True):
                    bp = kdb.decoder_block_prepare(
                        rnd(2 * hp, 2 * wp, 1), rnd(2 * hp, 2 * wp, 1), rnd(c, c) / c**0.5,
                        0.1 * rnd(c), 0.1 * rnd(c), 0.3, -0.2, rnd(c, 3) / c**0.5, dtype=dt,
                        noise_seeds=(1, 2) if hashed else None)
                    # at the kernel's C (the block's, or the count it is
                    # padded to); Wp a multiple of 16
                    y1 = torch.randn((hp, wp, bp["w2t"].shape[0]), generator=gen).to(dev, dt)
                    key = f"C={c} y1={hp}x{wp} {kdb.launch_name(bp)}"
                    streamed = args.cluster and kdb.is_streamed(kdb.kernel_channels(c))
                    for cl in args.cluster if streamed else (None,):
                        defines = () if cl is None else cluster_defines(cl)
                        ms = _lib.device_ms(lambda i: kdb._launch(y1, bp, True, 1, defines),
                                            50, "block_kernel")
                        out["ms"][key + ("" if cl is None else f" CL={cl}")] = ms
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
