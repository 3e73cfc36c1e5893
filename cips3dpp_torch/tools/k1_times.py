"""K1's device time at given geometries, on the card.

    python -m cips3dpp_torch.tools.k1_times [--geometries 512x12 512x24 256x24]
        [--rays 4096] [--root DIR] [--label L] [--cluster 1 2 4]

Each geometry WxS is a seeded depth-2 SDF renderer of width W (the model's
init) over R rays x S samples of random points, any width and sample
count K1 takes; its K1 library (the serving build at 256x24, else the
build the width runs in, padded: `kernel_defines`) is timed by the
profiler's device time over 50 launches (`_lib.device_ms`).
`--root` times the package under another checkout instead of this one
(its kernels built from its own sources there), so two versions compare
in one call on one card: run parent, change, change, parent. `--cluster`
times each geometry past width 256 (the wide kernel's builds) once at
each cluster size given, each in a library of its own built with
-DK1_WIDE_CLUSTER=n, the keys then ending in " CL=n". Prints one JSON
line: the label, the package's path, the card's name, {"WxS": ms} and
each library's registers and spills as ptxas reports them when this call
builds it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--geometries", nargs="+", default=["512x12", "512x20", "512x24", "512x48"])
    ap.add_argument("--rays", type=int, default=4096)
    ap.add_argument("--root", default=None, help="a checkout whose package is timed")
    ap.add_argument("--label", default="")
    ap.add_argument("--cluster", type=int, nargs="+", default=None,
                    help="cluster sizes of the wide kernel's builds to time")
    args = ap.parse_args(argv)
    if args.root is not None:
        root = os.path.abspath(args.root)
        sys.path.insert(0, root)
        for name in [m for m in sys.modules if m.split(".")[0] == "cips3dpp_torch"]:
            del sys.modules[name]
    import torch

    from cips3dpp_torch.kernels import _lib
    from cips3dpp_torch.kernels import siren_render as ksr
    from cips3dpp_torch.models.layers import init_parameters
    from cips3dpp_torch.models.renderer import VolumeFeatureRenderer

    if not torch.cuda.is_available():
        raise SystemExit("k1_times: needs a CUDA device")
    dev = torch.device("cuda", 0)
    geos = [tuple(int(v) for v in spec.split("x")) for spec in args.geometries]
    jobs = {}
    for w, s in geos:
        for cl in (args.cluster if args.cluster and w > 256 else (None,)):
            extra = () if cl is None else (f"-DK1_WIDE_CLUSTER={cl}",)
            jobs[(w, s, cl)] = ksr.kernel_defines(w, s) + extra
    reports = _lib.build([("siren_render", d) for d in jobs.values()])
    out = {"label": args.label, "package": os.path.dirname(os.path.dirname(ksr.__file__)),
           "card": torch.cuda.get_device_name(dev), "rays": args.rays, "ms": {},
           "ptxas": {label: [ln.split(":", 1)[-1].strip() for ln in rep.splitlines()
                             if "registers" in ln or "spill" in ln]
                     for label, rep in reports.items()}}
    with torch.inference_mode():
        for (w, s, cl), defines in jobs.items():
            gen = torch.Generator().manual_seed(w + s)
            rend = init_parameters(VolumeFeatureRenderer(depth=2, hidden_dim=w), gen).to(dev)
            styles = torch.randn((3, 256), generator=gen).to(dev)
            r = args.rays
            pts = (0.1 * torch.randn((r, s, 3), generator=gen)).to(dev)
            vd = torch.nn.functional.normalize(torch.randn((r, 3), generator=gen), dim=-1).to(dev)
            z = (torch.linspace(0.88, 1.12, s)[None]
                 + 1e-3 * torch.randn((r, 1), generator=gen)).to(dev)
            dnorm = torch.linalg.norm(1.05 * vd, dim=-1, keepdim=True)
            prep = ksr.siren_prepare(rend, styles, torch.tensor(0.88, device=dev),
                                     torch.tensor(1.12, device=dev))
            extra = defines[len(ksr.kernel_defines(w, s)):]
            ms = _lib.device_ms(lambda i: ksr._launch(prep, pts, vd, z, dnorm, extra), 50,
                                "siren_render_kernel")
            out["ms"][f"{w}x{s}" + ("" if cl is None else f" CL={cl}")] = ms
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
