"""Where K1's time goes, phase by phase, on the card.

    python -m cips3dpp_torch.tools.siren_phase_split [--rays 4096] [--iters 20]

Builds `csrc/siren_render.cu` a second time with -DSIREN_PHASE_CLOCKS, in
which thread 0 of each block adds the SM clock cycles of each phase of a
tile (constants, inputs, layer 0, layer 1 product, its epilogue, sigma and
alpha, transmittance, view product, view epilogue, feat output, thumb) to a
counter; each mark follows a block barrier, some of them added by the
instrumentation. Runs it at the serving shape (R rays x 24 samples, width
256, a seeded renderer) and prints one JSON line: each phase's share of the
blocks' cycles, the device time a launch (torch.profiler) of the plain and
the instrumented builds, so the cost of the marks can be read beside the
split.
"""

from __future__ import annotations

import argparse
import ctypes
import json

import torch

from ..kernels import _lib
from ..kernels import siren_render as ksr

DEFINES = ("-DSIREN_PHASE_CLOCKS",)
PHASES = ("constants", "inputs", "layer0", "layer1_product", "layer1_epilogue_sdf_head",
          "sigma_alpha", "transmittance", "view_product", "view_epilogue_feat_rgb_head",
          "feat_out_rgb_sigmoid", "thumb")


def serving_inputs(rays: int, device: torch.device, seed: int = 0):
    """A seeded width-256 renderer prepared for one style, and R rays of 24
    samples: the arguments of `siren_render_prepared`."""
    from ..models.layers import init_parameters
    from ..models.renderer import VolumeFeatureRenderer

    gen = torch.Generator().manual_seed(seed)
    rend = init_parameters(VolumeFeatureRenderer(depth=2), gen).to(device)
    s = 24
    styles = torch.randn((3, 256), generator=gen).to(device)
    pts = (0.1 * torch.randn((rays, s, 3), generator=gen)).to(device)
    vd = torch.nn.functional.normalize(torch.randn((rays, 3), generator=gen), dim=-1).to(device)
    z = (torch.linspace(0.88, 1.12, s)[None]
         + 1e-3 * torch.randn((rays, 1), generator=gen)).to(device)
    prep = ksr.siren_prepare(rend, styles, torch.tensor(0.88, device=device),
                             torch.tensor(1.12, device=device))
    return prep, pts, vd, z, 1.05 * vd


def phase_cycles(reset: bool) -> list[int]:
    lib = _lib.load("siren_render", DEFINES)
    fn = lib.siren_render_phase_cycles
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
    out = (ctypes.c_ulonglong * len(PHASES))()
    n = ctypes.c_int(0)
    _lib.raise_on_error(fn(out, ctypes.byref(n), int(reset)), "siren_render_phase_cycles")
    if n.value != len(PHASES):
        raise RuntimeError(f"the kernel counts {n.value} phases, want {len(PHASES)}")
    return list(out)


def measure(rays: int, iters: int, device: torch.device) -> dict:
    if device.type != "cuda":
        raise RuntimeError("the phase split runs on the card only")
    prep, pts, vd, z, rd = serving_inputs(rays, device)
    dnorm = torch.linalg.norm(rd, dim=-1, keepdim=True)
    plain_build = lambda i: ksr.siren_render_prepared(prep, pts, vd, z, rd)
    marked = lambda i: ksr._launch(prep, pts, vd, z, dnorm, DEFINES)
    # the instrumented build computes what the plain build computes
    for g, w in zip(marked(0), plain_build(0)):
        if not torch.equal(g, w):
            raise AssertionError("the instrumented build differs from the plain build")
    ms = _lib.device_ms(plain_build, iters, "siren_render_kernel")
    marked_ms = _lib.device_ms(marked, iters, "siren_render_kernel")
    torch.cuda.synchronize()
    phase_cycles(reset=True)
    for i in range(iters):
        marked(i)
    torch.cuda.synchronize()
    cycles = phase_cycles(reset=False)
    total = sum(cycles)
    return {
        "rays": rays, "samples": 24, "width": 256, "iters": iters,
        "device": torch.cuda.get_device_name(device),
        "ms": ms, "instrumented_ms": marked_ms,
        "share": {p: c / total for p, c in zip(PHASES, cycles)},
        "block_cycles_per_launch": total / iters,
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rays", type=int, default=4096)
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    with torch.inference_mode():
        print(json.dumps(measure(args.rays, args.iters, torch.device("cuda", 0))))


if __name__ == "__main__":
    main()
