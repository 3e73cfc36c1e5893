"""Where K1's time goes, phase by phase, on the card.

    python -m cips3dpp_torch.tools.siren_phase_split [--rays 4096] [--iters 20]
        [--width 256] [--samples 24]

Builds the K1 library of the geometry (`kernel_defines`) a second time
with -DSIREN_PHASE_CLOCKS and runs it on a seeded renderer of `--width`
over R rays x `--samples` samples (default: the serving shape, 4096 x 24
at width 256); any width K1 takes runs in its build, padded
(`kernel_build`). Up to width 256, thread 0 of each block adds the SM clock
cycles of each phase of a tile (constants, inputs, layer 0, layer 1
product, its epilogue, sigma and alpha, transmittance, view product, view
epilogue, feat output, thumb) to a counter; each mark follows a block
barrier, some of them added by the instrumentation. Past 256
(siren_render_kernel_wide) every warp counts its own cycles by phase and
no barrier is added: the producer's waits for an empty ring slot (past
512 also for h0 and h1 to be complete in the scratch), the
consumers' inputs and layer 0, and for each product the waits for a full
slot, wgmma (issue and group waits) and the epilogue, then integration and
the outputs. Prints one JSON line: each phase's share of the counted
cycles, the device time a launch (torch.profiler) of the plain and the
instrumented builds, so the cost of the marks can be read beside the
split, and the card's name.
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
# the wide kernel's (csrc/siren_render.cu, enum WidePhase)
WIDE_PHASES = ("producer_wait_empty", "inputs_layer0", "layer1_wait_full", "layer1_wgmma",
               "layer1_epilogue_sdf_head", "integration", "view_wait_full", "view_wgmma",
               "view_epilogue_feat_rgb_head", "outputs")


def phases(width: int) -> tuple[str, ...]:
    """The phase names of the K1 build that renders `width`."""
    return WIDE_PHASES if ksr.kernel_build(width, 1).width >= ksr.WIDE_WIDTH else PHASES


def render_inputs(rays: int, device: torch.device, width: int = 256, samples: int = 24,
                  seed: int = 0):
    """A seeded renderer of `width` prepared for one style, and R rays of
    `samples` samples: the arguments of `siren_render_prepared`."""
    from ..models.layers import init_parameters
    from ..models.renderer import VolumeFeatureRenderer

    gen = torch.Generator().manual_seed(seed)
    rend = init_parameters(VolumeFeatureRenderer(depth=2, hidden_dim=width), gen).to(device)
    styles = torch.randn((3, 256), generator=gen).to(device)
    pts = (0.1 * torch.randn((rays, samples, 3), generator=gen)).to(device)
    vd = torch.nn.functional.normalize(torch.randn((rays, 3), generator=gen), dim=-1).to(device)
    z = (torch.linspace(0.88, 1.12, samples)[None]
         + 1e-3 * torch.randn((rays, 1), generator=gen)).to(device)
    prep = ksr.siren_prepare(rend, styles, torch.tensor(0.88, device=device),
                             torch.tensor(1.12, device=device))
    return prep, pts, vd, z, 1.05 * vd


def phase_cycles(reset: bool, width: int = 256, samples: int = 24) -> list[int]:
    names = phases(width)
    lib = _lib.load("siren_render", ksr.kernel_defines(width, samples) + DEFINES)
    fn = lib.siren_render_phase_cycles
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
    out = (ctypes.c_ulonglong * len(names))()
    n = ctypes.c_int(0)
    _lib.raise_on_error(fn(out, ctypes.byref(n), int(reset)), "siren_render_phase_cycles")
    if n.value != len(names):
        raise RuntimeError(f"the kernel counts {n.value} phases, want {len(names)}")
    return list(out)


def measure(rays: int, iters: int, device: torch.device, width: int = 256,
            samples: int = 24) -> dict:
    if device.type != "cuda":
        raise RuntimeError("the phase split runs on the card only")
    prep, pts, vd, z, rd = render_inputs(rays, device, width, samples)
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
    phase_cycles(True, width, samples)
    for i in range(iters):
        marked(i)
    torch.cuda.synchronize()
    cycles = phase_cycles(False, width, samples)
    total = sum(cycles)
    return {
        "rays": rays, "samples": samples, "width": width, "iters": iters,
        "device": torch.cuda.get_device_name(device),
        "ms": ms, "instrumented_ms": marked_ms,
        "share": {p: c / total for p, c in zip(phases(width), cycles)},
        "cycles_per_launch": total / iters,
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rays", type=int, default=4096)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--width", type=int, default=256,
                    help="any width >= 1: K1's widths (kernel_build)")
    ap.add_argument("--samples", type=int, default=24)
    args = ap.parse_args(argv)
    if args.width < 1:
        ap.error(f"--width {args.width}: K1 takes widths 1 and up")
    with torch.inference_mode():
        print(json.dumps(measure(args.rays, args.iters, torch.device("cuda", 0), args.width,
                                 args.samples)))


if __name__ == "__main__":
    main()
