"""Where a served frame's gap to the plain path comes from, on the card.

    python -m cips3dpp_torch.tools.frame_gap_split [--multipliers 1 2 4] [--seeds 1234 1241]
        [--preset serving|r1024] [--width 256]

For each channel multiplier and seed: a full-width preset_serving
Generator (bf16 storage; preset_r1024 with `--preset r1024`, the f32
decoder of the sampling trajectories) with only the multiplier changed,
and the renderer's width with `--width` (512 takes K1's wide kernel);
weights from the seed, its zero-initialised noise weights and biases set
to draws, as chip_smoke.py's models; one identity's r1024 frame at yaw -0.3 through prepare_trajectory
/ render_frame, rendered four ways: both kernels (K1 and K2), K2's plain
version only, K1's plain version only, and both plain. Then the plain path
once more in one F = 4 call, whose cuBLAS GEMMs take another order: its
gap to the F = 1 plain frame is the spread of bf16 flips that any change of
f32 sum order gives; and once more with each of K1's products over the
width summed in 16-wide slices, slice after slice (`k1_sums_reordered`),
the spread of the flips that a change of K1's own sum order gives, which
at width 512 exceeds the first. Prints one JSON line a (multiplier, seed): max / mean |diff| of the
kernel frame to each of the others, the plain path's two spreads, the mean
|rgb|, and the card's name.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json

import torch


@contextlib.contextmanager
def plain(k1: bool, k2: bool):
    """The serving path with the plain versions of K1 and / or K2."""
    from .. import serving
    from ..kernels import decoder_block as kdb
    from ..kernels import decoder_fused as kdf
    from ..kernels import siren_render as ksr

    saved = serving.siren_render_prepared, ksr.siren_render_prepared, kdf.decoder_block_packed
    if k1:
        serving.siren_render_prepared = ksr.siren_render_prepared = (
            lambda p, pts, vd, z, d: ksr.siren_render_plain(
                p, pts, vd, z, torch.linalg.norm(d, dim=-1, keepdim=True)))
    if k2:
        kdf.decoder_block_packed = lambda y1, prepared, emit_feat=True, frames=1: \
            kdb.decoder_block_plain(y1, prepared, emit_feat, frames)
    try:
        yield
    finally:
        serving.siren_render_prepared, ksr.siren_render_prepared, kdf.decoder_block_packed = saved


@contextlib.contextmanager
def k1_sums_reordered(step: int = 16):
    """K1's plain version with each of its products over the width (layer
    1, the view layer, the two heads) summed in slices of `step` input
    features, slice after slice, as a kernel's tensor-core steps sum them:
    the same arithmetic and rounding points in another f32 summation
    order."""
    from ..kernels import siren_render as ksr

    saved = ksr._bdot

    def sliced(a, b):
        k = b.shape[0]
        if k <= step:  # layer 0 and the view term: K = 3
            return saved(a, b)
        out = saved(a[..., :step], b[:step])
        for i in range(step, k, step):
            out = out + saved(a[..., i:i + step], b[i:i + step])
        return out

    ksr._bdot = sliced
    try:
        yield
    finally:
        ksr._bdot = saved


def k1_bounds(tol: dict, prepared, pts, viewdirs, z_vals, dnorm) -> dict:
    """K1's bounds against its plain version by output (keys of `tol`, in
    the order the render returns them): `tol` up to width 512; past it,
    where the products sum over 640 or more features and the bf16 flips of
    any change of f32 order grow with them, the larger of `tol` and 1.5x
    the plain version's own spread under another sum order of its
    products (`k1_sums_reordered`) on the same inputs."""
    from ..kernels import siren_render as ksr

    if ksr.kernel_build(prepared["width"], pts.shape[1]).width <= ksr.WIDE_WIDTH:
        return dict(tol)
    want = ksr.siren_render_plain(prepared, pts, viewdirs, z_vals, dnorm)
    with k1_sums_reordered():
        other = ksr.siren_render_plain(prepared, pts, viewdirs, z_vals, dnorm)
    spread = {k: float((a - b).abs().max()) for k, a, b in zip(tol, want, other)}
    return {k: max(tol[k], 1.5 * spread[k]) for k in tol}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--multipliers", type=int, nargs="+", default=[1, 2, 4])
    ap.add_argument("--seeds", type=int, nargs="+", default=[1234, 1241])
    ap.add_argument("--preset", choices=("serving", "r1024"), default="serving")
    ap.add_argument("--width", type=int, default=None, help="the renderer's hidden_dim")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("frame_gap_split: needs a CUDA device")
    from .. import serving
    from ..kernels.siren_render import plain_precision
    from ..models.generator import Generator, preset_r1024, preset_serving
    from ..models.layers import randomize_zero_init_

    plain_precision()
    dev = torch.device("cuda", 0)
    base = preset_serving() if args.preset == "serving" else preset_r1024()
    if args.width is not None:
        base = dataclasses.replace(base, renderer=dataclasses.replace(base.renderer,
                                                                      hidden_dim=args.width))
    yaws = torch.linspace(-0.3, 0.3, 4, device=dev)
    gap = lambda a, b: [float((a - b).abs().max()), float((a - b).abs().mean())]
    with torch.inference_mode():
        for m in args.multipliers:
            for seed in args.seeds:
                cfg = dataclasses.replace(base, decoder=dataclasses.replace(
                    base.decoder, channel_multiplier=m))
                model = Generator(cfg, device=dev, seed=seed)
                randomize_zero_init_(model, torch.Generator().manual_seed(seed))
                gen = torch.Generator().manual_seed(seed + 1)
                zs = [torch.randn((1, cfg.mapping.z_dim), generator=gen).to(dev)
                      for _ in range(2)]
                noise = model.decoder.make_noise(gen, cfg.img_size, device=dev)
                prep = serving.prepare_trajectory(model, zs, noise_bufs=noise, device=dev)
                frame = lambda: serving.render_frame(model, prep, yaws[:1], yaws[:1] * 0,
                                                     device=dev)["rgb"]
                got = frame()
                with plain(False, True):
                    k2_plain = frame()
                with plain(True, False):
                    k1_plain = frame()
                with plain(True, True):
                    both = frame()
                    own = serving.render_frame(model, prep, yaws, yaws * 0, device=dev)["rgb"][:1]
                    with k1_sums_reordered():
                        reordered = frame()
                print(json.dumps({
                    "preset": args.preset, "channel_multiplier": m, "seed": seed,
                    "width": cfg.renderer.hidden_dim,
                    "to_k2_plain": gap(got, k2_plain), "to_k1_plain": gap(got, k1_plain),
                    "to_plain": gap(got, both), "plain_own_spread": gap(own, both),
                    "plain_k1_reorder_spread": gap(reordered, both),
                    "mean_abs_rgb": float(both.abs().mean()),
                    "card": torch.cuda.get_device_name(dev)}), flush=True)
                del model, prep
                torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
