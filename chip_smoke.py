"""Smoke run of the PyTorch port on one NVIDIA GPU (written for the H100).

    python3 chip_smoke.py [--profile]

Phases, each fatal on failure:
  1. device: name and power limit (nvidia-smi), torch and CUDA versions;
  2. build: nvcc compiles every kernel in cips3dpp_torch/csrc, one process
     per source, in parallel;
  3. K1 (SIREN render) against its plain PyTorch version at the serving
     shape (4096 rays x 24 samples, width 256), with timings;
  4. K2 (decoder upsample block) against its plain version at the four
     serving block shapes, with timings;
  5. the slice: a seeded full-width preset_serving Generator renders r1024
     frames through prepare_trajectory / render_frame (8 yaws at F=1, one
     F=4 call); the launch counters must show 1 K1 + 4 K2 per call; the
     F=1 and F=4 frames are compared with the plain path on the card, and
     each path's F=4 frames with its own F=1 frames;
  6. with --profile only: torch.profiler over 10 frames, device time per
     kernel and the device idle share (table in chiprun_out/profile_frame.txt).
Then one JSON line with every kernel's numbers, and as the last line
{"ok": true, "device": {...}}. A longer report goes to
chiprun_out/chip_smoke.json. Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
PEAK_BF16 = 989e12  # H100 SXM dense bf16 FLOP/s (NVIDIA data sheet)
PEAK_F32 = 67e12  # f32 FLOP/s outside the tensor cores
PEAK_BYTES = 3.35e12  # HBM3 bytes/s
SEED = 1234


def log(*args):
    print(*args, flush=True)


def cuda_time(fn, iters, warmup=2):
    """Mean ms per call of fn() on the current stream (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes, bf16_flops=0.0, f32_flops=0.0):
    """Least time in ms for the work: the larger of bytes over the memory
    rate and operations over the peak rate of their type."""
    times = {"bytes": nbytes / PEAK_BYTES,
             "operations": max(bf16_flops / PEAK_BF16, f32_flops / PEAK_F32)}
    by = max(times, key=times.get)
    return times[by] * 1e3, by


def max_err(a, b):
    return float((a.float() - b.float()).abs().max())


def profile_frames(render, frame_ms, n=10):
    """Device time per frame by kernel over n frames (torch.profiler), the
    groups K1 / K2 / matmul / other, and the device idle share against the
    unprofiled frame time. The full table goes to chiprun_out/."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    render()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            render()
        torch.cuda.synchronize()
    avgs = prof.key_averages()
    dev_events = [e for e in avgs if e.device_type == DeviceType.CUDA]
    if not dev_events:
        raise AssertionError("profile: the trace holds no device time")

    def group(name):
        if "siren_render" in name:
            return "K1 siren_render"
        if "decoder_block" in name:
            return "K2 decoder_block"
        if any(s in name for s in ("gemm", "xmma", "cutlass", "sm90")):
            return "matmul (cuBLAS)"
        return "other (elementwise, copies, reductions)"

    kernels = sorted(
        ({"name": e.key, "group": group(e.key), "calls_per_frame": e.count / n,
          "ms_per_frame": e.self_device_time_total / 1e3 / n} for e in dev_events),
        key=lambda k: -k["ms_per_frame"])
    groups = {}
    for k in kernels:
        groups[k["group"]] = groups.get(k["group"], 0.0) + k["ms_per_frame"]
    busy = sum(groups.values())
    out = {"frames": n, "device_ms_per_frame": busy, "frame_ms": frame_ms,
           "idle_share": 1.0 - busy / frame_ms, "groups": groups,
           "kernels": kernels[:25]}
    for g, ms in sorted(groups.items(), key=lambda x: -x[1]):
        log(f"[profile] {g}: {ms:.4f} ms/frame ({100 * ms / busy:.1f}% of device time)")
    log(f"[profile] device busy {busy:.4f} ms of a {frame_ms:.4f} ms frame "
        f"(idle share {out['idle_share']:.3f})")
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "profile_frame.txt"), "w") as fh:
        fh.write(avgs.table(sort_by="self_cuda_time_total", row_limit=60))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device")
        return 1
    sys.path.insert(0, ROOT)
    from cips3dpp_torch.kernels import _lib
    from cips3dpp_torch.kernels import decoder_block as kdb
    from cips3dpp_torch.kernels import decoder_fused as kdf
    from cips3dpp_torch.kernels import siren_render as ksr
    from cips3dpp_torch.models.generator import Generator, preset_serving
    from cips3dpp_torch.models.layers import randomize_zero_init_
    from cips3dpp_torch import serving

    report = {}
    dev = torch.device("cuda", 0)
    ksr.plain_precision()  # the plain versions are f32 references

    # ---- 1. device ----
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"[device] {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s)")
    report["device"] = smi

    # ---- 2. build ----
    t0 = time.time()
    ptxas = _lib.build_all()
    build_s = time.time() - t0
    log(f"[build] {len(ptxas)} libraries built in {build_s:.1f} s")
    report["build_s"] = build_s
    report["ptxas"] = ptxas

    # ---- model and trajectory state (shared by phases 3-5) ----
    cfg = preset_serving()
    model = Generator(cfg, device=dev, seed=SEED)
    randomize_zero_init_(model, torch.Generator().manual_seed(SEED))
    gen = torch.Generator().manual_seed(SEED + 1)
    zs = [torch.randn((1, cfg.mapping.z_dim), generator=gen).to(dev) for _ in range(2)]
    noise = model.decoder.make_noise(gen, cfg.img_size, device=dev)
    prep = serving.prepare_trajectory(model, zs, noise_bufs=noise, device=dev)
    kernels = []

    # ---- 3. K1 against its plain version ----
    from cips3dpp_torch.core.camera import camera_from_angles
    from cips3dpp_torch.core.rays import prepare_nerf_inputs

    cam = camera_from_angles(torch.full((1,), 0.2, device=dev),
                             torch.full((1,), -0.05, device=dev), cfg.img_size)
    pts, rays_d, viewdirs, z_vals = prepare_nerf_inputs(
        cam.focal, cfg.img_size, cam.extrinsics, cam.near, cam.far, cfg.n_samples)
    flat = lambda a: a.reshape(-1, *a.shape[3:]).contiguous()
    args = (prep["siren"], flat(pts), flat(viewdirs), flat(z_vals), flat(rays_d))
    r, s = args[1].shape[:2]
    width = cfg.renderer.hidden_dim
    dnorm = torch.linalg.norm(args[4], dim=-1, keepdim=True)
    got = ksr.siren_render_prepared(*args)
    want = ksr.siren_render_plain(*args[:4], dnorm)
    torch.cuda.synchronize()
    # same arithmetic; only f32 summation orders differ, and bf16 flips
    # they cause are amplified by gamma ~ 30-45 in the sin (the bounds of
    # the CPU parity test, tests/test_torch_port_siren.py)
    tol = {"thumb": 1e-2, "feat": 6e-2, "sdf": 1e-2, "mask_depth": 1e-2, "xyz": 1e-3}
    errs = {k: max_err(g, w) for k, g, w in zip(tol, got, want)}
    log(f"[K1] max |kernel - plain| {errs} (bounds {tol})")
    if not all(torch.isfinite(g).all() for g in got):
        raise AssertionError("K1 output not finite")
    bad = {k: e for k, e in errs.items() if not e <= tol[k]}
    if bad:
        raise AssertionError(f"K1 disagrees with its plain version: {bad}")
    # the kernel sums in a fixed order: a second launch gives the same bits
    again = ksr.siren_render_prepared(*args)
    if not all(torch.equal(g, a) for g, a in zip(got, again)):
        raise AssertionError("K1 differs from itself on the same inputs")
    log("[K1] two launches on the same inputs agree bit for bit")
    k1_ms = cuda_time(lambda: ksr.siren_render_prepared(*args), iters=50)
    k1_plain_ms = cuda_time(lambda: ksr.siren_render_plain(*args[:4], dnorm), iters=5)
    rows = r * s
    k1_bytes = 4 * (rows * 3 + r * 3 + rows + r  # pts, viewdirs, z, |d|
                    + r * (3 + width + 3 + 2) + rows)  # thumb, feat, xyz, maskd, sdf
    k1_bytes += 2 * 2 * width * width + 4 * (width * 17 + 4)  # weights
    k1_bf16 = rows * 2 * (2 * width * width)  # layer 1 + view layer
    # f32 on the CUDA cores per (row, channel): layer 0 (6), three phases
    # (2 each) and sines (13 each), sdf and rgb heads (2 + 6), feat sum (2)
    k1_f32 = rows * width * (6 + 3 * (2 + 13) + 8 + 2)
    k1_bound, k1_by = bound(k1_bytes, k1_bf16, k1_f32)
    log(f"[K1] {k1_ms:.4f} ms kernel, {k1_plain_ms:.4f} ms plain, bound "
        f"{k1_bound:.4f} ms ({k1_by}) at R={r}, S={s}, W={width}")
    kernels.append({
        "name": "siren_render", "route": "cuda",
        "source": "cips3dpp_torch/csrc/siren_render.cu",
        "replaces": "cips3dpp_tpu/kernels/siren_render.py:140",
        "max_abs_err": max(errs.values()), "ms": k1_ms, "plain_ms": k1_plain_ms,
        "bound_ms": k1_bound, "bound_by": k1_by, "library_ms": None,
    })
    report["K1"] = {"errs": errs, "ms": k1_ms, "plain_ms": k1_plain_ms,
                    "bound_ms": k1_bound, "bound_by": k1_by, "bytes": k1_bytes,
                    "bf16_flops": k1_bf16, "f32_flops": k1_f32}

    # ---- 4. K2 against its plain version at the four block shapes ----
    blocks = [b for b in prep["dec"]["blocks"] if "bp" in b]
    k2 = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "err": 0.0,
          "bytes": 0.0, "flops": 0.0, "shapes": []}
    hp = cfg.img_size
    for i, blk in enumerate(blocks):
        bp = blk["bp"]
        c = bp["w2t"].shape[0]
        last = i == len(blocks) - 1
        y1 = torch.randn((hp, hp, c), generator=gen).to(dev, torch.bfloat16)
        got = kdb.decoder_block_packed(y1, prepared=bp, emit_feat=not last)
        want = kdb.decoder_block_plain(y1, bp, emit_feat=not last)
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for g, w in zip(got, want):
            if not torch.isfinite(g.float()).all():
                raise AssertionError(f"K2 C={c}: output not finite")
            # a bf16 activation that rounds the other way moves a feature
            # by one bf16 ulp (2^-8 relative) and rgb by that times |wrgb|
            torch.testing.assert_close(g.float(), w.float(), rtol=1.6e-2, atol=2e-2)
        err = max(max_err(g, w) for g, w in zip(got, want))
        ms = cuda_time(lambda: kdb.decoder_block_packed(y1, prepared=bp, emit_feat=not last),
                       iters=50)
        plain_ms = cuda_time(lambda: kdb.decoder_block_plain(y1, bp, emit_feat=not last),
                             iters=5)
        px = 4 * hp * hp
        nbytes = (2 * hp * hp * c + 2 * 2 * px  # y1, two noise maps (bf16)
                  + (0 if last else 2 * px * c) + 4 * px * 3  # feat, rgb
                  + 2 * c * c + 4 * (2 * c + 2) + 2 * 3 * c)  # weights
        flops = 2 * px * c * c + 2 * px * c * 3
        b_ms, b_by = bound(nbytes, bf16_flops=flops)
        log(f"[K2] y1 ({hp},{hp},{c}) feat {'skipped' if last else 'stored'}: "
            f"max |kernel - plain| {err:.3e}; {ms:.4f} ms kernel, {plain_ms:.4f} ms "
            f"plain, bound {b_ms:.4f} ms ({b_by}, {nbytes / 1e6:.2f} MB)")
        k2["shapes"].append({"y1": [hp, hp, c], "feat": not last, "err": err,
                             "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                             "bound_by": b_by, "bytes": nbytes})
        k2["ms"] += ms
        k2["plain_ms"] += plain_ms
        k2["bound_ms"] += b_ms
        k2["err"] = max(k2["err"], err)
        k2["bytes"] += nbytes
        k2["flops"] += flops
        hp *= 2
    k2_by = "bytes" if k2["bytes"] / PEAK_BYTES > k2["flops"] / PEAK_BF16 else "operations"
    kernels.append({
        "name": "decoder_block", "route": "cuda",
        "source": "cips3dpp_torch/csrc/decoder_block.cu",
        "replaces": "cips3dpp_tpu/kernels/decoder_block.py:362",
        "max_abs_err": k2["err"], "ms": k2["ms"], "plain_ms": k2["plain_ms"],
        "bound_ms": k2["bound_ms"], "bound_by": k2_by, "library_ms": None,
    })
    report["K2"] = k2

    # ---- 5. the slice: r1024 frames through the serving entry points ----
    yaws = torch.linspace(-0.3, 0.3, 8, device=dev)
    zero = torch.zeros(1, device=dev)
    _lib.reset_launches()
    frames = [serving.render_frame(model, prep, yaws[i:i + 1], zero, device=dev)["rgb"]
              for i in range(len(yaws))]
    batched = serving.render_frame(model, prep, yaws[:4], yaws[:4] * 0, device=dev)["rgb"]
    torch.cuda.synchronize()
    launches = dict(_lib.LAUNCHES)
    calls = len(yaws) + 1
    log(f"[slice] launches over {calls} render_frame calls: {launches}")
    if launches.get("siren_render") != calls or launches.get("decoder_block") != 4 * calls:
        raise AssertionError(f"want {calls} K1 and {4 * calls} K2 launches, got {launches}")
    for k in kernels:
        k["launches"] = launches[k["name"]]
    out = frames[0]
    if out.shape != (1, 1024, 1024, 3) or batched.shape != (4, 1024, 1024, 3):
        raise AssertionError(f"frame shapes {tuple(out.shape)}, {tuple(batched.shape)}")
    if not all(torch.isfinite(f).all() for f in frames + [batched]):
        raise AssertionError("non-finite pixels")
    diffs = [max_err(frames[i], frames[i + 1]) for i in range(len(frames) - 1)]
    if min(diffs) <= 1e-3:
        raise AssertionError(f"neighbouring yaws give the same image: {diffs}")
    # fixed noise, no perturbation: the same camera gives the same bits
    again = serving.render_frame(model, prep, yaws[:1], zero, device=dev)["rgb"]
    if not torch.equal(again, out):
        raise AssertionError(f"a frame differs from itself: max {max_err(again, out):.3e}")
    log("[slice] the same camera rendered twice gives the same bits")
    @contextlib.contextmanager
    def plain_kernels():
        """The same entry points with both kernels' plain versions."""
        sr, db = serving.siren_render_prepared, kdf.decoder_block_packed

        def siren_plain(p, pts, viewdirs, z_vals, rays_d):
            dn = torch.linalg.norm(rays_d, dim=-1, keepdim=True)
            return ksr.siren_render_plain(p, pts, viewdirs, z_vals, dn)

        def block_plain(y1, prepared, emit_feat=True, frames=1):
            return kdb.decoder_block_plain(y1, prepared, emit_feat, frames)

        serving.siren_render_prepared, kdf.decoder_block_packed = siren_plain, block_plain
        try:
            yield
        finally:
            serving.siren_render_prepared, kdf.decoder_block_packed = sr, db

    with plain_kernels():
        ref = serving.render_frame(model, prep, yaws[:1], zero, device=dev)["rgb"]
        ref_batched = serving.render_frame(model, prep, yaws[:4], yaws[:4] * 0,
                                           device=dev)["rgb"]
        ref_alone = [serving.render_frame(model, prep, yaws[i:i + 1], zero,
                                          device=dev)["rgb"] for i in range(4)]

    def gap(x, y):
        d = (x - y).abs()
        return float(d.max()), float(d.mean())

    # bounds: bf16 flips in the SIREN (feat up to 6e-2, K1 bounds above)
    # carried through the decoder; the mean stays at the flip rate
    gaps = {
        "frame vs plain (F=1)": gap(out, ref),
        "F=4 frames vs plain F=4": gap(batched, ref_batched),
        # the same frames alone and in one F=4 call: the kernels' own
        # per-frame work does not change with F (K1 sums in a fixed order,
        # K2 zeroes the halo at frame edges); cuBLAS may pick another GEMM
        # for 4x the rows, and its f32 sums move bf16 roundings
        "F=4 vs F=1, kernels": gap(batched, torch.cat(frames[:4])),
        "F=4 vs F=1, plain": gap(ref_batched, torch.cat(ref_alone)),
    }
    scale = float(ref.abs().mean())
    for k, (mx, mean) in gaps.items():
        log(f"[slice] {k}: max |diff| {mx:.3e} (bound 0.5), mean {mean:.3e} "
            f"(bound 1e-2)")
    log(f"[slice] mean |rgb| {scale:.3f}")
    bad = {k: g for k, g in gaps.items() if not (g[0] <= 0.5 and g[1] <= 1e-2)}
    if bad:
        raise AssertionError(f"frames disagree: {bad}")
    frame_max, frame_mean = gaps["frame vs plain (F=1)"]

    def render_one():
        return serving.render_frame(model, prep, yaws[:1], zero, device=dev)

    torch.cuda.reset_peak_memory_stats()
    frame_ms = cuda_time(render_one, iters=20)
    peak = torch.cuda.max_memory_allocated()
    log(f"[slice] {frame_ms:.3f} ms per r1024 frame (F=1, CUDA events, 20 frames), "
        f"peak allocated {peak / 2**20:.1f} MiB")
    report["slice"] = {"launches": launches, "frame_ms": frame_ms, "peak_bytes": peak,
                       "frame_max_err": frame_max, "frame_mean_err": frame_mean,
                       "gaps": gaps, "yaw_diffs": diffs}
    report["kernels"] = kernels
    if "--profile" in sys.argv[1:]:
        report["profile"] = profile_frames(render_one, frame_ms)

    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as fh:
        json.dump(report, fh, indent=1)
    name = torch.cuda.get_device_name(0)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    with torch.inference_mode():
        sys.exit(main())
