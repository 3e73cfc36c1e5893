"""Smoke run of the PyTorch port on one NVIDIA GPU (written for the H100).

    python3 chip_smoke.py [--profile]

Phases, each fatal on failure:
  1. device: name and power limit (nvidia-smi), torch and CUDA versions;
  2. build: nvcc compiles every kernel in cips3dpp_torch/csrc, one process
     per source, in parallel;
  3. K1 (SIREN render) against its plain PyTorch version at the serving
     shape (4096 rays x 24 samples, width 256), with timings;
  4. K2 (decoder upsample block) against its plain version at the four
     block shapes of the r1024 decoder, in each of its variants: bf16
     storage with noise buffers (the serving mode), f32 storage (the f32
     decoder of the sample_multi_view config), and noise hashed in the
     kernel in bf16 and in f32; then K3 (the v1 block, f32 in and out) at
     the same shapes through its own entry point, and P1 (the elementwise
     dtype probe) in f32 and bf16 through the probe tool, bit for bit;
  5. the serving slice: a seeded full-width preset_serving Generator
     renders r1024 frames through prepare_trajectory / render_frame (8 yaws
     at F=1, one F=4 call); the launch counters must show 1 K1 + 4 K2 per
     call; the F=1 and F=4 frames are compared with the plain path on the
     card, and each path's F=4 frames with its own F=1 frames;
  6. the sampling slice: render_trajectory(fused=True, noise_seed=...) over
     4 yaw frames at r1024, in the f32-decoder config (preset_r1024, the
     sample_multi_view section of configs/ffhq.yaml) and in
     preset_serving: 1 K1 + 4 hash-mode K2 launches a frame, frames against
     the plain kernels, and against frames fed the seed's hash_noise_map
     buffers; a geometry-aware (project_noise) trajectory and a 2x2 style
     mixing grid; image grids written to chiprun_out/;
  7. with --profile only: torch.profiler over 10 serving frames, device
     time per kernel and the device idle share (table in
     chiprun_out/profile_frame.txt).
Each path that launches kernels runs with the launch counts set to 0
just before it and read just after. A kernel's "ms" is its device time a
launch (torch.profiler), beside the time a call takes back to back (CUDA
events), which also holds the host's issue time; plain versions and frames
are timed with CUDA events. Then one JSON line with every
kernel's numbers, the card's name and power limit, and as the last line
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
OUT = os.path.join(ROOT, "chiprun_out")
PEAK_BF16 = 989e12  # H100 SXM dense bf16 FLOP/s (NVIDIA data sheet)
PEAK_F32 = 67e12  # f32 FLOP/s outside the tensor cores
PEAK_BYTES = 3.35e12  # HBM3 bytes/s
SEED = 1234
NOISE_SEED = 20240607
# f32 operations of one hash_normal value: two avalanche hashes (2 x 7
# integer ops), two int->float uniforms (4), log, sqrt and -2x (3), the
# sin polynomial with its range reduction (14), the phase and product (3)
HASH_OPS = 38
K2_SRC, K2_TPU = "cips3dpp_torch/csrc/decoder_block.cu", "cips3dpp_tpu/kernels/decoder_block.py:362"
# Kernel against plain version by storage dtype. bf16: a bf16 activation
# that rounds the other way (the f32 sums differ in order) moves a stored
# feature by one bf16 ulp (2^-8 relative) and rgb by that times |wrgb|.
# f32: nothing is stored in bf16 and conv_b's bf16 operands are rounded
# from the same f32 values, so only f32 sum orders differ; 1e-3 lies under
# one bf16 ulp of a stored feature, so a kernel that rounded any of the f32
# mode's values at a bf16 point would fail it.
K2_TOL = {torch.bfloat16: dict(rtol=1.6e-2, atol=2e-2), torch.float32: dict(rtol=0, atol=1e-3)}


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


def kernel_time(fn, kernel, iters=50):
    """(device ms of one launch by the profiler, ms a call by CUDA events
    over back-to-back calls). The first is the kernel's time; the second
    also holds the host's issue time where that is the longer."""
    from cips3dpp_torch.kernels import _lib

    return _lib.device_ms(lambda i: fn(), iters, kernel), cuda_time(fn, iters)


def bound(nbytes, bf16_flops=0.0, f32_flops=0.0):
    """Least time in ms for the work: the larger of bytes over the memory
    rate and operations over the peak rate of their type."""
    times = {"bytes": nbytes / PEAK_BYTES,
             "operations": max(bf16_flops / PEAK_BF16, f32_flops / PEAK_F32)}
    by = max(times, key=times.get)
    return times[by] * 1e3, by


def max_err(a, b):
    return float((a.float() - b.float()).abs().max())


def gap(x, y):
    d = (torch.as_tensor(x).float() - torch.as_tensor(y).float()).abs()
    return float(d.max()), float(d.mean())


@contextlib.contextmanager
def counted(name, want=None):
    """Launch counts of one path: set to 0 before it, read after it (into
    the yielded dict); with `want`, the counts must equal it."""
    from cips3dpp_torch.kernels import _lib

    got = {}
    _lib.reset_launches()
    yield got
    torch.cuda.synchronize()
    got.update({k: v for k, v in _lib.LAUNCHES.items() if v})
    log(f"[launches] {name}: {got}")
    if want is not None and got != want:
        raise AssertionError(f"{name}: want launches {want}, got {got}")


@contextlib.contextmanager
def plain_kernels():
    """Every entry point with the plain versions of K1 and K2."""
    from cips3dpp_torch import serving
    from cips3dpp_torch.kernels import decoder_block as kdb
    from cips3dpp_torch.kernels import decoder_fused as kdf
    from cips3dpp_torch.kernels import siren_render as ksr

    saved = serving.siren_render_prepared, ksr.siren_render_prepared, kdf.decoder_block_packed

    def siren_plain(p, pts, viewdirs, z_vals, rays_d):
        dn = torch.linalg.norm(rays_d, dim=-1, keepdim=True)
        return ksr.siren_render_plain(p, pts, viewdirs, z_vals, dn)

    def block_plain(y1, prepared, emit_feat=True, frames=1):
        return kdb.decoder_block_plain(y1, prepared, emit_feat, frames)

    serving.siren_render_prepared = ksr.siren_render_prepared = siren_plain
    kdf.decoder_block_packed = block_plain
    try:
        yield
    finally:
        serving.siren_render_prepared, ksr.siren_render_prepared, kdf.decoder_block_packed = saved


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
        if "block_kernel" in name or "decoder_block" in name:
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
    with open(os.path.join(OUT, "profile_frame.txt"), "w") as fh:
        fh.write(avgs.table(sort_by="self_cuda_time_total", row_limit=60))
    return out


def make_model(cfg, dev, seed):
    """A seeded full-width Generator whose zero-initialised noise weights
    and biases are set to draws, and one identity's zs and noise buffers."""
    from cips3dpp_torch.models.generator import Generator
    from cips3dpp_torch.models.layers import randomize_zero_init_

    model = Generator(cfg, device=dev, seed=seed)
    randomize_zero_init_(model, torch.Generator().manual_seed(seed))
    gen = torch.Generator().manual_seed(seed + 1)
    zs = [torch.randn((1, cfg.mapping.z_dim), generator=gen).to(dev) for _ in range(2)]
    noise = model.decoder.make_noise(gen, cfg.img_size, device=dev)
    return model, zs, noise


def k2_phase(label, blocks, img_size, gen, dev):
    """K2 in the variant of `blocks` (decoder_block_prepare outputs of the
    four upsample blocks) against its plain version at each block shape,
    with timings. The last block skips its feature store, as in a frame."""
    from cips3dpp_torch.kernels import decoder_block as kdb

    res = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "err": 0.0, "bytes": 0.0,
           "flops": 0.0, "shapes": []}
    hp = img_size
    for i, bp in enumerate(blocks):
        c, dt = bp["w2t"].shape[0], bp["dtype"]
        last = i == len(blocks) - 1
        hashed = "seeds" in bp
        y1 = torch.randn((hp, hp, c), generator=gen).to(dev, dt)
        got = kdb.decoder_block_packed(y1, prepared=bp, emit_feat=not last)
        want = kdb.decoder_block_plain(y1, bp, emit_feat=not last)
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for g, w in zip(got, want):
            if not torch.isfinite(g.float()).all():
                raise AssertionError(f"{label} C={c}: output not finite")
            torch.testing.assert_close(g.float(), w.float(), **K2_TOL[dt])
        err = max(max_err(g, w) for g, w in zip(got, want))
        ms, call_ms = kernel_time(
            lambda: kdb.decoder_block_packed(y1, prepared=bp, emit_feat=not last),
            "block_kernel")
        plain_ms = cuda_time(lambda: kdb.decoder_block_plain(y1, bp, emit_feat=not last),
                             iters=5)
        es = y1.element_size()
        px = 4 * hp * hp
        nbytes = (es * hp * hp * c + (0 if hashed else 2 * es * px)  # y1, noise maps
                  + (0 if last else es * px * c) + 4 * px * 3  # feat, rgb
                  + 2 * c * c + 4 * (2 * c + 2) + es * 3 * c)  # weights
        flops = 2 * px * c * c
        f32_ops = 2 * px * 3 * c + (2 * px * HASH_OPS if hashed else 0)
        b_ms, b_by = bound(nbytes, bf16_flops=flops, f32_flops=f32_ops)
        log(f"[{label}] y1 ({hp},{hp},{c}) feat {'skipped' if last else 'stored'}: "
            f"max |kernel - plain| {err:.3e}; {ms:.4f} ms kernel ({call_ms:.4f} a call), "
            f"{plain_ms:.4f} ms plain, bound {b_ms:.4f} ms ({b_by}, {nbytes / 1e6:.2f} MB)")
        res["shapes"].append({"y1": [hp, hp, c], "feat": not last, "err": err, "ms": ms,
                              "call_ms": call_ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                              "bound_by": b_by, "bytes": nbytes})
        for k, v in (("ms", ms), ("plain_ms", plain_ms), ("bound_ms", b_ms),
                     ("bytes", nbytes), ("flops", flops)):
            res[k] += v
        res["err"] = max(res["err"], err)
        hp *= 2
    res["bound_by"] = ("bytes" if res["bytes"] / PEAK_BYTES > res["flops"] / PEAK_BF16
                       else "operations")
    return res


def k3_phase(gen, dev, img_size, channels):
    """K3, the v1 block, at the four block shapes: its path (one call of
    its entry point per shape, counted), then each shape against its plain
    version, with timings."""
    from cips3dpp_torch.kernels import decoder_block as kdb

    cases, hp = [], img_size
    for c in channels:
        rnd = lambda *shape: torch.randn(shape, generator=gen).to(dev)
        cases.append((rnd(hp, hp, c), rnd(hp, hp, 3), rnd(2 * hp, 2 * hp, 1),
                      rnd(2 * hp, 2 * hp, 1), rnd(c, c) / c**0.5, rnd(c, 3) / c**0.5,
                      0.1 * rnd(c), 0.1 * rnd(c), 0.1 * rnd(3), 0.3, -0.2))
        hp *= 2
    with counted("K3 path (decoder_block_fused at 4 shapes)",
                 {"decoder_block_fused": len(cases)}) as launches:
        for args in cases:
            kdb.decoder_block_fused(*args)
    res = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "err": 0.0, "bytes": 0.0,
           "flops": 0.0, "shapes": [], "launches": launches["decoder_block_fused"]}
    for args in cases:
        hp, _, c = args[0].shape
        got = kdb.decoder_block_fused(*args)
        want = kdb.decoder_block_fused_plain(*args)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            if not torch.isfinite(g).all():
                raise AssertionError(f"K3 C={c}: output not finite")
        # feat is f32 as in K2's f32 mode; rgb multiplies bf16(feat), whose
        # rounding flips where feat differs in its last f32 bits
        torch.testing.assert_close(got[0], want[0], **K2_TOL[torch.float32])
        torch.testing.assert_close(got[1], want[1], **K2_TOL[torch.bfloat16])
        err_feat, err_rgb = max_err(got[0], want[0]), max_err(got[1], want[1])
        err = max(err_feat, err_rgb)
        ms, call_ms = kernel_time(lambda: kdb.decoder_block_fused(*args), "block_kernel")
        plain_ms = cuda_time(lambda: kdb.decoder_block_fused_plain(*args), iters=5)
        px = 4 * hp * hp
        nbytes = (4 * hp * hp * (c + 3) + 2 * 4 * px  # y1, skip, noise maps
                  + 4 * px * (c + 3)  # feat, rgb
                  + 2 * c * c + 2 * 3 * c + 4 * (2 * c + 3 + 2))  # weights
        flops = 2 * px * c * c + 2 * px * c * 3
        b_ms, b_by = bound(nbytes, bf16_flops=flops)
        log(f"[K3] y1 ({hp},{hp},{c}): max |kernel - plain| feat {err_feat:.3e}, rgb "
            f"{err_rgb:.3e}; {ms:.4f} ms "
            f"kernel ({call_ms:.4f} a call), {plain_ms:.4f} ms plain, bound {b_ms:.4f} ms "
            f"({b_by}, {nbytes / 1e6:.2f} MB)")
        res["shapes"].append({"y1": [hp, hp, c], "err": err, "err_feat": err_feat,
                              "err_rgb": err_rgb, "ms": ms, "call_ms": call_ms,
                              "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                              "bytes": nbytes})
        for k, v in (("ms", ms), ("plain_ms", plain_ms), ("bound_ms", b_ms),
                     ("bytes", nbytes), ("flops", flops)):
            res[k] += v
        res["err"] = max(res["err"], err)
    res["bound_by"] = ("bytes" if res["bytes"] / PEAK_BYTES > res["flops"] / PEAK_BF16
                       else "operations")
    return res


def p1_phase(dev):
    """P1 through the probe tool, one dtype at a time (its path, counted):
    bit-equal to the plain chain, elements per second, bound."""
    from cips3dpp_torch.tools import elem_dtype_probe as probe

    out = {}
    for dtype, short in (("float32", "f32"), ("bfloat16", "bf16")):
        name = f"elem_probe_{short}"
        with counted(f"P1 path (elem_dtype_probe.measure {dtype})") as launches:
            r = probe.measure(dtype, dev)
        if not r["bit_equal"]:
            raise AssertionError(f"P1 {dtype}: kernel and plain chain differ by "
                                 f"{r['max_abs_err']}")
        if launches.keys() != {name}:
            raise AssertionError(f"P1 {dtype}: launches {launches}")
        # 6 operations a pass (s*n, two adds, 0.2v, max, *sqrt2), 12 passes
        b_ms, b_by = bound(r["bytes"], f32_flops=6 * probe.REPS * r["elements"])
        r.update(launches=launches[name], bound_ms=b_ms, bound_by=b_by)
        log(f"[P1] {dtype}: bit-equal to plain; {r['ms'] * 1e3:.2f} us kernel "
            f"(profiler device time; {r['issue_ms'] * 1e3:.2f} us a call back to back, "
            f"CUDA events), {r['elems_per_s']:.4e} elements/s (x{probe.REPS} passes), "
            f"{r['plain_ms']:.4f} ms plain, bound {b_ms * 1e3:.2f} us ({b_by}, "
            f"{r['bytes'] / 1e6:.1f} MB, {probe.ROTATE} rotating input sets)")
        out[short] = r
    out["bf16_over_f32"] = out["bf16"]["elems_per_s"] / out["f32"]["elems_per_s"]
    log(f"[P1] bf16 / f32 elements per second: {out['bf16_over_f32']:.3f}")
    return out


def save_grid(frames, name):
    """Frames (N, H, W, 3) in [-1, 1] at half size as one PNG under chiprun_out/."""
    import numpy as np

    from cips3dpp_torch.apps.sample import save_image_grid

    f = np.asarray(frames, np.float32)
    n, h, w, c = f.shape
    half = f.reshape(n, h // 2, 2, w // 2, 2, c).mean(axis=(2, 4))
    return save_image_grid(half, os.path.join(OUT, name), n_cols=min(n, 4))


def trajectory_phase(label, model, zs, dev, dtype_suffix):
    """render_trajectory(fused=True, noise_seed=...) over 4 yaw frames at
    full width: hash-mode K2 launches, frames against the plain kernels
    and against the seed's hash_noise_map buffers through the buffer mode."""
    from cips3dpp_torch.apps.sample import render_trajectory, yaw_trajectory

    cfg = model.cfg
    n = 4
    cams = yaw_trajectory(n, cfg.img_size, fov_ang=cfg.fov_ang,
                          dist_radius=cfg.dist_radius, device=dev)
    hash_name, buf_name = f"decoder_block_hash{dtype_suffix}", f"decoder_block{dtype_suffix}"
    with counted(f"{label} trajectory, noise_seed",
                 {"siren_render": n, hash_name: 4 * n}) as l_seed:
        t0 = time.perf_counter()
        out = render_trajectory(model, zs, cams, fused=True, noise_seed=NOISE_SEED)
        torch.cuda.synchronize()
        traj_s = time.perf_counter() - t0
    bufs = model.decoder.hash_noise(NOISE_SEED, cfg.img_size, device=dev)
    with counted(f"{label} trajectory, the seed's buffers",
                 {"siren_render": n, buf_name: 4 * n}) as l_bufs:
        by_bufs = render_trajectory(model, zs, cams, fused=True, noise_bufs=bufs)
    with plain_kernels():
        with counted(f"{label} trajectory, plain kernels", {}):
            ref = render_trajectory(model, zs, cams, fused=True, noise_seed=NOISE_SEED)
    rgb = torch.from_numpy(out["rgb"])
    if rgb.shape != (n, cfg.out_size, cfg.out_size, 3) or not torch.isfinite(rgb).all():
        raise AssertionError(f"{label}: frames {tuple(rgb.shape)}, finite "
                             f"{bool(torch.isfinite(rgb).all())}")
    yaw_diff = gap(out["rgb"][0], out["rgb"][1])[0]  # azim -0.3 and 0.22
    if yaw_diff <= 1e-3:
        raise AssertionError(f"{label}: neighbouring yaws give the same image")
    gaps = {"seed frames vs plain kernels": gap(out["rgb"], ref["rgb"]),
            "seed vs the seed's buffers": gap(out["rgb"], by_bufs["rgb"])}
    scale = float(rgb.abs().mean())
    for k, (mx, mean) in gaps.items():
        log(f"[{label}] {k}: max |diff| {mx:.3e}, mean {mean:.3e} (mean |rgb| {scale:.3f})")
    mx, mean = gaps["seed frames vs plain kernels"]
    # bf16: flips amplified through 14 bf16 layers (the serving frame's
    # bounds); f32: only K1's bf16 flips and the blocks' conv_b operands,
    # held under what the bf16 config reads (max 0.228, mean 6.8e-3)
    f_max, f_mean = (0.1, 1e-3) if dtype_suffix == "_f32" else (0.5, 1e-2)
    if not (mx <= f_max and mean <= f_mean):
        raise AssertionError(f"{label}: frames disagree with the plain kernels: {mx}, {mean} "
                             f"(bounds {f_max}, {f_mean})")
    mx, mean = gaps["seed vs the seed's buffers"]
    # f32: the same realization (tests/test_kernels.py:387's bound); bf16:
    # the blocks round buffers to bf16 but never the hash noise, so the
    # gap is held to the frame bounds only
    if dtype_suffix == "_f32" and not mx <= 1e-2:
        raise AssertionError(f"{label}: hash noise differs from its buffers by {mx}")
    if not (mx <= f_max and mean <= f_mean):
        raise AssertionError(f"{label}: hash noise differs from its buffers by {mx}, {mean}")
    log(f"[{label}] {n} r1024 frames through render_trajectory in {traj_s:.3f} s "
        f"({1e3 * traj_s / n:.1f} ms a frame, host clock, outputs copied to the host)")
    save_grid(out["rgb"], f"trajectory{dtype_suffix or '_bf16'}.png")
    return {"launches_seed": l_seed, "launches_buffers": l_bufs, "gaps": gaps,
            "mean_abs_rgb": scale, "ms_per_frame": 1e3 * traj_s / n, "yaw_diff": yaw_diff}


def main() -> int:
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device")
        return 1
    sys.path.insert(0, ROOT)
    from cips3dpp_torch.apps.sample import render_trajectory, style_mixing_grid
    from cips3dpp_torch.core.camera import camera_from_angles
    from cips3dpp_torch.core.rays import prepare_nerf_inputs
    from cips3dpp_torch.kernels import _lib
    from cips3dpp_torch.kernels import decoder_block as kdb
    from cips3dpp_torch.kernels import decoder_fused as kdf
    from cips3dpp_torch.kernels import siren_render as ksr
    from cips3dpp_torch.models.generator import preset_r1024, preset_serving
    from cips3dpp_torch import serving

    os.makedirs(OUT, exist_ok=True)
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

    # ---- models and trajectory state ----
    cfg = preset_serving()
    model, zs, noise = make_model(cfg, dev, SEED)
    prep = serving.prepare_trajectory(model, zs, noise_bufs=noise, device=dev)
    cfg32 = preset_r1024()  # f32 decoder storage (configs/ffhq.yaml sample_multi_view)
    model32, zs32, noise32 = make_model(cfg32, dev, SEED + 10)
    kernels = []

    def entry(name, source, replaces, res, launches):
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": res["err"], "ms": res["ms"],
            "plain_ms": res["plain_ms"], "bound_ms": res["bound_ms"],
            "bound_by": res["bound_by"], "library_ms": None,
        })

    # ---- 3. K1 against its plain version ----
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
    k1_ms, k1_call_ms = kernel_time(lambda: ksr.siren_render_prepared(*args),
                                    "siren_render_kernel")
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
    log(f"[K1] {k1_ms:.4f} ms kernel ({k1_call_ms:.4f} a call), {k1_plain_ms:.4f} ms plain, bound "
        f"{k1_bound:.4f} ms ({k1_by}) at R={r}, S={s}, W={width}")
    report["K1"] = {"errs": errs, "err": max(errs.values()), "ms": k1_ms, "call_ms": k1_call_ms,
                    "plain_ms": k1_plain_ms, "bound_ms": k1_bound, "bound_by": k1_by,
                    "bytes": k1_bytes, "bf16_flops": k1_bf16, "f32_flops": k1_f32}

    # ---- 4. K2 in its four variants, K3 and P1 against their plain versions ----
    gen = torch.Generator().manual_seed(SEED + 2)
    fused_blocks = lambda p: [b["bp"] for b in p["blocks"] if "bp" in b]
    dec32 = kdf.decoder_fused_prepare(model32.decoder, model32.map_zs(zs32)[1], noise32)
    variants = {
        "K2": fused_blocks(prep["dec"]),  # bf16, buffers
        "K2-f32": fused_blocks(dec32),
        "K2-hash": fused_blocks(serving.prepare_trajectory(
            model, zs, noise_seed=NOISE_SEED, device=dev)["dec"]),
        "K2-hash-f32": fused_blocks(kdf.decoder_fused_prepare(
            model32.decoder, model32.map_zs(zs32)[1], None, noise_seed=NOISE_SEED,
            feat_size=cfg32.img_size)),
    }
    for label, blocks in variants.items():
        report[label] = k2_phase(label, blocks, cfg.img_size, gen, dev)
        report[label]["kernel"] = kdb.launch_name(blocks[0])
    for i, shape in enumerate(report["K2"]["shapes"]):
        log(f"[K2 modes] y1 {shape['y1']}: bf16 buffers {shape['ms']:.4f} ms, hash "
            f"{report['K2-hash']['shapes'][i]['ms']:.4f}; f32 buffers "
            f"{report['K2-f32']['shapes'][i]['ms']:.4f}, hash "
            f"{report['K2-hash-f32']['shapes'][i]['ms']:.4f}")
    channels = [b["w2t"].shape[0] for b in variants["K2"]]
    report["K3"] = k3_phase(gen, dev, cfg.img_size, channels)
    report["P1"] = p1_phase(dev)

    # ---- 5. the serving slice: r1024 frames through prepare/render ----
    yaws = torch.linspace(-0.3, 0.3, 8, device=dev)
    zero = torch.zeros(1, device=dev)
    calls = len(yaws) + 1
    with counted(f"serving path ({calls} render_frame calls)",
                 {"siren_render": calls, "decoder_block": 4 * calls}) as serving_launches:
        frames = [serving.render_frame(model, prep, yaws[i:i + 1], zero, device=dev)["rgb"]
                  for i in range(len(yaws))]
        batched = serving.render_frame(model, prep, yaws[:4], yaws[:4] * 0, device=dev)["rgb"]
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
    with plain_kernels():
        ref = serving.render_frame(model, prep, yaws[:1], zero, device=dev)["rgb"]
        ref_batched = serving.render_frame(model, prep, yaws[:4], yaws[:4] * 0,
                                           device=dev)["rgb"]
        ref_alone = [serving.render_frame(model, prep, yaws[i:i + 1], zero,
                                          device=dev)["rgb"] for i in range(4)]
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

    def render_one():
        return serving.render_frame(model, prep, yaws[:1], zero, device=dev)

    torch.cuda.reset_peak_memory_stats()
    frame_ms = cuda_time(render_one, iters=20)
    peak = torch.cuda.max_memory_allocated()
    log(f"[slice] {frame_ms:.3f} ms per r1024 frame (F=1, CUDA events, 20 frames), "
        f"peak allocated {peak / 2**20:.1f} MiB")
    report["slice"] = {"launches": serving_launches, "frame_ms": frame_ms,
                       "peak_bytes": peak, "frame_max_err": gaps["frame vs plain (F=1)"][0],
                       "frame_mean_err": gaps["frame vs plain (F=1)"][1], "gaps": gaps,
                       "yaw_diffs": diffs}

    # ---- 6. the sampling slice: render_trajectory and the apps ----
    report["trajectory_f32"] = trajectory_phase("traj f32", model32, zs32, dev, "_f32")
    report["trajectory_bf16"] = trajectory_phase("traj bf16", model, zs, dev, "")
    from cips3dpp_torch.apps.sample import yaw_trajectory

    cams = yaw_trajectory(2, cfg.img_size, device=dev)
    with counted("project_noise trajectory (bf16, 2 frames)",
                 {"siren_render": 2, "decoder_block": 8}):
        t0 = time.perf_counter()
        proj = render_trajectory(model, zs, cams, fused=True, noise_bufs=noise,
                                 project_noise=True,
                                 project_noise_generator=torch.Generator().manual_seed(7))
        torch.cuda.synchronize()
        proj_s = time.perf_counter() - t0
    plain_noise = render_trajectory(model, zs, cams, fused=True, noise_bufs=noise)
    proj_gap = gap(proj["rgb"], plain_noise["rgb"])
    if not torch.isfinite(torch.from_numpy(proj["rgb"])).all():
        raise AssertionError("project_noise frames not finite")
    log(f"[apps] project_noise: 2 frames in {proj_s:.2f} s (mesh of the app's 128^3 SDF grid), "
        f"max |diff| to the unprojected noise {proj_gap[0]:.3e}")
    save_grid(proj["rgb"], "project_noise.png")
    front = camera_from_angles(zero, zero, cfg32.img_size, fov_ang=cfg32.fov_ang,
                               dist_radius=cfg32.dist_radius)
    with counted("style_mixing_grid 2x2 (plain modules)", {}):
        t0 = time.perf_counter()
        grid = style_mixing_grid(model32, torch.Generator().manual_seed(SEED + 3), 2, 2,
                                 front, truncation=0.7,
                                 mean_latents=model32.mean_latents(
                                     torch.Generator().manual_seed(2), 10_000))
        mix_s = time.perf_counter() - t0
    if grid.shape != (2048, 2048, 3) or not torch.isfinite(torch.from_numpy(grid)).all():
        raise AssertionError(f"style mixing grid {grid.shape}")
    log(f"[apps] style_mixing_grid 2x2 at r1024 (f32 config, plain modules): {mix_s:.2f} s")
    save_grid(grid[None], "style_mixing.png")
    report["apps"] = {"project_noise_s": proj_s, "project_noise_gap": proj_gap,
                      "style_mixing_s": mix_s}

    # ---- the kernels line ----
    t32, tbf = report["trajectory_f32"], report["trajectory_bf16"]
    entry("siren_render", "cips3dpp_torch/csrc/siren_render.cu",
          "cips3dpp_tpu/kernels/siren_render.py:140", report["K1"],
          serving_launches["siren_render"])
    entry("decoder_block", K2_SRC, K2_TPU, report["K2"], serving_launches["decoder_block"])
    entry("decoder_block_f32", K2_SRC, K2_TPU, report["K2-f32"],
          t32["launches_buffers"]["decoder_block_f32"])
    entry("decoder_block_hash", K2_SRC, K2_TPU, report["K2-hash"],
          tbf["launches_seed"]["decoder_block_hash"])
    entry("decoder_block_hash_f32", K2_SRC, K2_TPU, report["K2-hash-f32"],
          t32["launches_seed"]["decoder_block_hash_f32"])
    entry("decoder_block_fused", K2_SRC,
          "cips3dpp_tpu/kernels/decoder_block.py:64", report["K3"], report["K3"]["launches"])
    for short in ("f32", "bf16"):
        p = report["P1"][short]
        entry(f"elem_probe_{short}", "cips3dpp_torch/csrc/elem_probe.cu",
              "tools/vpu_dtype_probe.py:42", dict(p, err=p["max_abs_err"]), p["launches"])
    report["kernels"] = kernels
    if "--profile" in sys.argv[1:]:
        report["profile"] = profile_frames(render_one, frame_ms)

    with open(os.path.join(OUT, "chip_smoke.json"), "w") as fh:
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
