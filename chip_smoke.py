"""Smoke run of the PyTorch port on one NVIDIA GPU (written for the H100).

    python3 chip_smoke.py [--profile]

Phases, each fatal on failure:
  1. device: name and power limit (nvidia-smi), torch and CUDA versions;
  2. build: nvcc compiles every kernel in cips3dpp_torch/csrc, one process
     per source, in parallel; ptxas registers and spills by entry, and each
     K2/K3 instantiation's shared memory, blocks an SM and registers;
  3. K1 (SIREN render) against its plain PyTorch version at the serving
     shape (4096 rays x 24 samples, width 256), with timings;
  4. K2 (decoder upsample block) against its plain version at the four
     block shapes of the r1024 decoder, in each of its variants: bf16
     storage with noise buffers (the serving mode), f32 storage (the f32
     decoder of the sample_multi_view config), and noise hashed in the
     kernel in bf16 and in f32 (two launches bit-equal, the share of feat
     values that differ from the plain version's, and the bound per shape
     with its byte and operation terms from decoder_block_work, summed);
     then K3 (the v1 block, f32 in and out) at
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
  7. the training slice at train_r1024 (configs/ffhq.yaml), full width,
     batch 4, f32, random weights and "real" images from the seed:
     sphere_init_step, d_step with and without lazy R1, g_step,
     path_reg_step and ema_update, each once to warm up and twice timed
     (CUDA events, peak memory per step); losses finite, each optimizer
     moved its parameters, K1 launched once per batch item in every D step
     and nowhere else; the D step's fakes through K1 against K1's plain
     version, and SirenRender's gradients (K1 forward, replayed backward)
     against autograd through the replayed function and through the plain
     f32 renderer;
  8. the training loop through the command line, in-process
     (cips3dpp_torch.apps.cli.main) at train_r1024, batch 4, f32, with
     configs/ffhq.yaml read by the standard-library YAML reader (PyYAML
     hidden): `sphere-init --n-iters 20` (finite loss, a step-0
     checkpoint), `train --total-iters 8 --no-sphere-init` on a synthetic
     npy shard of 8 seeded 1024^2 images, then `train --resume
     --total-iters 16` (starts at step 8 from tensors bit-equal to those
     saved; lazy R1 at idx 14, path reg at 4, 9 and 14; exactly 4 K1
     launches an iteration, none elsewhere), every logged loss finite,
     checkpoints 8 and 16 with config_command.yaml; then
     `sample-multi-view --fused` of 2 frames from the trained checkpoint's
     G_ema (1 K1 + 4 f32 K2 launches a frame). Seconds an iteration (the
     logger's iters_per_sec, and each iteration's wall time to a
     synchronise at its end, the first apart), checkpoint save and restore
     seconds and bytes, peak allocated memory;
  9. flip-inversion at r1024 through the command line, in-process, with
     the flip_inversion section of configs/ffhq.yaml (PyYAML hidden), a
     seeded full-width generator (a .pth named by network_pkl), the
     random VGG and LPIPS, the schedule cut to 6 pose + 10 appearance + 2
     multiview steps (width and w_avg_samples not cut): `invert` of a
     frame the generator renders from its mean latents at azim 0.25,
     starting from azim 0.02 (every logged loss finite, the perceptual loss
     lower at the last step than at the first, exactly 2 K1 launches a
     step and 2 for the final render, no K2), `render-inverted --n-frames
     4` from the port's artifact and from the same artifact written in the
     JAX package's w.pkl format (bit-equal frames), a second `invert` of a
     target at azim -0.25 and `lerp-inversions --n-interp 3` over both;
     one appearance step's gradients with respect to the camera, w_render
     and w_decoder through K1 against K1's plain version's, the bf16
     plain renderer's (siren_render_reference under autograd) and the
     plain f32 renderer's, and the f32 stand-in on the fused route's
     against the plain f32 renderer's (cosine and max relative difference
     within INV_GRAD_BOUNDS), with the sample points or the view
     directions detached before K1 as planted faults that must fail
     them; the inverted views through K1 + f32 K2 at F = 1 against the
     plain kernels' (phase 6's f32 bounds). Step ms by kind (CUDA events, the
     first apart), the extrapolated time of the full 1200-step schedule,
     peak allocated memory, each command's wall seconds, PSNR and
     |azim - azim*| at step 0 and at the end (findings, not gates);
 10. with --profile only: torch.profiler over 10 serving frames (phase 5),
     over one call each of d_step with and without R1 and g_step (phase 7)
     and over one projector step (phase 9): device time per kernel and
     kernel group and the device idle share (tables in
     chiprun_out/profile_*.txt).
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
import dataclasses
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(ROOT, "chiprun_out")
PEAK_BF16 = 989e12  # H100 SXM dense bf16 FLOP/s (NVIDIA data sheet)
PEAK_F32 = 67e12  # f32 FLOP/s outside the tensor cores
# f32 operations a second where products and sums are rounded apart (no FMA
# contraction): one operation an instruction, half the FMA peak
PEAK_F32_APART = PEAK_F32 / 2
PEAK_BYTES = 3.35e12  # HBM3 bytes/s
SEED = 1234
NOISE_SEED = 20240607
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


def profile_calls(fn, call_ms, n=10, what="frame", table="profile_frame.txt"):
    """Device time per call of fn by kernel over n calls (torch.profiler),
    the groups K1 / K2 / convolution / matmul / other, and the device idle
    share against the unprofiled call time `call_ms`. The full table goes
    to chiprun_out/`table`."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
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
        if any(s in name for s in ("fprop", "dgrad", "wgrad", "conv", "fft")):
            return "convolution (cuDNN)"
        if any(s in name for s in ("gemm", "xmma", "cutlass", "sm90")):
            return "matmul (cuBLAS)"
        return "other (elementwise, copies, reductions)"

    kernels = sorted(
        ({"name": e.key, "group": group(e.key), "calls_per_call": e.count / n,
          "ms_per_call": e.self_device_time_total / 1e3 / n} for e in dev_events),
        key=lambda k: -k["ms_per_call"])
    groups = {}
    for k in kernels:
        groups[k["group"]] = groups.get(k["group"], 0.0) + k["ms_per_call"]
    busy = sum(groups.values())
    out = {"calls": n, "device_ms_per_call": busy, "call_ms": call_ms,
           "idle_share": 1.0 - busy / call_ms, "groups": groups, "kernels": kernels[:25]}
    for g, ms in sorted(groups.items(), key=lambda x: -x[1]):
        log(f"[profile] {what}: {g}: {ms:.4f} ms a call ({100 * ms / busy:.1f}% of device time)")
    log(f"[profile] {what}: device busy {busy:.4f} ms of a {call_ms:.4f} ms call "
        f"(idle share {out['idle_share']:.3f})")
    with open(os.path.join(OUT, table), "w") as fh:
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
    with timings. The last block skips its feature store, as in a frame.
    The bound is taken per shape (decoder_block_work: bytes against the
    tensor and f32 operations) and summed."""
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
        again = kdb.decoder_block_packed(y1, prepared=bp, emit_feat=not last)
        want = kdb.decoder_block_plain(y1, bp, emit_feat=not last)
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        again = again if isinstance(again, tuple) else (again,)
        want = want if isinstance(want, tuple) else (want,)
        for g, a, w in zip(got, again, want):
            if not torch.isfinite(g.float()).all():
                raise AssertionError(f"{label} C={c}: output not finite")
            if not torch.equal(g, a):
                raise AssertionError(f"{label} C={c}: two launches on the same inputs differ")
            torch.testing.assert_close(g.float(), w.float(), **K2_TOL[dt])
        err = max(max_err(g, w) for g, w in zip(got, want))
        # share of stored feature values that differ from the plain version's
        flips = float((got[0] != want[0]).float().mean()) if not last else None
        ms, call_ms = kernel_time(
            lambda: kdb.decoder_block_packed(y1, prepared=bp, emit_feat=not last),
            "block_kernel")
        plain_ms = cuda_time(lambda: kdb.decoder_block_plain(y1, bp, emit_feat=not last),
                             iters=5)
        work = kdb.decoder_block_work(hp, hp, c, dt, hashed, emit_feat=not last)
        b_ms, b_by = bound(work["bytes"], work["bf16_flops"], work["f32_dot"], work["f32_apart"])
        terms = {"bytes_ms": work["bytes"] / PEAK_BYTES * 1e3,
                 "f32_ms": (work["f32_dot"] / PEAK_F32 + work["f32_apart"] / PEAK_F32_APART) * 1e3,
                 "bf16_tensor_ms": work["bf16_flops"] / PEAK_BF16 * 1e3}
        flip_txt = "feat skipped" if last else f"{100 * flips:.4f}% of feat values differ"
        log(f"[{label}] y1 ({hp},{hp},{c}): max |kernel - plain| {err:.3e}, {flip_txt}, two "
            f"launches bit-equal; {ms:.4f} ms kernel ({call_ms:.4f} a call), {plain_ms:.4f} ms "
            f"plain, bound {b_ms:.4f} ms ({b_by}; bytes {terms['bytes_ms']:.4f} ms for "
            f"{work['bytes'] / 1e6:.2f} MB, f32 {terms['f32_ms']:.4f} ms for "
            f"{work['f32_apart'] / 1e6:.1f} M ops apart + {work['f32_dot'] / 1e6:.1f} M FMA "
            f"flops, bf16 tensor {terms['bf16_tensor_ms']:.4f} ms); {ms / b_ms:.2f}x the bound")
        res["shapes"].append({"y1": [hp, hp, c], "feat": not last, "err": err,
                              "feat_flip_share": flips, "ms": ms, "call_ms": call_ms,
                              "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                              "bound_terms_ms": terms, **work})
        for k, v in (("ms", ms), ("plain_ms", plain_ms), ("bound_ms", b_ms),
                     ("bytes", work["bytes"]), ("flops", work["bf16_flops"])):
            res[k] += v
        res["err"] = max(res["err"], err)
        hp *= 2
    by = [s["bound_by"] for s in res["shapes"]]
    res["bound_by"] = max(set(by), key=lambda b: sum(
        s["bound_ms"] for s in res["shapes"] if s["bound_by"] == b))
    log(f"[{label}] four blocks: {res['ms']:.4f} ms kernel, bound {res['bound_ms']:.4f} ms "
        f"(sum of the per-shape bounds, by {by}); {res['ms'] / res['bound_ms']:.2f}x the bound")
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


def training_phase(dev, profile=False):
    """The training slice at train_r1024 (configs/ffhq.yaml train_base:
    the _G_r1024 generator in f32, DStyleGANProgressive(1024, channel
    multiplier 2), DVolumeRenderProgressive(1024) on the 64^2 thumbnails,
    TrainConfig's defaults, batch 4), random weights from the seed and
    "real" images drawn from it. sphere_init_step, d_step with and without
    lazy R1, g_step, path_reg_step and ema_update, each once to warm up and
    twice timed (CUDA events, peak memory per step); every D step renders
    its fakes through K1, one launch per batch item. Then the fakes of K1
    against the same fakes through K1's plain version, and SirenRender's
    gradients against autograd through the plain renderer. With `profile`,
    the device time of d_step (with and without R1) and g_step by kernel
    group (one call each, after the timed ones)."""
    from cips3dpp_torch.kernels import _lib
    from cips3dpp_torch.kernels import siren_render as ksr
    from cips3dpp_torch.models.discriminator import DStyleGANProgressive
    from cips3dpp_torch.models.discriminator_pose import DVolumeRenderProgressive
    from cips3dpp_torch.models.generator import Generator, preset_r1024
    from cips3dpp_torch.models.layers import randomize_zero_init_
    from cips3dpp_torch.train import (TrainConfig, create_train_state, draw_inputs,
                                      ema_update, make_train_steps)

    cfg, tcfg = preset_r1024(), TrainConfig()  # _G_r1024, train_base: batch 4
    b, size = tcfg.batch, cfg.out_size
    g = Generator(cfg, device=dev, seed=SEED + 20)
    d = DStyleGANProgressive(1024, 2, device=dev, seed=SEED + 21)
    d_render = DVolumeRenderProgressive(1024, viewpoint_loss=True, device=dev, seed=SEED + 22)
    for i, m in enumerate((g, d)):
        randomize_zero_init_(m, torch.Generator().manual_seed(SEED + 23 + i))
    state = create_train_state(tcfg, g, d, d_render)
    d_step, g_step, path_step, sphere_step = make_train_steps(cfg, tcfg)
    gen = torch.Generator(device=dev).manual_seed(SEED + 25)
    real = torch.rand((b, size, size, 3), generator=gen, device=dev) * 2 - 1
    alpha = 0.5  # the fade branches of both Ds live
    snap = lambda m: [p.detach().clone() for p in m.parameters()]
    moved = lambda m, before: any(not torch.equal(p, q) for p, q in zip(m.parameters(), before))

    steps = {
        "sphere_init_step": (lambda: sphere_step(state, gen)[1], ("g",)),
        "d_step (R1)": (lambda: d_step(state, real, gen, alpha, True)[1], ("d", "d_render")),
        "d_step": (lambda: d_step(state, real, gen, alpha, False)[1], ("d", "d_render")),
        "g_step": (lambda: g_step(state, gen, alpha)[1], ("g",)),
        "path_reg_step": (lambda: path_step(state, gen)[1], ("g",)),
        "ema_update": (lambda: (ema_update(state, tcfg.ema_decay), {})[1], ("g_ema",)),
    }
    res = {"steps": {}, "config": "train_r1024 (configs/ffhq.yaml), batch 4, f32"}
    n_d = 0
    with counted("training path (3 calls of each step)") as launches:
        for name, (fn, mods) in steps.items():
            times, peaks, metrics = [], [], {}
            for i in range(3):
                before = {k: snap(getattr(state, k)) for k in mods}
                k1_before = _lib.LAUNCHES["siren_render"]
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                metrics = fn()
                end.record()
                torch.cuda.synchronize()
                k1 = _lib.LAUNCHES["siren_render"] - k1_before
                want_k1 = b if name.startswith("d_step") else 0
                if k1 != want_k1:
                    raise AssertionError(f"{name}: {k1} K1 launches, want {want_k1}")
                n_d += name.startswith("d_step")
                for k in mods:
                    if not moved(getattr(state, k), before[k]):
                        raise AssertionError(f"{name}: the {k} parameters did not move")
                bad = {k: float(v) for k, v in metrics.items() if not torch.isfinite(v)}
                if bad:
                    raise AssertionError(f"{name}: non-finite losses {bad}")
                if i:  # the first call warms up
                    times.append(start.elapsed_time(end))
                    peaks.append(torch.cuda.max_memory_allocated())
            ms, peak = sum(times) / len(times), max(peaks)
            res["steps"][name] = {"ms": ms, "ms_each": times, "peak_bytes": peak,
                                  "k1_launches_per_call": b if name.startswith("d_step") else 0,
                                  "metrics": {k: float(v) for k, v in metrics.items()}}
            log(f"[train] {name}: {ms:.1f} ms a call (CUDA events, calls 2-3: "
                f"{', '.join(f'{t:.1f}' for t in times)}), peak allocated "
                f"{peak / 2**30:.2f} GiB, K1 launches a call "
                f"{res['steps'][name]['k1_launches_per_call']}; losses "
                f"{ {k: round(float(v), 4) for k, v in metrics.items()} }")
    if launches != {"siren_render": b * n_d}:
        raise AssertionError(f"training path: launches {launches}, want {b * n_d} K1")
    res["launches"] = launches
    if profile:
        res["profile"] = {
            name: profile_calls(steps[name][0], res["steps"][name]["ms"], n=1, what=name,
                                table=f"profile_{name.split()[0]}{'_r1' if 'R1' in name else ''}.txt")
            for name in ("d_step (R1)", "d_step", "g_step")}

    # the D step's fakes through K1 against the same fakes through K1's
    # plain version, with the same draws (the serving frame's bounds for
    # rgb, K1's own for thumb)
    draws = draw_inputs(gen, b, cfg, tcfg, dev, decoder=g.decoder)
    cam = draws.cam
    fwd = lambda: g(zs=draws.zs, cam_poses=cam.extrinsics, focals=cam.focal, near=cam.near,
                    far=cam.far, noise_bufs=draws.noise, t_rand=draws.t_rand,
                    fused_renderer=True)
    with torch.no_grad():
        with counted("D-step fakes, K1", {"siren_render": b}):
            k1_fakes = fwd()
        with plain_kernels():
            plain_fakes = fwd()
        f32_fakes = g(zs=draws.zs, cam_poses=cam.extrinsics, focals=cam.focal, near=cam.near,
                      far=cam.far, noise_bufs=draws.noise, t_rand=draws.t_rand)
    fake_gaps = {k: gap(k1_fakes[k], plain_fakes[k]) for k in ("rgb", "thumb_rgb")}
    f32_gaps = {k: gap(k1_fakes[k], f32_fakes[k]) for k in ("rgb", "thumb_rgb")}
    log(f"[train] D-step fakes, K1 vs its plain version: rgb max {fake_gaps['rgb'][0]:.3e} "
        f"mean {fake_gaps['rgb'][1]:.3e} (bounds 0.5, 1e-2), thumb max "
        f"{fake_gaps['thumb_rgb'][0]:.3e} (bound 1e-3); vs the f32 renderer (no bound): rgb "
        f"max {f32_gaps['rgb'][0]:.3e} mean {f32_gaps['rgb'][1]:.3e}, thumb max "
        f"{f32_gaps['thumb_rgb'][0]:.3e}")
    if not all(torch.isfinite(k1_fakes[k]).all() for k in ("rgb", "thumb_rgb")):
        raise AssertionError("D-step fakes not finite")
    if k1_fakes["rgb"].shape != (b, size, size, 3):
        raise AssertionError(f"D-step fakes {tuple(k1_fakes['rgb'].shape)}")
    if not (fake_gaps["rgb"][0] <= 0.5 and fake_gaps["rgb"][1] <= 1e-2
            and fake_gaps["thumb_rgb"][0] <= 1e-3):
        raise AssertionError(f"D-step fakes disagree with the plain version: {fake_gaps}")
    res["fake_gaps"], res["fake_gaps_f32_renderer"] = fake_gaps, f32_gaps

    # SirenRender's gradients on the card (K1 forward, replayed backward),
    # full width, one batch item of those draws, random cotangents: against
    # autograd through the replayed function (the same arithmetic) and
    # through the plain f32 renderer (bf16 products against f32 ones)
    sr = g.map_zs(draws.zs)[0][0].detach().requires_grad_(True)
    flat = lambda x: x[0].reshape(-1, *x.shape[3:]).contiguous()
    from cips3dpp_torch.core.rays import prepare_nerf_inputs

    pts, rays_d, viewdirs, z_vals = (flat(x) for x in prepare_nerf_inputs(
        cam.focal, cfg.img_size, cam.extrinsics, cam.near, cam.far, cfg.n_samples,
        perturb=True, t_rand=draws.t_rand))
    pts.requires_grad_(True)
    rend = g.renderer
    params = list(rend.parameters())
    near, far = cam.near.reshape(-1)[0], cam.far.reshape(-1)[0]
    names = ["styles", "pts"] + [n for n, _ in rend.named_parameters()]
    with counted("SirenRender forward", {"siren_render": 1}):
        outs = ksr.SirenRender.apply(rend, sr, pts, viewdirs, z_vals, rays_d, near, far, *params)
    cots = [torch.randn(o.shape, generator=gen, device=dev) for o in outs]
    got = torch.autograd.grad(outs, [sr, pts] + params, cots)
    ref = ksr.siren_render_reference(rend, sr, pts, viewdirs, z_vals, rays_d, near, far)
    want = torch.autograd.grad(ref, [sr, pts] + params, cots)
    thumb, feat, sdf, maskd, xyz, _ = rend._render_tile(
        pts[None], rays_d[None], viewdirs[None], z_vals[None], cam.near[:1], cam.far[:1], sr[None])
    want32 = torch.autograd.grad([thumb[0], feat[0], sdf[0], maskd[0], xyz[0]],
                                 [sr, pts] + params, cots)
    rel = lambda x, y: float((x - y).abs().max() / y.abs().max().clamp_min(1e-30))
    cos = lambda x, y: float(torch.nn.functional.cosine_similarity(
        x.flatten().double(), y.flatten().double(), dim=0))
    rel_ref = {n: rel(x, y) for n, x, y in zip(names, got, want)}
    rel_32 = {n: rel(x, y) for n, x, y in zip(names, got, want32)}
    cos_32 = {n: cos(x, y) for n, x, y in zip(names, got, want32)}
    worst = lambda dct, f: f(dct.items(), key=lambda kv: kv[1])
    log(f"[train] SirenRender gradients (R={pts.shape[0]}, S={pts.shape[1]}, "
        f"W={cfg.renderer.hidden_dim}; styles, "
        f"pts and {len(params)} renderer parameters): vs autograd through the replayed "
        f"function max relative error {worst(rel_ref, max)} (bound 1e-5); vs the plain f32 "
        f"renderer max relative error {worst(rel_32, max)} (bound 0.25, bf16 products), "
        f"least cosine {worst(cos_32, min)} (bound 0.99)")
    if not all(torch.isfinite(x).all() for x in got):
        raise AssertionError("SirenRender gradients not finite")
    if (max(rel_ref.values()) > 1e-5 or max(rel_32.values()) > 0.25
            or min(cos_32.values()) < 0.99):
        raise AssertionError(f"SirenRender gradients disagree: {rel_ref}, {rel_32}, {cos_32}")
    res["siren_grads"] = {"rel_vs_replay": rel_ref, "rel_vs_f32_renderer": rel_32,
                          "cos_vs_f32_renderer": cos_32}
    return res


@contextlib.contextmanager
def patched(obj, name, wrap):
    """obj.name replaced by wrap(original) inside the block."""
    orig = getattr(obj, name)
    setattr(obj, name, wrap(orig))
    try:
        yield
    finally:
        setattr(obj, name, orig)


@contextlib.contextmanager
def hidden_module(name):
    """Imports of `name` raise ImportError inside the block."""
    missing = object()
    saved = sys.modules.get(name, missing)
    sys.modules[name] = None
    try:
        yield
    finally:
        if saved is missing:
            del sys.modules[name]
        else:
            sys.modules[name] = saved


def cli_json(argv):
    """Run one command of the port's CLI in this process; its last stdout
    line is a JSON object."""
    from cips3dpp_torch.apps import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    if rc != 0:
        raise AssertionError(f"{argv[0]} returned {rc}")
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def read_jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def training_loop_phase(dev, smi, cfg_path=os.path.join(ROOT, "configs", "ffhq.yaml")):
    """Phase 8: sphere-init, train 8 iterations, train --resume to 16, and
    sampling from the trained checkpoint, through the command line, with
    the sections train_base and sample_multi_view of `cfg_path`."""
    import numpy as np

    from cips3dpp_torch.apps import cli
    from cips3dpp_torch.io import checkpoint as ckpt_mod
    from cips3dpp_torch.io.config import load_command_config
    from cips3dpp_torch.train import train_loop as tl

    res = {"config": "train_r1024 (configs/ffhq.yaml train_base), batch 4, f32", "card": smi}
    probe = {"iter_s": [], "flags": [], "saves": [], "restores": [], "snap": None,
             "resumed": None}

    def stamped_prefetch(orig):
        def prefetch(data, device=None, size=2):  # the loop starts here
            torch.cuda.synchronize()
            probe["t"] = time.perf_counter()
            return orig(data, device, size)
        return prefetch

    def timed_ema(orig):
        def ema(state, decay):  # the end of an iteration: wait for the card
            out = orig(state, decay)
            torch.cuda.synchronize()
            now = time.perf_counter()
            probe["iter_s"].append(now - probe["t"])
            probe["t"] = now
            return out
        return ema

    def flagged_steps(orig):
        def make(gen_cfg, cfg):
            d_step, g_step, path_step, sphere_step = orig(gen_cfg, cfg)

            def d(state, real, generator, alpha, d_regularize):
                probe["flags"].append(("d", bool(d_regularize)))
                return d_step(state, real, generator, alpha, d_regularize=d_regularize)

            def p(state, generator):
                probe["flags"].append(("path_reg",))
                return path_step(state, generator)
            return d, g_step, p, sphere_step
        return make

    def flat(sd):
        out = {}
        for k, v in sd.items():
            if isinstance(v, torch.Tensor):
                out[k] = v
            elif isinstance(v, dict) and "state" in v and "param_groups" in v:
                for i, st in v["state"].items():
                    out.update({f"{k}.{i}.{n}": t for n, t in st.items()})
            elif isinstance(v, dict):
                out.update({f"{k}.{n}": t for n, t in v.items()})
        return out

    def timed_save(orig):
        def save(self, step, state, config=None, metrics=None):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            path = orig(self, step, state, config=config, metrics=metrics)
            probe["saves"].append({"step": step, "s": time.perf_counter() - t0,
                                   "bytes": os.path.getsize(path)})
            if step == 8:  # what the resumed run must start from
                probe["snap"] = {k: v.detach().to("cpu", copy=True)
                                 for k, v in flat(state.state_dict()).items()}
            return path
        return save

    def timed_restore(orig):
        def restore(self, state, step=None):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = orig(self, state, step)
            torch.cuda.synchronize()
            probe["restores"].append({"s": time.perf_counter() - t0})
            return out
        return restore

    def checked_resume(orig):
        def resume(self, state):
            restored, step = orig(self, state)
            got = flat(restored.state_dict())
            want = probe["snap"]
            if step != 8 or restored.step != 8 or got.keys() != want.keys():
                raise AssertionError(f"resume: step {step}, state step {restored.step}")
            bad = [k for k in want if not torch.equal(got[k].cpu(), want[k])]
            if bad:
                raise AssertionError(f"resume: {len(bad)} tensors differ from those saved, "
                                     f"e.g. {bad[:5]}")
            probe["resumed"] = {"step": step, "tensors": len(want),
                                "values": sum(v.numel() for v in want.values())}
            return restored, step
        return resume

    with tempfile.TemporaryDirectory() as tmp, contextlib.ExitStack() as stack:
        # the card has no PyYAML; hide it where it exists, so --cfg is
        # always read by the standard-library reader here
        stack.enter_context(hidden_module("yaml"))
        for obj, name, wrap in ((tl, "ema_update", timed_ema),
                                (tl, "prefetch_to_device", stamped_prefetch),
                                (tl, "make_train_steps", flagged_steps),
                                (ckpt_mod.CheckpointManager, "save", timed_save),
                                (ckpt_mod.CheckpointManager, "restore", timed_restore),
                                (tl.Trainer, "resume", checked_resume)):
            stack.enter_context(patched(obj, name, wrap))
        data = os.path.join(tmp, "data")
        os.makedirs(data)
        size = load_command_config(cfg_path, "train_base")["data_img_size"]
        rng = np.random.default_rng(SEED)
        np.save(os.path.join(data, f"images-{size}-0000.npy"),
                rng.integers(0, 256, (8, size, size, 3), dtype=np.uint8))
        base = ["--cfg", cfg_path, "--section", "train_base"]

        with counted("sphere-init (20 iterations)", {}):
            t0 = time.perf_counter()
            out = cli_json(["sphere-init", *base, "--outdir", f"{tmp}/si", "--n-iters", "20"])
            torch.cuda.synchronize()
            res["sphere_init_s"] = time.perf_counter() - t0
        losses = [r["sphere_init_l1"] for r in read_jsonl(f"{tmp}/si/logs/sphere_init.jsonl")]
        if out["step"] != 0 or ckpt_mod.checkpoint_steps(out["ckpt"]) != [0] or \
                not all(np.isfinite(losses)):
            raise AssertionError(f"sphere-init: {out}, losses {losses}")
        log(f"[loop] sphere-init: 20 iterations in {res['sphere_init_s']:.2f} s (set-up "
            f"included), sphere_init_l1 at step 0 {losses[0]:.4f}, step-0 checkpoint written")

        run = f"{tmp}/run"
        train = ["train", *base, "--data", data, "--outdir", run]
        peaks, k1 = [], 0
        for label, extra in (("train 0-8", ["--total-iters", "8", "--no-sphere-init"]),
                             ("train --resume 8-16", ["--total-iters", "16", "--resume"])):
            n_before = len(probe["iter_s"])
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            with counted(label, {"siren_render": 4 * 8}) as launches:
                t0 = time.perf_counter()
                out = cli_json(train + extra)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            k1 += launches["siren_render"]
            peaks.append(torch.cuda.max_memory_allocated())
            if out != {"outdir": run, "done": True}:
                raise AssertionError(f"{label}: {out}")
            its = probe["iter_s"][n_before:]
            if len(its) != 8:
                raise AssertionError(f"{label}: {len(its)} iterations, want 8")
            log(f"[loop] {label}: {wall:.2f} s with set-up and checkpoints; iteration wall "
                f"times (s, to a synchronise at each end) {', '.join(f'{x:.3f}' for x in its)}; "
                f"peak allocated {peaks[-1] / 2**30:.2f} GiB; {smi}")
            res[label] = {"wall_s": wall, "iter_s": its, "peak_bytes": peaks[-1]}
        want_flags = []
        for idx in range(16):
            want_flags.append(("d", (idx + 1) % 15 == 0))
            if (idx + 1) % 5 == 0:
                want_flags.append(("path_reg",))
        if probe["flags"] != want_flags:
            raise AssertionError(f"step flags {probe['flags']}, want {want_flags}")
        if probe["resumed"] is None:
            raise AssertionError("train --resume did not restore a checkpoint")
        log(f"[loop] train --resume started at step {probe['resumed']['step']} from "
            f"{probe['resumed']['tensors']} tensors ({probe['resumed']['values']} values) "
            f"bit-equal to those saved at step 8")
        records = read_jsonl(f"{run}/logs/metrics.jsonl")
        if [r["step"] for r in records] != [7, 9, 15]:
            raise AssertionError(f"log points {[r['step'] for r in records]}")
        bad = {(r["step"], k): v for r in records for k, v in r.items() if not np.isfinite(v)}
        if bad:
            raise AssertionError(f"non-finite logged values {bad}")
        if ckpt_mod.checkpoint_steps(f"{run}/ckpt") != [8, 16] or \
                not os.path.exists(f"{run}/ckpt/config_command.yaml"):
            raise AssertionError(f"checkpoints {os.listdir(f'{run}/ckpt')}")
        its = probe["iter_s"]  # idx 0-15 in order
        plain = [its[i] for i in range(16) if i not in (0, 8) and (i + 1) % 5 and (i + 1) % 15]
        res["iteration_s"] = {"first_of_each_run": [its[0], its[8]],
                              "plain_mean": sum(plain) / len(plain), "plain_n": len(plain),
                              "path_reg": [its[4], its[9]], "r1_and_path_reg": its[14]}
        res["iters_per_sec"] = {r["step"]: r["iters_per_sec"] for r in records}
        res["checkpoint_saves"] = probe["saves"]
        res["checkpoint_restores"] = probe["restores"]
        res["resumed"] = probe["resumed"]
        res["peak_bytes"] = max(peaks)
        res["logged"] = records
        it = res["iteration_s"]
        log(f"[loop] iteration wall times (s, to a synchronise at each end): first of each "
            f"run {it['first_of_each_run'][0]:.3f} / {it['first_of_each_run'][1]:.3f}, plain "
            f"{it['plain_mean']:.3f} (mean of {len(plain)}), with path reg (idx 4, 9) "
            f"{it['path_reg'][0]:.3f} / {it['path_reg'][1]:.3f}, with lazy R1 and path reg "
            f"(idx 14) {it['r1_and_path_reg']:.3f}; the logger's iters_per_sec by log point "
            f"{res['iters_per_sec']}; {smi}")
        for sv in probe["saves"]:
            log(f"[loop] checkpoint step {sv['step']}: {sv['bytes']} bytes saved in "
                f"{sv['s']:.3f} s; {smi}")
        for rs in probe["restores"]:
            log(f"[loop] checkpoint restored in {rs['s']:.3f} s; {smi}")
        log(f"[loop] logged losses finite at steps {[r['step'] for r in records]}; "
            f"checkpoints {ckpt_mod.checkpoint_steps(f'{run}/ckpt')} with config_command.yaml; "
            f"peak allocated {res['peak_bytes'] / 2**30:.2f} GiB")

        # sampling from the trained checkpoint: G_ema of step 16
        opts = ["--opts", "ckpt", f"{run}/ckpt"]
        model, _ = cli._build_generator(
            {**load_command_config(cfg_path, "sample_multi_view"), "ckpt": f"{run}/ckpt"}, dev)
        want = ckpt_mod.CheckpointManager(f"{run}/ckpt").restore_raw()["state"]["g_ema"]
        got = model.state_dict()
        if not all(torch.equal(got[k].cpu(), want[k]) for k in want):
            raise AssertionError("the sampling generator is not the checkpoint's G_ema")
        del model
        with counted("sample-multi-view --fused from the checkpoint (2 frames)",
                     {"siren_render": 2, "decoder_block_f32": 8}) as l_sample:
            t0 = time.perf_counter()
            out = cli_json(["sample-multi-view", "--fused", "--cfg", cfg_path, "--section",
                            "sample_multi_view", "--outdir", f"{tmp}/mv", "--n-frames", "2",
                            *opts])
            sample_s = time.perf_counter() - t0
        if out["frames"] != 2 or not os.path.exists(out["grid"]):
            raise AssertionError(f"sample-multi-view: {out}")
        import shutil

        shutil.copy(out["grid"], os.path.join(OUT, "trained_checkpoint_frames.png"))
        log(f"[loop] sample-multi-view --fused from the step-16 checkpoint: 2 frames in "
            f"{sample_s:.2f} s (set-up and depth video included), G_ema equal to the "
            f"checkpoint's")
        res["sampling"] = {"launches": l_sample, "s": sample_s}
        res["launches"] = {"siren_render": k1 + l_sample["siren_render"],
                           "decoder_block_f32": l_sample["decoder_block_f32"]}
    return res


INV_CUT = {"n_steps_pose": 6, "n_steps_app": 10, "n_steps_multiview": 2}
INV_AZIM = 0.25  # the target's azimuth, azim*
# One projector step's gradients through K1, held by group (camera,
# w_render, w_decoder) to (least cosine, largest max|diff| /
# max|reference|) against the same step computed other ways:
#   "kernel": K1's plain version in K1's place; the backward is the same
#     replay, so only the forward's f32 summation order differs;
#   "bf16": siren_render_reference, the function K1 computes (bf16 matmul
#     inputs, f32 sums; JAX's custom_vjp replays the same), in place of
#     SirenRender, differentiated by autograd. It checks the replayed
#     backward and that SirenRender's inputs carry every camera path. Its
#     forward has torch.sin and the bias unfolded where K1 has a polynomial
#     sine and the bias folded, so the cotangents differ more than under
#     "kernel";
#   "route": the same stand-in with f32 matmul inputs against the plain
#     f32 renderer (fused=False). It checks the renderer's fused branch
#     (near and far of item 0, one call an item) against the plain one;
#   "f32": K1 against the plain f32 renderer, which "bf16" and "route"
#     split: the styles keep phase 7's bounds. The camera's gradient (four
#     numbers, each a sum over every sample point) has no bound here: what
#     parts K1 from the f32 renderer is the bf16 rounding of the matmul
#     inputs, and "bf16" and "route" hold each side of it.
# With the sample points or the view directions detached before K1, the
# camera's gradient must fail "bf16" (INV_PLANTED), or that gate sees no
# dropped path. rays_d is detached too, as a finding: it enters only
# through its norm, which the camera's rotation keeps.
INV_GROUPS = {"camera": ("azim", "elev"), "w_render": ("w_render",),
              "w_decoder": ("w_decoder",)}
INV_GRAD_BOUNDS = {
    "kernel": dict.fromkeys(INV_GROUPS, (0.999, 0.05)),
    "bf16": dict.fromkeys(INV_GROUPS, (0.999, 0.1)),
    "route": dict.fromkeys(INV_GROUPS, (0.999, 0.05)),
    "f32": {"camera": None, "w_render": (0.99, 0.25), "w_decoder": (0.99, 0.25)},
}
# siren_render_fused(renderer, styles, pts, viewdirs, z_vals, rays_d, near,
# far): the argument detached, and whether "bf16" must see it
INV_PLANTED = {"pts": (2, True), "viewdirs": (3, True), "rays_d": (5, False)}


def write_jax_inversion(path: str, blob: dict) -> str:
    """The port's inversion artifact (`Projector.save_inversion`'s dict)
    written as the JAX package writes one (cips3dpp_tpu/apps/inversion.py:
    445-451), with numpy and pickle only: numpy arrays under flax names
    and layouts, which the port's `load_jax_inversion` and JAX's
    `Projector.load_inversion` read. The reference's unused StyledConv.bias
    is dropped, as the JAX tree has none. Phase 9 renders from it; the CPU
    tests hold it against the JAX package's reader."""
    import pickle

    import numpy as np

    sd = {f"decoder.{k}": v.numpy() for k, v in blob["decoder_params"].items()}
    sd.update({f"renderer.{k}": v.numpy() for k, v in blob["renderer_params"].items()})

    def lin(p):
        return {"weight": np.ascontiguousarray(sd[f"{p}.weight"].T), "bias": sd[f"{p}.bias"]}

    def film(p):
        return {**lin(p), "gamma": lin(f"{p}.gamma"), "beta": lin(f"{p}.beta")}

    def modconv(p):
        return {"weight": np.ascontiguousarray(sd[f"{p}.weight"][0].transpose(2, 3, 1, 0)),
                "modulation": lin(f"{p}.modulation")}

    def styled(p):
        return {"conv": modconv(f"{p}.conv"), "noise": {"weight": sd[f"{p}.noise.weight"]},
                "act_bias": sd[f"{p}.activate.bias"]}

    def torgb(p):
        return {"conv": modconv(f"{p}.conv"), "bias": sd[f"{p}.bias"].reshape(-1)}

    count = lambda prefix, leaf: sum(k.startswith(prefix) and k.endswith(leaf)
                                     and k[len(prefix):-len(leaf)].isdigit() for k in sd)
    n_convs = count("decoder.convs.", ".noise.weight")
    n_rgbs = count("decoder.to_rgbs.", ".conv.weight")
    decoder = {"conv1": styled("decoder.conv1"), "to_rgb1": torgb("decoder.to_rgb1")}
    decoder.update({f"convs_{i}": styled(f"decoder.convs.{i}") for i in range(n_convs)})
    decoder.update({f"to_rgbs_{i}": torgb(f"decoder.to_rgbs.{i}") for i in range(n_rgbs)})
    n_pts = count("renderer.network.pts_linears.", ".gamma.weight")
    network = {f"pts_{i}": film(f"renderer.network.pts_linears.{i}") for i in range(n_pts)}
    network.update(views=film("renderer.network.views_linears"),
                   rgb_head=lin("renderer.network.rgb_linear"),
                   sigma_head=lin("renderer.network.sigma_linear"))
    a = lambda x: np.asarray(x, np.float32)
    out = {"azim": a(blob["azim"]), "elev": a(blob["elev"]),
           "w_render_opt": a(blob["w_render_opt"]), "w_decoder_opt": a(blob["w_decoder_opt"]),
           "decoder_params": decoder,
           "renderer_params": {"sigmoid_beta": sd["renderer.sigmoid_beta"], "network": network},
           "noise_bufs": [a(b) for b in blob["noise_bufs"]]}
    with open(path, "wb") as f:
        pickle.dump(out, f)
    return path


def _step_kind(step, cfg):
    """pose, appearance, appearance with the decoder styles flipped, or
    multiview: the four kinds of projector step."""
    from cips3dpp_torch.apps.inversion import step_plan

    if step < cfg.n_steps_pose:
        return "pose"
    if step < cfg.n_steps_pose + cfg.n_steps_app:
        return "appearance, flip" if step_plan(step, cfg)[1] else "appearance"
    return "multiview"


def inversion_phase(dev, smi, profile=False,
                    cfg_path=os.path.join(ROOT, "configs", "ffhq.yaml")):
    """Phase 9: flip-inversion at r1024 through the command line, with the
    flip_inversion section of `cfg_path` read by the standard-library YAML
    reader, a full-width seeded generator (saved as a .pth and named by
    network_pkl) and the random VGG and LPIPS. The target is a frame the
    same generator renders from its mean latents at azim* (the JAX
    package's self-recovery gate, tests/test_apps.py:201-245); `invert`
    starts near the front. Then render-inverted of 4 frames from the port's
    artifact and from the same artifact in JAX's w.pkl format (bit-equal
    frames), a second invert of a target at -azim*, and lerp-inversions
    over both. Beside the commands: one appearance step's gradients
    through K1 against the same step computed four other ways
    (INV_GRAD_BOUNDS) and with planted faults (INV_PLANTED), and the
    inverted views through the kernels (F = 1) against the plain frames. With `profile`, the
    device time of one appearance step by kernel group."""
    import shutil

    import numpy as np

    from cips3dpp_torch.apps import inversion as inv
    from cips3dpp_torch.apps import sample as sample_mod
    from cips3dpp_torch.core.camera import camera_from_angles
    from cips3dpp_torch.io.config import generator_config_from_dict, load_command_config
    from cips3dpp_torch.kernels import _lib
    from cips3dpp_torch.kernels import siren_render as ksr
    from cips3dpp_torch.models.generator import Generator
    from cips3dpp_torch.models.layers import randomize_zero_init_
    from cips3dpp_torch.models.vgg import init_vgg
    from cips3dpp_torch.utils.metrics import psnr

    res = {"card": smi, "schedule": dict(INV_CUT, full=1200), "azim_true": INV_AZIM}
    probe = {"steps": [], "first_rgb": None}

    def timed_step(orig):
        def step(self, state, targets, t_rand, lrs, flip, mask_bg):
            k1 = _lib.LAUNCHES["siren_render"]
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = orig(self, state, targets, t_rand, lrs, flip, mask_bg)
            end.record()
            torch.cuda.synchronize()
            probe["steps"].append({"ms": start.elapsed_time(end),
                                   "k1": _lib.LAUNCHES["siren_render"] - k1,
                                   "metrics": {k: float(v) for k, v in out[1].items()}})
            return out
        return step

    def first_render(orig):
        def forward(self, leaves, t_rand, flip):
            out = orig(self, leaves, t_rand, flip)
            if probe["first_rgb"] is None:
                probe["first_rgb"] = out["rgb"][0].detach().clone()
            return out
        return forward

    def kept_frames(orig):
        def save_video(frames, path, fps=30):
            probe["frames"] = np.array(frames)
            return orig(frames, path, fps)
        return save_video

    with tempfile.TemporaryDirectory() as tmp, contextlib.ExitStack() as stack:
        stack.enter_context(hidden_module("yaml"))  # the card has no PyYAML
        section = load_command_config(cfg_path, "flip_inversion")
        gcfg = generator_config_from_dict(section["G_cfg"])
        fields = {f.name for f in dataclasses.fields(inv.InversionConfig)}
        icfg = inv.InversionConfig(**{k: v for k, v in {**section, **INV_CUT}.items()
                                      if k in fields})
        full_steps = {k: section[k] for k in INV_CUT}
        log(f"[inversion] {os.path.relpath(cfg_path, ROOT)} flip_inversion at full width "
            f"(r{gcfg.out_size}, {gcfg.img_size}^2 rays x {gcfg.n_samples} samples, SIREN width "
            f"{gcfg.renderer.hidden_dim}, w_avg_samples {icfg.w_avg_samples}); the schedule "
            f"cut to {INV_CUT} of {full_steps}, {sum(full_steps.values())} steps; random "
            f"weights, VGG and LPIPS from seeds")
        model = Generator(gcfg, device=dev, seed=SEED + 30)
        randomize_zero_init_(model, torch.Generator().manual_seed(SEED + 30))
        ckpt = os.path.join(tmp, "g.pth")
        torch.save({k: v.cpu() for k, v in model.state_dict().items()}, ckpt)
        size = gcfg.out_size

        # targets: the generator's mean latents at +-azim*, the projector's
        # noise buffers (seed 0), through the kernels at F = 1
        means = model.mean_latents(torch.Generator().manual_seed(SEED + 31), 10_000)
        sr = means[0][:, None, :].repeat(1, gcfg.renderer.n_layers + 1, 1)
        sd = means[1][:, None, :].repeat(1, model.decoder.n_latent, 1)
        noise0 = model.decoder.make_noise(torch.Generator().manual_seed(0), gcfg.img_size,
                                          device=dev)
        frame = sample_mod.make_frame_renderer(model, fused=True)
        targets = {}
        with counted("inversion targets (2 frames)",
                     {"siren_render": 2, "decoder_block_f32": 8}) as l_targets:
            for sign in (1, -1):
                cam = camera_from_angles(
                    torch.tensor([sign * INV_AZIM], device=dev), torch.zeros(1, device=dev),
                    gcfg.img_size, fov_ang=gcfg.fov_ang, dist_radius=gcfg.dist_radius)
                rgb = frame(sr, sd, cam.extrinsics, cam.focal, cam.near, cam.far, noise0)[0]
                u8 = sample_mod._to_u8(rgb[0].float().cpu().numpy())
                path = os.path.join(tmp, f"target_{'+' if sign > 0 else '-'}.png")
                sample_mod.write_png(path, u8)
                targets[sign] = (path, torch.from_numpy(u8.astype(np.float32) / 127.5 - 1.0))
        shutil.copy(targets[1][0], os.path.join(OUT, "inversion_target.png"))

        base = ["--cfg", cfg_path, "--section", "flip_inversion"]
        opts = ["--opts", "network_pkl", ckpt] + [x for k, v in INV_CUT.items()
                                                   for x in (k, str(v))]
        for obj, name, wrap in ((inv.Projector, "step", timed_step),
                                (inv.Projector, "forward", first_render),
                                (sample_mod, "save_video", kept_frames)):
            stack.enter_context(patched(obj, name, wrap))
        n_steps = sum(INV_CUT.values())
        runs = {}
        for sign in (1, -1):
            probe["steps"], probe["first_rgb"] = [], None
            outdir = os.path.join(tmp, f"inv_{'+' if sign > 0 else '-'}")
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            with counted(f"invert, target at azim {sign * INV_AZIM}",
                         {"siren_render": 2 * n_steps + 2}) as launches:
                t0 = time.perf_counter()
                report = cli_json(["invert", *base, "--image", targets[sign][0], "--outdir",
                                   outdir, "--azim-init", "0.02", "-0.02", *opts])
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            steps = probe["steps"]
            if len(steps) != n_steps or any(st["k1"] != 2 for st in steps):
                raise AssertionError(f"invert: {len(steps)} steps, K1 launches a step "
                                     f"{[st['k1'] for st in steps]}, want {n_steps} x 2")
            losses = [st["metrics"]["loss"] for st in steps]
            if not np.all(np.isfinite(losses)):
                raise AssertionError(f"invert: non-finite losses {losses}")
            percep = [st["metrics"]["percep"] for st in steps]
            if not percep[-1] < percep[0]:
                raise AssertionError(f"invert: percep {percep[0]} -> {percep[-1]} did not fall")
            target_t = targets[sign][1].to(dev)
            psnr0 = float(psnr(probe["first_rgb"], target_t))
            by_kind = {}
            for i, st in enumerate(steps[1:], start=1):
                by_kind.setdefault(_step_kind(i, icfg), []).append(st["ms"])
            kind_ms = {k: sum(v) / len(v) for k, v in by_kind.items()}
            full = dataclasses.replace(icfg, **full_steps)
            n_full = full.n_steps_pose + full.n_steps_app + full.n_steps_multiview
            extrap_s = sum(kind_ms[_step_kind(i, full)] for i in range(n_full)) / 1e3
            az = report["azim"][0]
            run = {"wall_s": wall, "launches": launches, "peak_bytes":
                   torch.cuda.max_memory_allocated(), "first_step_ms": steps[0]["ms"],
                   "ms_by_kind": kind_ms, "n_by_kind": {k: len(v) for k, v in by_kind.items()},
                   "extrapolated_full_s": extrap_s, "losses": losses, "percep": percep,
                   "psnr_step0": psnr0, "psnr_final": report["psnr"],
                   "azim_err_step0": abs(0.02 - sign * INV_AZIM),
                   "azim_err_final": abs(az - sign * INV_AZIM), "report": report}
            runs[sign] = run
            log(f"[inversion] invert, target at azim {sign * INV_AZIM}: {wall:.2f} s wall "
                f"(set-up, {n_steps} steps, final render and report); step ms (CUDA events) "
                f"first {steps[0]['ms']:.1f}, then by kind "
                f"{ {k: round(v, 1) for k, v in kind_ms.items()} } (steps "
                f"{run['n_by_kind']}); peak allocated {run['peak_bytes'] / 2**30:.2f} GiB; "
                f"K1 {launches['siren_render']} launches (2 a step + 2 for the final render), "
                f"no K2; {smi}")
            log(f"[inversion] percep {percep[0]:.5g} -> {percep[-1]:.5g}, loss {losses[0]:.6g} "
                f"-> {losses[-1]:.6g}; PSNR against the target at step 0 {psnr0:.3f} dB, final "
                f"{report['psnr']:.3f} dB; |azim - azim*| 0.02 start {run['azim_err_step0']:.4f}"
                f" -> {run['azim_err_final']:.4f} (findings, not gates: a random VGG in "
                f"{n_steps} steps); extrapolated full {n_full}-step schedule "
                f"{extrap_s:.1f} s ({extrap_s / 60:.2f} min)")
            shutil.copy(os.path.join(outdir, "proj.png"),
                        os.path.join(OUT, f"inversion_proj_{'+' if sign > 0 else '-'}.png"))
        res["invert"] = {str(k): v for k, v in runs.items()}
        art = os.path.join(tmp, "inv_+", "w.pt")

        # one appearance step's gradients through K1 (SirenRender) against
        # the same step computed other ways (INV_GRAD_BOUNDS), on the card
        vgg = init_vgg(torch.Generator().manual_seed(0), device=dev)
        proj_k1, proj_plain = inv.Projector(model, vgg, icfg), inv.Projector(model, vgg, icfg,
                                                                              fused=False)
        state = proj_k1.init_state(torch.Generator().manual_seed(SEED + 32), (0.02, -0.02))
        tg = proj_k1.prepare_targets(targets[1][1].numpy())
        t_rand = torch.rand((2, gcfg.img_size, gcfg.img_size, 1),
                            generator=torch.Generator().manual_seed(SEED + 33))
        step_i = icfg.n_steps_pose + 1
        _, flip, mask_bg = inv.step_plan(step_i, icfg)
        k1_fused = ksr.siren_render_fused

        def step_grads(name, proj, stand_in=None, want=None):
            """(metrics, gradients) of the step; `stand_in` takes the place
            of siren_render_fused, the renderer's fused call."""
            with contextlib.ExitStack() as st:
                if stand_in is not None:
                    st.enter_context(patched(ksr, "siren_render_fused", lambda _: stand_in))
                launches = st.enter_context(counted(f"appearance step, {name}", want or {}))
                out = proj.loss_and_grads(state, tg, t_rand, flip, mask_bg)
            return out, launches

        def reference(dtype):
            return lambda *args: ksr.siren_render_reference(*args, matmul_dtype=dtype)

        def detached(index):
            def call(*args):
                args = list(args)
                args[index] = args[index].detach()
                return k1_fused(*args)
            return call

        def gap_of(x, y, group):
            x = torch.cat([x[k].flatten() for k in INV_GROUPS[group]]).double()
            y = torch.cat([y[k].flatten() for k in INV_GROUPS[group]]).double()
            return {"cos": float(torch.nn.functional.cosine_similarity(x, y, dim=0)),
                    "max_rel": float((x - y).abs().max() / y.abs().max().clamp_min(1e-30))}

        def within(got, bound):
            return got["cos"] > bound[0] and got["max_rel"] <= bound[1]

        (m_k1, g_k1), l_grad = step_grads("K1", proj_k1, want={"siren_render": 2})
        with plain_kernels():
            (m_kp, g_kp), _ = step_grads("K1's plain version", proj_k1)
        (m_b16, g_b16), _ = step_grads("bf16 plain renderer", proj_k1,
                                       reference(torch.bfloat16))
        (m_r32, g_r32), _ = step_grads("f32 stand-in on the fused route", proj_k1,
                                       reference(torch.float32))
        (m_pl, g_pl), _ = step_grads("plain f32 renderer", proj_plain)
        if not all(torch.isfinite(g).all() for g in g_k1.values()):
            raise AssertionError("inversion gradients through K1 not finite")
        grads = {}
        for kind, name, x, y in (("kernel", "K1 vs K1's plain version", g_k1, g_kp),
                                 ("bf16", "K1 vs the bf16 plain renderer", g_k1, g_b16),
                                 ("route", "the f32 stand-in on the fused route vs the "
                                  "plain f32 renderer", g_r32, g_pl),
                                 ("f32", "K1 vs the plain f32 renderer", g_k1, g_pl)):
            for group in INV_GROUPS:
                got = gap_of(x, y, group)
                grads[f"{group}: {name}"] = got
                bound = INV_GRAD_BOUNDS[kind][group]
                held = (f"bound cosine > {bound[0]}, max relative difference <= {bound[1]}"
                        if bound else "no bound: the bf16 rounding, held by 'bf16' and 'route'")
                log(f"[inversion] appearance step {step_i} (mask on, no flip), {group} "
                    f"gradient, {name}: cosine {got['cos']:.6f}, max relative difference "
                    f"{got['max_rel']:.3e} ({held})")
                if bound and not within(got, bound):
                    raise AssertionError(f"inversion gradients disagree: {group}, {name}: "
                                         f"{got}")
        log(f"[inversion] loss through K1 {float(m_k1['loss']):.6g}, K1's plain version "
            f"{float(m_kp['loss']):.6g}, bf16 plain renderer {float(m_b16['loss']):.6g}, "
            f"f32 stand-in {float(m_r32['loss']):.6g}, plain f32 renderer "
            f"{float(m_pl['loss']):.6g}")
        for arg, (index, must_fail) in INV_PLANTED.items():
            (_, g_bad), _ = step_grads(f"K1 with {arg} detached (planted fault)", proj_k1,
                                       detached(index), want={"siren_render": 2})
            got = gap_of(g_bad, g_b16, "camera")
            grads[f"camera: K1 with {arg} detached vs the bf16 plain renderer"] = got
            caught = not within(got, INV_GRAD_BOUNDS["bf16"]["camera"])
            log(f"[inversion] planted fault, {arg} detached before K1: camera gradient vs "
                f"the bf16 plain renderer cosine {got['cos']:.6f}, max relative difference "
                f"{got['max_rel']:.3e}: {'fails' if caught else 'passes'} the 'bf16' bounds"
                + ("" if must_fail else " (|rays_d| does not depend on the camera)"))
            if must_fail and not caught:
                raise AssertionError(f"the 'bf16' gradient bounds do not see {arg} detached")
        res["grads"] = grads
        if profile:
            lrs = inv.step_plan(step_i, icfg)[0]
            res["profile"] = profile_calls(
                lambda: proj_k1.step(state, tg, t_rand, lrs, flip, mask_bg),
                runs[1]["ms_by_kind"]["appearance"], n=1, what="projector step",
                table="profile_inversion_step.txt")
        del proj_k1, proj_plain, tg

        # the inverted views through the kernels (F = 1) against the plain frames
        blob = inv.Projector.load_inversion(art)
        inv.restore_inverted(model, blob)
        azim0 = float(blob["azim"][0, 0])
        cams = sample_mod.yaw_trajectory(4, gcfg.img_size, azim_range=(azim0 - 0.3, azim0 + 0.3),
                                         elev=float(blob["elev"][0, 0]), fov_ang=gcfg.fov_ang,
                                         dist_radius=gcfg.dist_radius, device=dev)
        views_noise = [b.to(dev) for b in blob["noise_bufs"]]
        wr, wd = blob["w_render_opt"].to(dev), blob["w_decoder_opt"].to(dev)

        def views():
            f = sample_mod.make_frame_renderer(model, fused=True)
            return torch.cat([f(wr, wd, *(c[i:i + 1] for c in cams[:4]), views_noise)[0]
                              for i in range(4)])

        with counted("inverted views, kernels (4 frames at F = 1)",
                     {"siren_render": 4, "decoder_block_f32": 16}) as l_views:
            fused_views = views()
        with plain_kernels():
            with counted("inverted views, plain kernels", {}):
                plain_views = views()
        v_max, v_mean = gap(fused_views, plain_views)
        log(f"[inversion] inverted views through K1 + f32 K2 vs the plain kernels: max "
            f"{v_max:.3e}, mean {v_mean:.3e} (bounds 0.1, 1e-3)")
        if not torch.isfinite(fused_views).all() or not (v_max <= 0.1 and v_mean <= 1e-3):
            raise AssertionError(f"inverted views disagree: {v_max}, {v_mean}")
        res["views_gap"] = [v_max, v_mean]

        # render-inverted from the port's artifact and from it in JAX's format
        jax_art = write_jax_inversion(os.path.join(tmp, "w.pkl"), blob)
        rendered = {}
        for name, path in (("w.pt", art), ("w.pkl", jax_art)):
            with counted(f"render-inverted --n-frames 4 ({name}, plain modules)", {}):
                t0 = time.perf_counter()
                out = cli_json(["render-inverted", *base, "--inversion", path, "--outdir",
                                os.path.join(tmp, f"views_{name}"), "--n-frames", "4",
                                "--opts", "network_pkl", ckpt])
                res[f"render_inverted_s ({name})"] = time.perf_counter() - t0
            rendered[name] = probe["frames"]
            if rendered[name].shape != (4, size, size, 3) or not os.path.exists(out["grid"]):
                raise AssertionError(f"render-inverted {name}: {out}")
        if not np.array_equal(rendered["w.pt"], rendered["w.pkl"]):
            raise AssertionError("render-inverted: the JAX-format artifact renders other frames")
        shutil.copy(out["grid"], os.path.join(OUT, "inversion_views.png"))
        log(f"[inversion] render-inverted: 4 frames from w.pt in "
            f"{res['render_inverted_s (w.pt)']:.2f} s, from the JAX-format w.pkl in "
            f"{res['render_inverted_s (w.pkl)']:.2f} s, bit-equal")

        with counted("lerp-inversions --n-interp 3 (plain modules)", {}):
            t0 = time.perf_counter()
            out = cli_json(["lerp-inversions", *base, "--inversions", art,
                            os.path.join(tmp, "inv_-", "w.pt"), "--outdir",
                            os.path.join(tmp, "lerp"), "--n-interp", "3", "--opts",
                            "network_pkl", ckpt])
            res["lerp_s"] = time.perf_counter() - t0
        if out["frames"] != 6 or probe["frames"].shape != (6, size, size, 3) or \
                not np.isfinite(probe["frames"]).all():
            raise AssertionError(f"lerp-inversions: {out}")
        log(f"[inversion] lerp-inversions: 6 frames in {res['lerp_s']:.2f} s; {smi}")
    res["launches"] = {"siren_render": l_targets["siren_render"] + sum(
        r["launches"]["siren_render"] for r in runs.values()) + l_grad["siren_render"]
        + l_views["siren_render"],
        "decoder_block_f32": l_targets["decoder_block_f32"] + l_views["decoder_block_f32"]}
    return res


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
    for lib, rep in ptxas.items():  # each kernel's registers and spills, by entry
        for line in rep.splitlines():
            if "entry function" in line or "registers" in line or "spill" in line:
                log(f"[build] {lib}: {line.strip()}")
    report["build_s"] = build_s
    report["ptxas"] = ptxas
    # every K2 / K3 instantiation: shared memory (sizeof(Smem)), blocks an SM,
    # registers and local (spill) bytes a thread, tile geometry
    report["decoder_block_info"] = {}
    for mode, (dt, hashed, k3) in {
            "bf16": (torch.bfloat16, False, False), "bf16-hash": (torch.bfloat16, True, False),
            "f32": (torch.float32, False, False), "f32-hash": (torch.float32, True, False),
            "K3": (torch.float32, False, True)}.items():
        for c in kdb.KERNEL_CHANNELS:
            info = kdb.decoder_block_info(c, dt, hashed, k3)
            report["decoder_block_info"][f"{mode} C={c}"] = info
            log(f"[build] block_kernel {mode} C={c}: {info['smem_bytes']} B shared, "
                f"{info['blocks_per_sm']} block(s) an SM, {info['registers']} registers, "
                f"{info['local_bytes']} B local, tile {info['tile_input_columns']} input "
                f"columns = {info['tile_pixels']} output pixels")

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
    # same arithmetic and rounding points; only f32 summation orders
    # differ, and the rare bf16 flips they cause are amplified by gamma
    # ~ 30-45 in the sin. The bounds sit 10x (feat) to 90x (xyz) above the
    # largest readings on the H100, here and in the card test at R = 5,
    # 1001, 4096 (PERF.md section 6)
    tol = {"thumb": 1e-3, "feat": 5e-3, "sdf": 1e-3, "mask_depth": 1e-4, "xyz": 1e-4}
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
    # f32 on the CUDA cores per (row, channel). The dot products, which the
    # plain version computes as matmuls and which may contract to FMA:
    # layer 0 (6), sdf and rgb heads (2 + 6). Kept apart as in the plain
    # version, one operation an instruction: three phases (2 each) and
    # sines (13 each), feat sum (2)
    k1_dot = rows * width * (6 + 2 + 6)
    k1_apart = rows * width * (3 * (2 + 13) + 2)
    k1_bound, k1_by = bound(k1_bytes, k1_bf16, k1_dot, k1_apart)
    k1_terms = {"bf16_tensor_ms": k1_bf16 / PEAK_BF16 * 1e3,
                "f32_apart_ms": k1_apart / PEAK_F32_APART * 1e3,
                "f32_dot_ms": k1_dot / PEAK_F32 * 1e3,
                "bytes_ms": k1_bytes / PEAK_BYTES * 1e3}
    log(f"[K1] {k1_ms:.4f} ms kernel ({k1_call_ms:.4f} a call), {k1_plain_ms:.4f} ms plain, bound "
        f"{k1_bound:.4f} ms ({k1_by}; bf16 tensor {k1_terms['bf16_tensor_ms']:.4f} ms for "
        f"{k1_bf16 / 1e9:.1f} GFLOP; f32 unfused {k1_terms['f32_apart_ms']:.4f} ms for "
        f"{k1_apart / 1e9:.3f} G ops + f32 dot products {k1_terms['f32_dot_ms']:.4f} ms for "
        f"{k1_dot / 1e9:.3f} G ops; bytes {k1_terms['bytes_ms']:.4f} ms); "
        f"{k1_ms / k1_bound:.2f}x the bound, at R={r}, S={s}, W={width}")
    report["K1"] = {"errs": errs, "err": max(errs.values()), "ms": k1_ms, "call_ms": k1_call_ms,
                    "plain_ms": k1_plain_ms, "bound_ms": k1_bound, "bound_by": k1_by,
                    "bytes": k1_bytes, "bf16_flops": k1_bf16, "f32_dot_ops": k1_dot,
                    "f32_apart_ops": k1_apart, "bound_terms_ms": k1_terms}

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

    # ---- 7. the training slice ----
    with torch.inference_mode(False), torch.enable_grad():
        report["training"] = training_phase(dev, profile="--profile" in sys.argv[1:])

    # ---- 8. the training loop through the command line ----
    with torch.inference_mode(False), torch.enable_grad():
        report["training_loop"] = training_loop_phase(dev, smi)

    # ---- 9. flip-inversion at r1024 through the command line ----
    with torch.inference_mode(False):
        report["inversion"] = inversion_phase(dev, smi, profile="--profile" in sys.argv[1:])

    # ---- the kernels line ----
    t32, tbf = report["trajectory_f32"], report["trajectory_bf16"]
    # K1's launches: the serving path's, the training steps', the
    # training loop's (with its sampling from the checkpoint) and the
    # inversion's
    loop, inversion = report["training_loop"]["launches"], report["inversion"]["launches"]
    entry("siren_render", "cips3dpp_torch/csrc/siren_render.cu",
          "cips3dpp_tpu/kernels/siren_render.py:140", report["K1"],
          serving_launches["siren_render"] + report["training"]["launches"]["siren_render"]
          + loop["siren_render"] + inversion["siren_render"])
    entry("decoder_block", K2_SRC, K2_TPU, report["K2"], serving_launches["decoder_block"])
    entry("decoder_block_f32", K2_SRC, K2_TPU, report["K2-f32"],
          t32["launches_buffers"]["decoder_block_f32"] + loop["decoder_block_f32"]
          + inversion["decoder_block_f32"])
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
        report["profile"] = profile_calls(render_one, frame_ms)

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
