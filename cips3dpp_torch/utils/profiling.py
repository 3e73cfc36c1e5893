"""Profiling and timing (counterpart of cips3dpp_tpu/utils/profiling.py).

The reference's timing loops (exp/tests/test_cips3dpp.py:634-751
rendering-time, exp/stylesdf/scripts/rendering_time.py, gpu_memory.py) as
utilities: a torch.profiler trace, device-memory statistics under the JAX
package's keys, a timed loop that reads one checksum a repetition (CUDA
events on the card), and the rendering-time measurement of r1024 frames
through the serving path, the work `bench.py` times for the JAX package.
"""

from __future__ import annotations

import contextlib
import os
import subprocess
import time

import torch

#: the reference's headline: r1024 frames a second on a V100-class GPU
#: (BASELINE.md)
BASELINE_FPS = 46.93


@contextlib.contextmanager
def trace(outdir: str):
    """torch.profiler over the block (CPU, and CUDA where the card is
    there); writes `<outdir>/trace.json`, a Chrome trace. Yields the
    profiler."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(outdir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(outdir, "trace.json"))


def device_memory_stats(device=None) -> dict:
    """In-use, peak and total bytes of a CUDA device under the JAX
    package's keys (the reference's get_gpu_memory_GB probe); None each
    off the card."""
    keys = ("bytes_in_use", "peak_bytes_in_use", "bytes_limit")
    device = torch.device(device) if device is not None else (
        torch.device("cuda", torch.cuda.current_device()) if torch.cuda.is_available()
        else torch.device("cpu"))
    if device.type != "cuda":
        return dict.fromkeys(keys)
    return {"bytes_in_use": torch.cuda.memory_allocated(device),
            "peak_bytes_in_use": torch.cuda.max_memory_allocated(device),
            "bytes_limit": torch.cuda.get_device_properties(device).total_memory}


def card() -> str | None:
    """The card's name and power limit as nvidia-smi prints them, or None
    where there is no nvidia-smi."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return out.strip().splitlines()[0] if out.strip() else None


def time_reps(run, device, reps: int = 3) -> list[float]:
    """Seconds of each of `reps` calls of `run()`, after one untimed call;
    `run()` returns a 0-d
    checksum of its work; the checksum is read to the host once a call, so
    the call has finished when it is read (counterpart of time_scanned).
    CUDA events time a call on the card, the host clock elsewhere."""
    device = torch.device(device)
    float(run())
    times = []
    for _ in range(reps):
        if device.type == "cuda":
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            checksum = run()
            end.record()
            float(checksum)
            times.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            float(run())
            times.append(time.perf_counter() - t0)
    return times


def rendering_time(model, n_frames: int = 128, reps: int = 3, batch: int = 1,
                   generator: torch.Generator | None = None) -> dict:
    """The reference's rendering-time semantics (test_cips3dpp.py:634-751)
    on the serving path: one identity (zs and fixed noise buffers from
    `generator`, default seed 1) prepared once (serving.prepare_trajectory),
    then a yaw sweep over [-0.3, 0.3] of `n_frames` frames, `batch` frames a
    render_frame call, perturbation off, the checksum of every frame read
    once a repetition, after one untimed sweep.
    Returns ms_per_frame and fps (the mean over reps)
    and their best rep, n_frames and the device memory stats."""
    from ..serving import prepare_trajectory, render_trajectory_scan

    dev = model.device
    cfg = model.cfg
    gen = torch.Generator().manual_seed(1) if generator is None else generator
    zs = tuple(torch.randn((1, cfg.mapping.z_dim), generator=gen).to(dev) for _ in range(2))
    noise = model.decoder.make_noise(gen, cfg.img_size, device=dev)
    prep = prepare_trajectory(model, zs, noise_bufs=noise, device=dev)
    yaws = torch.linspace(-0.3, 0.3, n_frames, device=dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    times = time_reps(lambda: render_trajectory_scan(model, prep, yaws,
                                                     frames_per_step=batch, device=dev),
                      dev, reps=reps)
    mean, best = sum(times) / len(times), min(times)
    return {"ms_per_frame": mean / n_frames * 1e3, "fps": n_frames / mean,
            "best_ms_per_frame": best / n_frames * 1e3, "best_fps": n_frames / best,
            "n_frames": n_frames, "batch": batch, "reps": reps,
            "memory": device_memory_stats(dev)}
