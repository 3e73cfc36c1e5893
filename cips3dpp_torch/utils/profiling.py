"""Profiling and timing (counterpart of cips3dpp_tpu/utils/profiling.py).

The reference's timing loops (exp/tests/test_cips3dpp.py:634-751
rendering-time, exp/stylesdf/scripts/rendering_time.py, gpu_memory.py) as
utilities: a torch.profiler trace, device-memory statistics under the JAX
package's keys, a timed loop that reads one checksum a repetition (CUDA
events on the card), and the rendering-time measurement of r1024 frames
through the serving path, the work `bench.py` times for the JAX package.

The port's own instruments: `span(name)`, a host range named
`cips.<name>` around a layer's work while a torch profiler runs, and the
counters of `COUNTERS` (`count(what, n)` for host events, `LAUNCHES` in
kernels/_lib.py for kernel launches). The ranges are of the profiler's
ordinary operator scope, stamped on the clock of its device records, so
each gap between device records falls inside a named span; unlike
`torch.profiler.record_function`'s user annotations, the profiler does not
copy them onto the device timeline. With no profiler running a span is
one flag check and a shared no-op context.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import os
import subprocess
import time

import torch

#: the reference's headline: r1024 frames a second on a V100-class GPU
#: (BASELINE.md)
BASELINE_FPS = 46.93

# a range of the operator scope: exported as "cpu_op", never mirrored on
# the device timeline as a user annotation is
_Range = torch._C._profiler._RecordFunctionFast
_profiling = torch.autograd._profiler_enabled


class _Span:
    """A span's context: `enter` opens the range `cips.<name>` (none
    while no profiler runs); as a decorator, a span around every call."""

    __slots__ = ("name", "_range")

    def __init__(self, name: str):
        self.name, self._range = name, None

    def __enter__(self):
        self._range = _Range("cips." + self.name)
        self._range.__enter__()

    def __exit__(self, *exc):
        self._range.__exit__(*exc)
        return False

    def __call__(self, fn):
        name = self.name

        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return spanned


class _Off(_Span):
    """What `span` returns while no profiler runs: nothing to open."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


# one no-op context a span name, made at its first use
_OFF: dict[str, _Off] = {}


def span(name: str):
    """A context around a layer's work, or with `@span(name)` around every
    call of a function: while a torch profiler runs, a host range named
    `cips.<name>` (spans nest by time on the one host thread, each inside
    the span around it); otherwise a no-op shared by every use of the
    name, so the cost is one flag check. A span left open when the
    profiler stops ends at the stop."""
    if _profiling():
        return _Span(name)
    off = _OFF.get(name)
    if off is None:
        off = _OFF[name] = _Off(name)
    return off


#: every counter of the port by name, each a collections.Counter by key:
#: "launches" (kernels/_lib.py: LAUNCHES, a kernel's launches) and
#: "counts" (`count`: "host_sync", where the host waits for the card's
#: queue of work to drain: a device value read on the host, or a copy to
#: the card from pageable host memory)
COUNTERS: dict[str, collections.Counter] = {}


def counter(name: str) -> collections.Counter:
    """The registry's counter `name` (made on first use)."""
    return COUNTERS.setdefault(name, collections.Counter())


def reset(name: str) -> None:
    """Clear the counter `name`."""
    counter(name).clear()


COUNTS = counter("counts")


def count(what: str, n: int = 1) -> None:
    """Add `n` to `COUNTS[what]`; while a torch profiler runs, also leave
    `n` instant ranges `cips.count.<what>`, so each event carries its time
    and its enclosing span to the trace."""
    COUNTS[what] += n
    if _profiling():
        for _ in range(n):
            with _Range("cips.count." + what):
                pass


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
