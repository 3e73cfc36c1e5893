"""Build, load and count the CUDA kernels.

Each `csrc/<name>.cu` is compiled by `nvcc` for sm_90a into its own shared
library with a plain C interface, at first use, into
`cips3dpp_torch/_build/` (git-ignored), and loaded with ctypes. The library
name carries a hash of the source and the flags, so an edited source is
rebuilt. `build` starts one nvcc per library, all at once; `defines`
(extra `-D` flags) build a variant beside the plain library: another
geometry of a kernel, or an instrumented build.

`LAUNCHES[name]` counts kernel launches: a wrapper adds one where it
launches its kernel and nowhere else (the registry's "launches" counter,
utils/profiling.py). `device_ms` times a kernel on the card by the
profiler's device time.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

from ..utils import profiling

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
SOURCES = ("siren_render", "decoder_block", "elem_probe")

LAUNCHES: collections.Counter = profiling.counter("launches")

_lock = threading.Lock()
_libs: dict[tuple, ctypes.CDLL] = {}


def reset_launches() -> None:
    profiling.reset("launches")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a host "
                       "with the CUDA toolkit")


def _lib_path(name: str, defines=()) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS + tuple(defines)).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(jobs) -> dict[str, str]:
    """Compile every missing library of `jobs`, pairs (name, defines), in
    parallel (one nvcc each). Returns {label: ptxas report} for the
    libraries built by this call, labelled by name and, after a space,
    the defines of a variant; each report is also kept beside its library
    (`ptxas_report`)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, defines in dict.fromkeys((n, tuple(d)) for n, d in jobs):
        out = _lib_path(name, defines)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, *defines, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        label = " ".join((name, *defines))
        procs[label] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT, text=True),
                        tmp, out)
    reports, failed = {}, []
    for label, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{label}:\n{log}")
            continue
        out.with_suffix(".ptxas.txt").write_text(log)
        os.replace(tmp, out)
        reports[label] = log
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return reports


def build_all(names=SOURCES, defines=()) -> dict[str, str]:
    """`build` of every source in `names` with the extra flags `defines`."""
    return build((name, defines) for name in names)


def ptxas_report(name: str, defines=()) -> str | None:
    """The nvcc / ptxas output of the library's build (registers, spills
    by entry), or None if it was not built here."""
    path = _lib_path(name, defines).with_suffix(".ptxas.txt")
    return path.read_text() if path.exists() else None


def load(name: str, defines=()) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu (built with the extra flags
    `defines`), built first if needed."""
    key = (name, tuple(defines))
    with _lock:
        lib = _libs.get(key)
        if lib is None:
            path = _lib_path(name, defines)
            if not path.exists():
                build([(name, defines)])
            lib = ctypes.CDLL(str(path))
            _libs[key] = lib
        return lib


def ptr(t: torch.Tensor | None) -> ctypes.c_void_p:
    return ctypes.c_void_p(0 if t is None else t.data_ptr())


def stream_ptr(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def check(t: torch.Tensor, name: str, shape, dtype, device) -> None:
    """Raise unless `t` is a contiguous tensor of `shape`/`dtype` on
    `device`."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, want {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, want {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, want {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def device_ms(fn, iters: int, kernel: str, tries: int = 5) -> float:
    """Mean device time in ms of one launch of the CUDA kernel whose name
    holds `kernel`, over `iters` calls of fn(i), from torch.profiler. A
    wrapper's call can take the host longer to issue than the kernel takes
    on the card, so CUDA events around back-to-back calls would time the
    host; the profiler's device time does not. The profiler at times drops
    the device records of part of a run (13 of 50 launches once; 14 of 50
    launches of a 34 us kernel in each of three runs late in a long
    process; two of three runs of a 6 us kernel, on the H100), so each run
    first traces a warm-up step whose records it discards (the profiler's
    schedule), and a run whose count is off is profiled again, up to
    `tries` times; raises unless one run saw each call launch the kernel
    once."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    fn(0)
    torch.cuda.synchronize()
    seen = []
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            for _ in range(3):
                fn(0)
            torch.cuda.synchronize()
            prof.step()  # the warm-up step ends: the timed calls are traced
            for i in range(iters):
                fn(i)
            torch.cuda.synchronize()
            prof.step()
        hits = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and kernel in e.key]
        launches = sum(e.count for e in hits)
        if launches == iters:
            return sum(e.self_device_time_total for e in hits) / 1e3 / launches
        seen.append(launches)
    raise RuntimeError(f"profiler saw {seen} launches of {kernel} in {tries} runs, "
                       f"want {iters}")


def raise_on_error(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code} at launch")
