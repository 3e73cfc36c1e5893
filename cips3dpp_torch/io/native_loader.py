"""ctypes bindings for the native C++ data loader (counterpart of
cips3dpp_tpu/io/native_loader.py, over the port's own copy of its source,
`cips3dpp_torch/native/dataloader.cpp`).

An alternative to `dataset.data_iterator` for .npy shard datasets: worker
threads decode, flip and normalise off the interpreter and keep a ring of
ready float batches. The library is built at first use by
`g++ -O3 -shared -fPIC -std=c++17 -pthread` into `cips3dpp_torch/_build/`
(named by a hash of the source and flags); a missing or failing g++
raises. Batches of one seed equal the JAX package's loader's bit for bit.
With one worker thread the batches come in order; with more, each batch
is whole but the ring may hand them out in another order.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Iterator, Sequence

import numpy as np

SOURCE = Path(__file__).resolve().parent.parent / "native" / "dataloader.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")

_lock = threading.Lock()


def build_native() -> str:
    """The loader's shared library, built first if missing."""
    digest = hashlib.sha1(SOURCE.read_bytes() + " ".join(FLAGS).encode()).hexdigest()[:12]
    out = BUILD_DIR / f"libcips3d_dataloader-{digest}.so"
    with _lock:
        if out.exists():
            return str(out)
        gxx = shutil.which("g++")
        if gxx is None:
            raise RuntimeError("g++ not found: the native data loader is built with g++ "
                               "at first use")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run([gxx, *FLAGS, str(SOURCE), "-o", str(tmp)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed to build {SOURCE}:\n{proc.stderr}")
        os.replace(tmp, out)
        return str(out)


def _splitmix(x: int) -> int:
    m = (1 << 64) - 1
    x ^= x >> 30
    x = (x * 0xBF58476D1CE4E5B9) & m
    x ^= x >> 27
    x = (x * 0x94D049BB133111EB) & m
    return x ^ (x >> 31)


def sample_order(batch_idx: int, batch_size: int, total: int, seed: int = 0,
                 hflip: bool = True, shard_index: int = 0,
                 num_shards: int = 1) -> list[tuple[int, bool]]:
    """(image index, flipped) of each row of batch `batch_idx`, the loader's
    own arithmetic (`Loader::fill_batch`): a splitmix hash of the position
    in the epoch picks the image, and one of its bits the flip."""
    m = (1 << 64) - 1
    usable = total // num_shards
    out = []
    for b in range(batch_size):
        linear = batch_idx * batch_size + b
        epoch, pos = divmod(linear, usable)
        x = _splitmix((pos + 0x9E3779B97F4A7C15 * (seed + epoch * 1315423911)) & m)
        idx = (x % usable) * num_shards + shard_index
        out.append((idx % total, hflip and bool((x >> 33) & 1)))
    return out


class NativeLoader:
    """Batches (batch_size, H, W, 3) float32 in [-1, 1] from uint8 NHWC
    shards of one size; `shard_index` of `num_shards` hosts takes every
    num_shards-th image (the JAX package's signature)."""

    _handle = None

    def __init__(self, shard_paths: Sequence[str], batch_size: int, seed: int = 0,
                 hflip: bool = True, shard_index: int = 0, num_shards: int = 1,
                 n_threads: int = 4, ring_size: int = 8):
        lib = ctypes.CDLL(build_native())
        lib.loader_create.restype = ctypes.c_void_p
        lib.loader_create.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int, ctypes.c_uint64,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ]
        lib.loader_next.restype = ctypes.c_int
        lib.loader_next.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_float)]
        for name in ("loader_height", "loader_width", "loader_size"):
            getattr(lib, name).restype = ctypes.c_long
            getattr(lib, name).argtypes = [ctypes.c_void_p]
        lib.loader_destroy.restype = None
        lib.loader_destroy.argtypes = [ctypes.c_void_p]
        self._lib = lib
        if batch_size < 1 or n_threads < 1 or ring_size < 1 or not 0 <= shard_index < num_shards:
            raise ValueError(f"batch_size {batch_size}, n_threads {n_threads}, ring_size "
                             f"{ring_size}, shard {shard_index} of {num_shards}")
        paths = sorted(os.path.abspath(p) for p in shard_paths)
        # the workers start at once and divide by the images a host takes
        total = sum(np.load(p, mmap_mode="r").shape[0] for p in paths)
        if total // num_shards < 1:
            raise ValueError(f"{total} images over {num_shards} host shards")
        self._paths = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
        self._handle = lib.loader_create(self._paths, len(paths), batch_size, seed, int(hflip),
                                         shard_index, num_shards, n_threads, ring_size)
        if not self._handle:
            raise RuntimeError(f"native loader failed to open shards (uint8 (N, H, W, 3) "
                               f"of one size): {paths}")
        self.batch_size = batch_size
        self.height = lib.loader_height(self._handle)
        self.width = lib.loader_width(self._handle)

    def __len__(self):
        return self._lib.loader_size(self._handle)

    def __iter__(self) -> Iterator[np.ndarray]:
        return self

    def __next__(self) -> np.ndarray:
        if not self._handle:
            raise StopIteration
        out = np.empty((self.batch_size, self.height, self.width, 3), np.float32)
        rc = self._lib.loader_next(self._handle,
                                   out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        if rc != 0:
            raise StopIteration
        return out

    def close(self):
        if self._handle:
            self._lib.loader_destroy(self._handle)
            self._handle = None

    def __del__(self):
        self.close()


def open_native_loader(path: str, batch_size: int, **kwargs) -> NativeLoader:
    """The native loader over every .npy shard of a directory (one size), or
    raise."""
    shards = [os.path.join(path, f) for f in os.listdir(path) if f.endswith(".npy")]
    if not shards:
        raise FileNotFoundError(f"no .npy shards in {path}")
    return NativeLoader(shards, batch_size, **kwargs)
