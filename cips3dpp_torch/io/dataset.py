"""Training data pipeline (counterpart of cips3dpp_tpu/io/dataset.py, whose
readers import no framework; this is the port's own copy of them).

Behavioural contract: exp/stylesdf/dataset.py (hflip augmentation) and the
npy-shard format that `prepare-data` writes: one or more uint8 NHWC
arrays `{prefix}-{res}-{shard}.npy`, read memory-mapped. Batches are float
NHWC in [-1, 1], decoded and flipped on a host thread ahead of the step.
`data_iterator` draws from the same numpy streams as the JAX package's,
so a seed gives the same batches, bit for bit.

Not ported: LMDB datasets and the `prepare-data` writers (ROADMAP queue 1
item 3). A folder of images is read where PIL imports.
"""

from __future__ import annotations

import os
import queue as queue_mod
import threading
from typing import Iterator, Sequence

import numpy as np


def _to_float(img_u8: np.ndarray) -> np.ndarray:
    return img_u8.astype(np.float32) / 127.5 - 1.0


class ArrayDataset:
    """In-memory / mmap NHWC uint8 images."""

    def __init__(self, images: np.ndarray, hflip: bool = True):
        if images.ndim != 4 or images.shape[-1] != 3:
            raise ValueError(f"images must be (N, H, W, 3), got {images.shape}")
        self.images = images
        self.hflip = hflip

    def __len__(self):
        return len(self.images)

    def get(self, idx: int, rng: np.random.Generator) -> np.ndarray:
        img = self.images[idx]
        if self.hflip and rng.random() < 0.5:
            img = img[:, ::-1]
        return _to_float(img)


class NpyShardDataset(ArrayDataset):
    """Native format: one or more {prefix}-{res}-{shard}.npy uint8 arrays."""

    def __init__(self, paths: Sequence[str], hflip: bool = True):
        self.arrays = [np.load(p, mmap_mode="r") for p in sorted(paths)]
        for p, a in zip(sorted(paths), self.arrays):
            if a.ndim != 4 or a.shape[-1] != 3 or a.dtype != np.uint8:
                raise ValueError(f"{p}: want uint8 (N, H, W, 3), got {a.dtype} {a.shape}")
        self.sizes = np.array([len(a) for a in self.arrays])
        self.offsets = np.concatenate([[0], np.cumsum(self.sizes)])
        self.hflip = hflip

    def __len__(self):
        return int(self.offsets[-1])

    def get(self, idx: int, rng: np.random.Generator) -> np.ndarray:
        shard = int(np.searchsorted(self.offsets, idx, side="right") - 1)
        img = np.asarray(self.arrays[shard][idx - self.offsets[shard]])
        if self.hflip and rng.random() < 0.5:
            img = img[:, ::-1]
        return _to_float(img)


def open_dataset(path: str, resolution: int, hflip: bool = True):
    """A directory of .npy shards, or a directory of images (resized to
    `resolution`; needs PIL). An LMDB directory raises NotImplementedError."""
    if not os.path.isdir(path):
        raise FileNotFoundError(path)
    npys = [os.path.join(path, f) for f in os.listdir(path) if f.endswith(".npy")]
    if npys:
        return NpyShardDataset(npys, hflip=hflip)
    if os.path.exists(os.path.join(path, "data.mdb")):
        raise NotImplementedError(
            f"{path}: LMDB datasets are not ported (ROADMAP queue 1 item 3); "
            "convert it to uint8 npy shards ({prefix}-{res}-{shard}.npy, (N, H, W, 3))")
    try:
        from PIL import Image
    except ImportError as e:
        raise RuntimeError(
            f"{path}: reading a folder of images needs PIL, which is not installed; "
            "give a directory of uint8 npy shards ({prefix}-{res}-{shard}.npy, "
            "(N, H, W, 3)) instead") from e
    files = sorted(os.path.join(path, f) for f in os.listdir(path)
                   if f.lower().endswith((".png", ".jpg", ".jpeg", ".webp")))
    if not files:
        raise FileNotFoundError(f"{path}: no .npy shards and no images")
    imgs = np.stack([
        np.asarray(Image.open(f).convert("RGB").resize((resolution, resolution)))
        for f in files])
    return ArrayDataset(imgs, hflip=hflip)


def data_iterator(
    dataset,
    batch_size: int,
    seed: int = 0,
    shard_index: int = 0,
    num_shards: int = 1,
    prefetch: int = 4,
) -> Iterator[np.ndarray]:
    """Infinite shuffled iterator with a host-side prefetch thread: each
    epoch is the permutation of `seed + epoch`, flips are drawn from
    `seed + shard_index`, each shard takes every num_shards-th index (the
    reference's DistributedSampler, cips3d/utils.py:29-52). The thread ends
    when the iterator is closed or collected."""
    if len(dataset) // num_shards < batch_size:
        raise ValueError(f"{len(dataset)} images over {num_shards} shard(s) give no "
                         f"batch of {batch_size}")
    q: queue_mod.Queue = queue_mod.Queue(maxsize=prefetch)
    stop = threading.Event()

    def put(item):
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue_mod.Full:
                pass
        return False

    def worker():
        try:
            rng = np.random.default_rng(seed + shard_index)
            epoch = 0
            while True:
                order = np.random.default_rng(seed + epoch).permutation(len(dataset))
                order = order[shard_index::num_shards]
                for start in range(0, len(order) - batch_size + 1, batch_size):
                    idxs = order[start:start + batch_size]
                    if not put(np.stack([dataset.get(int(i), rng) for i in idxs])):
                        return
                epoch += 1
        except Exception as e:  # handed to the consumer, which raises it
            put(e)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        t.join(timeout=10)
