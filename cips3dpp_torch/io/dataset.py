"""Training data pipeline (counterpart of cips3dpp_tpu/io/dataset.py, whose
readers and writers import no framework; this is the port's own copy of
them).

Behavioural contract: exp/stylesdf/dataset.py (LMDB keyed
f"{resolution}-{idx:05d}", hflip augmentation) and
exp/stylesdf/scripts/prepare_data.py (centre crop, then a Lanczos resize
to each size). Two storage formats: uint8 NHWC npy shards
`{prefix}-{res}-{shard}.npy`, read memory-mapped (this package's and the
JAX package's native format), and the reference's LMDB of PNG bytes.
Batches are float NHWC in [-1, 1], decoded and flipped on a host thread
ahead of the step. `data_iterator` draws from the same numpy streams as
the JAX package's, so a seed gives the same batches, bit for bit.

PIL is optional, as on the card: PNG sources and LMDB records are read by
the standard-library reader `apps/sample.py:decode_png`, and the crop and
the resize are PIL's own arithmetic (`ops/resize.py`); JPEG and WebP
sources need PIL. `lmdb` is imported where an LMDB is opened or written.
"""

from __future__ import annotations

import io
import os
import queue as queue_mod
import re
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


class LMDBDataset:
    """Reads LMDBs written by the reference's prepare_data tool or by
    `prepare_images_lmdb` (the key scheme of dataset.py:13-65): PNG bytes
    under f"{resolution}-{idx:05d}" and the count under b"length"."""

    def __init__(self, path: str, resolution: int, hflip: bool = True):
        import lmdb

        self.env = lmdb.open(path, readonly=True, lock=False, readahead=False,
                             meminit=False)
        with self.env.begin(write=False) as txn:
            length = txn.get(b"length")
        if length is None:
            raise ValueError(f"{path}: no b'length' key (an interrupted build)")
        self.length = int(length.decode())
        self.resolution = resolution
        self.hflip = hflip

    def __len__(self):
        return self.length

    def get(self, idx: int, rng: np.random.Generator) -> np.ndarray:
        key = f"{self.resolution}-{idx:05d}".encode()
        with self.env.begin(write=False) as txn:
            buf = txn.get(key)
        img = _decode_rgb(buf, key.decode())
        if self.hflip and rng.random() < 0.5:
            img = img[:, ::-1]
        return _to_float(img)


_SHARD = re.compile(r"-(\d+)-\d+\.npy$")


def open_dataset(path: str, resolution: int, hflip: bool = True):
    """A directory of .npy shards (a shard named `{prefix}-{res}-{shard}.npy`
    with another res is skipped, so one `prepare-data` directory of several
    sizes serves each size), an LMDB directory, or a directory of images
    (resized to `resolution`; needs PIL)."""
    if not os.path.isdir(path):
        raise FileNotFoundError(path)
    npys = [os.path.join(path, f) for f in os.listdir(path) if f.endswith(".npy")
            if (m := _SHARD.search(f)) is None or int(m.group(1)) == resolution]
    if npys:
        return NpyShardDataset(npys, hflip=hflip)
    if os.path.exists(os.path.join(path, "data.mdb")):
        return LMDBDataset(path, resolution, hflip=hflip)
    try:
        from PIL import Image
    except ImportError as e:
        raise RuntimeError(
            f"{path}: reading a folder of images needs PIL, which is not installed; "
            "give a directory of uint8 npy shards ({prefix}-{res}-{shard}.npy, "
            "(N, H, W, 3)) instead (prepare-data writes them)") from e
    files = _list_images(path)
    if not files:
        raise FileNotFoundError(f"{path}: no .npy shards, no LMDB and no images")
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


# ---------------------------------------------------------------- writers --


def _list_images(src_dir: str):
    return sorted(os.path.join(src_dir, f) for f in os.listdir(src_dir)
                  if f.lower().endswith((".png", ".jpg", ".jpeg", ".webp")))


def _rgb(img: np.ndarray) -> np.ndarray:
    """PIL's convert("RGB") of an 8-bit image: gray repeated, alpha dropped."""
    return img[..., :3] if img.shape[-1] >= 3 else np.repeat(img[..., :1], 3, axis=-1)


def _decode_rgb(data: bytes, name: str) -> np.ndarray:
    """(H, W, 3) uint8 of PNG bytes (standard library), or of other image
    bytes through PIL."""
    from ..apps.sample import decode_png

    if data[:8] == b"\x89PNG\r\n\x1a\n":
        return _rgb(decode_png(data, name))
    try:
        from PIL import Image
    except ImportError as e:
        raise RuntimeError(f"{name}: not a PNG; decoding it needs PIL, which is not "
                           "installed") from e
    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("RGB"))


def _center_crop_resize(args):
    """Worker: one source image -> {size: uint8 HWC array} (the reference's
    pool worker, prepare_data.py:23-46). crop_size None crops the centred
    largest square; an explicit (crop_w, crop_h) is the crop_data.py
    tool's fixed centred window (crop_data.py:23-46). Then PIL's Lanczos
    to each size. Top level, so it pickles for the pool."""
    from ..ops.resize import center_crop, pil_lanczos_resize

    path, sizes, crop_size = args
    with open(path, "rb") as fh:
        img = _decode_rgb(fh.read(), path)
    img = center_crop(img, crop_size)
    return {size: pil_lanczos_resize(img, (size, size)) for size in sizes}


def _resized_stream(files, sizes, n_workers: int, crop_size=None):
    """Per-image {size: array} dicts in file order, through a pool of
    `n_workers` processes when above 1 (prepare_data.py:69-80)."""
    if isinstance(crop_size, int):
        crop_size = (crop_size, crop_size)
    work = [(f, tuple(sizes), crop_size) for f in files]
    if n_workers and n_workers > 1:
        import multiprocessing

        with multiprocessing.get_context("spawn").Pool(n_workers) as pool:
            yield from pool.imap(_center_crop_resize, work, chunksize=8)
    else:
        yield from map(_center_crop_resize, work)


def prepare_images(src_dir: str, out_dir: str, sizes: Sequence[int] = (1024,),
                   shard_size: int = 10_000, n_workers: int = 0, crop_size=None):
    """The native prepare tool (prepare_data.py:23-80): centre-crop to the
    largest square (or to an explicit crop_size window), Lanczos-resize to
    each size, and write uint8 .npy shards `images-{size}-{shard:04d}.npy`
    of up to `shard_size` images; one pass over the sources makes every
    size."""
    os.makedirs(out_dir, exist_ok=True)
    files = _list_images(src_dir)
    shards = {size: [] for size in sizes}
    shard_idx = {size: 0 for size in sizes}

    def flush(size):
        if shards[size]:
            np.save(os.path.join(out_dir, f"images-{size}-{shard_idx[size]:04d}.npy"),
                    np.stack(shards[size]))
            shards[size] = []
            shard_idx[size] += 1

    for per_size in _resized_stream(files, sizes, n_workers, crop_size):
        for size, arr in per_size.items():
            shards[size].append(arr)
            if len(shards[size]) == shard_size:
                flush(size)
    for size in sizes:
        flush(size)
    return out_dir


def prepare_images_lmdb(src_dir: str, out_dir: str,
                        sizes: Sequence[int] = (64, 128, 256, 512, 1024),
                        n_workers: int = 0, quality: int = 100, map_size: int = 1 << 40,
                        crop_size=None, codec: str = "png"):
    """The multi-size LMDB of the reference's tool (prepare_data.py:23-80):
    keys f"{size}-{idx:05d}" hold PNG bytes (prepare_data.py:44), the bytes
    PIL writes (`apps/sample.py:encode_png`), and the count b"length" is
    written after the images, so an interrupted build reads as incomplete.
    codec="jpeg" (with `quality`) is a lossy option and needs PIL."""
    import lmdb

    from ..apps.sample import encode_png

    jpeg = codec.lower() in ("jpeg", "jpg")
    if jpeg:
        try:
            from PIL import Image
        except ImportError as e:
            raise RuntimeError("codec='jpeg' needs PIL, which is not installed; "
                               "the default codec='png' does not") from e
    elif codec.lower() != "png":
        raise ValueError(f"codec {codec!r}: 'png' or 'jpeg'")

    def encode(arr):
        if not jpeg:
            return encode_png(arr)
        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, format=codec, quality=quality)
        return buf.getvalue()

    files = _list_images(src_dir)
    env = lmdb.open(out_dir, map_size=map_size, readahead=False)
    try:
        count = 0
        for idx, per_size in enumerate(_resized_stream(files, sizes, n_workers, crop_size)):
            with env.begin(write=True) as txn:
                for size, arr in per_size.items():
                    txn.put(f"{size}-{idx:05d}".encode("utf-8"), encode(arr))
            count = idx + 1
        with env.begin(write=True) as txn:
            txn.put(b"length", str(count).encode("utf-8"))
    finally:
        env.close()
    return out_dir
