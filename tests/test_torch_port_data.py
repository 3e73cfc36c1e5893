"""Dataset preparation, LMDB and the native loader of cips3dpp_torch against
the JAX package's, on the CPU.

- `prepare_images` writes .npy shards byte-equal to the JAX package's from
  the same PNGs (non-square, so the crop works): the largest square, an
  explicit window, two sizes, and a pool of two workers. The port decodes
  the PNGs itself and resizes with its own copy of PIL's Lanczos; the JAX
  package uses PIL.
- `prepare_images_lmdb` and `LMDBDataset` against a dict-backed stand-in
  for the `lmdb` module (it is on neither machine), put in sys.modules for
  both packages: the same keys, the same PNG bytes (the port's encoder
  writes PIL's), b"length" written last, the same pixels read back.
- The port's `NativeLoader` gives batches bit-equal to the JAX package's
  for the same shards and seed; two host shards take disjoint images; the
  pixels are the dataset's at the indices of the loader's own arithmetic
  (`sample_order`).
- `prepare-data` in process, in both formats; a JPEG source without PIL and
  a build without g++ raise.
"""

import contextlib
import json
import os
import sys
import types

import numpy as np
import pytest

import torch_port_helpers  # noqa: F401  (one torch thread a worker)


def _sources(tmp_path, n=3, w=37, h=29, seed=0):
    from cips3dpp_torch.apps.sample import write_png

    src = tmp_path / "src"
    src.mkdir()
    rng = np.random.default_rng(seed)
    for i in range(n):
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        # a smooth half too, so the row filters differ
        img[: h // 2] = np.linspace(0, 255, w, dtype=np.uint8)[None, :, None]
        write_png(str(src / f"img_{i}.png"), img)
    return str(src)


@pytest.mark.parametrize("kw", [
    dict(sizes=(16,)),
    dict(sizes=(16,), crop_size=(30, 20)),
    dict(sizes=(16, 8)),
    dict(sizes=(16, 8), n_workers=2),
], ids=["square", "explicit_crop", "two_sizes", "two_workers"])
def test_prepare_images_bytes_equal_jax(tmp_path, kw):
    from cips3dpp_tpu.io import dataset as jd
    from cips3dpp_torch.io import dataset as td

    src = _sources(tmp_path)
    want = jd.prepare_images(src, str(tmp_path / "jax"), **kw)
    got = td.prepare_images(src, str(tmp_path / "port"), **kw)
    names = sorted(os.listdir(want))
    assert names == sorted(os.listdir(got)) == sorted(f"images-{s}-0000.npy"
                                                      for s in kw["sizes"])
    for name in names:
        with open(os.path.join(want, name), "rb") as f, open(os.path.join(got, name), "rb") as g:
            assert f.read() == g.read(), name


class _FakeLMDB(types.ModuleType):
    """The calls the two packages make to `lmdb`, over dicts: every put is
    recorded in order, and a directory with data.mdb is made as lmdb
    makes it."""

    def __init__(self):
        super().__init__("lmdb")
        self.stores: dict[str, dict] = {}
        self.puts: dict[str, list] = {}

    def open(self, path, readonly=False, **kw):
        path = os.path.abspath(path)
        if not readonly:
            os.makedirs(path, exist_ok=True)
            open(os.path.join(path, "data.mdb"), "ab").close()
            self.stores.setdefault(path, {})
            self.puts.setdefault(path, [])
        return _FakeEnv(self, path)


class _FakeEnv:
    def __init__(self, mod, path):
        self.mod, self.path = mod, path

    @contextlib.contextmanager
    def begin(self, write=False):
        yield self

    def put(self, key, value):
        self.mod.stores[self.path][bytes(key)] = bytes(value)
        self.mod.puts[self.path].append(bytes(key))

    def get(self, key):
        return self.mod.stores[self.path].get(bytes(key))

    def close(self):
        pass


def test_lmdb_writer_and_reader_match_jax(tmp_path, monkeypatch):
    from cips3dpp_tpu.io import dataset as jd
    from cips3dpp_torch.io import dataset as td

    fake = _FakeLMDB()
    monkeypatch.setitem(sys.modules, "lmdb", fake)
    src = _sources(tmp_path, n=3)
    want = os.path.abspath(jd.prepare_images_lmdb(src, str(tmp_path / "jax"), sizes=(8, 16)))
    got = os.path.abspath(td.prepare_images_lmdb(src, str(tmp_path / "port"), sizes=(8, 16)))
    assert fake.puts[got] == fake.puts[want]
    assert fake.puts[got][-1] == b"length" and fake.stores[got][b"length"] == b"3"
    assert set(fake.stores[got]) == {b"length"} | {f"{s}-{i:05d}".encode()
                                                   for s in (8, 16) for i in range(3)}
    assert fake.stores[got] == fake.stores[want]  # the same PNG bytes

    for size in (8, 16):
        ds_j, ds_t = jd.LMDBDataset(want, size), td.open_dataset(got, size)
        assert isinstance(ds_t, td.LMDBDataset) and len(ds_t) == len(ds_j) == 3
        for i in range(3):
            got_img = ds_t.get(i, np.random.default_rng(i))
            assert got_img.shape == (size, size, 3)
            assert np.array_equal(got_img, ds_j.get(i, np.random.default_rng(i)))
    # both read the npy writer's pixels from the LMDB
    npy = td.prepare_images(src, str(tmp_path / "npy"), sizes=(16,))
    shards = np.load(os.path.join(npy, "images-16-0000.npy"))
    assert np.array_equal(td._decode_rgb(fake.stores[got][b"16-00001"], "x"), shards[1])


@pytest.fixture
def shards(tmp_path):
    rng = np.random.RandomState(0)
    d = tmp_path / "shards"
    d.mkdir()
    np.save(d / "images-16-0000.npy", (rng.rand(12, 16, 16, 3) * 255).astype(np.uint8))
    np.save(d / "images-16-0001.npy", (rng.rand(8, 16, 16, 3) * 255).astype(np.uint8))
    return str(d)


@pytest.mark.parametrize("kw", [dict(seed=7), dict(seed=3, hflip=False),
                                dict(seed=5, shard_index=1, num_shards=2)],
                         ids=["flips", "no_flips", "host_shard_1_of_2"])
def test_native_loader_bit_equal_jax(shards, kw):
    from cips3dpp_tpu.io.native_loader import open_native_loader as jopen
    from cips3dpp_torch.io.dataset import open_dataset
    from cips3dpp_torch.io.native_loader import open_native_loader, sample_order

    port = open_native_loader(shards, 4, n_threads=1, **kw)
    ref = jopen(shards, 4, n_threads=1, **kw)
    ds = open_dataset(shards, 16, hflip=False)
    assert (len(port), port.height, port.width) == (20, 16, 16)
    try:
        for k in range(8):  # past an epoch of the host's images
            got, want = next(port), next(ref)
            assert got.dtype == np.float32 and np.array_equal(got, want), k
            rows = [ds.get(i, None)[:, ::-1] if flip else ds.get(i, None)
                    for i, flip in sample_order(k, 4, len(ds), **kw)]
            assert np.array_equal(got, np.stack(rows)), k
    finally:
        port.close()
        ref.close()


def test_native_loader_host_shards_disjoint():
    from cips3dpp_torch.io.native_loader import sample_order

    seen = [{i for k in range(5) for i, _ in sample_order(k, 2, 20, seed=3, shard_index=s,
                                                             num_shards=2)}
            for s in (0, 1)]
    assert seen[0] and seen[1] and not seen[0] & seen[1]
    assert {i % 2 for i in seen[0]} == {0} and {i % 2 for i in seen[1]} == {1}


def test_native_loader_needs_gxx(tmp_path, monkeypatch):
    from cips3dpp_torch.io import native_loader

    monkeypatch.setattr(native_loader, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native_loader.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        native_loader.build_native()


def test_prepare_data_command(tmp_path, capsys, monkeypatch):
    from cips3dpp_torch.apps.cli import main
    from cips3dpp_torch.io.dataset import data_iterator, open_dataset

    src = _sources(tmp_path, n=4)

    def run(argv):
        assert main(["prepare-data", "--src", src] + argv) in (0, None)
        return json.loads(capsys.readouterr().out.strip().splitlines()[-1])

    out = run(["--outdir", str(tmp_path / "npy"), "--sizes", "16", "8", "--crop-size", "30",
               "20"])
    assert out == {"outdir": str(tmp_path / "npy"), "format": "npy"}
    for size in (16, 8):
        arr = np.load(tmp_path / "npy" / f"images-{size}-0000.npy")
        assert arr.shape == (4, size, size, 3) and arr.dtype == np.uint8
    # one directory of two sizes opens at each
    it = data_iterator(open_dataset(str(tmp_path / "npy"), 8), 2, seed=0)
    assert next(it).shape == (2, 8, 8, 3)
    it.close()
    monkeypatch.setitem(sys.modules, "lmdb", _FakeLMDB())
    out = run(["--outdir", str(tmp_path / "lmdb"), "--sizes", "8", "--format", "lmdb"])
    assert out["format"] == "lmdb" and len(open_dataset(str(tmp_path / "lmdb"), 8)) == 4


def test_jpeg_source_without_pil_raises(tmp_path, monkeypatch):
    from PIL import Image

    from cips3dpp_torch.io.dataset import prepare_images

    src = tmp_path / "src"
    src.mkdir()
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(src / "a.jpg")
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(RuntimeError, match="PIL"):
        prepare_images(str(src), str(tmp_path / "out"), sizes=(8,))
