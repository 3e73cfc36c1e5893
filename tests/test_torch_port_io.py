"""The port's io and data modules on the CPU, against PyYAML and the JAX
package: the standard-library YAML reader and snapshot writer
(io/yaml_lite.py, io/config.py), the typed configs, the data pipeline
(io/dataset.py, parallel/prefetch.py), checkpoints (io/checkpoint.py,
ClippedAdam and TrainState state dicts), and the `train`, `sphere-init`
and checkpoint-loading paths of the command line."""

import dataclasses
import json
import os
import sys

import numpy as np
import pytest
import torch
import yaml

from test_torch_port_cli import TINY_OPTS

CONFIGS = ["configs/ffhq.yaml", "configs/compcars.yaml", "configs/stylesdf.yaml"]
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# tests/test_cli.py:77-90, a training section in flow mappings
FLOW_CFG = """
train:
  G_cfg: {}
  D_cfg: {input_size: 1024, channel_multiplier: 1}
  D_renderer_cfg: {input_size: 64}
  batch: 4
  data_img_size: 16
  cam_img_size: 8
  d_reg_every: 2
  g_reg_every: 2
  ema_start: 1
  fade_steps: 10
  init_renderer: false
"""


def _sections(path):
    with open(os.path.join(ROOT, path)) as f:
        return list(yaml.safe_load(f))


@pytest.mark.parametrize("path", CONFIGS)
def test_yaml_reader_equals_pyyaml_on_the_configs(path, monkeypatch):
    from cips3dpp_tpu.io import config as jc
    from cips3dpp_torch.io import config as tc
    from cips3dpp_torch.io import yaml_lite

    full = os.path.join(ROOT, path)
    text = open(full).read()
    assert yaml_lite.load(text) == yaml.safe_load(text)
    with_pyyaml = {s: tc.load_command_config(full, s) for s in _sections(path)}
    monkeypatch.setitem(sys.modules, "yaml", None)  # PyYAML hidden
    with pytest.raises(ImportError):
        import yaml as _  # noqa: F401
    for s in with_pyyaml:
        got = tc.load_command_config(full, s)
        assert got == with_pyyaml[s] == jc.load_command_config(full, s), s


def test_yaml_reader_reads_flow_mappings(tmp_path, monkeypatch):
    from cips3dpp_torch.io import config as tc
    from cips3dpp_torch.io import yaml_lite

    assert yaml_lite.load(FLOW_CFG) == yaml.safe_load(FLOW_CFG)
    path = tmp_path / "cfg.yaml"
    path.write_text(FLOW_CFG)
    want = tc.load_command_config(str(path), "train")
    monkeypatch.setitem(sys.modules, "yaml", None)
    assert tc.load_command_config(str(path), "train") == want
    assert want["D_cfg"] == {"input_size": 1024, "channel_multiplier": 1}


@pytest.mark.parametrize("doc", [
    "a: 1e-5\nb: 2.0e-5\nc: .5\nd: 0x1F\ne: 010\nf: 0b101\ng: 1_000\nh: ~\ni: yes\n"
    "j: Off\nk: .inf\nl: -.Inf\nm: 09\nn: +12\no: 1.\np: -0.0\nq: NULL\nr: 'x'",
    "x: &a {p: 1, q: [1, 2,]}\ny: *a\nz:\n  <<: *a\n  q: 2\nw:\n  <<: [*a, {p: 3, r: 4}]",
    "a:\n- 1\n- [2, {b: c}]\n- - x\n  - y\n- k: v\n  k2: 'q''s'\nb: \"e\\n\\u00e9\\x41\"",
    "k: v # comment\n# a comment line\nk2: 'a # b'\nk3: a#b\nk4: http://x.y/z\n1: int\n"
    "true: bool\nkey with space: value with space\ne: ''\nf: {a, b: 1}",
], ids=["scalars", "anchors-merges", "sequences-quotes", "comments-keys"])
def test_yaml_reader_equals_pyyaml_on_its_subset(doc):
    from cips3dpp_torch.io import yaml_lite

    got, want = yaml_lite.load(doc), yaml.safe_load(doc)
    assert got == want and repr(got) == repr(want)
    # anchors and aliases give the same object, as PyYAML's do
    if "*a" in doc:
        assert got["x"] is got["y"]


@pytest.mark.parametrize("doc", [
    "a: !!str 1", "a: |\n  x", "a: >\n  x", "a: [1,\n 2]", "a: 'x\n  y'", "a: 2001-12-14",
    "a: 1:30", "---\na: 1", "%YAML 1.1\na: 1", "a: *nope", "? a\n: 1", "a: b: c",
    "a: plain\n  continued", "a: @x", "a:\n\t- 1", "a: [\"x\": 1]", "a: \"\\q\"",
])
def test_yaml_reader_raises_outside_its_subset(doc):
    from cips3dpp_torch.io import yaml_lite

    with pytest.raises(yaml_lite.YAMLError):
        yaml_lite.load(doc)


@pytest.mark.parametrize("path", CONFIGS)
def test_snapshot_round_trips(path, tmp_path, monkeypatch):
    from cips3dpp_tpu.io import config as jc
    from cips3dpp_torch.io import config as tc
    from cips3dpp_torch.io import yaml_lite

    full = os.path.join(ROOT, path)
    for s in _sections(path):
        cfg = tc.load_command_config(full, s)
        out = tmp_path / s
        tc.save_snapshot(cfg, str(out))
        text = (out / "config_command.yaml").read_text()
        assert yaml.safe_load(text) == cfg, s
        assert yaml_lite.load(text) == cfg, s
        assert jc.load_snapshot(str(out)) == cfg, s
        with monkeypatch.context() as m:
            m.setitem(sys.modules, "yaml", None)
            assert tc.load_snapshot(str(out)) == cfg, s
    odd = {"a": "yes", "b": "1e-5", "c": "x: y", "d": "#h", "e": "", "f": None,
           "g": [1, [2.5e-5, {"h": "i j"}], {}], "h": {}, "j": float("inf"), "k": "null",
           "l": "é\n\"", "n": True, "o": "<<", "p": "-x", 5: "int key", "u": (1, 2)}
    text = yaml_lite.dump(odd)
    want = {**odd, "u": [1, 2]}
    assert yaml.safe_load(text) == want and yaml_lite.load(text) == want


@pytest.mark.parametrize("path", CONFIGS)
def test_typed_configs_match_jax(path):
    from cips3dpp_tpu.io import config as jc
    from cips3dpp_torch.io import config as tc

    full = os.path.join(ROOT, path)
    for s in _sections(path):
        cfg = tc.load_command_config(full, s)
        assert dataclasses.asdict(tc.train_config_from_dict(cfg)) == \
            dataclasses.asdict(jc.train_config_from_dict(cfg)), s
        g = cfg.get("G_cfg", cfg if s.startswith("_") else {})
        assert dataclasses.asdict(tc.generator_config_from_dict(g)) == \
            dataclasses.asdict(jc.generator_config_from_dict(g)), s


def _shards(tmp_path, rng):
    d = tmp_path / "npy"
    d.mkdir()
    imgs = [rng.integers(0, 256, (n, 8, 8, 3), dtype=np.uint8) for n in (5, 7)]
    for i, a in enumerate(imgs):
        np.save(d / f"images-8-{i:04d}.npy", a)
    return str(d), np.concatenate(imgs)


def test_data_iterator_matches_jax(tmp_path):
    from cips3dpp_tpu.io import dataset as jd
    from cips3dpp_torch.io import dataset as td

    shard_dir, images = _shards(tmp_path, np.random.default_rng(0))
    for make in (lambda m: m.open_dataset(shard_dir, resolution=8),
                 lambda m: m.ArrayDataset(images, hflip=True)):
        want_it, got_it = jd.data_iterator(make(jd), 3, seed=4), td.data_iterator(make(td), 3, seed=4)
        for _ in range(6):  # two epochs of 12 images: both permutations and flips
            want, got = next(want_it), next(got_it)
            assert got.dtype == np.float32 and np.array_equal(got, want)
        got_it.close()
    assert isinstance(td.open_dataset(shard_dir, 8), td.NpyShardDataset)


def test_open_dataset_formats(tmp_path, monkeypatch):
    from PIL import Image

    from cips3dpp_torch.io import dataset as td

    lmdb = tmp_path / "lmdb"
    lmdb.mkdir()
    (lmdb / "data.mdb").write_bytes(b"")
    # an LMDB directory opens as one (LMDB is ported); without the lmdb
    # module the import raises, naming it
    monkeypatch.setitem(sys.modules, "lmdb", None)
    with pytest.raises(ImportError, match="lmdb"):
        td.open_dataset(str(lmdb), 8)
    imgs = tmp_path / "imgs"
    imgs.mkdir()
    for i in range(3):
        Image.fromarray(np.full((12, 12, 3), 40 * i, np.uint8)).save(imgs / f"{i}.png")
    ds = td.open_dataset(str(imgs), 8)
    assert len(ds) == 3 and ds.images.shape == (3, 8, 8, 3)
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(RuntimeError, match="npy shards"):
        td.open_dataset(str(imgs), 8)
    with pytest.raises(ValueError, match="no batch"):
        next(td.data_iterator(ds, 4))


def test_prefetch_keeps_order_and_values():
    from cips3dpp_torch.parallel import prefetch_to_device

    batches = [np.full((2, 3), i, np.float32) + np.arange(3, dtype=np.float32)
               for i in range(5)]
    for size in (1, 2, 8):
        got = list(prefetch_to_device(iter(batches), "cpu", size=size))
        assert len(got) == 5
        for g, b in zip(got, batches):
            assert g.dtype == torch.float32 and g.device.type == "cpu"
            assert np.array_equal(g.numpy(), b)
    with pytest.raises(ValueError):
        next(prefetch_to_device(iter(batches), "cpu", size=0))


def _tiny_state(seed):
    from cips3dpp_torch.models.discriminator import DStyleGANProgressive
    from cips3dpp_torch.models.discriminator_pose import DVolumeRenderProgressive
    from cips3dpp_torch.models.generator import (
        DecoderConfig, Generator, GeneratorConfig, RendererConfig,
    )
    from cips3dpp_torch.train import TrainConfig, create_train_state

    cfg = GeneratorConfig(renderer=RendererConfig(hidden_dim=16),
                          decoder=DecoderConfig(upsample_list=(16,), style_dim=32,
                                                mapping_n_layers=1),
                          img_size=8, n_samples=4)
    return create_train_state(
        TrainConfig(), Generator(cfg, device="cpu", seed=seed),
        DStyleGANProgressive(16, 1, device="cpu", seed=seed + 1),
        DVolumeRenderProgressive(8, device="cpu", seed=seed + 2))


def _grads(state, gen):
    return {name: {k: [torch.randn(p.shape, generator=gen) for p in ps]
                   for k, ps in getattr(state, name).groups.items()}
            for name in ("opt_g", "opt_d", "opt_d_render")}


def _step(state, grads):
    for name, g in grads.items():
        getattr(state, name).step(g)


def _flat(state):
    out = {}
    for k, v in state.state_dict().items():
        if isinstance(v, torch.Tensor):
            out[k] = v
        elif isinstance(v, dict) and "state" in v:  # an optimizer
            for i, s in v["state"].items():
                out.update({f"{k}.{i}.{n}": t for n, t in s.items()})
        elif isinstance(v, dict):
            out.update({f"{k}.{n}": t for n, t in v.items()})
    return out


def test_checkpoints_round_trip_and_rotate(tmp_path):
    from cips3dpp_torch.io.checkpoint import (
        CheckpointManager, checkpoint_steps, load_best, save_best,
    )

    gen = torch.Generator().manual_seed(0)
    state = _tiny_state(1)
    grads = _grads(state, gen)
    _step(state, grads)
    state.mean_path_length = torch.tensor(0.5)
    state.step = 1
    mgr = CheckpointManager(str(tmp_path / "ckpt"), keep=2)
    assert mgr.latest_step() is None and mgr.restore(state) is None
    saved = {k: v.clone() for k, v in _flat(state).items()}
    mgr.save(1, state, config={"a": [1, 2]}, metrics={"fid": 9.5})
    for step in (2, 3):
        mgr.save(step, state)
    assert checkpoint_steps(mgr.directory) == [2, 3] and mgr.latest_step() == 3
    assert not [f for f in os.listdir(mgr.directory) if f.endswith(".tmp")]
    assert mgr.load_config() == {"a": [1, 2]}

    # restore into fresh modules and optimizers equals what was saved, and
    # the restored optimizers' next update equals the saved ones'
    fresh = _tiny_state(7)
    assert mgr.restore(fresh) is fresh and fresh.step == 1
    got = _flat(fresh)
    assert got.keys() == saved.keys()
    assert all(torch.equal(got[k], saved[k]) for k in saved)
    g2 = _grads(state, gen)
    _step(state, g2)
    _step(fresh, g2)
    after, want = _flat(fresh), _flat(state)
    assert all(torch.equal(after[k], want[k]) for k in want)
    assert fresh.opt_g.adam.param_groups[0]["lr"] == state.opt_g.adam.param_groups[0]["lr"]

    save_best(mgr.directory, state)
    other = _tiny_state(9)
    load_best(mgr.directory, other)
    assert all(torch.equal(_flat(other)[k], want[k]) for k in want)
    assert mgr.restore_raw(2)["metrics"] == {}
    with pytest.raises(ValueError):
        fresh.opt_d.load_state_dict(state.opt_g.state_dict())


def _train_cfg(tmp_path):
    path = tmp_path / "cfg.yaml"
    path.write_text(FLOW_CFG)
    return ["--cfg", str(path), "--section", "train", "--device", "cpu"]


def test_cli_train_sphere_init_and_sampling_from_the_checkpoint(tmp_path, capsys, monkeypatch):
    from cips3dpp_torch.apps.cli import _build_generator, main
    from cips3dpp_torch.io.checkpoint import CheckpointManager
    from cips3dpp_torch.io.config import apply_overrides

    data = tmp_path / "data"
    data.mkdir()
    np.save(data / "images-16-0000.npy",
            np.random.default_rng(0).integers(0, 256, (8, 16, 16, 3), dtype=np.uint8))
    base = _train_cfg(tmp_path)

    def run(argv):
        assert main(argv + ["--opts", *TINY_OPTS]) in (0, None)
        return json.loads(capsys.readouterr().out.strip().splitlines()[-1])

    res = run(["sphere-init", *base, "--outdir", str(tmp_path / "si"), "--n-iters", "2"])
    assert res == {"ckpt": str(tmp_path / "si" / "ckpt"), "step": 0}
    assert CheckpointManager(res["ckpt"]).latest_step() == 0
    run_dir = tmp_path / "run"
    res = run(["train", *base, "--data", str(data), "--outdir", str(run_dir),
               "--total-iters", "2", "--no-sphere-init"])
    assert res == {"outdir": str(run_dir), "done": True}
    ckpt = run_dir / "ckpt"
    assert (ckpt / "2.pt").exists() and (ckpt / "config_command.yaml").exists()
    assert (run_dir / "logs" / "metrics.jsonl").exists()

    # finetuning starts G from the source run's G_ema, the step count from 0
    from cips3dpp_torch.train import train_loop

    seen = {}
    train = train_loop.Trainer.train

    def spy(self, state, *a, **k):
        seen["g"] = {n: v.clone() for n, v in state.g.state_dict().items()}
        seen["step"] = state.step
        return train(self, state, *a, **k)

    monkeypatch.setattr(train_loop.Trainer, "train", spy)
    res = run(["train", *base, "--data", str(data), "--outdir", str(tmp_path / "ft"),
               "--total-iters", "1", "--finetune-dir", str(ckpt)])
    src = CheckpointManager(str(ckpt)).restore_raw()["state"]
    assert seen["step"] == 0 and res["done"]
    assert all(torch.equal(seen["g"][k], src["g_ema"][k]) for k in src["g_ema"])
    assert (tmp_path / "ft" / "ckpt" / "1.pt").exists()

    # sampling loads the latest step's G_ema
    cfg = apply_overrides({"ckpt": str(ckpt)}, TINY_OPTS)
    model, _ = _build_generator(cfg, "cpu")
    want = CheckpointManager(str(ckpt)).restore_raw()["state"]["g_ema"]
    got = model.state_dict()
    assert all(torch.equal(got[k], want[k]) for k in want)
    res = run(["sample-multi-view", "--device", "cpu", "--outdir", str(tmp_path / "mv"),
               "--n-frames", "2", "--truncation", "1.0", "--fused", "--opts", "ckpt",
               str(ckpt)])
    assert res["frames"] == 2 and os.path.exists(res["grid"])


@pytest.mark.parametrize("flags,error,match", [
    (["--device", "cuda", "--n-devices", "64"], RuntimeError, "GPU|CUDA"),
    (["--fid-data", "missing"], FileNotFoundError, "missing"),
    (["--fid-data", "DATA", "--inception", "missing.pth"], FileNotFoundError, "missing"),
    (["--init-renderer-from", "missing"], FileNotFoundError, "missing"),
], ids=["n-devices", "fid-data", "inception", "init-renderer-from"])
def test_cli_train_flags_not_ported_raise(flags, error, match, tmp_path):
    """Every flag of the JAX command is ported; each raises before any step
    where it cannot be met: more ranks than GPUs, a missing FID dataset, a
    missing Inception file, a missing stage-1 checkpoint directory
    (tests/test_torch_port_stylesdf.py runs the handoff)."""
    from cips3dpp_torch.apps.cli import main

    data = tmp_path / "data"
    data.mkdir()
    np.save(data / "images-16-0000.npy", np.zeros((8, 16, 16, 3), np.uint8))
    flags = [str(data) if f == "DATA" else f for f in flags]
    with pytest.raises(error, match=match):
        main(["train", *_train_cfg(tmp_path), "--data", str(data), "--total-iters", "1",
              "--no-sphere-init", "--outdir", str(tmp_path / "o"), *flags,
              "--opts", *TINY_OPTS])
