"""FID and KID in cips3dpp_torch against the JAX package's, on the CPU.

- frechet_distance, kid, feature_stats and _sym_eigvals on the same float64
  numpy inputs: within 1e-12 (the same numpy code; measured equal);
- tf1_bilinear_resize within 1e-6 (two f32 products; measured 4.8e-7);
- InceptionV3Features with the JAX package's init_inception(PRNGKey(0))
  weights, carried across by io.jax_params.jax_inception_to_state_dict, at
  batch 2 on 64^2 inputs in both input protocols: within REL_FEATURES of
  the largest |feature| (measured 1.2e-6 and 1.1e-6; f32 convolutions
  summed in another order through 94 layers). One module-scoped JAX init and one
  compile of the JAX features per input shape;
- the port's state dict read back by the JAX package's
  import_torch_inception gives the same flax variables exactly (the
  pt_inception names);
- eval_fid on the tiny generator with injected z's, cameras, perturbation
  and noise against the JAX generator's forward and features on the same
  draws: images within the generator parity bound of
  tests/test_torch_port_generator.py (1e-4; measured 2.7e-5), FID within
  REL_FID of its value
  (measured 2.8e-8; with random Inception weights and 4 images it is
  -4.0e-3 in both packages);
- the `eval-fid` command in process, and `train --n-devices 1 --fid-data`
  on a one-rank gloo group: FID logged at the checkpoint, best_fid.pt
  written, and its final checkpoint bit-equal to plain `train`'s (the
  all-reduce at world size 1 divides by 1; the FID draws come from their
  own generator).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import a, port_and_jax_generator, t
from torch_port_train_helpers import tiny_configs

REL_FEATURES = 1e-5
REL_FID = 1e-6


@pytest.fixture(scope="module")
def incep():
    """(JAX variables of init_inception(PRNGKey(0)), the port's module with
    them, a jitted JAX feature function of (variables, x, fidelity_u8))."""
    from cips3dpp_tpu.models.inception import InceptionV3Features as JInc, init_inception
    from cips3dpp_torch.io.jax_params import jax_inception_to_state_dict
    from cips3dpp_torch.models.inception import InceptionV3Features

    jv = jax.jit(init_inception)(jax.random.PRNGKey(0))
    model = InceptionV3Features(device="cpu")
    model.load_state_dict(jax_inception_to_state_dict(jax.tree.map(np.asarray, jv)))
    feats = jax.jit(lambda v, x, u8: JInc(fidelity_u8=u8).apply(v, x), static_argnums=2)
    return jv, model, feats


def _feature_stats_cases():
    rng = np.random.RandomState(0)
    return {
        "separated": (rng.randn(300, 16), rng.randn(300, 16) + 0.5),
        # fewer samples than dimensions: rank-deficient covariances
        "rank_deficient": (rng.randn(8, 32), 2 * rng.randn(8, 32)),
        "identical": (rng.randn(200, 8),) * 2,
    }


@pytest.mark.parametrize("case", ["separated", "rank_deficient", "identical"])
def test_fid_formulas_match_jax(case):
    from cips3dpp_tpu.apps import eval_fid as je
    from cips3dpp_torch.apps import eval_fid as te

    fa, fb = _feature_stats_cases()[case]
    (mu_a, s_a), (mu_b, s_b) = te.feature_stats(fa), te.feature_stats(fb)
    for got, want in zip(te.feature_stats(fa) + te.feature_stats(fb),
                         je.feature_stats(fa) + je.feature_stats(fb)):
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(te._sym_eigvals(s_a @ s_b), je._sym_eigvals(s_a @ s_b),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(te.frechet_distance(mu_a, s_a, mu_b, s_b),
                               je.frechet_distance(mu_a, s_a, mu_b, s_b), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(te.kid(fa, fb, n_subsets=5, subset_size=6),
                               je.kid(fa, fb, n_subsets=5, subset_size=6), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("shape", [(2, 64, 64, 3), (1, 16, 24, 3), (1, 320, 300, 3)])
def test_tf1_bilinear_resize_matches_jax(shape):
    from cips3dpp_tpu.models.inception import tf1_bilinear_resize as jr
    from cips3dpp_torch.models.inception import tf1_bilinear_resize

    x = np.random.default_rng(1).uniform(-1, 1, shape).astype(np.float32)
    np.testing.assert_allclose(a(tf1_bilinear_resize(t(x), 299, 299)), a(jr(x, 299, 299)),
                               rtol=0, atol=1e-6)


def _rel(got, want):
    got, want = a(got), a(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("u8", [True, False], ids=["fidelity_u8", "float"])
def test_inception_features_match_jax(incep, u8):
    jv, model, feats = incep
    rng = np.random.default_rng(2)
    x = (rng.integers(0, 256, (2, 64, 64, 3)).astype(np.float32) if u8
         else rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32))
    with torch.no_grad():
        got = model(t(x), fidelity_u8=u8)
    want = feats(jv, jnp.asarray(x), u8)
    assert got.shape == (2, 2048) and np.isfinite(a(got)).all()
    assert _rel(got, want) <= REL_FEATURES, _rel(got, want)


def test_state_dict_names_are_pt_inception(incep):
    """The port's state dict is what torch-fidelity's .pth holds: the JAX
    package's importer of that file gives back the same variables."""
    from cips3dpp_tpu.models.inception import import_torch_inception

    jv, model, _ = incep
    back = import_torch_inception({k: v.numpy() for k, v in model.state_dict().items()})
    flat = lambda tree: {jax.tree_util.keystr(k): np.asarray(v)
                         for k, v in jax.tree_util.tree_leaves_with_path(tree)}
    want, got = flat(jv), flat(back)
    assert got.keys() == want.keys() and len(got) == 94 * 5
    assert all(np.array_equal(got[k], want[k]) for k in want)


def _draws_np(batch, seed, cfg):
    from cips3dpp_torch.models.decoder import Decoder

    rng = np.random.default_rng(seed)
    shapes = Decoder(upsample_list=cfg.decoder.upsample_list).noise_shapes(cfg.img_size)
    return dict(
        zs=[rng.standard_normal((batch, 256)).astype(np.float32) for _ in range(2)],
        azim=(0.3 * rng.standard_normal(batch)).astype(np.float32),
        elev=(0.15 * rng.standard_normal(batch)).astype(np.float32),
        t_rand=rng.uniform(size=(batch, cfg.img_size, cfg.img_size, 1)).astype(np.float32),
        noise=[rng.standard_normal((batch,) + sh[1:]).astype(np.float32) for sh in shapes])


def test_eval_fid_matches_jax(incep, monkeypatch):
    from cips3dpp_tpu.apps import eval_fid as je
    from cips3dpp_tpu.core.camera import camera_from_angles as jcam
    from cips3dpp_tpu.models.generator import Generator as JG
    from cips3dpp_torch.apps.eval_fid import eval_fid, generate_images
    from cips3dpp_torch.core.camera import camera_from_angles
    from cips3dpp_torch.train.steps import Draws

    jv, model, feats = incep
    jcfg, tcfg = tiny_configs()
    g, gvars = port_and_jax_generator(jcfg, tcfg, seed=31)
    batches = [_draws_np(2, 40 + i, tcfg) for i in range(2)]
    draws = [Draws(zs=tuple(t(z) for z in d["zs"]),
                   cam=camera_from_angles(t(d["azim"]), t(d["elev"]), tcfg.img_size),
                   t_rand=t(d["t_rand"]), noise=[t(n) for n in d["noise"]]) for d in batches]
    reals = [np.tanh(np.random.default_rng(50 + i).standard_normal((2, 16, 16, 3)))
             .astype(np.float32) for i in range(2)]

    # the JAX generator's forward on the same draws: its perturbation offsets
    # (jax.random.uniform in core/rays.py) replaced by the injected ones
    uniform = jax.random.uniform

    @jax.jit
    def jax_rgb(zs, azim, elev, noise, t_rand):
        def offsets(key, shape, dtype=jnp.float32, *args, **kw):
            # flax also draws (abstractly) for its parameter shape checks
            if tuple(shape) != t_rand.shape:
                return uniform(key, shape, dtype, *args, **kw)
            return t_rand.astype(dtype)

        cam = jcam(azim, elev, jcfg.img_size)
        with monkeypatch.context() as mp:
            mp.setattr(jax.random, "uniform", offsets)
            out = JG(jcfg).apply(gvars, zs=zs, cam_poses=cam.extrinsics, focals=cam.focal,
                                 near=cam.near, far=cam.far, noise_bufs=noise,
                                 rngs={"perturb": jax.random.PRNGKey(0)})
        return jnp.clip(out["rgb"], -1, 1)

    def jax_images(d):
        return np.asarray(jax_rgb(tuple(jnp.asarray(z) for z in d["zs"]), d["azim"],
                                  d["elev"], [jnp.asarray(n) for n in d["noise"]],
                                  jnp.asarray(d["t_rand"])))

    want_imgs = [jax_images(d) for d in batches]
    got_imgs = list(generate_images(g, 4, 2, draws=draws))
    for got, want in zip(got_imgs, want_imgs):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)

    u8 = lambda x: jnp.floor((jnp.clip(jnp.asarray(x), -1, 1) + 1) * 127.5)
    jf = lambda imgs: np.concatenate([np.asarray(feats(jv, u8(x), True)) for x in imgs])
    jreal, jfake = jf(reals), jf(want_imgs)
    want_fid = je.frechet_distance(*je.feature_stats(jfake), *je.feature_stats(jreal))
    res = eval_fid(g, reals, model, n_fake=4, batch_size=2, draws=draws)
    assert (res.n_real, res.n_fake) == (4, 4) and res.kid_mean is None
    assert abs(res.fid - want_fid) <= REL_FID * abs(want_fid), (res.fid, want_fid)


def _shards(path, n=8, size=16, seed=0):
    os.makedirs(path, exist_ok=True)
    np.save(os.path.join(path, f"images-{size}-0000.npy"),
            np.random.default_rng(seed).integers(0, 256, (n, size, size, 3), dtype=np.uint8))
    return str(path)


def _cli(argv, capsys):
    from cips3dpp_torch.apps.cli import main
    from test_torch_port_cli import TINY_OPTS

    assert main(argv + ["--opts", *TINY_OPTS]) in (0, None)
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_eval_fid_command(tmp_path, capsys):
    res = _cli(["eval-fid", "--device", "cpu", "--data", _shards(tmp_path / "data"),
                "--n-images", "4", "--batch", "2", "--kid"], capsys)
    assert res["inception_weights"] == "random"
    assert (res["n_real"], res["n_fake"]) == (4, 4)
    assert all(np.isfinite(res[k]) for k in ("fid", "kid_mean", "kid_std"))


def test_train_one_rank_with_fid_equals_plain_train(tmp_path, capsys, monkeypatch):
    """`train --n-devices 1 --fid-data` (a one-rank gloo group, the FID at
    the step-1 checkpoint) ends on the same tensors as plain `train`, bit
    for bit."""
    from cips3dpp_torch.io.checkpoint import CheckpointManager, checkpoint_steps
    from cips3dpp_torch.train import train_loop
    from test_torch_port_io import FLOW_CFG

    # discriminators sized to the 16^2 images and 8^2 thumbnails: small
    # checkpoints
    flow = FLOW_CFG.replace("input_size: 1024", "input_size: 16").replace(
        "input_size: 64", "input_size: 8")
    assert flow.count("input_size") == 2 and flow != FLOW_CFG

    init = train_loop.Trainer.__init__
    monkeypatch.setattr(train_loop.Trainer, "__init__",
                        lambda self, *a, **k: init(self, *a, **{**k, "ckpt_every": 1}))
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(flow)
    data = _shards(tmp_path / "data")
    base = ["train", "--cfg", str(cfg), "--section", "train", "--device", "cpu", "--data",
            data, "--total-iters", "1"]
    _cli(base + ["--outdir", str(tmp_path / "plain")], capsys)
    res = _cli(base + ["--outdir", str(tmp_path / "dp"), "--n-devices", "1", "--fid-data",
                       _shards(tmp_path / "fid", seed=1)], capsys)
    assert res["done"]
    plain = CheckpointManager(str(tmp_path / "plain" / "ckpt")).restore_raw(1)
    dp = CheckpointManager(str(tmp_path / "dp" / "ckpt")).restore_raw(1)
    with open(tmp_path / "dp" / "logs" / "fid.jsonl") as f:
        logged = [json.loads(line) for line in f]
    assert [r["step"] for r in logged] == [1] and np.isfinite(logged[0]["fid"])
    assert not os.path.exists(tmp_path / "plain" / "logs" / "fid.jsonl")
    assert os.path.exists(tmp_path / "dp" / "ckpt" / "best_fid.pt")
    assert checkpoint_steps(str(tmp_path / "dp" / "ckpt")) == [1]

    def flat(tree, prefix=""):
        if isinstance(tree, torch.Tensor):
            return {prefix: tree}
        if isinstance(tree, dict):
            return {k: v for n, sub in tree.items() for k, v in flat(sub, f"{prefix}.{n}").items()}
        return {}

    want, got = flat(plain["state"]), flat(dp["state"])
    assert got.keys() == want.keys() and len(want) > 100
    bad = [k for k in want if not torch.equal(got[k], want[k])]
    assert not bad, (len(bad), bad[:5])
