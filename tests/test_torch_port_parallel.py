"""Data-parallel training of cips3dpp_torch on the CPU: two gloo ranks, each
with half of a global batch of 4, against one process with the whole
batch (the port's form of tests/test_mesh_equivalence.py; the port's
one-process steps are held to the JAX package by
tests/test_torch_port_train_steps.py).

One spawn of two ranks (parallel.run_ranks, the rendezvous file under
tmp_path) runs, with the tiny generator of tests/torch_port_train_helpers.py
without its decoder upsample block (8^2 rays, an 8^2 image, so the
discriminators' 512-channel blocks run at 8^2), both discriminators sized
to it, DiffAugment on, and every draw from a generator seeded alike on
each rank:

- each of d_step without and with lazy R1, g_step, path_reg_step,
  sphere_init_step and ema_update from the same replicated state, once
  with each optimizer's Adam swapped for SGD(lr=1), as
  tests/test_mesh_equivalence.py does, so an updated parameter is the
  parameter minus its averaged, clipped gradient, and once with the real
  clipped Adam, whose moments are the gradient (exp_avg, b1 = 0) and its
  square. Adam's parameters are compared in the SGD form: its first
  update, lr * g / (|g| + 1e-8), turns the f32 noise of a near-zero
  gradient into up to +-lr (measured here: 1.1e-4 on the image D);
- the first d_step with a planted fault, a per-rank minibatch stddev;
- the stddev and its gradient on the gathered batch and the rows of the
  data stream;
- the Trainer for two iterations (SGD(lr=1e-2) in each optimizer, for the
  same reason) with a checkpoint, the best-FID slot and a resume.

Every parameter, Adam moment, mean_path_length and logged metric must
equal the one-process run's within TOL: the ranks sum over 2 rows where
the process sums over 4 and average the halves, so only f32 summation
orders differ. Measured here: at most 4.8e-7 on the D steps' tensors and
4.8e-6 on the G steps' (gradients of order 1, inside rtol); the planted
fault moves 13 tensors of the first D step, by up to 9.8e-3.
"""

import os

import numpy as np
import pytest
import torch

TOL = dict(rtol=1e-5, atol=1e-6)
BATCH = 4
SEED = 7


def _setup():
    from cips3dpp_torch.models.discriminator import DStyleGANProgressive
    from cips3dpp_torch.models.discriminator_pose import DVolumeRenderProgressive
    from cips3dpp_torch.models.generator import (
        DecoderConfig, Generator, GeneratorConfig, RendererConfig,
    )
    from cips3dpp_torch.models.layers import randomize_zero_init_
    from cips3dpp_torch.train.state import TrainConfig

    torch.set_num_threads(2)
    gcfg = GeneratorConfig(
        renderer=RendererConfig(n_layers=2, hidden_dim=32),
        decoder=DecoderConfig(channel_multiplier=2, kernel_size=1, upsample_list=(),
                              style_dim=64, mapping_n_layers=2),
        img_size=8, n_samples=4)
    tcfg = TrainConfig(batch=BATCH, gen_img_size=8, cam_img_size=8, data_img_size=8,
                       fused_renderer_d=False, d_reg_every=2, g_reg_every=2, ema_start=1,
                       fade_steps=10, warmup_iters=1, init_renderer=False)
    g = Generator(gcfg, device="cpu", seed=SEED)
    randomize_zero_init_(g, torch.Generator().manual_seed(SEED))
    d = DStyleGANProgressive(8, 1, diffaug=True, device="cpu", seed=SEED + 1)
    randomize_zero_init_(d, torch.Generator().manual_seed(SEED + 1))
    dr = DVolumeRenderProgressive(8, device="cpu", seed=SEED + 2)
    return gcfg, tcfg, g, d, dr


def _images(n=8):
    return np.random.default_rng(SEED).uniform(-1, 1, (n, 8, 8, 3)).astype(np.float32)


def _snapshot(state, modules=None, moments_only=False):
    """Copies of the state's tensors: of `modules` (default: all) and their
    optimizers' moments, and mean_path_length."""
    modules = modules or state.MODULES
    out = {}
    for k in () if moments_only else modules:
        out.update({f"{k}.{n}": v.detach().clone()
                    for n, v in getattr(state, k).state_dict().items()})
    for k in (OPTIMIZER[m] for m in modules if m in OPTIMIZER):
        for i, s in getattr(state, k).state_dict()["state"].items():
            out.update({f"{k}.{i}.{n}": v.detach().clone() for n, v in s.items()})
    out["mean_path_length"] = state.mean_path_length.detach().clone()
    return out


OPTIMIZER = {"g": "opt_g", "d": "opt_d", "d_render": "opt_d_render"}
# the modules each step updates
UPDATES = {"d": ("d", "d_render"), "d_r1": ("d", "d_render"), "g": ("g",),
           "path_reg": ("g",), "sphere_init": ("g",), "ema": ("g_ema",)}


PLAN = ("d", "d_r1", "g", "path_reg", "sphere_init", "ema")


def _swap_sgd(state, lr):
    for k in state.OPTIMIZERS:
        opt = getattr(state, k)
        opt.adam = torch.optim.SGD([{"params": ps, "name": k} for k, ps in opt.groups.items()],
                                   lr=lr)


def _fresh(mesh, sgd):
    """A replicated state, its steps and draw generator and the rank's real
    rows; with `sgd`, every optimizer's Adam swapped for SGD(lr=1)."""
    from cips3dpp_torch.parallel import replicate, shard_batch
    from cips3dpp_torch.train.state import create_train_state
    from cips3dpp_torch.train.steps import make_train_steps

    gcfg, tcfg, g, d, dr = _setup()
    state = replicate(create_train_state(tcfg, g, d, dr, mesh), mesh)
    if sgd:
        _swap_sgd(state, 1.0)
    steps = make_train_steps(gcfg, tcfg, mesh)
    real = torch.from_numpy(shard_batch(_images(BATCH), mesh))
    return state, steps, torch.Generator().manual_seed(SEED + 3), real


def _run(name, state, steps, gen, real):
    from cips3dpp_torch.train.steps import ema_update

    d_step, g_step, path_step, sphere_step = steps
    if name == "ema":
        # after one G update, so G and G_ema differ
        g_step(state, gen, 0.5)
        return ema_update(state, 0.5), {}
    if name in ("d", "d_r1"):
        return d_step(state, real, gen, 0.5, d_regularize=name == "d_r1")
    if name == "g":
        return g_step(state, gen, 0.5, renderer_detach=None)
    return (path_step if name == "path_reg" else sphere_step)(state, gen)


def _steps(mesh, planted=False):
    """{kind: [(name, metrics, snapshot)]}, each step from the fresh state:
    "sgd" under SGD(lr=1) (every tensor of the state), "adam" under the
    clipped Adam (the moments); with `planted`, the first SGD step only."""
    out = {"sgd": [], "adam": []}
    for kind, plan in (("sgd", PLAN[:1] if planted else PLAN),
                       ("adam", () if planted else PLAN[:-1])):
        for name in plan:
            state, *rest = _fresh(mesh, sgd=kind == "sgd")
            _, metrics = _run(name, state, *rest)
            out[kind].append((name, {k: float(v) for k, v in metrics.items()},
                              _snapshot(state, UPDATES[name], moments_only=kind == "adam")))
    return out


def _per_rank_stddev(x, group_size=4, num_features=1, split=None, mesh=None):
    """The planted fault: the statistic over the rank's rows only."""
    return _ORIGINAL_STDDEV(x, group_size, num_features, split)


_ORIGINAL_STDDEV = None


def _stddev_case():
    x = torch.from_numpy(np.random.default_rng(SEED).standard_normal((BATCH, 6, 4, 4))
                         .astype(np.float32))
    w = torch.from_numpy(np.random.default_rng(SEED + 1).standard_normal((BATCH, 7, 4, 4))
                         .astype(np.float32))
    return x, w


def _trainer_run(mesh, outdir):
    """Two iterations (a checkpoint at 2 with an FID hook), then a resume
    into a state drawn from another seed."""
    from cips3dpp_torch.train.train_loop import TrainHooks, Trainer

    gcfg, tcfg, g, d, dr = _setup()
    tr = Trainer(g, d, dr, gcfg, tcfg, outdir, mesh=mesh, log_every=1, ckpt_every=2,
                 keep_ckpts=1)
    state = tr.init_state(torch.Generator().manual_seed(SEED + 4))
    _swap_sgd(state, 1e-2)

    def batches():
        imgs = _images()
        i = 0
        while True:
            yield imgs[[(i + j) % len(imgs) for j in range(BATCH)]]
            i += BATCH

    state = tr.train(state, batches(), torch.Generator().manual_seed(SEED + 5),
                     total_iters=2, hooks=TrainHooks(eval_fid=lambda s: 1.5))
    trained = _snapshot(state)
    gcfg, tcfg, g, d, dr = _setup()
    tr2 = Trainer(g, d, dr, gcfg, tcfg, outdir, mesh=mesh)
    fresh = tr2.init_state(torch.Generator().manual_seed(SEED + 6))
    _swap_sgd(fresh, 1e-2)
    restored, step = tr2.resume(fresh)
    return {"trained": trained, "resumed": _snapshot(restored), "step": step,
            "logger": tr.logger is not None}


def _on_rank(mesh, outdir):
    """Everything the test holds a rank to, in one spawn."""
    global _ORIGINAL_STDDEV
    from cips3dpp_torch.io.dataset import ArrayDataset, data_iterator
    from cips3dpp_torch.models import discriminator
    from cips3dpp_torch.parallel import shard_batch

    res = {"rank": mesh.rank, "world": mesh.world, "steps": _steps(mesh)}
    res["counts"] = dict(mesh.counts)
    _ORIGINAL_STDDEV = discriminator.minibatch_stddev
    discriminator.minibatch_stddev = _per_rank_stddev
    try:
        res["planted"] = _steps(mesh, planted=True)
    finally:
        discriminator.minibatch_stddev = _ORIGINAL_STDDEV

    x, w = _stddev_case()
    xr = shard_batch(x, mesh).clone().requires_grad_(True)
    out = discriminator.minibatch_stddev(xr, mesh=mesh)
    (grad,) = torch.autograd.grad((out * shard_batch(w, mesh)).sum(), xr)
    res["stddev"] = out.detach()
    res["stddev_grad"] = grad
    res["stddev_per_rank"] = discriminator.minibatch_stddev(shard_batch(x, mesh))

    it = data_iterator(ArrayDataset(_images(), hflip=True), BATCH, seed=3)
    res["rows"] = [torch.from_numpy(shard_batch(next(it), mesh).copy()) for _ in range(3)]
    it.close()
    res["trainer"] = _trainer_run(mesh, outdir)
    return res


def _one_process(tmp):
    """The same functions in one process, on the whole batch."""
    from cips3dpp_torch.io.dataset import ArrayDataset, data_iterator
    from cips3dpp_torch.models.discriminator import minibatch_stddev

    x, w = _stddev_case()
    xg = x.clone().requires_grad_(True)
    out = minibatch_stddev(xg)
    (grad,) = torch.autograd.grad((out * w).sum(), xg)
    it = data_iterator(ArrayDataset(_images(), hflip=True), BATCH, seed=3)
    rows = [torch.from_numpy(next(it)) for _ in range(3)]
    it.close()
    return {"steps": _steps(None), "stddev": out.detach(), "stddev_grad": grad,
            "rows": rows, "trainer": _trainer_run(None, str(tmp / "single"))}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from concurrent.futures import ThreadPoolExecutor

    from cips3dpp_torch.parallel import run_ranks

    tmp = tmp_path_factory.mktemp("parallel")
    # the one-process run on a thread of this process while the ranks run
    with ThreadPoolExecutor(1) as pool:
        single = pool.submit(_one_process, tmp)
        ranks = run_ranks(_on_rank, 2, str(tmp / "ranks"), device="cpu",
                          workdir=str(tmp / "rendezvous"), timeout=600)
        return ranks, single.result(), tmp


def _gap(got: dict, want: dict):
    """(largest |got - want|, the names outside TOL)."""
    assert got.keys() == want.keys()
    worst, bad = 0.0, []
    for k in want:
        g, w = torch.as_tensor(got[k]).double(), torch.as_tensor(want[k]).double()
        worst = max(worst, float((g - w).abs().max()))
        if not torch.allclose(g, w, **TOL):
            bad.append(k)
    return worst, bad


@pytest.mark.parametrize("kind", ["sgd", "adam"])
def test_two_ranks_equal_one_process(runs, kind):
    ranks, single, _ = runs
    assert [r["rank"] for r in ranks] == [0, 1] and {r["world"] for r in ranks} == {2}
    plan = PLAN if kind == "sgd" else PLAN[:-1]
    for r in ranks:
        assert [s[0] for s in r["steps"][kind]] == list(plan)
        for (name, m, snap), (_, m1, snap1) in zip(r["steps"][kind], single["steps"][kind]):
            gap, bad = _gap(m, m1)
            assert not bad, (r["rank"], name, "metrics", bad, gap)
            gap, bad = _gap(snap, snap1)
            assert not bad, (r["rank"], name, bad[:5], gap)
    # the two ranks hold the same state after every step, bit for bit
    for (_, _, s0), (_, _, s1) in zip(ranks[0]["steps"][kind], ranks[1]["steps"][kind]):
        assert all(torch.equal(s0[k], s1[k]) for k in s0)
    if kind == "sgd":
        # path reg moved the mean path length
        assert float(single["steps"]["sgd"][3][2]["mean_path_length"]) != 0.0
    # one gradient all-reduce an optimizer step: d and d_r1 (two optimizers
    # each), g, path_reg, sphere_init and the G step before ema, then the
    # same but ema under Adam
    assert ranks[0]["counts"]["grad_all_reduce"] == 8 + 7


def test_per_rank_stddev_is_caught(runs):
    """The planted fault (each rank's stddev over its own 2 rows) moves the
    first D step outside TOL, so the comparison sees a lost gather."""
    ranks, single, _ = runs
    for r in ranks:
        gap, bad = _gap(r["planted"]["sgd"][0][2], single["steps"]["sgd"][0][2])
        assert bad and gap > 1e3 * TOL["atol"], (gap, bad[:3])


def _rows(x, rank):
    return x[2 * rank:2 * rank + 2]


def test_minibatch_stddev_on_the_gathered_batch(runs):
    ranks, single, _ = runs
    for r in ranks:
        # the same global statistic: the rank's rows of the one-process output
        assert torch.equal(r["stddev"], _rows(single["stddev"], r["rank"]))
        torch.testing.assert_close(r["stddev_grad"], _rows(single["stddev_grad"], r["rank"]),
                                   **TOL)
        assert not torch.allclose(r["stddev_per_rank"], r["stddev"], **TOL)


def test_rows_of_the_data_stream(runs):
    ranks, single, _ = runs
    for r in ranks:
        for got, want in zip(r["rows"], single["rows"]):
            assert torch.equal(got, _rows(want, r["rank"]))


def test_trainer_on_two_ranks(runs):
    """Two iterations on two ranks equal one process; rank 0 alone logs and
    writes the checkpoint and the best-FID slot; a resume restores it on
    every rank."""
    ranks, single, tmp = runs
    for r in ranks:
        gap, bad = _gap(r["trainer"]["trained"], single["trainer"]["trained"])
        assert not bad, (r["rank"], bad[:5], gap)
        assert r["trainer"]["step"] == 2
        assert all(torch.equal(r["trainer"]["resumed"][k], r["trainer"]["trained"][k])
                   for k in r["trainer"]["trained"])
    assert [r["trainer"]["logger"] for r in ranks] == [True, False]
    run = tmp / "ranks"
    assert sorted(os.listdir(run / "ckpt")) == ["2.pt", "best_fid.pt"]
    assert os.path.exists(run / "logs" / "metrics.jsonl")


def test_mesh_options_raise(tmp_path):
    """The ray axis works on two ranks (data 1 x ray 2) and raises where it
    does not divide the ranks; the other options raise as before."""
    from cips3dpp_torch.parallel import make_mesh, run_ranks
    from torch_port_ray_helpers import _ray_axes

    axes = run_ranks(_ray_axes, 2, device="cpu", ray=2, workdir=str(tmp_path), timeout=120)
    assert axes == [{"rank": r, "data": 1, "ray": 2, "data_rank": 0, "ray_rank": r}
                    for r in (0, 1)]
    with pytest.raises(ValueError, match="a mesh of 1 ranks has no ray axis of 2"):
        make_mesh(ray=2, device="cpu")
    with pytest.raises(ValueError, match="rendezvous"):
        make_mesh(2, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh(1)
