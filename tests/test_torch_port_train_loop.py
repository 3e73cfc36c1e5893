"""The training loop of cips3dpp_torch (train/train_loop.py) against the
JAX package's, on the CPU:

- the schedule: both packages' `Trainer.train` drive recorders in place of
  their steps and `ema_update` for 40 iterations, and must issue the same
  calls with the same flags at the same indices, log the same metrics,
  and call eval_fid / on_checkpoint at the same indices;
- resume on the real loop at the tiny size of tests/test_train_e2e.py:
  4 iterations, a checkpoint, a restore into fresh modules and 4 more
  equal 8 straight iterations bit for bit (atol 0: the CPU runs the same
  operations in the same order, and the restore copies every tensor);
  the D step renders through K1's plain version;
- a JAX TrainState carried into the port by io/jax_params.py gives the
  same next Adam update: parameters within rtol 1e-6, or ATOL_LR of the
  step size lr where a parameter lands near 0 (Adam in f32).
"""

import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torch_port_helpers import port_and_jax_generator
from torch_port_train_helpers import k1_off_card, port_and_jax_d, port_and_jax_pose_d, \
    tiny_configs

# Where the carried-across update leaves a parameter near 0, it keeps the
# update's rounding: the packages sum the squares of a group's gradient
# norm (the clip) in different orders, and that f32 rounding, about
# log2(N) eps = 1.4e-6 for a tree reduction over N ~ 1e7 values, scales
# the whole step. So a parameter is held within rtol 1e-6 or ATOL_LR of
# its step size lr (largest reading 1.9e-6 of lr, the image D).
ATOL_LR = 4e-6
SCHEDULE = dict(d_reg_every=4, g_reg_every=3, warmup_iters=10, ema_start=12, fade_steps=16)


class _Recorder:
    """Steps and ema_update that record their calls. Each D step starts an
    iteration; every call logs (idx, name, flags...)."""

    def __init__(self, start):
        self.idx = start - 1
        self.calls = []
        self.n = {"d": 0, "g": 0, "p": 0}

    def metrics(self, name):
        self.n[name] += 1
        return {f"{name}_loss": np.float32(self.n[name] + 0.25 * self.idx)}

    def d_step(self, state, real, key, alpha, d_regularize):
        self.idx += 1
        self.calls.append((self.idx, "d", float(alpha), bool(d_regularize),
                           float(np.asarray(real)[0, 0, 0, 0])))
        return state, self.metrics("d")

    def g_step(self, state, key, alpha, renderer_detach=None):
        self.calls.append((self.idx, "g", float(alpha), renderer_detach))
        return state, self.metrics("g")

    def path_step(self, state, key):
        self.calls.append((self.idx, "path_reg"))
        return state, self.metrics("p")

    def ema_update(self, state, decay):
        self.calls.append((self.idx, "ema", float(decay)))
        return state


class _PortState:
    """What the port's checkpoint manager saves of a state."""

    def state_dict(self):
        return {"w": torch.arange(3.0)}


def _batches(n=2):
    """Batch i is filled with i (the order the steps see)."""
    i = 0
    while True:
        yield np.full((n, 2, 2, 3), i, np.float32)
        i += 1


def _drive(trainer, rec, state, key, tmp_hooks, total=40):
    trainer.steps = (rec.d_step, rec.g_step, rec.path_step, None)
    return trainer.train(state, _batches(), key, start_iter=0, total_iters=total,
                         hooks=tmp_hooks)


def _hooks(module, rec):
    seen = {"metrics": [], "fid": [], "ckpt": []}
    fids = iter([3.0, 2.0, 2.5])

    def eval_fid(state):
        seen["fid"].append(rec.idx)
        return next(fids)

    return seen, module.TrainHooks(
        on_metrics=lambda i, m: seen["metrics"].append(
            (i, {k: v for k, v in m.items() if k != "iters_per_sec"})),
        on_checkpoint=lambda i, s: seen["ckpt"].append(i),
        eval_fid=eval_fid)


def test_loop_schedule_matches_jax(tmp_path, monkeypatch):
    import cips3dpp_torch.train.train_loop as tl
    import cips3dpp_tpu.train.train_loop as jl
    from cips3dpp_tpu.train.state import TrainConfig as JTC
    from cips3dpp_torch.train.state import TrainConfig

    _, gen_cfg = tiny_configs()
    kw = dict(log_every=5, ckpt_every=15, keep_ckpts=2, config_snapshot={"demo": True})

    jrec = _Recorder(0)
    jseen_hooks = _hooks(jl, jrec)
    monkeypatch.setattr(jl, "ema_update", jrec.ema_update)
    jtr = jl.Trainer(None, None, None, None, JTC(**SCHEDULE), str(tmp_path / "jax"), **kw)
    _drive(jtr, jrec, {"w": np.arange(3.0, dtype=np.float32)}, jax.random.PRNGKey(0),
           jseen_hooks[1])

    prec = _Recorder(0)
    pseen_hooks = _hooks(tl, prec)
    monkeypatch.setattr(tl, "ema_update", prec.ema_update)
    ptr = tl.Trainer(types.SimpleNamespace(device=torch.device("cpu")), None, None, gen_cfg,
                     TrainConfig(**SCHEDULE), str(tmp_path / "port"), **kw)
    _drive(ptr, prec, _PortState(), torch.Generator().manual_seed(0), pseen_hooks[1])

    assert prec.calls == jrec.calls
    # the schedule the recorders saw is the one the issue states
    d_calls = [c for c in prec.calls if c[1] == "d"]
    assert len(d_calls) == 40 and [c[4] for c in d_calls] == list(range(40))
    assert [c[0] for c in d_calls if c[3]] == [3, 7, 11, 15, 19, 23, 27, 31, 35, 39]
    assert [c[0] for c in prec.calls if c[1] == "path_reg"] == list(range(2, 40, 3))
    assert {c[3] for c in prec.calls if c[1] == "g" and c[0] < 10} == {True}
    assert {c[3] for c in prec.calls if c[1] == "g" and c[0] >= 10} == {None}
    assert [c[2] for c in prec.calls if c[1] == "ema"][11:13] == [0.0, JTC().ema_decay]
    jseen, pseen = jseen_hooks[0], pseen_hooks[0]
    assert pseen["metrics"] == jseen["metrics"]
    assert [i for i, _ in pseen["metrics"]] == [4, 9, 14, 19, 24, 29, 34, 39]
    assert pseen["ckpt"] == jseen["ckpt"] == [14, 29]
    assert pseen["fid"] == jseen["fid"] == [14, 29]
    assert os.path.exists(tmp_path / "port" / "ckpt" / "best_fid.pt")
    assert os.path.isdir(tmp_path / "jax" / "ckpt" / "best_fid")
    from cips3dpp_torch.io.checkpoint import checkpoint_steps

    assert checkpoint_steps(str(tmp_path / "port" / "ckpt")) == [15, 30]
    assert ptr.checkpointer().restore_raw(15)["metrics"] == {"fid": 3.0}


def _tiny_trainer(outdir, log_every=2, ckpt_every=4, auto_remat=False):
    """tests/test_train_e2e.py's tiny configuration in the port (16^2
    images)."""
    from cips3dpp_torch.models.discriminator import DStyleGANProgressive
    from cips3dpp_torch.models.discriminator_pose import DVolumeRenderProgressive
    from cips3dpp_torch.models.generator import (
        DecoderConfig, Generator, GeneratorConfig, RendererConfig,
    )
    from cips3dpp_torch.train import TrainConfig, Trainer

    gen_cfg = GeneratorConfig(
        renderer=RendererConfig(n_layers=2, hidden_dim=32),
        decoder=DecoderConfig(size_end=32, upsample_list=(16,), style_dim=64,
                              mapping_n_layers=2),
        img_size=8, n_samples=4)
    train_cfg = TrainConfig(batch=4, d_reg_every=4, g_reg_every=4, fade_steps=16,
                            warmup_iters=8, ema_start=8, init_iters=20, data_img_size=16)
    g = Generator(gen_cfg, device="cpu")
    d = DStyleGANProgressive(input_size=16, channel_multiplier=1, device="cpu")
    dr = DVolumeRenderProgressive(input_size=8, device="cpu")
    return Trainer(g, d, dr, gen_cfg, train_cfg, str(outdir), log_every=log_every,
                   ckpt_every=ckpt_every, keep_ckpts=2, config_snapshot={"demo": True},
                   auto_remat=auto_remat)


def _images(n=16, size=16, seed=0):
    return np.random.default_rng(seed).uniform(-1, 1, (n, size, size, 3)).astype(np.float32)


def _cyclic(images, batch, skip=0):
    i = skip * batch
    while True:
        yield images[[(i + j) % len(images) for j in range(batch)]]
        i += batch


def _tensors(state):
    out = {}
    for k in ("g", "g_ema", "d", "d_render"):
        out.update({f"{k}.{n}": v for n, v in getattr(state, k).state_dict().items()})
    for k in ("opt_g", "opt_d", "opt_d_render"):
        for i, s in getattr(state, k).state_dict()["state"].items():
            out.update({f"{k}.{i}.{n}": v for n, v in s.items()})
    out["mean_path_length"] = state.mean_path_length
    return out


def test_resume_equals_straight_run(tmp_path, monkeypatch):
    """8 straight iterations (checkpoints at 4 and 8) against a restore of
    the step-4 checkpoint into fresh modules and 4 more iterations, whose
    generator is restored from its state at the save point."""
    import shutil

    import cips3dpp_torch.kernels.siren_render as ksr
    from cips3dpp_torch.train import TrainHooks

    plain_calls = []
    plain = ksr.siren_render_plain
    monkeypatch.setattr(ksr, "siren_render_plain",
                        lambda *a: plain_calls.append(1) or plain(*a))
    k1_off_card(monkeypatch)  # the default D step renders plainly off the card
    images = _images()
    logged, gen_states = [], {}
    gen = torch.Generator().manual_seed(5)
    hooks = TrainHooks(on_metrics=lambda i, m: logged.append((i, m)),
                       on_checkpoint=lambda i, s: gen_states.setdefault(i + 1, gen.get_state()))

    tr_a = _tiny_trainer(tmp_path / "straight")
    state_a = tr_a.init_state(torch.Generator().manual_seed(1))
    state_a = tr_a.train(state_a, _cyclic(images, 4), gen, total_iters=8, hooks=hooks)
    assert len(plain_calls) == 8 * 4  # every D step renders its fakes through K1's plain version
    assert sorted(gen_states) == [4, 8]

    os.makedirs(tmp_path / "resumed" / "ckpt")
    shutil.copy(tmp_path / "straight" / "ckpt" / "4.pt", tmp_path / "resumed" / "ckpt")
    tr_c = _tiny_trainer(tmp_path / "resumed")  # fresh modules, other weights
    state_c = tr_c.init_state(torch.Generator().manual_seed(99))
    restored, step = tr_c.resume(state_c)
    assert step == 4 and restored is state_c and state_c.step == 4
    gen = torch.Generator()
    gen.set_state(gen_states[4])
    state_c = tr_c.train(state_c, _cyclic(images, 4, skip=4), gen, start_iter=4,
                         total_iters=8, hooks=TrainHooks(
                             on_metrics=lambda i, m: logged.append((i, m))))

    assert state_c.step == state_a.step == 8
    want, got = _tensors(state_a), _tensors(state_c)
    assert want.keys() == got.keys()
    bad = [k for k in want if not torch.equal(want[k], got[k])]
    assert not bad, bad[:10]
    assert float(state_a.mean_path_length) > 0  # path reg ran
    assert [i for i, _ in logged] == [1, 3, 5, 7, 5, 7]
    assert all(np.isfinite(v) for _, m in logged for v in m.values())


def _auto_remat_memory(monkeypatch, limit, peak):
    """The card's side of the probe on the CPU: the allocator's limit, and
    the peak of the R1 step, which runs (None: it ran out of memory)."""
    import cips3dpp_torch.train.train_loop as tl

    monkeypatch.setattr(tl, "device_memory_limit", lambda device: limit)
    monkeypatch.setattr(tl, "peak_memory", lambda fn, device: (fn(), peak)[1])


@pytest.mark.parametrize("peak", [2048, None], ids=["over-97%", "out-of-memory"])
def test_auto_remat_switches_when_r1_does_not_fit(tmp_path, monkeypatch, peak):
    """JAX's test_trainer_auto_remat_guard in the port: a limit the R1 step
    does not fit (a peak over 97% of it, or out of memory) switches remat_d
    on, says so in the events log, and the rebuilt R1 step runs; the probe
    leaves the state as a trainer without it makes it, bit for bit."""
    k1_off_card(monkeypatch)
    _auto_remat_memory(monkeypatch, 1024, peak)
    tr = _tiny_trainer(tmp_path / "auto", auto_remat=True)
    assert not tr.cfg.remat_d
    state = tr.init_state(torch.Generator().manual_seed(1))
    assert tr.cfg.remat_d and tr.auto_remat_probe == {"peak": peak, "limit": 1024,
                                                      "switched": True}
    events = open(tmp_path / "auto" / "logs" / "events.log").read()
    assert "auto_remat: d_step_r1" in events and "enabling remat_d" in events
    want = _tensors(_tiny_trainer(tmp_path / "plain").init_state(
        torch.Generator().manual_seed(1)))
    got = _tensors(state)
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) for k in want)
    real = torch.from_numpy(_images(4))
    state, m = tr.steps[0](state, real, torch.Generator().manual_seed(2), 1.0,
                           d_regularize=True)
    assert all(np.isfinite(float(v)) for v in m.values()) and "d_loss_gp_decoder" in m


@pytest.mark.parametrize("limit", [None, 1 << 40], ids=["no-limit", "fits"])
def test_auto_remat_leaves_a_fitting_run_bit_equal(tmp_path, monkeypatch, limit):
    """Two iterations with auto_remat=True equal two without it, bit for
    bit: with no limit (the CPU) the probe does nothing; under a limit the
    step fits, it runs the R1 step on the state and restores it."""
    k1_off_card(monkeypatch)
    if limit is not None:
        _auto_remat_memory(monkeypatch, limit, 2048)
    images = _images()
    out = []
    for auto in (True, False):
        tr = _tiny_trainer(tmp_path / str(auto), auto_remat=auto)
        state = tr.init_state(torch.Generator().manual_seed(1))
        assert not tr.cfg.remat_d
        state = tr.train(state, _cyclic(images, 4), torch.Generator().manual_seed(5),
                         total_iters=2)
        out.append((_tensors(state), tr.auto_remat_probe))
    (got, probe), (want, _) = out
    assert probe == (None if limit is None else {"peak": 2048, "limit": limit,
                                                 "switched": False})
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) for k in want)


def test_jax_train_state_carried_across():
    """One optax update in JAX, the state carried into the port, then one
    more update with the same gradients in both packages."""
    from cips3dpp_tpu.train.state import TrainConfig as JTC
    from cips3dpp_tpu.train.state import create_train_state as jax_create
    from cips3dpp_torch.io.jax_params import (
        jax_d_params_to_state_dict, jax_d_pose_params_to_state_dict,
        jax_params_to_state_dict, load_jax_train_state,
    )
    from cips3dpp_torch.train.state import TrainConfig, create_train_state

    jcfg, tcfg = tiny_configs()
    g, gvars = port_and_jax_generator(jcfg, tcfg, seed=31)
    _, pd, d = port_and_jax_d(seed=32)
    _, pdr, dr = port_and_jax_pose_d(seed=33)
    jstate, txs = jax_create(jax.random.PRNGKey(0), jcfg, JTC(),
                             lambda k: {"params": pd}, lambda k: {"params": pdr},
                             lambda k: jax.tree.map(jnp.asarray, gvars))
    rng = np.random.default_rng(7)
    grads = {name: jax.tree.map(lambda p: rng.standard_normal(p.shape).astype(np.float32),
                                getattr(jstate, name))
             for name in ("params_g", "params_d", "params_d_render")}
    opts = dict(zip(("params_g", "params_d", "params_d_render"),
                    ("opt_g", "opt_d", "opt_d_render")))

    @jax.jit
    def update(st, grads):
        new = {}
        for (pname, oname), tx in zip(opts.items(), txs):
            upd, o = tx.update(grads[pname], getattr(st, oname), getattr(st, pname))
            new[pname], new[oname] = optax.apply_updates(getattr(st, pname), upd), o
        return st.replace(**new)

    jstate = update(jstate, grads)
    jstate = jstate.replace(mean_path_length=jnp.float32(0.75), step=jnp.int32(3))
    state = create_train_state(TrainConfig(), g, d, dr)
    load_jax_train_state(state, jax.tree.map(np.asarray, jstate))
    assert state.step == 3 and float(state.mean_path_length) == 0.75
    bridges = {"params_g": jax_params_to_state_dict, "params_d": jax_d_params_to_state_dict,
               "params_d_render": jax_d_pose_params_to_state_dict}
    mods = {"params_g": state.g, "params_d": state.d, "params_d_render": state.d_render}
    for pname, mod in mods.items():
        want = bridges[pname](jax.tree.map(np.asarray, getattr(jstate, pname)["params"]))
        for n, p in mod.named_parameters():
            assert torch.equal(p.detach(), want[n]), (pname, n)
    adam = state.opt_g.adam.state[next(iter(state.g.parameters()))]
    assert float(adam["step"]) == 1.0 and float(adam["exp_avg_sq"].abs().sum()) > 0

    jstate = update(jstate, grads)
    for (pname, mod), opt in zip(mods.items(), (state.opt_g, state.opt_d, state.opt_d_render)):
        lr = {id(p): group["lr"] for group in opt.adam.param_groups for p in group["params"]}
        g_sd = bridges[pname](jax.tree.map(np.asarray, grads[pname]["params"]))
        names = {id(p): n for n, p in mod.named_parameters()}
        opt.step({k: [g_sd[names[id(p)]] for p in ps] for k, ps in opt.groups.items()})
        want = bridges[pname](jax.tree.map(np.asarray, getattr(jstate, pname)["params"]))
        for n, p in mod.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(), rtol=1e-6,
                                       atol=ATOL_LR * lr[id(p)], err_msg=f"{pname} {n}")
    # the EMA generator came across too
    want = jax_params_to_state_dict(jax.tree.map(np.asarray, jstate.params_g_ema["params"]))
    for n, p in state.g_ema.named_parameters():
        assert torch.equal(p.detach(), want[n]), n


def test_not_ported_options_raise(tmp_path):
    """The two options the port once refused are taken: a mesh with a ray
    axis (two gloo ranks, data 1 x ray 2) and Trainer(auto_remat=True),
    whose probe off the card finds no limit and leaves remat_d off."""
    from cips3dpp_torch.parallel import run_ranks
    from cips3dpp_torch.train import TrainConfig, Trainer
    from torch_port_ray_helpers import _ray_axes

    _, gen_cfg = tiny_configs()
    dev = types.SimpleNamespace(device=torch.device("cpu"))

    axes = run_ranks(_ray_axes, 2, device="cpu", ray=2, workdir=str(tmp_path / "ranks"),
                     timeout=120)
    assert [(x["data_rank"], x["ray_rank"]) for x in axes] == [(0, 0), (0, 1)]
    tr = Trainer(dev, None, None, gen_cfg, TrainConfig(), str(tmp_path), auto_remat=True)
    assert tr.auto_remat and not tr.cfg.remat_d
    tr._auto_remat(None)  # no limit off the card: returns before touching the state
    assert tr.auto_remat_probe is None and not tr.cfg.remat_d
