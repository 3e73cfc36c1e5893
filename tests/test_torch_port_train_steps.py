"""One step of each training update of cips3dpp_torch against the same
step composed from the JAX package's own functions (generator.apply with
perturb=False and given noise buffers, the flax discriminators,
cips3dpp_tpu.train.losses, jax.grad and the JAX package's optimizers), at
the tiny size of tests/test_train.py (tiny_config at 8^2 rays x 4
samples, one upsample to 16^2; DStyleGANProgressive(1024, channel
multiplier 1); DVolumeRenderProgressive(64); batch 4).

The port's steps take the same draws (`Draws`): zs, cameras, decoder noise
and t_rand = 0, which gives the unperturbed z-values exactly.

Compared: every metric (rtol 5e-5: the fakes carry the SIREN's f32
residue), the gradient of every parameter (within REL = 1e-4 of its
tensor's largest |gradient| unless a bound below says otherwise, captured
where the step hands it to the optimizer) and the parameters after the
update. Adam with b1 = 0 moves a parameter by lr * g / (|g| + 1e-8) on its
first step, so where |g| is within the gradient bound of zero its sign,
and with it the update, may differ between the packages by f32 noise
alone. So the updates are compared (rtol 1e-3, plus two f32 spacings of
the parameter, which the difference new - old carries) only where |g| is
above the gradient bound and above 1e-6 (100x eps); elsewhere both are
held within lr.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torch_port_helpers import a, np_tree, port_and_jax_generator, t
from torch_port_train_helpers import REL, assert_rel, port_and_jax_d, port_and_jax_pose_d, \
    tiny_configs

B, ALPHA = 2, 0.5  # the draws' batch; TrainConfig.batch stays 4
# Gradient bounds where a scalar parameter's gradient is a sum with
# cancellation: the G step's sdf-head bias (measured 4.8e-4 of its value)
# and, in the path-length step, the decoder's first layer (measured
# 3.6e-3 at its noise weight; there the JAX package's own f32 gradient is
# 1e-2 off its f64 value, tests/test_torch_port_train_generator.py)
REL_G, REL_PATH = 2e-3, 1e-2


@pytest.fixture(scope="module")
def setup():
    from cips3dpp_tpu.train.state import TrainConfig as JTC
    from cips3dpp_torch.train.state import TrainConfig

    jcfg, tcfg = tiny_configs()
    kw = dict(batch=B, gen_img_size=16, cam_img_size=8, data_img_size=16,
              fused_renderer_d=False)
    g, gvars = port_and_jax_generator(jcfg, tcfg, seed=21)
    jd, pd, d = port_and_jax_d(seed=22)
    jdr, pdr, dr = port_and_jax_pose_d(seed=23)
    return dict(jcfg=jcfg, tcfg=tcfg, jtrain=JTC(**kw), ttrain=TrainConfig(**kw),
                g=g, pg=jax.tree.map(jnp.asarray, np_tree(gvars["params"])),
                jd=jd, pd=pd, d=d, jdr=jdr, pdr=pdr, dr=dr)


def fresh_state(s, train_cfg=None):
    """A port TrainState on copies of the fixture's modules."""
    import copy

    from cips3dpp_torch.train.state import create_train_state

    return create_train_state(train_cfg or s["ttrain"], copy.deepcopy(s["g"]),
                              copy.deepcopy(s["d"]), copy.deepcopy(s["dr"]))


def draws_np(s, batch, seed):
    from cips3dpp_torch.models.decoder import Decoder

    rng = np.random.default_rng(seed)
    cfg = s["tcfg"]
    shapes = Decoder(upsample_list=cfg.decoder.upsample_list).noise_shapes(cfg.img_size)
    return dict(
        zs=[rng.standard_normal((batch, 256)).astype(np.float32) for _ in range(2)],
        azim=(0.3 * rng.standard_normal(batch)).astype(np.float32),
        elev=(0.15 * rng.standard_normal(batch)).astype(np.float32),
        noise=[rng.standard_normal((batch,) + sh[1:]).astype(np.float32) for sh in shapes],
        real=(0.5 * rng.standard_normal((batch, 16, 16, 3))).astype(np.float32),
        path_noise=(rng.standard_normal((batch, 16, 16, 3)) / 16.0).astype(np.float32))


def port_draws(s, dn):
    from cips3dpp_torch.core.camera import camera_from_angles
    from cips3dpp_torch.train.steps import Draws

    b = dn["azim"].shape[0]
    return Draws(zs=tuple(t(z) for z in dn["zs"]),
                 cam=camera_from_angles(t(dn["azim"]), t(dn["elev"]), s["tcfg"].img_size),
                 t_rand=torch.zeros(b, 8, 8, 1), noise=[t(n) for n in dn["noise"]],
                 path_noise=t(dn["path_noise"][:b]))


def arr(tree):
    return jax.tree.map(jnp.asarray, tree)


def jax_cam(s, dn):
    from cips3dpp_tpu.core.camera import camera_from_angles

    return camera_from_angles(arr(dn["azim"]), arr(dn["elev"]), s["jcfg"].img_size)


def jax_update(tx, grads, params):
    """Params after one update of a fresh optax optimizer (jitted: eager
    optax over a whole tree dispatches op by op)."""
    def one(g, p):
        upd, _ = tx.update(g, tx.init(p), p)
        return optax.apply_updates(p, upd)

    return jax.jit(one)(grads, params)


def spy(opt, store, key):
    """Record the gradients a ClippedAdam is handed."""
    step = opt.step

    def wrapped(grads):
        store[key] = {k: [None if g is None else g.detach().clone() for g in gs]
                      for k, gs in grads.items()}
        step(grads)

    opt.step = wrapped


def named_grads(opt, grads, named_params):
    """{name: gradient} of a spied ClippedAdam (zeros where None)."""
    ids = {id(p): n for n, p in named_params}
    out = {}
    for k, ps in opt.groups.items():
        for p, g in zip(ps, grads[k]):
            out[ids[id(p)]] = torch.zeros_like(p) if g is None else g
    return out


def compare_update(name, old, new, want_new, g_want, lr, rel):
    """The updates new - old, read off f32 parameters (each carries up to
    two f32 spacings of the parameter on top of rtol 1e-3), where |g| is
    above 1e-6 and above the gradient bound rel * max|g| (so the two
    gradients have one sign); elsewhere both within lr."""
    ulp = 2 * np.spacing(np.abs(a(old)).astype(np.float32)).astype(np.float64)
    old, new, want_new, g_want = (np.asarray(a(x), np.float64) for x in (old, new, want_new, g_want))
    du, dw = new - old, want_new - old
    big = (np.abs(g_want) > rel * np.abs(g_want).max()) & (np.abs(g_want) > 1e-6)
    assert np.all(np.abs(du - dw)[big] <= 1e-3 * np.abs(dw)[big] + ulp[big]), name
    assert np.all(np.abs(du) <= lr * 1.001 + ulp) and np.all(np.abs(dw) <= lr * 1.001 + ulp), name


def check_module(model, old_sd, grads, want_grads, want_new, lr, rel=REL):
    for name, p in model.named_parameters():
        assert_rel(grads[name], want_grads[name], rel=rel, name=name)
        compare_update(name, old_sd[name], p, want_new[name], want_grads[name], lr(name), rel)


def check_metrics(got, want):
    for k, w in want.items():
        np.testing.assert_allclose(float(got[k]), float(w), rtol=5e-5, atol=1e-7, err_msg=k)


# ---------------------------------------------------------------- d_step --


@pytest.mark.parametrize("d_regularize", [True, False])
def test_d_step_matches_jax(setup, d_regularize):
    from cips3dpp_tpu.train import losses as jl
    from cips3dpp_tpu.train.state import make_d_optimizer, make_d_render_optimizer
    from cips3dpp_tpu.train.steps import downsample_to
    from cips3dpp_torch.io.jax_params import jax_d_params_to_state_dict, \
        jax_d_pose_params_to_state_dict
    from cips3dpp_torch.train.steps import make_train_steps

    s = setup
    cfg = s["jtrain"]
    dn = draws_np(s, B, seed=1)
    jg, jd, jdr = s["jcfg"], s["jd"], s["jdr"]
    from cips3dpp_tpu.models.generator import Generator as JG

    cam = jax_cam(s, dn)
    fake = jax.jit(lambda p: JG(jg).apply(
        {"params": p}, zs=tuple(arr(z) for z in dn["zs"]), cam_poses=cam.extrinsics,
        focals=cam.focal, near=cam.near, far=cam.far,
        noise_bufs=[arr(n) for n in dn["noise"]], perturb=False))(arr(s["pg"]))
    real = arr(dn["real"])
    real_thumb = downsample_to(real, 8)

    def loss_fn(pd, pdr):
        dra = lambda x: jdr.apply({"params": pdr}, x, alpha=ALPHA)
        dd = lambda x: jd.apply({"params": pd}, x, alpha=ALPHA)
        fake_pred_r, fake_view = dra(fake["thumb_rgb"])
        real_pred_r, _ = dra(real_thumb)
        m = {"d_loss_gan_render": jl.d_logistic_loss(real_pred_r, fake_pred_r),
             "d_loss_r1_render": cfg.lambda_gp * 0.5 * jl.r1_penalty(lambda x: dra(x)[0], real_thumb),
             "d_loss_pose_render": cfg.lambda_pose * jl.viewpoint_loss(fake_view, cam.viewpoint)}
        fake_pred, real_pred = dd(fake["rgb"]), dd(real)
        m["d_loss_gan_decoder"] = jl.d_logistic_loss(real_pred, fake_pred)
        m["d_loss_gp_decoder"] = (cfg.lambda_gp * 0.5 * cfg.d_reg_every * jl.r1_penalty(dd, real)
                                  if d_regularize else jnp.zeros(()))
        total = sum(m.values())
        m.update(d_logits_real_decoder=real_pred.mean(), d_logits_fake_decoder=fake_pred.mean(),
                 d_logits_real_render=real_pred_r.mean(), d_logits_fake_render=fake_pred_r.mean(),
                 d_loss_total=total)
        return total, m

    (_, jm), (gd, gdr) = jax.jit(jax.value_and_grad(loss_fn, argnums=(0, 1), has_aux=True))(
        arr(s["pd"]), arr(s["pdr"]))
    new = {"d": jax_update(make_d_optimizer(cfg), gd, arr(s["pd"])),
           "dr": jax_update(make_d_render_optimizer(cfg), gdr, arr(s["pdr"]))}
    jm = {k: float(v) for k, v in jm.items()}

    state = fresh_state(s)
    old_d = {k: v.clone() for k, v in state.d.state_dict().items()}
    old_dr = {k: v.clone() for k, v in state.d_render.state_dict().items()}
    store = {}
    spy(state.opt_d, store, "d")
    spy(state.opt_d_render, store, "dr")
    d_step = make_train_steps(s["tcfg"], s["ttrain"])[0]
    g_before = [p.clone() for p in state.g.parameters()]
    state, metrics = d_step(state, t(dn["real"]), None, ALPHA, d_regularize,
                            draws=port_draws(s, dn))
    check_metrics(metrics, jm)
    r = cfg.d_reg_every / (cfg.d_reg_every + 1)
    check_module(state.d, old_d, named_grads(state.opt_d, store["d"], state.d.named_parameters()),
                 jax_d_params_to_state_dict(np_tree(gd)),
                 jax_d_params_to_state_dict(np_tree(new["d"])), lambda n: cfg.d_lr_decoder * r)
    check_module(state.d_render, old_dr,
                 named_grads(state.opt_d_render, store["dr"], state.d_render.named_parameters()),
                 jax_d_pose_params_to_state_dict(np_tree(gdr)),
                 jax_d_pose_params_to_state_dict(np_tree(new["dr"])), lambda n: cfg.d_lr_render)
    assert all(torch.equal(p, q) for p, q in zip(state.g.parameters(), g_before))


# ------------------------------------------------------------ G updates --


def _g_update(s, grads):
    from cips3dpp_tpu.train.state import make_g_optimizer
    from cips3dpp_torch.io.jax_params import jax_params_to_state_dict

    tx = make_g_optimizer(s["jtrain"], {"params": s["pg"]})
    new = jax_update(tx, {"params": grads}, {"params": s["pg"]})["params"]
    return jax_params_to_state_dict(np_tree(grads)), jax_params_to_state_dict(np_tree(new))


def _check_g(s, state, old_g, store, want_g, want_new, rel=REL):
    cfg = s["jtrain"]
    grads = named_grads(state.opt_g, store["g"], state.g.named_parameters())
    lr = lambda n: cfg.g_lr_decoder if n.split(".")[0] in ("decoder", "style_decoder") \
        else cfg.g_lr_render
    check_module(state.g, old_g, grads, want_g, want_new, lr, rel)


def _run_port(s, step_index, *args, train_cfg=None, **kw):
    from cips3dpp_torch.train.steps import make_train_steps

    state = fresh_state(s, train_cfg)
    old = {k: v.clone() for k, v in state.g.state_dict().items()}
    store = {}
    spy(state.opt_g, store, "g")
    step = make_train_steps(s["tcfg"], train_cfg or s["ttrain"])[step_index]
    state, metrics = step(state, *args, **kw)
    return state, metrics, old, store


def test_g_step_matches_jax(setup):
    from cips3dpp_tpu.models.generator import Generator as JG
    from cips3dpp_tpu.train import losses as jl

    s = setup
    cfg = s["jtrain"]
    dn = draws_np(s, B, seed=2)
    jg, jd, jdr = JG(s["jcfg"]), s["jd"], s["jdr"]
    cam = jax_cam(s, dn)
    pd, pdr = arr(s["pd"]), arr(s["pdr"])

    def loss_fn(pg):
        ret = jg.apply({"params": pg}, zs=tuple(arr(z) for z in dn["zs"]),
                       cam_poses=cam.extrinsics, focals=cam.focal, near=cam.near, far=cam.far,
                       noise_bufs=[arr(n) for n in dn["noise"]], perturb=False,
                       eikonal_reg=cfg.eikonal_reg)
        fake_pred_r, fake_view = jdr.apply({"params": pdr}, ret["thumb_rgb"], alpha=ALPHA)
        m = {"g_loss_gan_render": jl.g_nonsaturating_loss(fake_pred_r),
             "g_loss_pose_render": cfg.lambda_pose * jl.viewpoint_loss(fake_view, cam.viewpoint),
             "g_loss_eikonal_render": cfg.lambda_eikonal * jl.eikonal_loss(ret["eikonal_term"]),
             "g_loss_minimal_surface_render": cfg.lambda_min_surf * jl.minimal_surface_loss(
                 ret["sdf"], cfg.min_surf_beta),
             "g_loss_gan_decoder": jl.g_nonsaturating_loss(
                 jd.apply({"params": pd}, ret["rgb"], alpha=ALPHA))}
        total = sum(m.values())
        return total, dict(m, g_loss_total=total)

    (_, jm), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(arr(s["pg"]))
    jm = {k: float(v) for k, v in jm.items()}
    want_g, want_new = _g_update(s, grads)
    state, metrics, old, store = _run_port(s, 1, None, ALPHA, draws=port_draws(s, dn))
    check_metrics(metrics, jm)
    assert float(metrics["g_loss_eikonal_render"]) > 0 and state.step == 1
    _check_g(s, state, old, store, want_g, want_new, rel=REL_G)


def test_path_reg_step_matches_jax(setup):
    """The path-length penalty's gradient (through d rgb / d styles, a
    gradient of a gradient), the renderer group held at zero, and the
    running mean path length."""
    from cips3dpp_tpu.models.generator import Generator as JG
    from cips3dpp_tpu.train import losses as jl
    from cips3dpp_tpu.train.state import _g_label_tree

    s = setup
    cfg = s["jtrain"]
    b = cfg.batch // cfg.path_batch_shrink
    dn = draws_np(s, b, seed=3)
    jg = JG(s["jcfg"])
    cam = jax_cam(s, dn)
    zs = tuple(arr(z) for z in dn["zs"])

    def loss_fn(pg):
        sr, sd = jg.apply({"params": pg}, zs, method="map_zs")
        sd = jax.lax.stop_gradient(sd)

        def img_fn(style_decoder):
            return jg.apply({"params": pg}, style_render=sr, style_decoder=style_decoder,
                            cam_poses=cam.extrinsics, focals=cam.focal, near=cam.near,
                            far=cam.far, noise_bufs=[arr(n) for n in dn["noise"]],
                            perturb=False)["rgb"]

        rgb, pullback = jax.vjp(img_fn, sd)
        (latents_grad,) = pullback(arr(dn["path_noise"][:b]))
        penalty, new_mean, plens = jl.path_length_penalty(rgb, latents_grad, jnp.zeros(()))
        weighted = cfg.path_regularize * cfg.g_reg_every * penalty
        return weighted, (new_mean, plens.mean())

    (jw, (jmean, jplen)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        arr(s["pg"]))
    labels = _g_label_tree({"params": grads})["params"]
    grads = jax.tree.map(lambda g, l: jnp.zeros_like(g) if l == "renderer" else g, grads, labels)
    jw, jmean, jplen = float(jw), float(jmean), float(jplen)
    want_g, want_new = _g_update(s, grads)
    state, metrics, old, store = _run_port(s, 2, None, draws=port_draws(s, dn))
    check_metrics(metrics, {"g_loss_weighted_path": jw, "path_length_mean": jplen})
    np.testing.assert_allclose(float(state.mean_path_length), float(jmean), rtol=1e-5)
    _check_g(s, state, old, store, want_g, want_new, rel=REL_PATH)
    for name, p in state.g.named_parameters():  # only the decoder group moved
        if name.split(".")[0] not in ("decoder", "style_decoder"):
            assert torch.equal(p, old[name]), name


def test_sphere_init_step_matches_jax(setup):
    from cips3dpp_tpu.models.generator import Generator as JG

    s = setup
    dn = draws_np(s, 4, seed=4)
    jg = JG(s["jcfg"])
    cam = jax_cam(s, dn)

    def loss_fn(pg):
        sdf, target = jg.apply({"params": pg}, zs=tuple(arr(z) for z in dn["zs"]),
                               cam_poses=cam.extrinsics, focals=cam.focal, near=cam.near,
                               far=cam.far, method="init_forward")
        return jnp.abs(sdf - target).mean()

    jloss, grads = jax.jit(jax.value_and_grad(loss_fn))(s["pg"])
    want_g, want_new = _g_update(s, grads)
    draws = port_draws(s, dn)
    draws.noise = None
    state, metrics, old, store = _run_port(s, 3, None, draws=draws)
    check_metrics(metrics, {"sphere_init_l1": jloss})
    _check_g(s, state, old, store, want_g, want_new)


# ------------------------------------------ the fused routes, draws, EMA --


def test_fused_d_and_g_steps_follow_the_plain_steps(setup):
    """The default D step renders its fakes through the SIREN render
    kernel (here its plain version: bf16 products, polynomial sin), and
    fused_renderer_g runs the kernel's forward and the replayed backward
    in the G step. Their losses stay within the bf16 rounding of the
    renderer of the plain steps' (measured up to 1.4e-3 relative, bound
    1e-2; the eikonal term is the same function in both), and the G
    step's gradient keeps its direction (measured cosine 0.99956, bound
    0.99)."""
    import dataclasses

    from cips3dpp_torch.train.steps import make_train_steps

    s = setup
    dn = draws_np(s, B, seed=5)
    out = {}
    for fused in (False, True):
        cfg = dataclasses.replace(s["ttrain"], fused_renderer_d=fused, fused_renderer_g=fused)
        state = fresh_state(s, cfg)
        store = {}
        spy(state.opt_g, store, "g")
        d_step, g_step = make_train_steps(s["tcfg"], cfg)[:2]
        _, dm = d_step(state, t(dn["real"]), None, ALPHA, True, draws=port_draws(s, dn))
        state = fresh_state(s, cfg)
        spy(state.opt_g, store, "g")
        _, gm = g_step(state, None, ALPHA, draws=port_draws(s, dn))
        out[fused] = dm, gm, torch.cat([g.flatten() for g in store["g"]["renderer"]
                                        + store["g"]["decoder"] if g is not None])
    for k in ("d_loss_total", "d_loss_gan_decoder", "d_loss_gan_render"):
        np.testing.assert_allclose(float(out[True][0][k]), float(out[False][0][k]), rtol=1e-2,
                                   err_msg=k)
    for k in ("g_loss_total", "g_loss_eikonal_render", "g_loss_gan_decoder"):
        np.testing.assert_allclose(float(out[True][1][k]), float(out[False][1][k]), rtol=1e-2,
                                   err_msg=k)
    cos = torch.nn.functional.cosine_similarity(out[True][2], out[False][2], dim=0)
    assert float(cos) > 0.99


def test_steps_draw_their_own_inputs_and_ema(setup):
    """Without `draws` each step draws from its torch.Generator (the same
    seed gives the same step); ema_update and fade_alpha follow the JAX
    package's formulas; the image D's options are taken, and values the
    steps do not take raise (tests/test_torch_port_train_options.py holds
    each option to the JAX step)."""
    import dataclasses

    from cips3dpp_torch.train.state import TrainConfig, create_train_state
    from cips3dpp_torch.train.steps import ema_update, fade_alpha, make_train_steps

    s = setup
    real = t(draws_np(s, B, seed=6)["real"])
    results = []
    for _ in range(2):
        state = fresh_state(s)
        d_step, g_step, path_step, sphere_step = make_train_steps(s["tcfg"], s["ttrain"])
        gen = torch.Generator().manual_seed(7)
        state, dm = d_step(state, real, gen, 1.0, True)
        state, gm = g_step(state, gen, 1.0)
        state, pm = path_step(state, gen)
        state, sm = sphere_step(state, gen)
        results.append([float(m[k]) for m in (dm, gm, pm, sm) for k in sorted(m)])
    assert results[0] == results[1] and all(np.isfinite(results[0]))
    ema_before = [p.clone() for p in state.g_ema.parameters()]
    ema_update(state, 0.9)
    for e0, e1, p in zip(ema_before, state.g_ema.parameters(), state.g.parameters()):
        torch.testing.assert_close(e1, 0.9 * e0 + 0.1 * p, rtol=1e-6, atol=1e-7)
    assert fade_alpha(5_000, 10_000) == 0.5 and fade_alpha(0, 10, fade=False) == 1.0
    for field, value in (("d_cat", True), ("d_seq", True), ("d_r1_chunk", 2),
                         ("remat_d", True), ("d_dtype", "bfloat16")):
        create_train_state(dataclasses.replace(TrainConfig(), **{field: value}),
                           s["g"], s["d"], s["dr"])
    for field, value in (("d_dtype", "float16"), ("d_r1_chunk", 0)):
        with pytest.raises(ValueError, match=field):
            create_train_state(dataclasses.replace(TrainConfig(), **{field: value}),
                               s["g"], s["d"], s["dr"])
