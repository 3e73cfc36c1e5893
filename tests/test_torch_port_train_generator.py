"""The generator's training features in cips3dpp_torch against the JAX
package on the CPU: the differentiable fused SIREN render (`SirenRender`)
against jax.vjp of the jnp oracle, the renderer's eikonal term (plain and
fused, grad of grad), Generator.forward with each training switch
against jax.grad, and the repairs of the generator's config handling
(kernel_size, the perturb default, fields that did nothing).

Tolerances: f32 forward values of the SIREN rtol 1e-4 / atol 1e-4, as in
tests/test_torch_port_generator.py (f32 sums in another order, amplified
by gamma ~ 30-45 in the sin); f32 gradients within 1e-4 of their tensor's
largest |gradient| (tests/torch_port_train_helpers.py).
SirenRender's backward replays the bf16-rounded oracle, as JAX's does,
and both round the cotangents at the same bf16 casts; where f32 sums in
another order flip a bf16 rounding, a gradient moves by about one bf16
ulp (2^-8) of an element. Measured over three seeds: up to 5.9e-3 of the
largest |gradient| (one seed exact to 1e-4); bound SIREN_REL = 2e-2.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import a, np_tree, port_and_jax_generator, port_renderer, t
from torch_port_train_helpers import assert_rel, grads_by_name, tiny_configs

SIREN_NAMES = ("thumb", "feat", "sdf", "mask_depth", "xyz")
SIREN_REL = 2e-2
SIREN_FWD = dict(rtol=1e-4, atol=1e-4)


def _siren_inputs(seed, r=16, s=8, width=32):
    """A random depth-2 renderer tree (as tests/test_kernels.py draws one)
    and one batch item's inputs."""
    rng = np.random.default_rng(seed)

    def lin(din, dout, sc=0.05):
        return {"weight": (sc * rng.standard_normal((din, dout))).astype(np.float32),
                "bias": (0.1 * rng.standard_normal(dout)).astype(np.float32)}

    def film(din, dout):
        return {**lin(din, dout), "gamma": lin(256, dout, 0.02), "beta": lin(256, dout, 0.02)}

    params = {"sigmoid_beta": np.asarray([0.1], np.float32),
              "network": {"pts_0": film(3, width), "pts_1": film(width, width),
                          "views": film(width + 3, width),
                          "sigma_head": lin(width, 1), "rgb_head": lin(width, 3)}}
    vd = rng.standard_normal((r, 3)).astype(np.float32)
    inputs = dict(
        styles=rng.standard_normal((3, 256)).astype(np.float32),
        pts=(0.1 * rng.standard_normal((r, s, 3))).astype(np.float32),
        viewdirs=vd / np.linalg.norm(vd, axis=-1, keepdims=True),
        z_vals=np.sort(rng.uniform(0.88, 1.12, (r, s)), axis=1).astype(np.float32),
        rays_d=rng.standard_normal((r, 3)).astype(np.float32),
        near=np.float32(0.88), far=np.float32(1.12))
    return params, inputs


def test_siren_render_backward_matches_jax_vjp():
    """SirenRender (plain forward on the CPU, replayed backward) against
    jax.vjp of siren_render_reference with the same cotangents, for the
    renderer's parameters, styles, pts, viewdirs, z_vals and rays_d."""
    from cips3dpp_tpu.kernels.siren_render import siren_render_reference as jref
    from cips3dpp_torch.io.jax_params import jax_params_to_state_dict
    from cips3dpp_torch.kernels.siren_render import SirenRender

    params, x = _siren_inputs(0)
    renderer = port_renderer(params, 32)
    order = ("styles", "pts", "viewdirs", "z_vals", "rays_d", "near", "far")
    jargs = (jax.tree.map(jnp.asarray, params), *[jnp.asarray(x[k]) for k in order])
    rng = np.random.default_rng(1)
    cots = [rng.standard_normal(o.shape).astype(np.float32)
            for o in jax.eval_shape(jref, *jargs)]
    jg = jax.jit(lambda args, ct: jax.vjp(jref, *args)[1](ct))(
        jargs, tuple(jnp.asarray(c) for c in cots))

    ins = [t(x[k]).requires_grad_(k not in ("near", "far")) for k in order]
    rparams = tuple(renderer.parameters())
    got = SirenRender.apply(renderer, *ins, *rparams)
    assert all(o.grad_fn is not None for o in got)
    tg = torch.autograd.grad(got, ins[:5] + list(rparams), [t(c) for c in cots])
    for name, g, w in zip(order, tg[:5], jg[1:6]):
        assert_rel(g, w, rel=SIREN_REL, name=name)
    want_p = jax_params_to_state_dict({"renderer": np_tree(jg[0])})
    names = [f"renderer.{n}" for n, _ in renderer.named_parameters()]
    assert sorted(names) == sorted(want_p)
    for name, g in zip(names, tg[5:]):
        assert_rel(g, want_p[name], rel=SIREN_REL, name=name)


def test_fused_render_carries_gradients():
    """siren_render_fused goes through SirenRender under grad (the fault:
    it returned outputs with no grad_fn) and stays the no-grad serving
    path otherwise; its gradients are autograd's through the oracle."""
    from cips3dpp_torch.kernels.siren_render import siren_render_fused, \
        siren_render_reference

    params, x = _siren_inputs(2)
    renderer = port_renderer(params, 32)
    args = [t(x[k]) for k in ("styles", "pts", "viewdirs", "z_vals", "rays_d", "near", "far")]
    out = siren_render_fused(renderer, *args)
    assert out[0].grad_fn is not None
    with torch.no_grad():
        assert siren_render_fused(renderer, *args)[0].grad_fn is None
    loss = sum((o * (i + 1)).sum() for i, o in enumerate(out))
    ref = siren_render_reference(renderer, *args)
    ref_loss = sum((o * (i + 1)).sum() for i, o in enumerate(ref))
    got, want = grads_by_name(renderer, loss), grads_by_name(renderer, ref_loss)
    for name in got:
        torch.testing.assert_close(got[name], want[name], rtol=0, atol=0)


# --------------------------------------------------------------- renderer --


@pytest.fixture(scope="module")
def renderer_pair():
    """JAX VolumeFeatureRenderer params (from the random tree) and the port
    renderer with the same weights, and inputs of a batch of two."""
    params, _ = _siren_inputs(3)
    rng = np.random.default_rng(4)
    b, r, n = 2, 12, 6
    vd = rng.standard_normal((b, r, 3)).astype(np.float32)
    z = np.sort(rng.uniform(0.88, 1.12, (b, r, n)), axis=-1).astype(np.float32)
    rays_d = rng.standard_normal((b, r, 3)).astype(np.float32)
    # points near the origin, as a camera at distance 1 samples them
    pts = (0.1 * rng.standard_normal((b, r, n, 3))).astype(np.float32)
    inputs = dict(pts=pts, rays_d=rays_d, viewdirs=vd / np.linalg.norm(vd, axis=-1, keepdims=True),
                  z_vals=z, near=np.full((b, 1, 1), 0.88, np.float32),
                  far=np.full((b, 1, 1), 1.12, np.float32),
                  styles=rng.standard_normal((b, 3, 256)).astype(np.float32))
    return params, inputs


ORDER = ("pts", "rays_d", "viewdirs", "z_vals", "near", "far", "styles")


def test_renderer_eikonal_matches_jax(renderer_pair):
    """The eikonal term (d sdf / d pts) and the gradient of the eikonal
    loss with respect to every renderer parameter, which goes through
    d sdf / d pts (grad of grad); with ray tiles too."""
    from cips3dpp_tpu.models.renderer import VolumeFeatureRenderer as JR
    from cips3dpp_tpu.train.losses import eikonal_loss as jeik
    from cips3dpp_torch.io.jax_params import jax_params_to_state_dict
    from cips3dpp_torch.train.losses import eikonal_loss

    params, x = renderer_pair
    jr = JR(depth=2, hidden_dim=32)
    jp = jax.tree.map(jnp.asarray, params)
    jin = [jnp.asarray(x[k]) for k in ORDER]

    def jloss(p):
        out = jr.apply({"params": p}, *jin, return_eikonal=True)
        return jeik(out[5]) + out[0].sum() * 0.1, out

    (jval, jout), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jp)
    renderer = port_renderer(params, 32)
    want_g = jax_params_to_state_dict({"renderer": np_tree(jgrads)})
    for ray_chunk in (None, 4):
        out = renderer(*[t(x[k]) for k in ORDER], return_eikonal=True, ray_chunk=ray_chunk)
        for i, name in enumerate(SIREN_NAMES[:2] + ("sdf", "mask_depth", "xyz", "eikonal")):
            np.testing.assert_allclose(a(out[i]), a(jout[i]), err_msg=name, **SIREN_FWD)
        loss = eikonal_loss(out[5]) + out[0].sum() * 0.1
        np.testing.assert_allclose(float(loss.detach()), float(jval), rtol=1e-5)
        for name, g in grads_by_name(renderer, loss).items():
            assert_rel(g, want_g[f"renderer.{name}"], name=name)


def test_fused_eikonal_matches_plain(renderer_pair):
    """The fused branch's eikonal term (a trunk pass beside the kernel's
    render) against the plain branch's: the same function, so the term
    and its loss's gradient agree to f32. Its rendered outputs are the
    kernel's (here its plain version's) per batch item, held to the
    bf16 oracle at tests/test_torch_port_siren.py's bounds."""
    from cips3dpp_torch.kernels.siren_render import siren_render_reference
    from cips3dpp_torch.train.losses import eikonal_loss

    params, x = renderer_pair
    renderer = port_renderer(params, 32)
    ins = [t(x[k]) for k in ORDER]
    plain = renderer(*ins, return_eikonal=True)
    fused = renderer(*ins, return_eikonal=True, fused=True)
    torch.testing.assert_close(fused[5], plain[5], rtol=1e-6, atol=1e-6)
    pts, rays_d, viewdirs, z_vals, near, far, styles = ins
    atol = {"thumb": 2e-2, "feat": 1.5e-1, "sdf": 2e-2, "mask_depth": 2e-2, "xyz": 2e-2}
    for i in range(pts.shape[0]):
        ref = siren_render_reference(renderer, styles[i], pts[i], viewdirs[i], z_vals[i],
                                     rays_d[i], near.reshape(-1)[0], far.reshape(-1)[0])
        for k, (name, tol) in enumerate(atol.items()):
            np.testing.assert_allclose(a(fused[k][i]), a(ref[k]), rtol=0, atol=tol,
                                       err_msg=name)
    gp = grads_by_name(renderer, eikonal_loss(plain[5]))
    gf = grads_by_name(renderer, eikonal_loss(fused[5]))
    for name in gp:
        assert_rel(gf[name], gp[name], rel=1e-5, name=name)


# -------------------------------------------------------------- generator --


def _gen_inputs(cfg, seed, b=2):
    from cips3dpp_tpu.models.decoder import Decoder

    rng = np.random.default_rng(seed)
    zs = [rng.standard_normal((b, 256)).astype(np.float32) for _ in range(2)]
    azim = (0.3 * rng.standard_normal(b)).astype(np.float32)
    elev = (0.15 * rng.standard_normal(b)).astype(np.float32)
    shapes = Decoder(upsample_list=cfg.decoder.upsample_list).noise_shapes(cfg.img_size)
    noise = [rng.standard_normal((b,) + s[1:]).astype(np.float32) for s in shapes]
    return zs, azim, elev, noise


CASES = {
    # eikonal (grad of grad through d sdf / d pts), path_reg, ray subset
    "eikonal_path_reg_sample_idx": (dict(eikonal_reg=True, path_reg=True, sample_idx=True), {}),
    # the switches that cut gradients, and remat of both halves
    "detach_freeze_remat": (dict(eikonal_reg=True, renderer_detach=True),
                            dict(freeze_renderer=True, remat=True)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_generator_training_switches_match_jax(case):
    """Generator.forward's training switches: outputs and the gradient of a
    loss over rgb, thumb_rgb, sdf and the eikonal term with respect to
    every generator parameter, against jax.grad of the flax Generator.

    The JAX side runs in f64 (jax.enable_x64) on the same f32 weights and
    inputs: in the ray-subset case its f32 gradients at the decoder's
    first layer are 1e-2 (noise weight) and 2e-3 (conv weight) off its
    own f64 values, where the port's f32 gradients are 7e-6 and 2e-6
    off. Against f64, the f32 bounds above hold for every case."""
    from cips3dpp_tpu.core.camera import camera_from_angles as jcam
    from cips3dpp_tpu.models.generator import Generator as JG
    from cips3dpp_tpu.train.losses import eikonal_loss as jeik
    from cips3dpp_torch.core.camera import camera_from_angles
    from cips3dpp_torch.io.jax_params import jax_params_to_state_dict
    from cips3dpp_torch.train.losses import eikonal_loss

    kw, cfg_kw = CASES[case]
    jcfg, tcfg = tiny_configs()
    if cfg_kw:
        def change(c):
            return dataclasses.replace(
                c, freeze_renderer=True,
                renderer=dataclasses.replace(c.renderer, remat=True),
                decoder=dataclasses.replace(c.decoder, remat=True))
        jcfg, tcfg = change(jcfg), change(tcfg)
    model, variables = port_and_jax_generator(jcfg, tcfg, seed=5)
    zs, azim, elev, noise = _gen_inputs(jcfg, seed=6)
    call = dict(kw)
    if call.pop("sample_idx", False):
        rng = np.random.default_rng(7)
        idx = [np.sort(rng.permutation(8)[:4]).reshape(1, 4).repeat(2, 0) for _ in range(2)]
        idx[1][1] = np.arange(2, 6)
        call["sample_idx"] = tuple(idx)
        noise = [n[:, : n.shape[1] // 2, : n.shape[2] // 2] for n in noise]

    c = camera_from_angles(t(azim), t(elev), tcfg.img_size)
    tcall = dict(call)
    if "sample_idx" in tcall:
        tcall["sample_idx"] = tuple(torch.from_numpy(i) for i in tcall["sample_idx"])
    tout = model([t(z) for z in zs], c.extrinsics, c.focal, c.near, c.far,
                 noise_bufs=[t(n) for n in noise], perturb=False, **tcall)
    shapes = {k: tuple(v.shape) for k, v in tout.items()
              if v is not None and k != "style_decoder"}
    rng = np.random.default_rng(8)
    rw = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    loss = _loss(tout, eikonal_loss, {k: t(w) for k, w in rw.items()})
    got = grads_by_name(model, loss)

    with jax.enable_x64(True):
        f64 = lambda x: jnp.asarray(x, jnp.float64)
        jc = jcam(f64(azim), f64(elev), jcfg.img_size)
        jm = JG(jcfg)
        jcall = dict(call)
        if "sample_idx" in jcall:
            jcall["sample_idx"] = tuple(jnp.asarray(i) for i in jcall["sample_idx"])

        def jloss(p):
            out = jm.apply({"params": p}, zs=tuple(f64(z) for z in zs),
                           cam_poses=jc.extrinsics, focals=jc.focal, near=jc.near,
                           far=jc.far, noise_bufs=[f64(n) for n in noise], perturb=False,
                           **jcall)
            return _loss(out, jeik, {k: f64(w) for k, w in rw.items()}), out

        (jval, jout), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
            jax.tree.map(f64, np_tree(variables["params"])))
        jout = {k: np.asarray(jout[k], np.float32) for k in shapes}
        jval = float(jval)
        want = jax_params_to_state_dict(np_tree(jgrads))
    for k in shapes:
        np.testing.assert_allclose(a(tout[k]), jout[k], err_msg=k, **SIREN_FWD)
    np.testing.assert_allclose(float(loss.detach()), jval, rtol=1e-4)
    for name, g in got.items():
        assert_rel(g, want[name], name=name)
    # the switches took effect: the cut modules get no gradient
    zero = lambda prefix: all(not got[n].any() for n in got if n.startswith(prefix))
    if call.get("path_reg"):
        assert tout["style_decoder"] is not None and zero("style_decoder.")
    if call.get("renderer_detach"):
        # only the thumbnail / sdf / eikonal terms reach the renderer
        assert not zero("renderer.")
    if cfg_kw:
        assert zero("style.")
        assert model.renderer.remat and model.decoder.remat


def _loss(out, eik_fn, rw):
    """A weighted sum over the outputs, plus the eikonal loss (so its
    gradient is a gradient of d sdf / d pts)."""
    loss = sum((out[k] * w).sum() for k, w in rw.items() if k != "eikonal_term")
    if out.get("eikonal_term") is not None:
        loss = loss + eik_fn(out["eikonal_term"])
    return loss


# ------------------------------------------------- repairs of config handling --


def test_decoder_kernel_size_other_than_1_raises():
    """kernel_size 3 used to build a 1x1 decoder without a word. It now
    builds 3x3 modulated convs (held to JAX in test_torch_port_kxk.py),
    and the decoder block kernels, which take 1x1 convs only, raise."""
    from cips3dpp_torch.core.camera import camera_from_angles
    from cips3dpp_torch.models.generator import (DecoderConfig, Generator, GeneratorConfig,
                                                 RendererConfig)

    cfg = GeneratorConfig(renderer=RendererConfig(hidden_dim=32),
                          decoder=DecoderConfig(kernel_size=3, upsample_list=(), size_end=8,
                                                style_dim=64, mapping_n_layers=1),
                          img_size=4, n_samples=4)
    g = Generator(cfg, device="cpu")
    assert g.decoder.conv1.conv.weight.shape == (1, 512, 32, 3, 3)
    assert g.decoder.convs[0].conv.weight.shape[-2:] == (3, 3)
    gen = torch.Generator().manual_seed(0)
    zs = [torch.randn((1, 256), generator=gen) for _ in range(2)]
    zero = torch.zeros(1)
    cam = camera_from_angles(zero, zero, cfg.img_size)
    with pytest.raises(ValueError, match="kernel_size 3"):
        g(zs, cam.extrinsics, cam.focal, cam.near, cam.far, perturb=False,
          fused_decoder=True, generator=gen)


def test_forward_perturbs_by_default():
    """perturb defaults to True as in JAX (the train steps rely on it):
    the default call jitters the z-values from `generator`, as t_rand
    drawn from the same stream does, and differs from perturb=False."""
    from cips3dpp_torch.core.camera import camera_from_angles

    _, tcfg = tiny_configs()
    from cips3dpp_torch.models.generator import Generator

    model = Generator(tcfg, device="cpu", seed=1)
    zs, azim, elev, noise = _gen_inputs(tcfg, seed=9)
    c = camera_from_angles(t(azim), t(elev), tcfg.img_size)
    args = ([t(z) for z in zs], c.extrinsics, c.focal, c.near, c.far)
    kw = dict(noise_bufs=[t(n) for n in noise])
    with torch.no_grad():
        dflt = model(*args, generator=torch.Generator().manual_seed(3), **kw)
        t_rand = torch.rand((2, 8, 8, 1), generator=torch.Generator().manual_seed(3))
        injected = model(*args, t_rand=t_rand, **kw)
        still = model(*args, perturb=False, **kw)
    torch.testing.assert_close(dflt["rgb"], injected["rgb"], rtol=0, atol=0)
    assert float((dflt["rgb"] - still["rgb"]).abs().max()) > 1e-4


def test_renderer_remat_gives_the_same_gradients():
    """remat (was read and ignored) recomputes the SIREN in the backward:
    the network runs again during the backward, and values and gradients
    are the same, eikonal grad of grad included."""
    from cips3dpp_torch.train.losses import eikonal_loss

    params, _ = _siren_inputs(10)
    rng = np.random.default_rng(11)
    b, r, n = 1, 6, 4
    x = [t(v) for v in (0.1 * rng.standard_normal((b, r, n, 3)), rng.standard_normal((b, r, 3)),
                        rng.standard_normal((b, r, 3)), np.sort(rng.uniform(0.9, 1.1, (b, r, n))),
                        np.full((b, 1, 1), 0.88), np.full((b, 1, 1), 1.12),
                        rng.standard_normal((b, 3, 256)))]
    results, runs = [], []
    for remat in (False, True):
        renderer = port_renderer(params, 32)
        renderer.remat = remat
        calls = []
        renderer.network.register_forward_pre_hook(lambda *_: calls.append(1))
        feat = renderer(*x)[1]
        before = len(calls)
        feat.square().sum().backward()
        runs.append(len(calls) - before)
        out = renderer(*x, return_eikonal=True)
        results.append(grads_by_name(renderer, eikonal_loss(out[5]) + out[1].square().sum()))
    assert runs == [0, 1]  # the backward reran the network only with remat
    for name in results[0]:
        torch.testing.assert_close(results[1][name], results[0][name], rtol=1e-6, atol=1e-7)
