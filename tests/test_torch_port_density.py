"""The density renderer (RendererConfig.with_sdf=False) of cips3dpp_torch
against the JAX package on the CPU: `volume_integration`'s density branch
with and without its noise and with `force_background`, the renderer, a
tiny generator, and one D and one G step.

The density branch's noise is JAX's draw, `jax.random.normal(key,
sdf.shape)`, handed to the port as the array. Bounds: integration at TIGHT
(rtol 1e-5, atol 1e-6: both sides f32, one softplus, one cumprod); the
renderer at rtol 1e-5, atol 1e-5 (its SIREN's f32 sums amplified by the
sine); the generator at the generator test's rtol 1e-4, atol 1e-4; the D
step at the step tests' bounds (metrics rtol 5e-5, gradients within 1e-4
of each tensor's largest). The G step's metrics too; its gradients within
2e-2 of each tensor's largest (REL_DENSITY_G): at this size the density
model's gradient through the decoder is ill-conditioned in f32, so that
JAX's own jitted and eager evaluations of the image-D term lie 1.0e-2
apart, while the port lies 7.3e-6 from the eager one
(`python tests/torch_port_jit_gap.py 61 density 1`; JAX's gap is 1.5e-5
for the SDF model, `... 61 sdf 1`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_port_train_options as opts
from torch_port_helpers import a, np_tree, t

TIGHT = dict(rtol=1e-5, atol=1e-6)
RENDER = dict(rtol=1e-5, atol=1e-5)
REL_DENSITY_G = 2e-2


def integration_inputs(seed, b=3, r=5, n=7, c=6):
    rng = np.random.default_rng(seed)
    z = np.sort(rng.uniform(0.88, 1.12, (b, r, n)), axis=-1).astype(np.float32)
    return dict(
        rgb=rng.standard_normal((b, r, n, 3)).astype(np.float32),
        sdf=(3.0 * rng.standard_normal((b, r, n, 1))).astype(np.float32),
        features=rng.standard_normal((b, r, n, c)).astype(np.float32),
        z_vals=z, rays_d=rng.standard_normal((b, r, 3)).astype(np.float32),
        pts=rng.standard_normal((b, r, n, 3)).astype(np.float32))


CASES = [(False, 0.0, False), (False, 0.5, False), (False, 0.5, True), (False, 0.0, True),
         (True, 0.0, True)]


@pytest.mark.parametrize("with_sdf,noise_std,force_bg", CASES,
                         ids=[f"{'sdf' if w else 'density'}-noise{n}-bg{int(f)}"
                              for w, n, f in CASES])
def test_volume_integration_matches_jax(with_sdf, noise_std, force_bg):
    from cips3dpp_tpu.core.integration import volume_integration as jvi
    from cips3dpp_torch.core.integration import volume_integration

    x = integration_inputs(seed=7)
    beta = np.asarray([0.1], np.float32)
    key = jax.random.PRNGKey(3)
    want = jvi(**x, with_sdf=with_sdf, sigmoid_beta=beta, raw_noise_std=noise_std,
               force_background=force_bg, noise_key=key if noise_std else None)
    noise = jax.random.normal(key, x["sdf"].shape) if noise_std else None
    got = volume_integration(**{k: t(v) for k, v in x.items()}, with_sdf=with_sdf,
                             sigmoid_beta=t(beta), raw_noise_std=noise_std,
                             force_background=force_bg,
                             noise=None if noise is None else t(noise))
    for name, g, w in zip(("rgb", "feat", "xyz", "mask_depth"), got, want):
        np.testing.assert_allclose(a(g), a(w), err_msg=name, **TIGHT)


def test_density_noise_needs_a_draw():
    """raw_noise_std > 0 raises with neither noise nor a generator, as JAX
    raises without noise_key; a generator's draw moves the result."""
    from cips3dpp_torch.core.integration import volume_integration

    x = {k: t(v) for k, v in integration_inputs(seed=8).items()}
    with pytest.raises(ValueError, match="raw_noise_std"):
        volume_integration(**x, with_sdf=False, raw_noise_std=1.0)
    quiet = volume_integration(**x, with_sdf=False)
    noisy = volume_integration(**x, with_sdf=False, raw_noise_std=1.0,
                               generator=torch.Generator().manual_seed(0))
    assert all(torch.isfinite(v).all() for v in noisy)
    assert float((noisy[0] - quiet[0]).abs().max()) > 1e-3


def renderer_inputs(seed, b=2, r=6, n=5):
    rng = np.random.default_rng(seed)
    rays_d = rng.standard_normal((b, r, 3)).astype(np.float32)
    return dict(
        pts=rng.uniform(-0.1, 0.1, (b, r, n, 3)).astype(np.float32), rays_d=rays_d,
        viewdirs=(rays_d / np.linalg.norm(rays_d, axis=-1, keepdims=True)).astype(np.float32),
        z_vals=np.broadcast_to(np.linspace(0.88, 1.12, n, dtype=np.float32), (b, r, n)).copy(),
        near=np.full((b, 1, 1), 0.88, np.float32), far=np.full((b, 1, 1), 1.12, np.float32),
        styles=rng.standard_normal((b, 3, 256)).astype(np.float32))


@pytest.mark.parametrize("eikonal", [False, True])
def test_renderer_density_matches_jax(eikonal):
    """VolumeFeatureRenderer(with_sdf=False), weights from a flax init
    carried by the weight bridge (sigmoid_beta kept, unused), against the
    flax renderer: every output, the eikonal term too."""
    from cips3dpp_tpu.models.renderer import VolumeFeatureRenderer as JR
    from cips3dpp_torch.io.jax_params import jax_params_to_state_dict
    from cips3dpp_torch.models.renderer import VolumeFeatureRenderer

    x = renderer_inputs(seed=11)
    jr = JR(depth=2, hidden_dim=32, with_sdf=False)
    args = [jnp.asarray(x[k]) for k in ("pts", "rays_d", "viewdirs", "z_vals", "near", "far",
                                         "styles")]
    variables = jr.init(jax.random.PRNGKey(0), *args)
    want = jr.apply(variables, *args, return_eikonal=eikonal)
    sd = jax_params_to_state_dict({"renderer": np_tree(variables["params"])})
    r = VolumeFeatureRenderer(depth=2, hidden_dim=32, with_sdf=False)
    r.load_state_dict({k[len("renderer."):]: v for k, v in sd.items()}, strict=True)
    got = r(*(t(v) for v in x.values()), return_eikonal=eikonal)
    for name, g, w in zip(("thumb", "feat", "sdf", "mask_depth", "xyz", "eikonal"), got, want):
        if w is None:
            assert g is None, name
            continue
        np.testing.assert_allclose(a(g), a(w), err_msg=name, **RENDER)
    with pytest.raises(ValueError, match="no SDF"):
        r(*(t(v) for v in x.values()), fused=True)


@pytest.fixture(scope="module")
def density():
    return opts.build(seed=61, with_sdf=False)


def test_generator_density_matches_jax(density):
    """A tiny generator with the density renderer (width 32 at 8^2 rays x
    4 samples, one upsample to 16^2), weights carried port -> flax, its
    forward against flax's: every output."""
    from cips3dpp_tpu.core.camera import camera_from_angles as jcam
    from cips3dpp_tpu.models.generator import Generator as JG
    from cips3dpp_torch.core.camera import camera_from_angles

    s = density
    rng = np.random.default_rng(12)
    zs = [rng.standard_normal((2, 256)).astype(np.float32) for _ in range(2)]
    azim = np.asarray([0.2, -0.1], np.float32)
    elev = np.asarray([0.05, 0.0], np.float32)
    noise = [rng.standard_normal(sh).astype(np.float32)
             for sh in s["g"].decoder.noise_shapes(8)]
    jc = jcam(jnp.asarray(azim), jnp.asarray(elev), 8)
    want = JG(s["jcfg"]).apply(
        {"params": jax.tree.map(jnp.asarray, s["pg"])}, zs=tuple(map(jnp.asarray, zs)),
        cam_poses=jc.extrinsics, focals=jc.focal, near=jc.near, far=jc.far,
        noise_bufs=[jnp.asarray(n) for n in noise], perturb=False)
    c = camera_from_angles(t(azim), t(elev), 8)
    with torch.no_grad():
        got = s["g"]([t(z) for z in zs], c.extrinsics, c.focal, c.near, c.far,
                     noise_bufs=[t(n) for n in noise], perturb=False)
    assert got["rgb"].shape == (2, 16, 16, 3)
    for k in ("rgb", "thumb_rgb", "sdf", "mask", "depth", "xyz"):
        np.testing.assert_allclose(a(got[k]), a(want[k]), rtol=1e-4, atol=1e-4, err_msg=k)


def test_d_step_density_matches_jax(density):
    """One D step with lazy R1 at the default TrainConfig (both packages
    render plainly off the card): metrics and every gradient."""
    opts.check_f32(*opts.run_d(density, dict(fused_renderer_d=True), True))


def test_g_step_density_matches_jax(density):
    """One G step (eikonal and minimal-surface terms on the density
    network's fourth output, as JAX): metrics and every gradient, the
    latter at REL_DENSITY_G (the module docstring says why)."""
    opts.check_f32(*opts.run_g(density, {}), rel=REL_DENSITY_G)


def test_fused_density_routes_raise(density):
    """K1 composites by the SDF rule only: fused=True raises for a density
    renderer, and so does the serving path (JAX's would composite it by
    the SDF rule without a word); the default train route renders
    plainly."""
    from cips3dpp_torch import serving
    from cips3dpp_torch.core.camera import camera_from_angles

    g = density["g"]
    zs = [torch.zeros((1, 256)), torch.zeros((1, 256))]
    zero = torch.zeros(1)
    c = camera_from_angles(zero, zero, 8)
    with pytest.raises(ValueError, match="no SDF"):
        g(zs, c.extrinsics, c.focal, c.near, c.far, perturb=False, fused_renderer=True,
          generator=torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="no SDF"):
        serving.prepare_trajectory(g, zs, noise_seed=1, device="cpu")
