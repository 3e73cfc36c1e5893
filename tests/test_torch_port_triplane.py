"""The triplane renderer (models/triplane.py) against the JAX package's on
the CPU: the bilinear plane sampler against JAX's 4-tap gather and against
F.grid_sample, the plane modes, the renderer's forward and eikonal term,
and the gradient of an eikonal-plus-image loss with respect to the planes
and every weight against jax.grad; gradgradcheck of the sampler in
float64, the double backward the eikonal loss takes.

Weights are a flax init carried by `io/jax_params.py:
jax_triplane_params_to_state_dict`. The points stay inside the planes, as
in JAX's own test (tests/test_triplane.py): at a point wholly outside,
the eikonal row is zero and the norm's gradient NaN in both packages.
The port's sampler is JAX's four-tap form, not F.grid_sample, whose
double backward the card's torch lacks.
Bounds: the sampler at atol 1e-5, as JAX's test holds its sampler to
torch's (texel positions rounded in other orders, 1.7e-6 measured); the
renderer's outputs at rtol 1e-5, atol 1e-5 (its softplus MLP's f32 sums
in other orders), the eikonal term within 1e-5 of its largest |value|
(a derivative through the sampler whose entries reach 1e3, where atol
1e-5 is below one f32 ulp); the loss gradients within 1e-4 of each
tensor's largest |value|, the step tests' gradient bound.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from torch_port_helpers import a, np_tree, t
from torch_port_train_helpers import assert_rel

RENDER = dict(rtol=1e-5, atol=1e-5)
REL_EIK = 1e-5
REL_GRAD = 1e-4


def test_grid_sample_matches_jax_and_torch():
    """Coords past [-1, 1] exercise the zeros padding."""
    from cips3dpp_tpu.models.triplane import grid_sample_bilinear as jgs
    from cips3dpp_torch.models.triplane import grid_sample_bilinear

    rng = np.random.default_rng(0)
    feat = rng.standard_normal((2, 7, 9, 4)).astype(np.float32)  # NHWC
    coords = rng.uniform(-1.3, 1.3, (2, 50, 2)).astype(np.float32)
    got = grid_sample_bilinear(t(feat), t(coords))
    np.testing.assert_allclose(a(got), a(jgs(jnp.asarray(feat), jnp.asarray(coords))),
                               atol=1e-5)
    lib = F.grid_sample(t(feat).permute(0, 3, 1, 2), t(coords)[:, None], mode="bilinear",
                        padding_mode="zeros", align_corners=False)[:, :, 0].transpose(1, 2)
    np.testing.assert_allclose(a(got), a(lib), atol=1e-5)


@pytest.mark.parametrize("mode", ["xy_xz_yz", "xy_xz_zx", "xz_yz"])
def test_plane_modes_match_jax(mode):
    """generate_planes, project_onto_planes and sample_from_planes in both
    modes; any other mode raises in both packages."""
    from cips3dpp_tpu.models import triplane as jt
    from cips3dpp_torch.models import triplane as tt

    if mode == "xz_yz":
        for m in (jt, tt):
            with pytest.raises(NotImplementedError):
                m.generate_planes(mode)
        return
    axes = tt.generate_planes(mode)
    np.testing.assert_array_equal(axes, jt.generate_planes(mode))
    rng = np.random.default_rng(1)
    coords = rng.uniform(-1, 1, (2, 5, 3)).astype(np.float32)
    planes = rng.standard_normal((2, 3, 4, 6, 6)).astype(np.float32)
    np.testing.assert_allclose(a(tt.project_onto_planes(axes, t(coords))),
                               a(jt.project_onto_planes(axes, jnp.asarray(coords))), atol=1e-6)
    np.testing.assert_allclose(
        a(tt.sample_from_planes(axes, t(planes), t(coords))),
        a(jt.sample_from_planes(axes, jnp.asarray(planes), jnp.asarray(coords))), atol=1e-6)


def inputs(seed, b=2, r=6, s=5, c=8, hw=16):
    rng = np.random.default_rng(seed)
    rays_d = rng.standard_normal((b, r, 3)).astype(np.float32)
    return dict(
        planes=rng.standard_normal((b, 3, c, hw, hw)).astype(np.float32),
        pts=rng.uniform(-0.1, 0.1, (b, r, s, 3)).astype(np.float32), rays_d=rays_d,
        viewdirs=(rays_d / np.linalg.norm(rays_d, axis=-1, keepdims=True)).astype(np.float32),
        z_vals=np.broadcast_to(np.linspace(0.88, 1.12, s, dtype=np.float32), (b, r, s)).copy(),
        near=np.full((b, 1, 1), 0.88, np.float32), far=np.full((b, 1, 1), 1.12, np.float32))


def renderers(cfg_kw, seed=0):
    """(flax renderer, its params, the port's renderer with the same
    weights, the inputs)."""
    from cips3dpp_tpu.models.triplane import TriplaneConfig as JC, TriplaneRenderer as JR
    from cips3dpp_torch.io.jax_params import jax_triplane_params_to_state_dict
    from cips3dpp_torch.models.triplane import TriplaneConfig, TriplaneRenderer

    x = inputs(seed)
    jr = JR(JC(plane_channels=8, hidden_dim=16, **cfg_kw))
    params = np_tree(jr.init(jax.random.PRNGKey(seed), *map(jnp.asarray, x.values()))["params"])
    tr = TriplaneRenderer(TriplaneConfig(plane_channels=8, hidden_dim=16, **cfg_kw),
                          device="cpu", seed=seed + 1)
    tr.load_state_dict(jax_triplane_params_to_state_dict(params), strict=True)
    return jr, jax.tree.map(jnp.asarray, params), tr, x


CFGS = [dict(view_n_freqs=2), dict(view_n_freqs=0), dict(view_n_freqs=2, with_sdf=False)]
IDS = ["views2", "views0", "density"]


@pytest.mark.parametrize("cfg", CFGS, ids=IDS)
def test_triplane_renderer_matches_jax(cfg):
    """Every output with the eikonal term, and the forward without it."""
    jr, params, tr, x = renderers(cfg)
    want = jr.apply({"params": params}, *map(jnp.asarray, x.values()), return_eikonal=True)
    got = tr(*map(t, x.values()), return_eikonal=True)
    for name, g, w in zip(("rgb", "feat", "sdf", "mask_depth", "xyz"), got, want):
        np.testing.assert_allclose(a(g), a(w), err_msg=name, **RENDER)
    assert_rel(got[-1], want[-1], rel=REL_EIK, name="eikonal")
    with torch.no_grad():
        plain = tr(*map(t, x.values()))
    assert plain[-1] is None
    np.testing.assert_array_equal(a(plain[0]), a(got[0]))


@pytest.mark.parametrize("cfg", CFGS[:2], ids=IDS[:2])
def test_triplane_loss_gradients_match_jax(cfg):
    """The gradient of (|eikonal| - 1)^2 plus the rendered image's mean
    square, with respect to the planes and every weight (the eikonal part
    through the sampler's double backward), against jax.grad."""
    from cips3dpp_torch.io.jax_params import jax_triplane_params_to_state_dict

    jr, params, tr, x = renderers(cfg, seed=3)

    rest = list(x.values())[1:]

    def jloss(p, planes):
        out = jr.apply({"params": p}, planes, *map(jnp.asarray, rest), return_eikonal=True)
        return jnp.mean(jnp.square(jnp.linalg.norm(out[-1], axis=-1) - 1.0)) \
            + jnp.mean(out[0] ** 2)

    jgp, jgplanes = jax.grad(jloss, argnums=(0, 1))(params, jnp.asarray(x["planes"]))
    planes = t(x["planes"]).requires_grad_(True)
    out = tr(planes, *map(t, rest), return_eikonal=True)
    loss = torch.mean(torch.square(torch.linalg.norm(out[-1], dim=-1) - 1.0)) \
        + torch.mean(out[0] ** 2)
    names = [n for n, _ in tr.named_parameters()]
    grads = torch.autograd.grad(loss, [planes] + [p for _, p in tr.named_parameters()])
    assert_rel(grads[0], jgplanes, rel=REL_GRAD, name="planes")
    want = jax_triplane_params_to_state_dict(np_tree(jgp))
    for name, g in zip(names, grads[1:]):
        assert_rel(g, want[name], rel=REL_GRAD, name=name)
    assert float(grads[0].abs().max()) > 0


def test_grid_sample_gradgradcheck():
    """The sampler's first and second derivatives against finite
    differences in float64, with respect to the features and the coords
    (the coords kept off the texel lines, where bilinear is not smooth)."""
    from cips3dpp_torch.models.triplane import grid_sample_bilinear

    rng = np.random.default_rng(5)
    feat = torch.from_numpy(rng.standard_normal((1, 4, 5, 2))).requires_grad_(True)
    coords = torch.from_numpy(rng.uniform(-0.9, 0.9, (1, 6, 2))).requires_grad_(True)
    assert torch.autograd.gradcheck(grid_sample_bilinear, (feat, coords))
    assert torch.autograd.gradgradcheck(grid_sample_bilinear, (feat, coords))
