"""K1, the SIREN render: the port's plain version (what the CUDA kernel
computes, run on the CPU) against the Pallas kernel in interpret mode and
against the jnp oracle, at tests/test_kernels.py's fixture (width 128,
512 rays x 24 samples).

Why not exact: both sides round matmul inputs to bf16, and gamma ~ 30-45
in the sin amplifies every bf16 rounding flip that a different f32
summation order causes; the raw per-sample features are the most
sensitive output, the composited values much less so.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import a, np_tree, port_renderer, t

NAMES = ("thumb", "feat", "sdf", "mask_depth", "xyz")
# plain version vs the Pallas kernel: same fold, same fast_sin, same
# rounding points; measured max |diff| thumb 3.3e-3, feat 2.9e-2,
# sdf 4.9e-3, mask_depth 3e-4, xyz 1.3e-4 on a numpy-drawn fixture
ATOL_KERNEL = {"thumb": 1e-2, "feat": 6e-2, "sdf": 1e-2, "mask_depth": 1e-2,
               "xyz": 1e-3}
# against the unfused oracle: tests/test_kernels.py's own tolerances for
# kernel vs oracle (sin vs fast_sin and the unfolded bias add as well)
ATOL_ORACLE = {"thumb": 2e-2, "feat": 1.5e-1, "sdf": 2e-2, "mask_depth": 2e-2,
               "xyz": 2e-2}


def _make_renderer_params(key, width):
    """tests/test_kernels.py's random renderer tree (same draws)."""
    ks = jax.random.split(key, 32)
    i = iter(range(32))

    def lin(k1, k2, din, dout, s=0.05):
        return {"weight": s * jax.random.normal(k1, (din, dout)),
                "bias": 0.1 * jax.random.normal(k2, (dout,))}

    def film(din, dout, sd=256):
        return {**lin(ks[next(i)], ks[next(i)], din, dout),
                "gamma": lin(ks[next(i)], ks[next(i)], sd, dout, s=0.02),
                "beta": lin(ks[next(i)], ks[next(i)], sd, dout, s=0.02)}

    net = {"pts_0": film(3, width), "pts_1": film(width, width),
           "views": film(width + 3, width),
           "sigma_head": lin(ks[next(i)], ks[next(i)], width, 1),
           "rgb_head": lin(ks[next(i)], ks[next(i)], width, 3)}
    return {"sigmoid_beta": jnp.asarray([0.1]), "network": net}


@pytest.fixture(scope="module")
def setup():
    params = _make_renderer_params(jax.random.PRNGKey(0), 128)
    r, s = 512, 24
    styles = jax.random.normal(jax.random.PRNGKey(1), (3, 256))
    pts = 0.1 * jax.random.normal(jax.random.PRNGKey(2), (r, s, 3))
    viewdirs = jax.random.normal(jax.random.PRNGKey(3), (r, 3))
    viewdirs = viewdirs / jnp.linalg.norm(viewdirs, axis=-1, keepdims=True)
    z_vals = jnp.broadcast_to(jnp.linspace(0.88, 1.12, s), (r, s)) + \
        0.001 * jax.random.normal(jax.random.PRNGKey(4), (r, 1))
    rays_d = viewdirs * 1.05
    near, far = jnp.asarray(0.88), jnp.asarray(1.12)
    jargs = (styles, pts, viewdirs, z_vals, rays_d, near, far)
    targs = tuple(t(x) for x in jargs)
    return params, port_renderer(np_tree(params), 128), jargs, targs


def _compare(got, want, atol):
    for name, g, w in zip(NAMES, got, want):
        assert tuple(g.shape) == tuple(w.shape), (name, g.shape, w.shape)
        np.testing.assert_allclose(a(g), a(w), rtol=0, atol=atol[name], err_msg=name)


def test_plain_matches_pallas_interpret(setup):
    from cips3dpp_tpu.kernels.siren_render import siren_render_fused as jfused
    from cips3dpp_torch.kernels.siren_render import siren_render_fused

    params, renderer, jargs, targs = setup
    want = jfused(params, *jargs, ray_tile=128, interpret=True)
    _compare(siren_render_fused(renderer, *targs), want, ATOL_KERNEL)


def test_plain_matches_jnp_oracle(setup):
    from cips3dpp_tpu.kernels.siren_render import siren_render_reference as jref
    from cips3dpp_torch.kernels.siren_render import siren_render_fused

    params, renderer, jargs, targs = setup
    _compare(siren_render_fused(renderer, *targs), jref(params, *jargs), ATOL_ORACLE)


def test_reference_matches_jnp_oracle(setup):
    """The port's unfused oracle against JAX's: in f32 both are the same
    formulas (tight: f32 order, amplified by gamma ~ 45 in the sin); with
    bf16 matmul inputs the kernel tolerances apply."""
    from cips3dpp_tpu.kernels.siren_render import siren_render_reference as jref
    from cips3dpp_torch.kernels.siren_render import siren_render_reference

    params, renderer, jargs, targs = setup
    got = siren_render_reference(renderer, *targs, matmul_dtype=torch.float32)
    want = jref(params, *jargs, matmul_dtype=jnp.float32)
    _compare(got, want, {k: 1e-4 for k in NAMES})
    _compare(siren_render_reference(renderer, *targs), jref(params, *jargs),
             ATOL_KERNEL)


def test_fast_sin_matches_jax():
    """The polynomial sin is bit-for-bit the same function of x in f32 up
    to fma/ordering of the Horner steps (5e-7 over SIREN phases)."""
    from cips3dpp_tpu.kernels.siren_render import fast_sin as jsin
    from cips3dpp_torch.kernels.siren_render import fast_sin

    x = np.linspace(-40.0, 40.0, 200_001, dtype=np.float32)
    got = a(fast_sin(t(x)))
    np.testing.assert_allclose(got, a(jsin(jnp.asarray(x))), rtol=0, atol=5e-7)
    assert np.abs(got - np.sin(x.astype(np.float64))).max() < 2e-5
