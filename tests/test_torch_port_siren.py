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


def _make_renderer_params(key, width, scale=0.05):
    """tests/test_kernels.py's random renderer tree (same draws; `scale`
    is the std of the layers' weights, 0.05 there)."""
    ks = jax.random.split(key, 32)
    i = iter(range(32))

    def lin(k1, k2, din, dout, s=scale):
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


@pytest.mark.parametrize("width", [64, 512])
@pytest.mark.parametrize("s", [12, 20, 48])
def test_plain_matches_jnp_oracle_at_other_geometries(width, s):
    """K1 takes widths 32-512 and 1-64 samples on the card: its plain
    version against the jnp oracle at two widths and three sample counts
    (20 is no multiple of K1's 24-sample chunk, 48 two chunks), 64 rays,
    the oracle tolerances above. The weights' std is 0.05 * sqrt(128 /
    width), so the phases spread as in the width-128 fixture the
    tolerances were set on, as a SIREN's fan-in init keeps them: at 0.05
    and width 512 they spread twice as far, and JAX's own Pallas kernel
    (interpret mode) lies 0.063 (thumb) and 0.31 (feat) from the oracle,
    as far as the plain version does (the test below)."""
    from cips3dpp_tpu.kernels.siren_render import siren_render_reference as jref
    from cips3dpp_torch.kernels.siren_render import siren_render_fused

    params = _make_renderer_params(jax.random.PRNGKey(width + s), width,
                                   scale=0.05 * (128 / width) ** 0.5)
    rng = np.random.default_rng(s)
    r = 64
    vd = rng.standard_normal((r, 3)).astype(np.float32)
    vd /= np.linalg.norm(vd, axis=-1, keepdims=True)
    jargs = (rng.standard_normal((3, 256)).astype(np.float32),
             (0.1 * rng.standard_normal((r, s, 3))).astype(np.float32), vd,
             (np.linspace(0.88, 1.12, s)[None] + 1e-3 * rng.standard_normal((r, 1))).astype(
                 np.float32),
             (1.05 * vd).astype(np.float32), np.float32(0.88), np.float32(1.12))
    got = siren_render_fused(port_renderer(np_tree(params), width), *(t(x) for x in jargs))
    _compare(got, jref(params, *(jnp.asarray(x) for x in jargs)), ATOL_ORACLE)


def test_plain_is_as_far_from_the_oracle_as_the_pallas_kernel_at_width_512():
    """The witness for the scaled tree above: at the fixture's own weight
    std 0.05 and width 512 both kernels' arithmetic (bias fold, fast_sin,
    bf16 operands) leaves the oracle's tolerances, K1's plain version no
    further than JAX's Pallas kernel in interpret mode (within 10% and
    1e-3 of its distance, output by output)."""
    from cips3dpp_tpu.kernels.siren_render import siren_render_fused as jfused
    from cips3dpp_tpu.kernels.siren_render import siren_render_reference as jref
    from cips3dpp_torch.kernels.siren_render import siren_render_fused

    width, r, s = 512, 64, 12
    params = _make_renderer_params(jax.random.PRNGKey(width + s), width)
    rng = np.random.default_rng(s)
    vd = rng.standard_normal((r, 3)).astype(np.float32)
    vd /= np.linalg.norm(vd, axis=-1, keepdims=True)
    jargs = (rng.standard_normal((3, 256)).astype(np.float32),
             (0.1 * rng.standard_normal((r, s, 3))).astype(np.float32), vd,
             (np.linspace(0.88, 1.12, s)[None] + 1e-3 * rng.standard_normal((r, 1))).astype(
                 np.float32),
             (1.05 * vd).astype(np.float32), np.float32(0.88), np.float32(1.12))
    jx = [jnp.asarray(x) for x in jargs]
    oracle = jref(params, *jx)
    pallas = jfused(params, *jx, ray_tile=64, interpret=True)
    plain = siren_render_fused(port_renderer(np_tree(params), width), *(t(x) for x in jargs))
    far = []
    for name, p, k, o in zip(NAMES, plain, pallas, oracle):
        d_plain, d_pallas = (float(np.abs(a(x) - a(o)).max()) for x in (p, k))
        print(f"{name}: plain {d_plain:.3g}, Pallas {d_pallas:.3g} from the oracle")
        assert d_plain <= 1.1 * d_pallas + 1e-3, name
        far.append(d_pallas > ATOL_ORACLE[name])
    assert any(far)  # the tolerances do not hold at this spread of phases
