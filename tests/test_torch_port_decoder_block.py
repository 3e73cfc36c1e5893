"""K2, the decoder upsample block: the port's plain version (what the CUDA
kernel computes, run on the CPU) against the packed Pallas kernel in
interpret mode and against its jnp oracle, for C in {32, 128}: with ToRGB
folded in, with the feature store skipped, and with two frames stacked on
rows (the upsample halo must stop at each frame's edge).

Why not exact: conv_b multiplies bf16-rounded activations and sums in f32
in another order than the Pallas kernel; an activation that lands next to
a bf16 rounding boundary can round the other way, which moves a stored
bf16 feature by one bf16 ulp (2^-8 relative).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import a, t

HP = WP = 16


def _inputs(c, seed, frames=1):
    rng = np.random.default_rng(seed)
    # serving stores y1 and the noise maps in bf16 (the JAX serving path
    # casts them before the kernel): draw values that are bf16-exact
    bf16_exact = lambda shape: a(t(rng.standard_normal(shape)).to(torch.bfloat16))
    return {
        "y1": bf16_exact((frames * HP, WP, c)),
        "noise1": bf16_exact((2 * HP, 2 * WP, 1)),
        "noise2": bf16_exact((2 * HP, 2 * WP, 1)),
        "w2": (rng.standard_normal((c, c)) / np.sqrt(c)).astype(np.float32),
        "b1": (0.1 * rng.standard_normal(c)).astype(np.float32),
        "b2": (0.1 * rng.standard_normal(c)).astype(np.float32),
        "wrgb": (rng.standard_normal((c, 3)) / np.sqrt(c)).astype(np.float32),
    }


def _port(x, dtype, **kw):
    from cips3dpp_torch.kernels.decoder_block import decoder_block_packed

    return decoder_block_packed(
        t(x["y1"]), t(x["noise1"]), t(x["noise2"]), t(x["w2"]), t(x["b1"]),
        t(x["b2"]), 0.3, -0.2, dtype=dtype, **kw,
    )


def _pallas(x, dt, **kw):
    from cips3dpp_tpu.kernels.decoder_block import decoder_block_packed as jblock

    return jblock(
        x["y1"], x["noise1"], x["noise2"], x["w2"], x["b1"], x["b2"], 0.3, -0.2,
        t_rows=8, interpret=True, out_dtype=dt, colup_dtype=dt, rgb_dtype=dt,
        **kw,
    )


@pytest.mark.parametrize("c", [32, 128])
def test_plain_matches_pallas_bf16_rgb_fold(c):
    """The serving configuration: bf16 storage, ToRGB folded in; then the
    final-block mode (feature store skipped) and two stacked frames."""
    x = _inputs(c, seed=c)
    feat, rgb = _port(x, torch.bfloat16, wrgb=t(x["wrgb"]))
    jfeat, jrgb = _pallas(x, jnp.bfloat16, wrgb=x["wrgb"])
    assert feat.dtype == torch.bfloat16 and feat.shape == (2 * HP, 2 * WP, c)
    assert rgb.dtype == torch.float32 and rgb.shape == (2 * HP, 2 * WP, 3)
    # stored bf16 features: a rounding flip is one bf16 ulp of |feat| <= ~4
    np.testing.assert_allclose(a(feat), a(jfeat), rtol=0, atol=3.2e-2)
    assert np.mean(a(feat) != a(jfeat)) < 0.01  # flips are rare
    # rgb = stored feat @ wrgb: a feat flip moves rgb by ulp * |wrgb|
    np.testing.assert_allclose(a(rgb), a(jrgb), rtol=0, atol=1e-2)

    rgb_only = _port(x, torch.bfloat16, wrgb=t(x["wrgb"]), emit_feat=False)
    torch.testing.assert_close(rgb_only, rgb, rtol=0, atol=0)

    x2 = _inputs(c, seed=c + 1, frames=2)
    feat2, rgb2 = _port(x2, torch.bfloat16, wrgb=t(x2["wrgb"]), frames=2)
    jfeat2, jrgb2 = _pallas(x2, jnp.bfloat16, wrgb=x2["wrgb"], frames=2)
    assert feat2.shape == (4 * HP, 2 * WP, c)
    np.testing.assert_allclose(a(feat2), a(jfeat2), rtol=0, atol=3.2e-2)
    np.testing.assert_allclose(a(rgb2), a(jrgb2), rtol=0, atol=1e-2)
    # each frame equals the same frame rendered alone (no halo leak)
    for f in range(2):
        xf = dict(x2, y1=x2["y1"][f * HP:(f + 1) * HP])
        ff, rf = _port(xf, torch.bfloat16, wrgb=t(x2["wrgb"]))
        torch.testing.assert_close(feat2[2 * f * HP:2 * (f + 1) * HP], ff,
                                   rtol=0, atol=0)
        torch.testing.assert_close(rgb2[2 * f * HP:2 * (f + 1) * HP], rf,
                                   rtol=0, atol=0)


@pytest.mark.parametrize("c", [32, 128])
def test_plain_matches_pallas_and_oracle_f32(c):
    """f32 storage (the f32 decoder config): only conv_b rounds to bf16."""
    from cips3dpp_tpu.kernels.decoder_block import decoder_block_packed_reference as jref
    from cips3dpp_torch.kernels.decoder_block import decoder_block_packed_reference

    x = _inputs(c, seed=10 + c)
    feat = _port(x, torch.float32)
    # tests/test_kernels.py's tolerance for kernel vs oracle
    tol = dict(rtol=2e-2, atol=2e-3)
    np.testing.assert_allclose(a(feat), a(_pallas(x, jnp.float32)), **tol)
    want = jref(x["y1"], x["noise1"], x["noise2"], x["w2"], x["b1"], x["b2"], 0.3, -0.2)
    np.testing.assert_allclose(a(feat), a(want), **tol)
    got_ref = decoder_block_packed_reference(
        t(x["y1"]), t(x["noise1"]), t(x["noise2"]), t(x["w2"]), t(x["b1"]),
        t(x["b2"]), 0.3, -0.2,
    )
    np.testing.assert_allclose(a(got_ref), a(want), **tol)


def test_v1_block_plain_matches_pallas_and_oracle():
    """K3, the v1 block (f32 in and out, ToRGB bias and upsampled-skip
    epilogue): the port's plain version against the Pallas kernel in
    interpret mode and against its jnp oracle, at tests/test_kernels.py's
    shape (32, 16, 32) and tolerance."""
    from cips3dpp_tpu.kernels.decoder_block import decoder_block_fused as jfused
    from cips3dpp_tpu.kernels.decoder_block import decoder_block_reference as jref
    from cips3dpp_torch.kernels.decoder_block import decoder_block_fused

    hp, wp, c = 32, 16, 32
    rng = np.random.default_rng(3)
    n = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    args = (n(hp, wp, c), n(hp, wp, 3), n(2 * hp, 2 * wp, 1), n(2 * hp, 2 * wp, 1),
            0.1 * n(c, c), 0.1 * n(c, 3), 0.1 * n(c), 0.1 * n(c), 0.1 * n(3))
    nw = (0.3, 0.2)
    feat, rgb = decoder_block_fused(*[t(x) for x in args], *nw)
    assert feat.shape == (2 * hp, 2 * wp, c) and rgb.shape == (2 * hp, 2 * wp, 3)
    assert feat.dtype == rgb.dtype == torch.float32
    jn = tuple(jnp.asarray(v) for v in nw)
    for want in (jfused(*args, *jn, t_rows=8, interpret=True), jref(*args, *jn)):
        np.testing.assert_allclose(a(feat), a(want[0]), rtol=0, atol=2e-3)
        np.testing.assert_allclose(a(rgb), a(want[1]), rtol=0, atol=2e-3)
