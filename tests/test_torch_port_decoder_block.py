"""K2, the decoder upsample block: the port's plain version (what the CUDA
kernel computes, run on the CPU) against the packed Pallas kernel in
interpret mode and against its jnp oracle, for C in {16, 32, 128, 384,
512, 1024, 2048} (the resident kernel's smallest and largest shipped C,
and the streamed-weight kernel at each of its tile sizes, 384 a count
that is no power of two): with ToRGB folded in, with the feature store
skipped, and with two frames stacked on rows (the upsample halo must stop
at each frame's edge). The plain versions are generic in C: the same
code serves every C. Then K3's plain version at C = 32, 512 and 1024,
the decoder's channel table at channel multipliers 1-17 and 32 against
the channel counts K2 takes and JAX's packed-block assertion, and the
admission check at counts JAX refuses.

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


# the resident kernel's C, then the streamed kernel's three tile sizes
CHANNELS = [16, 32, 128, 384, 512, 1024, 2048]


@pytest.mark.parametrize("c", CHANNELS)
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


@pytest.mark.parametrize("c", CHANNELS)
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


@pytest.mark.parametrize("c", [32, 512, 1024])
def test_v1_block_plain_matches_pallas_and_oracle(c):
    """K3, the v1 block (f32 in and out, ToRGB bias and upsampled-skip
    epilogue): the port's plain version against the Pallas kernel in
    interpret mode and against its jnp oracle, at tests/test_kernels.py's
    shape (32, 16, 32) and tolerance, and at C = 512 and 1024, which the
    card takes through the streamed-weight kernel."""
    from cips3dpp_tpu.kernels.decoder_block import decoder_block_fused as jfused
    from cips3dpp_tpu.kernels.decoder_block import decoder_block_reference as jref
    from cips3dpp_torch.kernels.decoder_block import decoder_block_fused

    hp, wp = (32, 16) if c == 32 else (16, 16)
    rng = np.random.default_rng(3 if c == 32 else c)
    n = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    g = 0.1 * np.sqrt(32 / c)  # the C = 32 case's gain at every C
    args = (n(hp, wp, c), n(hp, wp, 3), n(2 * hp, 2 * wp, 1), n(2 * hp, 2 * wp, 1),
            g * n(c, c), g * n(c, 3), 0.1 * n(c), 0.1 * n(c), 0.1 * n(3))
    nw = (0.3, 0.2)
    feat, rgb = decoder_block_fused(*[t(x) for x in args], *nw)
    assert feat.shape == (2 * hp, 2 * wp, c) and rgb.shape == (2 * hp, 2 * wp, 3)
    assert feat.dtype == rgb.dtype == torch.float32
    jn = tuple(jnp.asarray(v) for v in nw)
    for want in (jfused(*args, *jn, t_rows=8, interpret=True), jref(*args, *jn)):
        np.testing.assert_allclose(a(feat), a(want[0]), rtol=0, atol=2e-3)
        np.testing.assert_allclose(a(rgb), a(want[1]), rtol=0, atol=2e-3)


@pytest.mark.parametrize("m", list(range(1, 18)) + [32, 65, 128])
def test_channel_table_blocks_lie_in_the_kernel(m):
    """Every upsample block of a decoder at channel multiplier m (128^2 to
    1024^2), from both packages' channel tables: K2 takes its C exactly
    when JAX's packed block admits it (cips3dpp_tpu/kernels/
    decoder_block.py:754: (c * p) % 128 == 0 or c >= 128 with p = max(1,
    128 // c)), and then runs it at a built kernel's count no smaller, the
    next multiple of 64 past 256, 192 at 129-192 and 256 at 193-256 (the
    1024^2 blocks at m = 3, 5, 6 and 7, 48 to 112 channels, JAX refuses).
    There is no ceiling: m = 65 (the
    first multiplier past C = 8192, its 128^2 block at 8320) and 128 (at
    16384) run every block, past C = 2048 on the staged build."""
    from cips3dpp_tpu.models.layers import channel_table as jax_table
    from cips3dpp_torch.kernels import decoder_block as kdb
    from cips3dpp_torch.models.layers import channel_table

    assert channel_table(m) == jax_table(m)
    got = [channel_table(m)[r] for r in (128, 256, 512, 1024)]
    assert got == [128 * m, 64 * m, 32 * m, 16 * m]
    for c in got:
        p = max(1, 128 // c)
        jax_admits = (c * p) % 128 == 0 or c >= 128
        try:
            kdb.check_k2(c)
            taken = True
        except ValueError as e:
            assert "(c * p) % 128 == 0 or c >= 128" in str(e)
            taken = False
        assert taken == jax_admits, c
        if taken:
            ck = kdb.kernel_channels(c)
            assert kdb.is_kernel_channels(ck) and c <= ck
            assert ck == c or ck == (-(-c // 64) * 64 if c > 256 else 192 if c <= 192 else 256)
            assert kdb.is_staged(ck) == (ck > 2048)
    assert all(kdb.kernel_channels(c) == c for c in got) == (m in (1, 2, 4, 8, 12, 16, 32, 128))


@pytest.mark.parametrize("c", [48, 96])
def test_shape_check_names_the_channel_counts_taken(c):
    """A C that JAX's packed block refuses (48 and 96: below 128 and no
    divisor of it, the 1024^2 blocks at channel multipliers 3 and 6)
    raises, quoting JAX's rule, before any library is built or loaded, at
    every entry point of K2; K3, whose JAX block takes every C, takes it.
    The kernel that runs an admitted C and its tile follow kernel_channels."""
    from cips3dpp_torch.kernels import _lib
    from cips3dpp_torch.kernels import decoder_block as kdb

    rule = r"\(c \* p\) % 128 == 0 or c >= 128 and wp % p == 0"
    built = []
    saved = _lib.build, _lib.load
    _lib.build = _lib.load = lambda *a, **k: built.append(a)
    try:
        with pytest.raises(ValueError, match=rule):
            kdb.check_k2(c)
        with pytest.raises(ValueError, match=rule):
            kdb.decoder_block_info(c)
        x = _inputs(c, seed=c)
        with pytest.raises(ValueError, match=rule):
            _port(x, torch.bfloat16)
    finally:
        _lib.build, _lib.load = saved
    assert built == []
    kdb.check_k3(c)
    assert kdb.kernel_channels(c) == {48: 64, 96: 128}[c]
    assert [kdb.tile_pixels(c) for c in (1, 16, 144, 256, 288, 384, 512, 640, 1024, 1152,
                                         2048, 2176, 4096, 4224, 8192)] == [
        512, 512, 64, 32, 64, 64, 64, 64, 64, 32, 32, 64, 64, 64, 64]
    with pytest.raises(ValueError):
        kdb.check_k3(0)
    kdb.check_k3(8193)  # no ceiling: K3 takes it at 8256


@pytest.mark.parametrize("c", [384, 1024, 2048])
def test_streamed_weight_chunks_invert(c):
    """The streamed kernel's weight layout (chunk_weight): the whole weight
    in 16 KB chunks of 128 output x 64 input channels, pass by pass, each
    row's 16-byte groups swizzled by row % 8. Its inverse gives back w2t
    bit for bit, and decoder_block_prepare carries it only where the
    weight is streamed."""
    from cips3dpp_torch.kernels import decoder_block as kdb

    gen = torch.Generator().manual_seed(c)
    w2t = torch.randn((c, c), generator=gen).to(torch.bfloat16)
    w2c = kdb.chunk_weight(w2t)
    assert w2c.shape == (c * c,) and w2c.dtype == torch.bfloat16
    chunks = w2c.reshape(c // 128, c // 64, 128, 8, 8)  # pass, chunk, row, group, value
    back = torch.empty_like(w2t)
    for n in range(128):  # the inverse, row by row: group j of row n sits at j ^ (n % 8)
        groups = chunks[:, :, n, [j ^ (n % 8) for j in range(8)]]  # (pass, chunk, j, value)
        back[n::128] = groups.reshape(c // 128, c)
    assert torch.equal(back, w2t)
    for p, k, n, j in ((0, 0, 0, 0), (1, 2, 13, 3), (c // 128 - 1, c // 64 - 1, 127, 7)):
        assert torch.equal(chunks[p, k, n, j ^ (n % 8)],
                           w2t[128 * p + n, 64 * k + 8 * j:64 * k + 8 * j + 8])
    prep = kdb.decoder_block_prepare(
        torch.zeros(4, 4), torch.zeros(4, 4), w2t.float().t(), torch.zeros(c), torch.zeros(c),
        0.1, 0.1)
    assert torch.equal(prep["w2c"], w2c)
    small = kdb.decoder_block_prepare(
        torch.zeros(4, 4), torch.zeros(4, 4), torch.zeros(256, 256), torch.zeros(256),
        torch.zeros(256), 0.1, 0.1)
    assert "w2c" not in small
