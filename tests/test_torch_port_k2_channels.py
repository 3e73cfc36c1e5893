"""K2 and K3 at the channel counts and widths no built kernel runs as they
are, each of which JAX's block kernels admit: the port's route (the
operands zero-padded to the kernel's C and width, the plain version in the
kernel's place, the outputs sliced back) against the packed Pallas kernel
in interpret mode and its jnp oracle, and against the plain version on
the unpadded operands (tests/test_torch_port_k2_multipliers.py: the
fused decoder at channel multipliers 9 and 17, and the refusals).

K2: C = 1 and 8 (run at 16), 144 (at 192), 288 (at 320) and 2176 (the
staged build), Wp = 24 at C = 256 and Wp = 8 at C = 16
(run at Wp = 32 and 16), with noise buffers and with hash noise, whose
pixel ids count in the caller's width. K3: C = 3, 48 and 144 at Wp = 12.

Tolerances: the decoder block tests' (tests/test_torch_port_decoder_block.py:
bf16 feat one bf16 ulp of |feat| <= ~4, 3.2e-2, flips under 1%; rgb 1e-2;
f32 rtol 2e-2, atol 2e-3 against the Pallas kernel and the oracle; hash
noise in f32 at tests/test_kernels.py:346's 5e-3); the padded route
against the unpadded one at f32 rounding (1e-5: only the order of f32 sums
over zero rows may differ; both give the same bits here), the bf16 storage
at one bf16 ulp for at most 0.1% of the values.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import a, t

HP = 8
SEEDS = (123, 456)
# (C, Wp) JAX's packed block admits: (c * p) % 128 == 0 or c >= 128 and
# wp % p == 0, p = max(1, 128 // c)
K2_CASES = [(1, 128), (8, 16), (144, 16), (288, 16), (2176, 16), (256, 24), (16, 8)]


def _inputs(c, wp, seed):
    rng = np.random.default_rng(seed)
    # y1 and the noise maps are stored in bf16 by the serving path: draw
    # bf16-exact values
    bf16_exact = lambda shape: a(t(rng.standard_normal(shape)).to(torch.bfloat16))
    return {
        "y1": bf16_exact((HP, wp, c)),
        "noise1": bf16_exact((2 * HP, 2 * wp, 1)),
        "noise2": bf16_exact((2 * HP, 2 * wp, 1)),
        "w2": (rng.standard_normal((c, c)) / np.sqrt(c)).astype(np.float32),
        "b1": (0.1 * rng.standard_normal(c)).astype(np.float32),
        "b2": (0.1 * rng.standard_normal(c)).astype(np.float32),
        "wrgb": (rng.standard_normal((c, 3)) / np.sqrt(c)).astype(np.float32),
    }


def _port(x, dtype, hashed, **kw):
    from cips3dpp_torch.kernels.decoder_block import decoder_block_packed

    n1, n2 = (None, None) if hashed else (t(x["noise1"]), t(x["noise2"]))
    return decoder_block_packed(
        t(x["y1"]), n1, n2, t(x["w2"]), t(x["b1"]), t(x["b2"]), 0.3, -0.2, dtype=dtype,
        noise_seeds=SEEDS if hashed else None, **kw)


def _pallas(x, dt, hashed, **kw):
    from cips3dpp_tpu.kernels.decoder_block import decoder_block_packed as jblock

    n1, n2 = (None, None) if hashed else (x["noise1"], x["noise2"])
    seeds = jnp.asarray(SEEDS, jnp.uint32) if hashed else None
    return jblock(
        x["y1"], n1, n2, x["w2"], x["b1"], x["b2"], 0.3, -0.2, t_rows=8, interpret=True,
        out_dtype=dt, colup_dtype=dt, rgb_dtype=dt, noise_seeds=seeds, **kw)


@pytest.mark.parametrize("noise", ["buffers", "hash"])
@pytest.mark.parametrize("c,wp", K2_CASES, ids=[f"C{c}-Wp{w}" for c, w in K2_CASES])
def test_k2_matches_pallas_and_oracle(c, wp, noise):
    """bf16 storage with ToRGB folded against the Pallas kernel; f32
    storage against the Pallas kernel and the jnp oracle (fed the seeds'
    maps in hash mode), outputs at the caller's C and width."""
    from cips3dpp_tpu.kernels.decoder_block import decoder_block_packed_reference as jref
    from cips3dpp_tpu.kernels.decoder_block import hash_noise_map as jmap

    hashed = noise == "hash"
    x = _inputs(c, wp, seed=c + wp)
    feat, rgb = _port(x, torch.bfloat16, hashed, wrgb=t(x["wrgb"]))
    jfeat, jrgb = _pallas(x, jnp.bfloat16, hashed, wrgb=x["wrgb"])
    assert feat.shape == (2 * HP, 2 * wp, c) and rgb.shape == (2 * HP, 2 * wp, 3)
    if hashed:  # hash noise is never stored: f32 in either storage
        np.testing.assert_allclose(a(feat), a(jfeat), rtol=1.6e-2, atol=2e-2)
        np.testing.assert_allclose(a(rgb), a(jrgb), rtol=1.6e-2, atol=2e-2)
    else:
        np.testing.assert_allclose(a(feat), a(jfeat), rtol=0, atol=3.2e-2)
        np.testing.assert_allclose(a(rgb), a(jrgb), rtol=0, atol=1e-2)
    assert np.mean(a(feat) != a(jfeat)) < 0.01  # flips are rare

    feat32 = _port(x, torch.float32, hashed)
    assert feat32.shape == (2 * HP, 2 * wp, c)
    tol = dict(rtol=0, atol=5e-3) if hashed else dict(rtol=2e-2, atol=2e-3)
    np.testing.assert_allclose(a(feat32), a(_pallas(x, jnp.float32, hashed)), **tol)
    maps = ([jmap(2 * HP, 2 * wp, jnp.uint32(s)) for s in SEEDS] if hashed
            else [x["noise1"], x["noise2"]])
    want = jref(x["y1"], *maps, x["w2"], x["b1"], x["b2"], 0.3, -0.2)
    np.testing.assert_allclose(a(feat32), a(want), **tol)


def _unpadded(c, wp, hashed, x, dtype):
    """decoder_block_prepare's operands left at C and the maps at 2 Wp: the
    plain version straight on them."""
    from cips3dpp_torch.kernels import decoder_block as kdb

    prep = {"dtype": dtype, "c": c, "w2t": t(x["w2"]).t().contiguous().to(torch.bfloat16),
            "b1": t(x["b1"]), "b2": t(x["b2"]), "nw": torch.tensor([0.3, -0.2]),
            "wrgbt": t(x["wrgb"]).t().contiguous().to(dtype)}
    if hashed:
        prep["seeds"] = SEEDS
    else:
        prep["n1"] = t(x["noise1"]).reshape(2 * HP, 2 * wp).to(dtype)
        prep["n2"] = t(x["noise2"]).reshape(2 * HP, 2 * wp).to(dtype)
    return kdb.decoder_block_plain(t(x["y1"]), prep)


PAD_CASES = [(1, 128, False), (8, 16, True), (16, 8, True), (144, 16, False),
             (256, 24, False), (288, 20, True), (2176, 12, True)]


@pytest.mark.parametrize("c,wp,hashed", PAD_CASES,
                         ids=[f"C{c}-Wp{w}-{'hash' if h else 'buffers'}"
                              for c, w, h in PAD_CASES])
def test_padded_route_equals_the_unpadded_plain_version(c, wp, hashed):
    """The route the card takes: prepare pads w2, b1, b2, wrgb with zeros
    to kernel_channels(C) and the noise maps to the kernel's width, the
    entry point pads y1 (zero channels, zero columns past Wp: the
    upsample's zero edge) and slices feat and rgb back; hash noise counts
    its pixel ids in the caller's width. It equals the plain version on
    the unpadded operands, and the padded feat channels hold lrelu(noise *
    nw), finite."""
    from cips3dpp_torch.kernels import decoder_block as kdb

    x = _inputs(c, wp, seed=7 * c + wp)
    ck, wk = kdb.kernel_channels(c), kdb.kernel_width(wp)
    assert (ck, wk) != (c, wp)
    for dt in kdb.STORAGE:
        prep = kdb.decoder_block_prepare(
            *((None, None) if hashed else (t(x["noise1"]), t(x["noise2"]))), t(x["w2"]),
            t(x["b1"]), t(x["b2"]), 0.3, -0.2, t(x["wrgb"]), dtype=dt,
            noise_seeds=SEEDS if hashed else None)
        assert prep["c"] == c and prep["w2t"].shape == (ck, ck)
        assert not prep["w2t"][c:].any() and not prep["w2t"][:, c:].any()
        assert not prep["b1"][c:].any() and not prep["wrgbt"][:, c:].any()
        if not hashed:
            assert prep["n1"].shape == (2 * HP, 2 * wk) and not prep["n1"][:, 2 * wp:].any()
        got = kdb.decoder_block_packed(t(x["y1"]), prepared=prep)
        want = _unpadded(c, wp, hashed, x, dt)
        # the kernel's own operands: y1 padded, feat at the kernel's shape
        inner = kdb.decoder_block_plain(kdb._pad_to(t(x["y1"]), HP, wk, ck), prep, width=wp)
        assert inner[0].shape == (2 * HP, 2 * wk, ck)
        assert torch.isfinite(inner[0].float()).all()
        for g, w, i in zip(got, want, inner):
            assert g.shape == w.shape and g.dtype == w.dtype
            torch.testing.assert_close(i[:, :2 * wp, :g.shape[-1]], g, rtol=0, atol=0)
            if dt == torch.float32:
                torch.testing.assert_close(g, w, rtol=0, atol=1e-5)
            else:
                torch.testing.assert_close(g.float(), w.float(), rtol=0, atol=3.2e-2)
                assert float((g != w).float().mean()) <= 1e-3


@pytest.mark.parametrize("c", [3, 48, 144])
def test_k3_matches_pallas_and_oracle(c):
    """K3 at C no built kernel runs (3 -> 16, 48 -> 64, 144 -> 192) and Wp =
    12 (-> 16), through its entry point, against the v1 Pallas kernel in
    interpret mode and its jnp oracle at tests/test_kernels.py's 2e-3."""
    from cips3dpp_tpu.kernels.decoder_block import decoder_block_fused as jfused
    from cips3dpp_tpu.kernels.decoder_block import decoder_block_reference as jref
    from cips3dpp_torch.kernels.decoder_block import decoder_block_fused

    hp, wp = 16, 12
    rng = np.random.default_rng(c)
    n = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    g = 0.1 * np.sqrt(32 / c)  # tests/test_kernels.py's C = 32 gain at every C
    args = (n(hp, wp, c), n(hp, wp, 3), n(2 * hp, 2 * wp, 1), n(2 * hp, 2 * wp, 1),
            g * n(c, c), g * n(c, 3), 0.1 * n(c), 0.1 * n(c), 0.1 * n(3))
    nw = (0.3, 0.2)
    feat, rgb = decoder_block_fused(*[t(v) for v in args], *nw)
    assert feat.shape == (2 * hp, 2 * wp, c) and rgb.shape == (2 * hp, 2 * wp, 3)
    jn = tuple(jnp.asarray(v) for v in nw)
    for want in (jfused(*args, *jn, t_rows=8, interpret=True), jref(*args, *jn)):
        np.testing.assert_allclose(a(feat), a(want[0]), rtol=0, atol=2e-3)
        np.testing.assert_allclose(a(rgb), a(want[1]), rtol=0, atol=2e-3)
