"""K2 and K3 past C = 8192, where the port once stopped: JAX's packed block
admits every C >= 128 and its v1 block every C, and so does the port,
whose streamed-weight kernel runs every multiple of 64 past 2048 on its
staged build (the activation tile through a scratch in device memory,
shared memory the same at every C). On the CPU the port's route runs the
plain version in the kernel's place.

K2 at C = 8320 (the 128^2 block of a decoder at channel multiplier 65, the
first one past 8192) on a tiny y1 (2, 16, 8320): bf16 storage with ToRGB
folded against the packed Pallas kernel in interpret mode (t_rows 2), f32
storage against its jnp oracle. K3 at C = 8320 on y1
(2, 16, 8320) against the v1 Pallas kernel in interpret mode and its
oracle. Then the admission rules and tiles past 8192, the tiles the
card test holds the staged build's scratch against, and the intake count
(`decoder_block_intake`) chip_smoke.py reports beside K2's times.

Tolerances: tests/test_torch_port_decoder_block.py's (bf16 feat one bf16
ulp of |feat| <= ~4, 3.2e-2, flips under 1%; rgb 1e-2; f32 rtol 2e-2, atol
2e-3) and tests/test_torch_port_k2_channels.py's for K3 (2e-3, at the C =
32 case's gain).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import a, t

C = 8320
HP, WP = 2, 16


def _inputs(c, seed):
    rng = np.random.default_rng(seed)
    # y1 and the noise maps are stored in bf16 by the serving path: draw
    # bf16-exact values
    bf16_exact = lambda shape: a(t(rng.standard_normal(shape)).to(torch.bfloat16))
    w2 = rng.standard_normal((c, c), dtype=np.float32)
    w2 *= np.float32(1 / np.sqrt(c))  # in place: one C x C f32 array
    return {
        "y1": bf16_exact((HP, WP, c)),
        "noise1": bf16_exact((2 * HP, 2 * WP, 1)),
        "noise2": bf16_exact((2 * HP, 2 * WP, 1)),
        "w2": w2,
        "b1": (0.1 * rng.standard_normal(c)).astype(np.float32),
        "b2": (0.1 * rng.standard_normal(c)).astype(np.float32),
        "wrgb": (rng.standard_normal((c, 3)) / np.sqrt(c)).astype(np.float32),
    }


def _pallas(x, dt, **kw):
    from cips3dpp_tpu.kernels.decoder_block import decoder_block_packed as jblock

    return jblock(
        x["y1"], x["noise1"], x["noise2"], x["w2"], x["b1"], x["b2"], 0.3, -0.2,
        t_rows=2, interpret=True, out_dtype=dt, colup_dtype=dt, rgb_dtype=dt, **kw)


def test_k2_past_8192_matches_pallas_and_oracle():
    """K2 at C = 8320 through decoder_block_packed, at the caller's C: bf16
    storage with ToRGB folded against the Pallas kernel; f32 storage
    against the jnp oracle."""
    from cips3dpp_torch.kernels import decoder_block as kdb
    from cips3dpp_tpu.kernels.decoder_block import decoder_block_packed_reference as jref

    x = _inputs(C, seed=C)
    # JAX first, kept as numpy; the port's operands share w2's memory (the
    # case stays near 2 GB)
    xj = {k: jnp.asarray(v) for k, v in x.items()}  # one copy for both JAX calls
    jfeat, jrgb = (a(v) for v in _pallas(xj, jnp.bfloat16, wrgb=xj["wrgb"]))
    want32 = a(jref(xj["y1"], xj["noise1"], xj["noise2"], xj["w2"], xj["b1"], xj["b2"], 0.3,
                    -0.2))
    del xj
    ops = {k: torch.from_numpy(v) for k, v in x.items()}
    for dt in kdb.STORAGE:
        prep = kdb.decoder_block_prepare(ops["noise1"], ops["noise2"], ops["w2"], ops["b1"],
                                         ops["b2"], 0.3, -0.2, ops["wrgb"], dtype=dt)
        assert prep["c"] == C and prep["w2t"].shape == (C, C)
        assert prep["w2c"].shape == (C * C,)
        assert kdb.launch_name(prep) == ("decoder_block_staged" if dt == torch.bfloat16
                                         else "decoder_block_f32_staged")
        feat, rgb = kdb.decoder_block_packed(ops["y1"], prepared=prep)
        del prep
        assert feat.dtype == dt and feat.shape == (2 * HP, 2 * WP, C)
        assert rgb.dtype == torch.float32 and rgb.shape == (2 * HP, 2 * WP, 3)
        if dt == torch.bfloat16:
            np.testing.assert_allclose(a(feat), jfeat, rtol=0, atol=3.2e-2)
            assert np.mean(a(feat) != jfeat) < 0.01  # flips are rare
            np.testing.assert_allclose(a(rgb), jrgb, rtol=0, atol=1e-2)
        else:
            # f32 storage against the oracle alone: the Pallas kernel's
            # interpret mode takes ~12 s a call at this C
            np.testing.assert_allclose(a(feat), want32, rtol=2e-2, atol=2e-3)


def test_k3_past_8192_matches_pallas_and_oracle():
    """K3 at C = 8320 through decoder_block_fused against the v1 Pallas
    kernel in interpret mode and its jnp oracle."""
    from cips3dpp_torch.kernels import decoder_block as kdb
    from cips3dpp_tpu.kernels.decoder_block import decoder_block_fused as jfused
    from cips3dpp_tpu.kernels.decoder_block import decoder_block_reference as jref

    rng = np.random.default_rng(C + 1)
    n = lambda *shape: rng.standard_normal(shape, dtype=np.float32)
    g = 0.1 * np.sqrt(32 / C)  # tests/test_kernels.py's C = 32 gain at every C
    args = (n(HP, WP, C), n(HP, WP, 3), n(2 * HP, 2 * WP, 1), n(2 * HP, 2 * WP, 1),
            g * n(C, C), g * n(C, 3), 0.1 * n(C), 0.1 * n(C), 0.1 * n(3))
    nw = (0.3, 0.2)
    assert kdb.fused_launch_name(C) == "decoder_block_fused_staged"
    feat, rgb = kdb.decoder_block_fused(*[t(v) for v in args], *nw)
    assert feat.shape == (2 * HP, 2 * WP, C) and rgb.shape == (2 * HP, 2 * WP, 3)
    jn = tuple(jnp.asarray(v) for v in nw)
    for want in (jfused(*args, *jn, t_rows=2, interpret=True), jref(*args, *jn)):
        np.testing.assert_allclose(a(feat), a(want[0]), rtol=0, atol=2e-3)
        np.testing.assert_allclose(a(rgb), a(want[1]), rtol=0, atol=2e-3)


# (C, the kernel's C, its tile's output pixels, the staged build)
ADMITTED = [(2176, 2176, 64, True), (8192, 8192, 64, True), (8193, 8256, 64, True),
            (8320, 8320, 64, True), (16384, 16384, 64, True), (46400, 46400, 64, True),
            (2048, 2048, 32, False), (1152, 1152, 32, False)]


@pytest.mark.parametrize("c,ck,tm,staged", ADMITTED, ids=[f"C{v[0]}" for v in ADMITTED])
def test_no_ceiling_past_8192(c, ck, tm, staged):
    """check_k2 and check_k3 admit every C JAX admits, with no upper limit;
    the kernel's C is the next multiple of 64, its tile 64 pixels past
    2048 on the staged build, whose scratch is 64 x C bf16 a CTA. Nothing
    is built or allocated."""
    from cips3dpp_torch.kernels import decoder_block as kdb

    kdb.check_k2(c)
    kdb.check_k2(c, 16)
    kdb.check_k3(c)
    assert kdb.kernel_channels(c) == ck and kdb.is_kernel_channels(ck)
    assert kdb.tile_pixels(c) == tm
    assert kdb.is_staged(ck) == staged and kdb.is_streamed(ck)
    assert kdb.staged_scratch_bytes(ck) == 128 * ck
    assert not hasattr(kdb, "MAX_CHANNELS") and not hasattr(kdb, "CEILING")


@pytest.mark.parametrize("c", [2176, 8320])
def test_staged_activation_layout(c):
    """What the card test holds the staged build's scratch against
    (staged_tiles_plain): each tile's conv_b input, which in f32 storage is
    JAX's oracle's (its upsample, noise1, b1 and lrelu, in bf16 at the
    product), laid out as the kernel's upsample writes it (column_pass
    with SW128 in csrc/decoder_block.cu: channel k of pixel p at
    (k / 64) * 64 * 64 + p * 64 + 8 * (((k / 8) % 8) ^ (p % 8)) + k % 8),
    tiles in the kernel's order over 2 frames of one row and 2 segments.
    The prepared operands are only those the upsample reads."""
    from cips3dpp_torch.kernels import decoder_block as kdb
    from cips3dpp_tpu.kernels.decoder_block import K4
    from cips3dpp_tpu.ops.upfirdn2d import _upsample2x_separable_4tap

    rng = np.random.default_rng(c + 2)
    frames, wp = 2, 32
    y1 = rng.standard_normal((frames, wp, c), dtype=np.float32)
    n1 = rng.standard_normal((2, 2 * wp), dtype=np.float32)
    b1 = (0.1 * rng.standard_normal(c)).astype(np.float32)
    prep = {"dtype": torch.float32, "nw": torch.tensor([0.3, -0.2]), "b1": t(b1), "n1": t(n1)}
    h = kdb.decoder_block_activation_plain(t(y1), prep, frames)
    assert h.shape == (frames, 2, 2 * wp, c) and h.dtype == torch.bfloat16
    for f in range(frames):
        up = _upsample2x_separable_4tap(jnp.asarray(y1[f:f + 1])[None],
                                        np.asarray(K4, np.float32))[0]
        v = up + 0.3 * jnp.asarray(n1)[..., None] + jnp.asarray(b1)
        want = a(jnp.where(v >= 0, v, 0.2 * v) * 1.4142135623730951).astype(np.float32)
        got = a(h[f].float())
        want = a(t(want).to(torch.bfloat16))
        np.testing.assert_allclose(got, want, rtol=2**-7, atol=0)
        assert np.mean(got != want) < 0.01  # another f32 rounding of the blend flips few
    tiles = kdb.staged_tiles_plain(t(y1), prep, frames)
    assert tiles.shape == (4, kdb.staged_scratch_bytes(c) // 2)
    p = torch.arange(64)[:, None]
    k = torch.arange(c)[None, :]
    at = (k >> 6) * 4096 + p * 64 + ((((k >> 3) & 7) ^ (p & 7)) << 3) + (k & 7)
    for i in range(4):  # tile i: frame i // 2, columns 32 (i % 2) .. of both output rows
        tile = h[i // 2, :, 32 * (i % 2):32 * (i % 2) + 32].reshape(64, c)
        want = torch.empty(64 * c, dtype=torch.bfloat16)
        want[at.reshape(-1)] = tile.reshape(-1)
        assert torch.equal(tiles[i], want), i


def test_intake_count():
    """decoder_block_intake, the bytes into the SMs chip_smoke.py prints
    beside the streamed kernel's times, by hand: at y1 (64, 64, C), 4 x 64 x
    64 = 16384 output pixels; with clusters of 2 the weight comes in once a
    pair of tiles, and past C = 2048 each tile reads its activations back
    once a 128-channel pass."""
    from cips3dpp_torch.kernels import decoder_block as kdb

    for c, tm in ((1024, 64), (2048, 32)):  # the activation stays in shared memory
        got = kdb.decoder_block_intake(64, 64, c)
        tiles = 16384 // tm
        assert got == {"tile_pixels": tm, "tiles": tiles, "weight_bytes": tiles // 2 * 2 * c * c,
                       "activation_bytes": 0, "bytes": tiles // 2 * 2 * c * c}
    for c in (2176, 4096, 8192, 8320, 16384):
        got = kdb.decoder_block_intake(64, 64, c)
        # 256 tiles: 128 cluster groups x 2 C^2 of weight, 256 x C^2 of activation
        assert got == {"tile_pixels": 64, "tiles": 256, "weight_bytes": 256 * c * c,
                       "activation_bytes": 256 * c * c, "bytes": 512 * c * c}
    assert kdb.decoder_block_intake(64, 64, 8192)["bytes"] == 34359738368  # 34.4 GB
    # padded: C = 8193 runs at 8256 (64 passes and a tail: 65 reads of the
    # tile, 8320 channels' worth); Wp = 20 at 32; 3 frames of Hp = 1; a
    # cluster of 4 leaves the last group part-full
    got = kdb.decoder_block_intake(1, 20, 8193, frames=3, cluster=4)
    assert got["tiles"] == 3 * 32 * 4 // 64 == 6
    assert got["weight_bytes"] == 2 * 2 * 8256 * 8256
    assert got["activation_bytes"] == 6 * 8320 * 8256
    with pytest.raises(ValueError, match="shared memory"):
        kdb.decoder_block_intake(64, 64, 256)
