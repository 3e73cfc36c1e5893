"""K2 and K3 at channel counts whose streamed kernel runs a tail pass: the
counts past 256 that are odd multiples of 64 once padded to the next
multiple of 64 (kernel_channels), where block_kernel_wide walks C // 128
passes of 128 output channels and one of 64. The port's route (the plain
version in the kernel's place, at the kernel's C) against the packed
Pallas kernel in interpret mode and its jnp oracle, as
tests/test_torch_port_k2_channels.py runs them: C = 272 (run at 320, m =
17's 1024^2 block), 320 (as it is), 576 (as it is; it ran at 640 before
the tail), 1088 (the 32-pixel tile's tail) and 2112 (the staged build's);
K3 at the same counts against the v1 Pallas kernel and its oracle. Then
the weight layout with a tail pass (chunk_weight: 8 KB chunks after the
full passes' 16 KB ones) inverted, and the bytes into the SMs
(decoder_block_intake) by hand.

Tolerances: tests/test_torch_port_k2_channels.py's (bf16 feat one bf16
ulp of |feat| <= ~4, 3.2e-2, flips under 1%; rgb 1e-2; f32 rtol 2e-2,
atol 2e-3; K3 2e-3).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import a, t

# (C, the kernel's C); y1 (HP, WP, C): 4 x 32 output pixels keep the
# interpret-mode products short
CASES = [(272, 320), (320, 320), (576, 576), (1088, 1088), (2112, 2112)]
HP, WP = 2, 16


def _inputs(c, hp, seed):
    rng = np.random.default_rng(seed)
    # y1 and the noise maps are stored in bf16 by the serving path: draw
    # bf16-exact values
    bf16_exact = lambda shape: a(t(rng.standard_normal(shape)).to(torch.bfloat16))
    return {
        "y1": bf16_exact((hp, WP, c)),
        "noise1": bf16_exact((2 * hp, 2 * WP, 1)),
        "noise2": bf16_exact((2 * hp, 2 * WP, 1)),
        "w2": (rng.standard_normal((c, c)) / np.sqrt(c)).astype(np.float32),
        "b1": (0.1 * rng.standard_normal(c)).astype(np.float32),
        "b2": (0.1 * rng.standard_normal(c)).astype(np.float32),
        "wrgb": (rng.standard_normal((c, 3)) / np.sqrt(c)).astype(np.float32),
    }


@pytest.mark.parametrize("c,ck", CASES, ids=[f"C{c}" for c, _ in CASES])
def test_k2_with_a_tail_pass_matches_pallas_and_oracle(c, ck):
    """bf16 storage with ToRGB folded against the Pallas kernel; f32
    storage against the jnp oracle; the prepared
    operands at the kernel's C, a tail pass of 64 output channels there,
    outputs at the caller's C."""
    from cips3dpp_torch.kernels import decoder_block as kdb
    from cips3dpp_tpu.kernels.decoder_block import decoder_block_packed as jblock
    from cips3dpp_tpu.kernels.decoder_block import decoder_block_packed_reference as jref

    assert kdb.kernel_channels(c) == ck and ck % 128 == 64 and kdb.is_streamed(ck)
    hp = HP
    x = _inputs(c, hp, seed=c + 1)
    ops = {k: t(v) for k, v in x.items()}

    def pallas(dt, **kw):
        return jblock(x["y1"], x["noise1"], x["noise2"], x["w2"], x["b1"], x["b2"], 0.3, -0.2,
                      t_rows=2, interpret=True, out_dtype=dt, colup_dtype=dt, rgb_dtype=dt,
                      **kw)

    for dt in kdb.STORAGE:
        prep = kdb.decoder_block_prepare(ops["noise1"], ops["noise2"], ops["w2"], ops["b1"],
                                         ops["b2"], 0.3, -0.2, ops["wrgb"], dtype=dt)
        assert prep["c"] == c and prep["w2t"].shape == (ck, ck)
        assert prep["w2c"].shape == (ck * ck,)
        feat, rgb = kdb.decoder_block_packed(ops["y1"], prepared=prep)
        assert feat.dtype == dt and feat.shape == (2 * hp, 2 * WP, c)
        assert rgb.shape == (2 * hp, 2 * WP, 3)
        if dt == torch.bfloat16:
            jfeat, jrgb = (a(v) for v in pallas(jnp.bfloat16, wrgb=x["wrgb"]))
            np.testing.assert_allclose(a(feat), jfeat, rtol=0, atol=3.2e-2)
            assert np.mean(a(feat) != jfeat) < 0.01  # flips are rare
            np.testing.assert_allclose(a(rgb), jrgb, rtol=0, atol=1e-2)
        else:
            want = jref(x["y1"], x["noise1"], x["noise2"], x["w2"], x["b1"], x["b2"], 0.3,
                        -0.2)
            np.testing.assert_allclose(a(feat), a(want), rtol=2e-2, atol=2e-3)


@pytest.mark.parametrize("c,ck", CASES, ids=[f"C{c}" for c, _ in CASES])
def test_k3_with_a_tail_pass_matches_pallas_and_oracle(c, ck):
    """K3 at the same counts through its entry point (zero-padded to the
    kernel's C where it is not one) against the v1 Pallas kernel in
    interpret mode and its jnp oracle at tests/test_kernels.py's 2e-3."""
    from cips3dpp_torch.kernels import decoder_block as kdb
    from cips3dpp_tpu.kernels.decoder_block import decoder_block_fused as jfused
    from cips3dpp_tpu.kernels.decoder_block import decoder_block_reference as jref

    hp = HP
    rng = np.random.default_rng(c + 2)
    n = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    g = 0.1 * np.sqrt(32 / c)  # tests/test_kernels.py's C = 32 gain at every C
    args = (n(hp, WP, c), n(hp, WP, 3), n(2 * hp, 2 * WP, 1), n(2 * hp, 2 * WP, 1),
            g * n(c, c), g * n(c, 3), 0.1 * n(c), 0.1 * n(c), 0.1 * n(3))
    nw = (0.3, 0.2)
    assert kdb.fused_launch_name(c) == "decoder_block_fused" + ("_staged" if c > 2048 else "")
    feat, rgb = kdb.decoder_block_fused(*[t(v) for v in args], *nw)
    assert feat.shape == (2 * hp, 2 * WP, c) and rgb.shape == (2 * hp, 2 * WP, 3)
    jn = tuple(jnp.asarray(v) for v in nw)
    for want in (jfused(*args, *jn, t_rows=2, interpret=True), jref(*args, *jn)):
        np.testing.assert_allclose(a(feat), a(want[0]), rtol=0, atol=2e-3)
        np.testing.assert_allclose(a(rgb), a(want[1]), rtol=0, atol=2e-3)


@pytest.mark.parametrize("c", [192, 320, 2112])
def test_weight_chunks_with_a_tail_pass_invert(c):
    """chunk_weight at a C with a tail pass: C // 128 passes of 16 KB
    chunks (128 output x 64 input channels), then C / 64 chunks of 8 KB
    (the last 64 output channels x 64 input channels), each row's 16-byte
    groups swizzled by row % 8. Its inverse gives back w2t bit for bit,
    and decoder_block_prepare carries it."""
    from cips3dpp_torch.kernels import decoder_block as kdb

    gen = torch.Generator().manual_seed(c)
    w2t = torch.randn((c, c), generator=gen).to(torch.bfloat16)
    w2c = kdb.chunk_weight(w2t)
    assert w2c.shape == (c * c,) and w2c.dtype == torch.bfloat16
    full = c // 128
    head = w2c[:full * 128 * c].reshape(full, c // 64, 128, 8, 8)  # pass, chunk, row, group
    tail = w2c[full * 128 * c:].reshape(c // 64, 64, 8, 8)  # chunk, row, group, value
    back = torch.empty_like(w2t)
    for n in range(128):  # group j of row n sits at j ^ (n % 8)
        back[n:full * 128:128] = head[:, :, n, [j ^ (n % 8) for j in range(8)]].reshape(full, c)
    for n in range(64):
        back[full * 128 + n] = tail[:, n, [j ^ (n % 8) for j in range(8)]].reshape(c)
    assert torch.equal(back, w2t)
    # the tail's chunk k, row n, group j: output channel 128 full + n,
    # input channels 64 k + 8 j ..
    for k, n, j in ((0, 0, 0), (c // 64 - 1, 63, 7), (1, 9, 2)):
        assert torch.equal(tail[k, n, j ^ (n % 8)],
                           w2t[128 * full + n, 64 * k + 8 * j:64 * k + 8 * j + 8])
    prep = kdb.decoder_block_prepare(
        torch.zeros(4, 4), torch.zeros(4, 4), w2t.float().t(), torch.zeros(c), torch.zeros(c),
        0.1, 0.1)
    assert torch.equal(prep["w2c"], w2c)


def test_intake_with_a_tail_pass():
    """decoder_block_intake at counts with a tail pass, by hand, at y1 (64,
    64, C): the weight (2 C^2 bytes) once a pair of tiles at every C; past
    2048 each tile reads its whole activation tile (64 x C bf16) back once
    a pass, the tail pass too: 17 reads at 2112."""
    from cips3dpp_torch.kernels import decoder_block as kdb

    for c, ck, tm in ((272, 320, 64), (320, 320, 64), (1088, 1088, 32), (1984, 1984, 32)):
        tiles = 16384 // tm
        assert kdb.decoder_block_intake(64, 64, c) == {
            "tile_pixels": tm, "tiles": tiles, "weight_bytes": tiles // 2 * 2 * ck * ck,
            "activation_bytes": 0, "bytes": tiles // 2 * 2 * ck * ck}
    got = kdb.decoder_block_intake(64, 64, 2112)
    assert got == {"tile_pixels": 64, "tiles": 256, "weight_bytes": 256 * 2112 * 2112,
                   "activation_bytes": 256 * 17 * 64 * 2112 * 2,
                   "bytes": 256 * 2112 * 2112 + 256 * 17 * 128 * 2112}
    assert kdb.staged_scratch_bytes(2112) == 128 * 2112
