"""Hash noise, the serving noise made from a seed instead of read from
buffers: the port's integer hash and seeds bit for bit against the JAX
package, its noise maps to f32 rounding, the K2 block's hash mode (plain
version, what the CUDA kernel computes) against the packed Pallas kernel
in interpret mode, and the whole fused decoder driven by one seed.

Why the maps are not exact: log and the sin polynomial are f32 on both
sides, but the CPU's log may differ by an ulp.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import a, port_and_jax_generator, t

U32 = np.array([0, 1, 2, 7, 255, 65535, 65536, 0x7FFFFFFF, 0x80000000,
                0x9E3779B9, 0xABC00000, 0xFFFFFFFE, 0xFFFFFFFF], np.uint32)


def test_hash_u32_and_layer_seed_match_jax_bit_for_bit():
    from cips3dpp_tpu.kernels.decoder_block import _hash_u32, layer_seed as jseed
    from cips3dpp_torch.kernels.decoder_block import hash_u32, layer_seed

    rng = np.random.default_rng(0)
    x = np.concatenate([U32, rng.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32)])
    want = np.asarray(_hash_u32(jnp.asarray(x)))
    got = hash_u32(torch.from_numpy(x.astype(np.int64)))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    assert [hash_u32(int(v)) for v in U32] == [int(v) for v in want[:len(U32)]]
    for base in (0, 1, 42, 0xFFFFFFFF, 2**40 + 5):
        for idx in range(0, 19):
            assert layer_seed(base, idx) == int(jseed(base & 0xFFFFFFFF, idx)), (base, idx)


@pytest.mark.parametrize("seed", [0, 9, 123, 0xFFFFFFFF])
def test_hash_noise_map_matches_jax(seed):
    from cips3dpp_tpu.kernels.decoder_block import hash_noise_map as jmap
    from cips3dpp_torch.kernels.decoder_block import hash_noise_map

    got = hash_noise_map(64, 48, seed, "cpu")
    want = np.asarray(jmap(64, 48, jnp.uint32(seed)))
    assert got.shape == (64, 48, 1) and got.dtype == torch.float32
    np.testing.assert_allclose(a(got), want, rtol=0, atol=1e-5)


def test_hash_noise_statistics():
    """tests/test_kernels.py's checks of the realization: N(0, 1), rows
    decorrelated."""
    from cips3dpp_torch.kernels.decoder_block import hash_noise_map

    big = a(hash_noise_map(256, 256, 9, "cpu"))
    assert abs(big.mean()) < 0.02 and abs(big.std() - 1.0) < 0.02
    flat = big.reshape(256, 256)
    corr = np.corrcoef(flat[:-1].ravel(), flat[1:].ravel())[0, 1]
    assert abs(corr) < 0.02


def _block_inputs(c, hp, wp, frames, seed):
    rng = np.random.default_rng(seed)
    # y1 is stored in the block's dtype: draw bf16-exact values
    y1 = a(t(rng.standard_normal((frames * hp, wp, c))).to(torch.bfloat16))
    return {
        "y1": y1,
        "w2": (rng.standard_normal((c, c)) / np.sqrt(c)).astype(np.float32),
        "b1": (0.1 * rng.standard_normal(c)).astype(np.float32),
        "b2": (0.1 * rng.standard_normal(c)).astype(np.float32),
        "wrgb": (rng.standard_normal((c, 3)) / np.sqrt(c)).astype(np.float32),
    }


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("frames", [1, 2])
def test_block_hash_mode_matches_pallas(dtype, frames):
    """K2 with noise_seeds: the port's plain block against the Pallas
    kernel in interpret mode, C=32, Hp=Wp=16. Every frame of a stacked
    call takes the same realization, which is the seeds' hash_noise_map."""
    _check_block_hash_mode(dtype, frames, 32, seed=frames)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("frames", [1, 2])
@pytest.mark.parametrize("c", [16, 512])
def test_block_hash_mode_matches_pallas_at_c16_and_c512(dtype, frames, c):
    """The same at the kernel's smallest and largest C."""
    _check_block_hash_mode(dtype, frames, c, seed=c + frames)


def _check_block_hash_mode(dtype, frames, c, seed):
    from cips3dpp_tpu.kernels.decoder_block import decoder_block_packed as jblock
    from cips3dpp_torch.kernels.decoder_block import (
        decoder_block_packed, hash_noise_map,
    )

    hp, wp = 16, 16
    x = _block_inputs(c, hp, wp, frames, seed=seed)
    seeds = (123, 456)
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    jdt = jnp.dtype(dtype)
    kw = dict(noise_seeds=seeds, dtype=dt, frames=frames)
    feat, rgb = decoder_block_packed(t(x["y1"]), None, None, t(x["w2"]), t(x["b1"]),
                                     t(x["b2"]), 0.3, -0.2, t(x["wrgb"]), **kw)
    jfeat, jrgb = jblock(
        x["y1"], None, None, x["w2"], x["b1"], x["b2"], 0.3, -0.2, wrgb=x["wrgb"],
        noise_seeds=jnp.asarray(seeds, jnp.uint32), t_rows=8, interpret=True,
        out_dtype=jdt, colup_dtype=jdt, rgb_dtype=jdt, frames=frames)
    assert feat.dtype == dt and feat.shape == (2 * frames * hp, 2 * wp, c)
    if dt == torch.float32:
        tol = dict(rtol=0, atol=5e-3)  # tests/test_kernels.py:346
    else:  # one bf16 ulp of a stored feature, as for buffer noise
        tol = dict(rtol=1.6e-2, atol=2e-2)
    np.testing.assert_allclose(a(feat), a(jfeat), **tol)
    np.testing.assert_allclose(a(rgb), a(jrgb), **tol)

    # the same block fed the seeds' maps as f32 buffers (no rounding of
    # the noise in either storage: hash noise is never stored)
    maps = [hash_noise_map(2 * hp, 2 * wp, s, "cpu") for s in seeds]
    if dt == torch.float32:
        feat_b, rgb_b = decoder_block_packed(
            t(x["y1"]), *maps, t(x["w2"]), t(x["b1"]), t(x["b2"]), 0.3, -0.2,
            t(x["wrgb"]), dtype=dt, frames=frames)
        torch.testing.assert_close(feat_b, feat, rtol=0, atol=0)
        torch.testing.assert_close(rgb_b, rgb, rtol=0, atol=0)
    if frames == 2:  # every frame reuses one realization
        one = decoder_block_packed(t(x["y1"][:hp]), None, None, t(x["w2"]), t(x["b1"]),
                                   t(x["b2"]), 0.3, -0.2, t(x["wrgb"]),
                                   noise_seeds=seeds, dtype=dt)
        torch.testing.assert_close(feat[:2 * hp], one[0], rtol=0, atol=0)


def _decoder_pair():
    """The flagship decoder (channel schedule and upsample list of the
    r1024 config) on 64-channel features: the port's, seeded, with its
    zero-initialised noise weights and biases set to draws, and the same
    weights as the JAX decoder's param tree."""
    from cips3dpp_tpu.models import generator as jg
    from cips3dpp_torch.models import generator as tg

    cfgs = [m.GeneratorConfig(renderer=m.RendererConfig(hidden_dim=64),
                              mapping=m.MappingConfig(n_layers=1),
                              decoder=m.DecoderConfig(mapping_n_layers=1))
            for m in (jg, tg)]
    model, variables = port_and_jax_generator(*cfgs, seed=5)
    rng = np.random.default_rng(6)
    feats = rng.standard_normal((1, 8, 8, 64)).astype(np.float32)
    styles = rng.standard_normal((1, model.decoder.n_latent, 512)).astype(np.float32)
    return variables["params"]["decoder"], model.decoder, feats, styles


def test_decoder_fused_apply_noise_seed_matches_jax():
    """The f32 fused decoder driven by seed 42 (8x8 features up to the
    flagship's 1024 schedule): port against JAX in interpret mode, and the
    port's seed route against the port fed the seed's own buffers (the
    contract of tests/test_kernels.py:387, atol 1e-2; here they agree to
    1e-5).

    Port against JAX is held to max 0.1 and mean 2e-3 (measured 0.053 and
    8.8e-4, mean |rgb| 5.2), not 1e-2. The witnesses below show why:
    - the seed is not the cause: both packages fed the seed's maps as
      buffers differ by the same amount (measured max 0.053, mean 8.7e-4);
    - nothing differs before bf16 rounding: with no block rounding conv_b's
      operands (JAX's f32 XLA up-blocks, fuse_res=(), against the port's
      f32 Decoder) the two packages agree to 1e-3 (measured max 5.0e-5,
      mean 5.7e-6).
    So the gap is bf16 rounding boundaries: an activation that the other
    package's f32 sums put one f32 ulp away, across a boundary, moves by
    one bf16 ulp, and four blocks of up to 256 channels carry such flips to
    the image. The JAX package's own seed route and its route through the
    seed's maps differ the same way here (measured max 0.019)."""
    from cips3dpp_tpu.kernels.decoder_fused import decoder_fused_apply as japply
    from cips3dpp_torch.kernels.decoder_fused import decoder_fused_apply

    params, dec, feats, styles = _decoder_pair()
    kw = dict(upsample_list=(128, 256, 512, 1024), dtype=jnp.float32)
    want = japply(params, feats, styles, None, interpret=True, noise_seed=42, **kw)
    got = decoder_fused_apply(dec, t(feats), t(styles), None, noise_seed=42)
    assert got.shape == (1, 128, 128, 3)
    bufs = dec.hash_noise(42, 8, device="cpu")
    jbufs = [a(b) for b in bufs]
    by_bufs = decoder_fused_apply(dec, t(feats), t(styles), bufs)
    gaps = {
        "seed": np.abs(a(got) - a(want)),
        "seed's buffers": np.abs(
            a(by_bufs) - a(japply(params, feats, styles, jbufs, interpret=True, **kw))),
        "no bf16 rounding": np.abs(
            a(dec(t(feats), t(styles), bufs))
            - a(japply(params, feats, styles, jbufs, fuse_res=(), **kw))),
    }
    report = {k: (float(d.max()), float(d.mean())) for k, d in gaps.items()}
    for k in ("seed", "seed's buffers"):
        assert gaps[k].max() <= 0.1 and gaps[k].mean() <= 2e-3, report
    assert gaps["no bf16 rounding"].max() <= 1e-3, report
    torch.testing.assert_close(by_bufs, got, rtol=0, atol=1e-5)
    # explicit buffers take priority over the seed
    zeros = [torch.zeros_like(b) for b in bufs]
    torch.testing.assert_close(
        decoder_fused_apply(dec, t(feats), t(styles), zeros, noise_seed=42),
        decoder_fused_apply(dec, t(feats), t(styles), zeros), rtol=0, atol=0)
