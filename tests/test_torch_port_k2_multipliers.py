"""The fused decoder at channel multipliers with blocks no built kernel
runs as they are (9: C = 1152, 576, 288, 144, of which 288 and 144 run at
320 and 192; 17: 2176, 1088, 544, 272, of which 544 and 272 run at 576 and
320) against the flax Decoder and against its own route with nothing padded,
and preset_serving refusing the multipliers whose blocks JAX's packed
block refuses (3 and 6).

Bounds: against the flax Decoder (f32 throughout) the blocks round
conv_b's operands to bf16, a few parts in 2^9 of |rgb| ~1.3-1.8: max 0.1,
mean 1e-2 (measured max / mean 0.032 / 5.8e-3 at m = 9, 0.018 / 3.2e-3 at
m = 17, 0.017 / 3.2e-3 with two plain steps, with the blocks padded to
multiples of 128 as they were before the tail pass; a decoder at m = 2, which
pads nothing, lies 3.0e-3 from flax by the same rounding); against the
same route with the counts left unpadded (kernel_channels the identity,
which the plain version takes) only the order of f32 sums over zero rows
differs, which flips a rare bf16 rounding by one ulp: the decoder block
tests' 3.2e-2, mean 3e-4 (measured 6.4e-3 / 1.2e-5 at m = 9, 8.9e-3 /
6.7e-5 at m = 17, 2.9e-6 / 5.5e-7 with two plain steps).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import a, t

# the four upsample blocks' C at channel multipliers 9 and 17, and the
# counts the built kernels run them at
ALL_UP = (128, 256, 512, 1024)
# (m, upsample list): the four upsample blocks; two followed by two plain
# steps (576 runs as it is: their first conv reads an unpadded feat); and
# three followed by one plain step, whose conv reads a padded feat (288 ->
# 320 channels)
CASES = [(9, ALL_UP), (17, ALL_UP), (9, (128, 256)), (9, (128, 256, 512))]
BLOCKS = {(9, ALL_UP): ([1152, 576, 288, 144], [1152, 576, 320, 192]),
          (17, ALL_UP): ([2176, 1088, 544, 272], [2176, 1088, 576, 320]),
          (9, (128, 256)): ([1152, 576], [1152, 576]),
          (9, (128, 256, 512)): ([1152, 576, 288], [1152, 576, 320])}


@pytest.mark.parametrize("m,ups", CASES, ids=["m9", "m17", "m9-two-plain-steps",
                                             "m9-one-plain-step"])
def test_fused_decoder_matches_flax_at_multiplier(m, ups):
    """decoder_fused_apply (f32 storage, the serving path's prepare padding
    conv_a's columns and the next reader's rows) against the flax Decoder
    at channel multiplier m: size_start 64, 4x4 features, the upsample
    blocks of `ups` (to 64x64, or to 16x16 or 32x32 then plain steps), weights
    carried by the bridge. The blocks run at the padded counts, y1 made at
    them (one block call a block, no padding a frame); the route equals
    itself with nothing padded (the module's bounds)."""
    from cips3dpp_tpu.models.decoder import Decoder as JD
    from cips3dpp_torch.io.jax_params import jax_params_to_state_dict
    from cips3dpp_torch.kernels import decoder_block as kdb
    from cips3dpp_torch.kernels import decoder_fused as kdf
    from cips3dpp_torch.models.decoder import Decoder

    rng = np.random.default_rng(m + len(ups))
    jd = JD(size_start=64, size_end=1024, in_channel=16, channel_multiplier=m,
            upsample_list=ups)
    feats = rng.standard_normal((1, 4, 4, 16)).astype(np.float32)
    styles = rng.standard_normal((1, jd.n_latent, 32)).astype(np.float32)
    noise = [rng.standard_normal(sh).astype(np.float32) for sh in jd.noise_shapes(4)]
    # the parameter tree's shapes, filled from the seed (flax's own init
    # draws 20M values op by op): weights N(0, 1), modulation biases near
    # their init 1, noise weights and the biases 0.1 N(0, 1)

    def draw(path, v):
        key = jax.tree_util.keystr(path)
        x = rng.standard_normal(v.shape).astype(np.float32)
        if key.endswith("['modulation']['bias']"):
            return 1 + 0.1 * x
        if key.endswith(("['noise']['weight']", "['act_bias']", "['bias']")):
            return 0.1 * x
        return x

    shapes = jax.eval_shape(lambda: jd.init(jax.random.PRNGKey(m), feats, styles, noise))
    params = jax.tree_util.tree_map_with_path(draw, shapes["params"])
    # jitted: one compile, where op by op the first apply compiles each op
    want = jax.jit(jd.apply)({"params": jax.tree.map(jnp.asarray, params)}, feats, styles,
                             noise)
    dec = Decoder(64, 1024, 16, 32, m, ups)
    sd = jax_params_to_state_dict({"decoder": params})
    dec.load_state_dict({k[len("decoder."):]: v for k, v in sd.items()}, strict=True)

    prep = kdf.decoder_fused_prepare(dec, t(styles), [t(n) for n in noise], fold_rgb=False)
    fused = [b for b in prep["blocks"] if "bp" in b]
    assert [b["bp"]["c"] for b in fused] == BLOCKS[m, ups][0]
    assert [b["bp"]["w2t"].shape[0] for b in fused] == BLOCKS[m, ups][1]
    calls = []
    saved = kdf.decoder_block_packed
    kdf.decoder_block_packed = lambda *a, **k: calls.append(a[0].shape) or saved(*a, **k)
    try:
        with torch.no_grad():
            got = kdf.decoder_fused_apply(dec, t(feats), t(styles), [t(n) for n in noise])
    finally:
        kdf.decoder_block_packed = saved
    # y1 comes at the kernel's C: no padding a frame
    assert [s[-1] for s in calls] == BLOCKS[m, ups][1]
    side = 4 * 2 ** len(ups)
    assert got.shape == want.shape == (1, side, side, 3)
    d = np.abs(a(got) - a(want))
    assert d.max() <= 0.1 and d.mean() <= 1e-2, (float(d.max()), float(d.mean()))
    saved = kdb.kernel_channels, kdf.kernel_channels
    kdb.kernel_channels = kdf.kernel_channels = lambda c: c
    try:
        with torch.no_grad():
            unpadded = kdf.decoder_fused_apply(dec, t(feats), t(styles), [t(n) for n in noise])
    finally:
        kdb.kernel_channels, kdf.kernel_channels = saved
    d = np.abs(a(got) - a(unpadded))
    assert d.max() <= 3.2e-2 and d.mean() <= 3e-4, (float(d.max()), float(d.mean()))
    with torch.no_grad():
        plain = dec(t(feats), t(styles), [t(n) for n in noise])
    np.testing.assert_allclose(a(plain), a(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("m", [3, 6])
def test_serving_refuses_what_jax_refuses(m):
    """preset_serving at channel multiplier m, whose 512^2 and 1024^2
    blocks have C = 96 and 48 (m = 3) and 192 and 96 (m = 6): at the first
    block JAX's packed block refuses (96), prepare_trajectory raises
    quoting JAX's rule, as JAX's serving path asserts, before any block's
    library is built or loaded."""
    import dataclasses

    from cips3dpp_torch import serving
    from cips3dpp_torch.kernels import _lib
    from cips3dpp_torch.models.generator import Generator, preset_serving

    base = preset_serving()
    cfg = dataclasses.replace(
        base, decoder=dataclasses.replace(base.decoder, channel_multiplier=m))
    model = Generator(cfg, device="cpu", seed=m)
    gen = torch.Generator().manual_seed(m)
    zs = [torch.randn((1, 256), generator=gen) for _ in range(2)]
    noise = model.decoder.make_noise(gen, cfg.img_size, device="cpu")
    built = []
    saved = _lib.build, _lib.load
    _lib.build = _lib.load = lambda *a, **k: built.append(a)
    try:
        with pytest.raises(ValueError, match=r"C = 96 is not admitted .*c >= 128"):
            serving.prepare_trajectory(model, zs, noise_bufs=noise, device="cpu")
    finally:
        _lib.build, _lib.load = saved
    assert built == []
