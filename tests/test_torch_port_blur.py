"""The decoder's `blur_kernel` other than (1, 3, 3, 1) on the plain path,
against the JAX package on the CPU: `upsample2x` (a 4-tap kernel as
shift-adds, any other through upfirdn2d with the Upsample pads),
ModulatedConv2d at k = 1 and 3 with upsample or downsample, ToRGB's skip
upsample, and a Decoder with a 3-tap blur; then the fused decoder, whose
block kernels blur with (1, 3, 3, 1) only, raising on it.

Bounds: the kxk tests' (tests/test_torch_port_kxk.py): a layer at rtol
1e-5, atol 1e-5 (f32 sums of the FIR taps and the k*k*Cin products in
other orders), the decoder at rtol 1e-4, atol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import a, np_tree, t

LAYER = dict(rtol=1e-5, atol=1e-5)
BLURS = [(1, 2, 1), (1, 3, 3, 1), (1, 4, 6, 4, 1)]


@pytest.mark.parametrize("blur", BLURS, ids=["3tap", "4tap", "5tap"])
def test_upsample2x_matches_jax(blur):
    """(B, H, W, C) -> (B, 2H, 2W, C) at odd and even sides."""
    from cips3dpp_tpu.ops.upfirdn2d import upsample2x as jup
    from cips3dpp_torch.ops.upfirdn2d import upsample2x

    x = np.random.default_rng(len(blur)).standard_normal((2, 5, 6, 3)).astype(np.float32)
    got = upsample2x(t(x), blur)
    want = jup(jnp.asarray(x), blur)
    assert got.shape == (2, 10, 12, 3) == want.shape
    np.testing.assert_allclose(a(got), a(want), **LAYER)


def _load_modconv(layer, p, prefix=""):
    """A flax ModulatedConv2d's params into the port's layer (the weight
    bridge's layouts)."""
    layer.load_state_dict({
        prefix + "weight": t(np.transpose(p["weight"], (3, 2, 0, 1))[None]),
        prefix + "modulation.weight": t(p["modulation"]["weight"].T),
        prefix + "modulation.bias": t(p["modulation"]["bias"])}, strict=False)


MODCONV = [(1, "up", (1, 2, 1)), (3, "up", (1, 2, 1)), (3, "up", (1, 4, 6, 4, 1)),
           (3, "down", (1, 2, 1)), (3, "down", (1, 4, 6, 4, 1))]


@pytest.mark.parametrize("k,mode,blur", MODCONV,
                         ids=[f"k{k}-{m}-{len(b)}tap" for k, m, b in MODCONV])
def test_modulated_conv_blur_matches_jax(k, mode, blur):
    """ModulatedConv2d with a non-default blur: k = 1 upsample (modulate,
    then upsample2x), k = 3 upsample (stride-2 transposed conv, then the
    blur with pads from its length) and downsample (the blur, then a
    stride-2 conv)."""
    from cips3dpp_tpu.models.layers import ModulatedConv2d as JM
    from cips3dpp_torch.models.layers import ModulatedConv2d

    rng = np.random.default_rng(k + len(blur))
    x = rng.standard_normal((2, 6, 6, 4)).astype(np.float32)
    style = rng.standard_normal((2, 8)).astype(np.float32)
    jm = JM(5, k, upsample=mode == "up", downsample=mode == "down", blur_kernel=blur)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(style))
    want = jm.apply(variables, x, style)
    layer = ModulatedConv2d(4, 5, 8, upsample=mode == "up", downsample=mode == "down",
                            kernel_size=k, blur_kernel=blur)
    _load_modconv(layer, np_tree(variables["params"]))
    with torch.no_grad():
        got = layer(t(x), t(style))
    assert got.shape == want.shape
    np.testing.assert_allclose(a(got), a(want), **LAYER)


def test_to_rgb_skip_blur_matches_jax():
    """ToRGB's field blurs the upsampled skip."""
    from cips3dpp_tpu.models.layers import ToRGB as JT
    from cips3dpp_torch.models.layers import ToRGB

    rng = np.random.default_rng(3)
    x = rng.standard_normal((1, 8, 8, 6)).astype(np.float32)
    skip = rng.standard_normal((1, 4, 4, 3)).astype(np.float32)
    style = rng.standard_normal((1, 8)).astype(np.float32)
    jt = JT(upsample=True, blur_kernel=(1, 2, 1))
    variables = jt.init(jax.random.PRNGKey(1), x, style, skip)
    p = np_tree(variables["params"])
    want = jt.apply(variables, x, style, skip)
    rgb = ToRGB(6, 8, upsample=True, blur_kernel=(1, 2, 1))
    _load_modconv(rgb, p["conv"], "conv.")
    with torch.no_grad():
        rgb.bias.copy_(t(p["bias"] + 0.1).reshape(1, 3, 1, 1))
    want = want + 0.1
    with torch.no_grad():
        got = rgb(t(x), t(style), t(skip))
    np.testing.assert_allclose(a(got), a(want), **LAYER)


def _decoders(blur):
    """The flax Decoder with `blur` (4^2 features to 16^2, upsampling at
    16 and 32) and the port's with the same weights (the bridge), nonzero
    noise weights and biases; and its inputs."""
    from cips3dpp_tpu.models.decoder import Decoder as JD
    from cips3dpp_torch.io.jax_params import jax_params_to_state_dict
    from cips3dpp_torch.models.decoder import Decoder

    rng = np.random.default_rng(9)
    jd = JD(size_start=8, size_end=32, in_channel=16, channel_multiplier=1,
            upsample_list=(16, 32), blur_kernel=blur)
    feats = rng.standard_normal((1, 4, 4, 16)).astype(np.float32)
    styles = rng.standard_normal((1, jd.n_latent, 32)).astype(np.float32)
    noise = [rng.standard_normal(sh).astype(np.float32) for sh in jd.noise_shapes(4)]
    variables = jd.init(jax.random.PRNGKey(2), feats, styles, noise)
    params = jax.tree_util.tree_map_with_path(
        lambda path, v: np.asarray(v) + (0.1 * rng.standard_normal(v.shape)).astype(np.float32)
        if jax.tree_util.keystr(path).endswith(("['noise']['weight']", "['act_bias']"))
        else np.asarray(v), np_tree(variables["params"]))
    want = jd.apply({"params": jax.tree.map(jnp.asarray, params)}, feats, styles, noise)
    dec = Decoder(8, 32, 16, 32, 1, (16, 32), blur_kernel=blur)
    sd = jax_params_to_state_dict({"decoder": params})
    dec.load_state_dict({k[len("decoder."):]: v for k, v in sd.items()}, strict=True)
    return dec, feats, styles, noise, want


def test_decoder_blur_kernel_matches_flax():
    """Decoder(blur_kernel=(1, 2, 1)): its upsampling StyledConvs blur with
    it, its ToRGBs' skip keeps (1, 3, 3, 1), as JAX's Decoder passes the
    field (cips3dpp_tpu/models/decoder.py:108, 125, 131)."""
    dec, feats, styles, noise, want = _decoders((1, 2, 1))
    assert dec.convs[0].conv.blur_kernel == (1, 2, 1)
    assert dec.to_rgbs[0].blur_kernel == (1, 3, 3, 1)
    with torch.no_grad():
        got = dec(t(feats), t(styles), [t(n) for n in noise])
    assert got.shape == want.shape == (1, 16, 16, 3)
    np.testing.assert_allclose(a(got), a(want), rtol=1e-4, atol=1e-4)


def test_fused_decoder_raises_on_a_3tap_blur():
    """The block kernels blur with (1, 3, 3, 1): decoder_fused_prepare, and
    so decoder_fused_apply, Generator's fused route and serving, raise on
    a decoder with another blur (JAX's fused path applies (1, 3, 3, 1)
    whatever the field says)."""
    from cips3dpp_torch import serving
    from cips3dpp_torch.core.camera import camera_from_angles
    from cips3dpp_torch.kernels.decoder_fused import decoder_fused_apply
    from cips3dpp_torch.models.decoder import Decoder
    from cips3dpp_torch.models.generator import (
        DecoderConfig, Generator, GeneratorConfig, RendererConfig,
    )
    from cips3dpp_torch.models.layers import init_parameters

    dec = Decoder(8, 32, 16, 32, 1, (16, 32), blur_kernel=(1, 2, 1))
    gen = torch.Generator().manual_seed(0)
    feats = torch.randn((1, 4, 4, 16), generator=gen)
    styles = torch.randn((1, dec.n_latent, 32), generator=gen)
    noise = dec.make_noise(gen, 4)
    with pytest.raises(ValueError, match=r"blur with \(1, 3, 3, 1\).*\(1, 2, 1\)"):
        decoder_fused_apply(dec, feats, styles, noise)

    cfg = GeneratorConfig(renderer=RendererConfig(n_layers=2, hidden_dim=16),
                          decoder=DecoderConfig(size_end=16, upsample_list=(16,), style_dim=32,
                                                mapping_n_layers=1),
                          img_size=8, n_samples=4)
    model = Generator(cfg, device="cpu", seed=1)
    d = model.decoder
    model.decoder = init_parameters(
        Decoder(d.size_start, d.size_end, cfg.renderer.hidden_dim, 32, d.channel_multiplier,
                d.upsample_list, blur_kernel=(1, 2, 1)), gen)
    zs = [torch.randn((1, 256), generator=gen) for _ in range(2)]
    bufs = model.decoder.make_noise(gen, cfg.img_size)
    with pytest.raises(ValueError, match="blur_kernel"):
        serving.prepare_trajectory(model, zs, noise_bufs=bufs, device="cpu")
    c = camera_from_angles(torch.zeros(1), torch.zeros(1), cfg.img_size)
    with pytest.raises(ValueError, match="blur_kernel"):
        model(zs, c.extrinsics, c.focal, c.near, c.far, noise_bufs=bufs, fused_decoder=True)
    # the plain route renders it
    out = model(zs, c.extrinsics, c.focal, c.near, c.far, noise_bufs=bufs)
    assert out["rgb"].shape == (1, 16, 16, 3) and torch.isfinite(out["rgb"]).all()
