"""k x k modulated convs in the decoder (DecoderConfig.kernel_size > 1) of
cips3dpp_torch against the JAX package on the CPU: ModulatedConv2d at
k = 3 and 5 in its plain, upsample and downsample modes, the decoder and a
tiny generator at k = 3, one G step at k = 3, and the routes that take the
1x1 decoder only (the decoder block kernels, serving), which raise.

Weights travel from flax to the port through `io/jax_params.py`. Bounds:
a layer at rtol 1e-5, atol 1e-5 (f32 sums of k*k*Cin products in other
orders); the decoder and the generator at the generator test's rtol 1e-4,
atol 1e-4; the G step's metrics at the step tests' rtol 5e-5 and its
gradients within 5e-3 of each tensor's largest (REL_KXK_G): the 3x3
decoder's gradients lie 2.0e-3 apart between JAX's own jitted and eager
evaluations at this size, the step tests' 2e-3 itself
(`python tests/torch_port_jit_gap.py 71 sdf 3`; 1.5e-5 at k = 1,
`... 61 sdf 1`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_port_train_options as opts
from torch_port_helpers import a, np_tree, t

LAYER = dict(rtol=1e-5, atol=1e-5)
REL_KXK_G = 5e-3
CASES = [(k, mode, demod, h) for k in (3, 5) for mode in ("plain", "up", "down")
         for demod in (True, False) for h in (5, 6)]


def flax_modconv(k, mode, demod, h, cin=6, cout=5, style_dim=8, b=2, seed=0):
    """(flax params, x, style, JAX output) of one ModulatedConv2d."""
    from cips3dpp_tpu.models.layers import ModulatedConv2d as JM

    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, h, h, cin)).astype(np.float32)
    style = rng.standard_normal((b, style_dim)).astype(np.float32)
    m = JM(cout, k, demodulate=demod, upsample=mode == "up", downsample=mode == "down")
    variables = m.init(jax.random.PRNGKey(seed), jnp.asarray(x), jnp.asarray(style))
    return np_tree(variables["params"]), x, style, m.apply(variables, x, style)


@pytest.mark.parametrize("k,mode,demod,h", CASES,
                         ids=[f"k{k}-{m}-{'demod' if d else 'mod'}-h{h}" for k, m, d, h in CASES])
def test_modulated_conv_matches_jax(k, mode, demod, h):
    """The output's shape (2h up; (h - 2) // 2 + 1 down, JAX's VALID
    stride-2 conv after the blur) and values, at odd and even h."""
    from cips3dpp_torch.models.layers import ModulatedConv2d

    p, x, style, want = flax_modconv(k, mode, demod, h)
    layer = ModulatedConv2d(x.shape[-1], want.shape[-1], style.shape[-1], demodulate=demod,
                            upsample=mode == "up", downsample=mode == "down", kernel_size=k)
    # the weight bridge's layouts (the decoder tests below go through it)
    layer.load_state_dict({"weight": t(np.transpose(p["weight"], (3, 2, 0, 1))[None]),
                           "modulation.weight": t(p["modulation"]["weight"].T),
                           "modulation.bias": t(p["modulation"]["bias"])})
    assert layer.weight.shape == (1, want.shape[-1], x.shape[-1], k, k)
    with torch.no_grad():
        got = layer(t(x), t(style))
    assert got.shape == want.shape
    np.testing.assert_allclose(a(got), a(want), **LAYER)


def test_modulated_conv2d_op_matches_jax():
    """ops.modulated_conv2d (weights in torch's layout) against JAX's, at
    k = 3 with its default SAME padding, demodulated and not."""
    from cips3dpp_tpu.ops.modulated import modulated_conv2d as jconv
    from cips3dpp_torch.ops.modulated import modulated_conv2d

    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 7, 6, 4)).astype(np.float32)
    w = rng.standard_normal((3, 3, 4, 5)).astype(np.float32)  # (k, k, in, out)
    s = rng.standard_normal((3, 4)).astype(np.float32)
    for demod in (True, False):
        want = jconv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(s), demodulate=demod)
        got = modulated_conv2d(t(x), t(np.transpose(w, (3, 2, 0, 1))), t(s), demodulate=demod)
        np.testing.assert_allclose(a(got), a(want), **LAYER)


def test_decoder_kxk_matches_jax():
    """A k = 3 decoder from 8^2 features to 16^2 (blocks at 16 and 32, the
    upsample at 32), flax init
    carried by the weight bridge, every conv 3x3 but the ToRGBs (1x1, as
    JAX's)."""
    from cips3dpp_tpu.models.decoder import Decoder as JD
    from cips3dpp_torch.io.jax_params import jax_params_to_state_dict
    from cips3dpp_torch.models.decoder import Decoder

    rng = np.random.default_rng(5)
    jd = JD(size_start=8, size_end=32, in_channel=16, channel_multiplier=1, kernel_size=3,
            upsample_list=(32,))
    feats = rng.standard_normal((2, 8, 8, 16)).astype(np.float32)
    styles = rng.standard_normal((2, jd.n_latent, 32)).astype(np.float32)
    noise = [rng.standard_normal((2,) + sh[1:]).astype(np.float32)
             for sh in jd.noise_shapes(8)]
    variables = jd.init(jax.random.PRNGKey(1), feats, styles, noise)
    # nonzero noise weights and activation biases, so both paths count
    params = jax.tree_util.tree_map_with_path(
        lambda path, v: np.asarray(v) + (0.1 * rng.standard_normal(v.shape)).astype(np.float32)
        if jax.tree_util.keystr(path).endswith(("['noise']['weight']", "['act_bias']"))
        else np.asarray(v), np_tree(variables["params"]))
    want = jd.apply({"params": jax.tree.map(jnp.asarray, params)}, feats, styles, noise)
    dec = Decoder(8, 32, 16, 32, 1, (32,), kernel_size=3)
    sd = jax_params_to_state_dict({"decoder": params})
    dec.load_state_dict({k[len("decoder."):]: v for k, v in sd.items()}, strict=True)
    assert dec.convs[0].conv.weight.shape == (1, 512, 512, 3, 3)
    assert dec.to_rgbs[0].conv.weight.shape[-2:] == (1, 1)
    with torch.no_grad():
        got = dec(t(feats), t(styles), [t(n) for n in noise])
    assert got.shape == (2, 16, 16, 3)
    np.testing.assert_allclose(a(got), a(want), rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def kxk():
    return opts.build(seed=71, kernel_size=3)


def test_generator_kxk_matches_jax(kxk):
    """A tiny generator with the k = 3 decoder (8^2 rays x 4 samples, one
    upsample to 16^2), its forward against flax's: every output; and the
    flax tree carried back by the weight bridge is the port's state dict."""
    from cips3dpp_tpu.core.camera import camera_from_angles as jcam
    from cips3dpp_tpu.models.generator import Generator as JG
    from cips3dpp_torch.core.camera import camera_from_angles
    from cips3dpp_torch.io.jax_params import jax_params_to_state_dict

    s = kxk
    mine = s["g"].state_dict()
    back = jax_params_to_state_dict(s["pg"])
    assert sorted(back) == sorted(mine)
    for k, v in back.items():
        np.testing.assert_array_equal(a(v), a(mine[k]), err_msg=k)
    rng = np.random.default_rng(13)
    zs = [rng.standard_normal((2, 256)).astype(np.float32) for _ in range(2)]
    azim = np.asarray([0.2, -0.1], np.float32)
    elev = np.asarray([0.05, 0.0], np.float32)
    noise = [rng.standard_normal(sh).astype(np.float32)
             for sh in s["g"].decoder.noise_shapes(8)]
    jc = jcam(jnp.asarray(azim), jnp.asarray(elev), 8)
    want = jax.jit(lambda p, zs, n: JG(s["jcfg"]).apply(
        {"params": p}, zs=zs, cam_poses=jc.extrinsics, focals=jc.focal, near=jc.near,
        far=jc.far, noise_bufs=n, perturb=False))(
        jax.tree.map(jnp.asarray, s["pg"]), tuple(map(jnp.asarray, zs)),
        [jnp.asarray(n) for n in noise])
    c = camera_from_angles(t(azim), t(elev), 8)
    with torch.no_grad():
        got = s["g"]([t(z) for z in zs], c.extrinsics, c.focal, c.near, c.far,
                     noise_bufs=[t(n) for n in noise], perturb=False)
    assert got["rgb"].shape == (2, 16, 16, 3)
    for k in ("rgb", "thumb_rgb", "sdf", "mask", "depth", "xyz"):
        np.testing.assert_allclose(a(got[k]), a(want[k]), rtol=1e-4, atol=1e-4, err_msg=k)


def test_g_step_kxk_matches_jax(kxk):
    """One G step through the k = 3 decoder: metrics and every gradient,
    the latter at REL_KXK_G (the module docstring says why)."""
    opts.check_f32(*opts.run_g(kxk, {}), rel=REL_KXK_G)


def test_kxk_decoder_routes_raise(kxk):
    """The decoder block kernels take 1x1 convs, as JAX's do: the fused
    decoder raises at k = 3, and so does the serving path (JAX's would
    read the centre tap of each 3x3 weight without a word)."""
    from cips3dpp_torch import serving
    from cips3dpp_torch.core.camera import camera_from_angles

    g = kxk["g"]
    zs = [torch.zeros((1, 256)), torch.zeros((1, 256))]
    zero = torch.zeros(1)
    c = camera_from_angles(zero, zero, 8)
    with pytest.raises(ValueError, match="kernel_size 3"):
        g(zs, c.extrinsics, c.focal, c.near, c.far, perturb=False, fused_decoder=True,
          generator=torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="kernel_size 3"):
        serving.prepare_trajectory(g, zs, noise_seed=1, device="cpu")
