"""The training modules of cips3dpp_torch against the JAX package on the
CPU: cameras and perturbed z-values, upfirdn2d, the discriminator layers,
both discriminators (forward and the R1 gradient of gradient), DiffAugment,
the losses, the thumbnail resize and pixel gathers, the weight bridges of
both discriminators and the clipped Adam.

Inputs are drawn with numpy from a seed; JAX's own random draws (threefry)
are reproduced in the tests and handed to the port as tensors. Both sides
run f32 (the JAX side at "highest" matmul precision, tests/conftest.py).
Tolerances: forward values rtol 1e-5 (atol 1e-5 where values cross zero);
gradients within 1e-4 of the largest |gradient| of their tensor ("REL"),
the residue of f32 sums in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import a, np_tree, t
from torch_port_train_helpers import FWD, assert_rel, grads_by_name, port_and_jax_d, \
    port_and_jax_pose_d



def randomize_biases(tree, seed):
    """Nonzero draws for the zero-initialised biases, so bias paths count."""
    rng = np.random.default_rng(seed)

    def f(path, x):
        if "bias" in str(path[-1]):
            return (0.1 * rng.standard_normal(x.shape)).astype(np.float32)
        return np.array(x, np.float32)

    return jax.tree_util.tree_map_with_path(f, tree)


# ----------------------------------------------------------------- cameras --


@pytest.mark.parametrize("uniform", [False, True])
def test_sample_cameras_matches_jax_draws(uniform):
    from cips3dpp_tpu.core.camera import sample_cameras as jsample
    from cips3dpp_torch.core.camera import sample_cameras

    key = jax.random.PRNGKey(3)
    want = jsample(key, 5, 64, uniform=uniform)
    ka, ke = jax.random.split(key)
    draw = jax.random.uniform if uniform else jax.random.normal
    draws = (t(draw(ka, (5,))), t(draw(ke, (5,))))
    got = sample_cameras(None, 5, 64, uniform=uniform, draws=draws)
    for name in want._fields:
        np.testing.assert_allclose(a(getattr(got, name)), a(getattr(want, name)),
                                   err_msg=name, rtol=1e-5, atol=1e-6)
    drawn = sample_cameras(torch.Generator().manual_seed(0), 5, 64, uniform=uniform)
    assert drawn.extrinsics.shape == (5, 3, 4)
    if uniform:
        assert float(drawn.viewpoint[:, 0].abs().max()) <= 0.3


def test_perturbed_z_vals_match_jax():
    from cips3dpp_tpu.core.rays import get_z_vals as jz
    from cips3dpp_torch.core.rays import get_z_vals

    rng = np.random.default_rng(0)
    rays_d = rng.standard_normal((2, 4, 4, 3)).astype(np.float32)
    near, far = np.full((2, 1, 1), 0.88, np.float32), np.full((2, 1, 1), 1.12, np.float32)
    key = jax.random.PRNGKey(5)
    want = jz(jnp.asarray(near), jnp.asarray(far), jnp.asarray(rays_d), 6,
              perturb=True, key=key)
    t_rand = t(jax.random.uniform(key, (2, 4, 4, 1)))
    got = get_z_vals(t(near), t(far), t(rays_d), 6, perturb=True, t_rand=t_rand)
    np.testing.assert_allclose(a(got), a(want), rtol=1e-6, atol=1e-7)


# --------------------------------------------------------------- upfirdn2d --


@pytest.mark.parametrize("kernel,up,down,pad", [
    ((1, 3, 3, 1), 1, 1, (2, 1)),
    ((1, 3, 3, 1), 1, 2, (1, 1)),
    ((1, 3, 3, 1), 2, 1, (2, 1)),
    ((1, 2, 1), 2, 2, (1, 1)),
])
def test_upfirdn2d_matches_jax(kernel, up, down, pad):
    from cips3dpp_tpu.ops.upfirdn2d import make_blur_kernel as jkernel
    from cips3dpp_tpu.ops.upfirdn2d import upfirdn2d as jup
    from cips3dpp_torch.ops.upfirdn2d import make_blur_kernel, upfirdn2d

    x = np.random.default_rng(1).standard_normal((2, 9, 9, 5)).astype(np.float32)
    want = jup(jnp.asarray(x), jkernel(kernel, up), up=up, down=down, pad=pad)
    got = upfirdn2d(t(x).permute(0, 3, 1, 2), make_blur_kernel(kernel, up), up=up,
                    down=down, pad=pad).permute(0, 2, 3, 1)
    np.testing.assert_allclose(a(got), a(want), **FWD)


def test_blur_and_downsample2x_match_jax():
    import importlib

    # the JAX package's ops/__init__ exports a function of the module's name
    ju = importlib.import_module("cips3dpp_tpu.ops.upfirdn2d")
    tu = importlib.import_module("cips3dpp_torch.ops.upfirdn2d")

    x = np.random.default_rng(2).standard_normal((2, 16, 16, 4)).astype(np.float32)
    xt = t(x).permute(0, 3, 1, 2)
    want = ju.downsample2x(jnp.asarray(x))
    got = tu.downsample2x(xt).permute(0, 2, 3, 1)
    np.testing.assert_allclose(a(got), a(want), **FWD)
    for pad in ((2, 2), (2, 1)):
        want = ju.blur(jnp.asarray(x), ju.make_blur_kernel((1, 3, 3, 1)), pad=pad)
        got = tu.blur(xt, tu.separable_taps((1, 3, 3, 1)), pad)
        np.testing.assert_allclose(a(got.permute(0, 2, 3, 1)), a(want), **FWD)


# ------------------------------------------------------------- D layers ----


def test_resblock_and_bilinear_downsample_match_jax():
    """ResBlock covers EqualConv2d, Blur and ConvLayer (with and without
    downsampling and activation); the fade-path bilinear resize too."""
    from cips3dpp_tpu.models.discriminator import ResBlock as JRes
    from cips3dpp_tpu.models.layers import torch_bilinear_downsample as jbil
    from cips3dpp_torch.models.discriminator import ResBlock
    from cips3dpp_torch.models.layers import torch_bilinear_downsample

    x = np.random.default_rng(3).standard_normal((2, 8, 8, 6)).astype(np.float32)
    jr = JRes(6, 10)
    tmpl = jax.eval_shape(jr.init, jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    rng = np.random.default_rng(1)
    p = jax.tree.map(lambda s: rng.standard_normal(s.shape).astype(np.float32), tmpl)
    p = randomize_biases(p, 1)
    conv = lambda w: torch.from_numpy(np.ascontiguousarray(np.transpose(w, (3, 2, 0, 1))))
    sd = {"conv1.0.weight": conv(p["conv1"]["EqualConv2d_0"]["weight"]),
          "conv1.1.bias": t(p["conv1"]["act_bias"]),
          "conv2.1.weight": conv(p["conv2"]["EqualConv2d_0"]["weight"]),
          "conv2.2.bias": t(p["conv2"]["act_bias"]),
          "skip.1.weight": conv(p["skip"]["EqualConv2d_0"]["weight"])}
    tr = ResBlock(6, 10)
    tr.load_state_dict(sd, strict=True)
    want = jax.jit(jr.apply)({"params": p}, jnp.asarray(x))
    got = tr(t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(a(got), a(want), **FWD)
    for size in (4, 2):
        np.testing.assert_allclose(
            a(torch_bilinear_downsample(t(x).permute(0, 3, 1, 2), size).permute(0, 2, 3, 1)),
            a(jbil(jnp.asarray(x), size)), **FWD)


@pytest.mark.parametrize("b,split", [(4, None), (6, None), (2, None), (8, 4)])
def test_minibatch_stddev_matches_jax(b, split):
    from cips3dpp_tpu.models.discriminator import minibatch_stddev as jstd
    from cips3dpp_torch.models.discriminator import minibatch_stddev

    x = np.random.default_rng(b).standard_normal((b, 4, 4, 5)).astype(np.float32)
    want = jstd(jnp.asarray(x), split=split)
    got = minibatch_stddev(t(x).permute(0, 3, 1, 2), split=split).permute(0, 2, 3, 1)
    np.testing.assert_allclose(a(got), a(want), **FWD)


# ------------------------------------------------------ discriminators -----


@pytest.fixture(scope="module")
def image_d():
    return port_and_jax_d(seed=2)


@pytest.fixture(scope="module")
def pose_d():
    return port_and_jax_pose_d(seed=3)


def test_d_weight_bridges_match_the_exporters(image_d, pose_d):
    from cips3dpp_tpu.io.torch_import import export_d_pose_state_dict, \
        export_d_stylegan_state_dict
    from cips3dpp_torch.io.jax_params import jax_d_params_to_state_dict, \
        jax_d_pose_params_to_state_dict

    for (_, params, model), export, bridge in (
            (image_d, export_d_stylegan_state_dict, jax_d_params_to_state_dict),
            (pose_d, export_d_pose_state_dict, jax_d_pose_params_to_state_dict)):
        want = export({"params": params})
        got = bridge(np_tree(params))  # the round trip gives the port's weights
        assert sorted(got) == sorted(want) == sorted(model.state_dict())
        for k, w in want.items():
            np.testing.assert_array_equal(a(got[k]), np.asarray(w, np.float32), err_msg=k)
            np.testing.assert_array_equal(a(got[k]), a(model.state_dict()[k]), err_msg=k)


@pytest.mark.parametrize("size,alpha", [(16, 0.5), (8, 1.0)])
def test_image_d_forward_and_r1_match_jax(image_d, size, alpha):
    """Forward at two input sizes (the fade branch live at alpha 0.5), and
    R1's gradient with respect to every D parameter (grad of grad)."""
    from cips3dpp_tpu.train.losses import r1_penalty as jr1
    from cips3dpp_torch.io.jax_params import jax_d_params_to_state_dict
    from cips3dpp_torch.train.losses import r1_penalty

    jd, params, td = image_d
    x = (0.5 * np.random.default_rng(size).standard_normal((4, size, size, 3))).astype(np.float32)
    want = jax.jit(lambda p, im: jd.apply({"params": p}, im, alpha=alpha))(params, jnp.asarray(x))
    xt = t(x).requires_grad_(True)
    got = td(xt, alpha)
    np.testing.assert_allclose(a(got), a(want), **FWD)
    r1 = r1_penalty(got, xt)
    jfn = lambda p: jr1(lambda im: jd.apply({"params": p}, im, alpha=alpha), jnp.asarray(x))
    jval, jgrads = jax.jit(jax.value_and_grad(jfn))(params)
    np.testing.assert_allclose(float(r1.detach()), float(jval), rtol=1e-5)
    want_g = jax_d_params_to_state_dict(np_tree(jgrads))
    for name, g in grads_by_name(td, r1).items():
        assert_rel(g, want_g[name], name=name)


def test_pose_d_forward_and_r1_match_jax(pose_d):
    from cips3dpp_tpu.train.losses import r1_penalty as jr1
    from cips3dpp_torch.io.jax_params import jax_d_pose_params_to_state_dict
    from cips3dpp_torch.train.losses import r1_penalty

    jp, params, tp = pose_d
    x = (0.5 * np.random.default_rng(4).standard_normal((3, 16, 16, 3))).astype(np.float32)
    want_gan, want_view = jax.jit(lambda p, im: jp.apply({"params": p}, im, alpha=0.5))(
        params, jnp.asarray(x))
    xt = t(x).requires_grad_(True)
    gan, view = tp(xt, 0.5)
    np.testing.assert_allclose(a(gan), a(want_gan), **FWD)
    np.testing.assert_allclose(a(view), a(want_view), **FWD)
    r1 = r1_penalty(gan, xt)
    jfn = lambda p: jr1(lambda im: jp.apply({"params": p}, im, alpha=0.5)[0], jnp.asarray(x))
    jval, jgrads = jax.jit(jax.value_and_grad(jfn))(params)
    np.testing.assert_allclose(float(r1.detach()), float(jval), rtol=1e-5)
    want_g = jax_d_pose_params_to_state_dict(np_tree(jgrads))
    for name, g in grads_by_name(tp, r1).items():
        assert_rel(g, want_g[name], name=name)


@pytest.mark.parametrize("kind", ["image", "pose"])
def test_flat_discriminators_match_jax(kind):
    """DStyleGAN(64) and DVolumeRender(32) forward, weights carried across by
    the bridges (random draws for every parameter, biases included)."""
    from cips3dpp_tpu.models import discriminator as jdisc
    from cips3dpp_tpu.models import discriminator_pose as jpose
    from cips3dpp_torch.io.jax_params import load_jax_params
    from cips3dpp_torch.models import discriminator as tdisc
    from cips3dpp_torch.models import discriminator_pose as tpose

    size = 64 if kind == "image" else 32
    if kind == "image":
        jm, tm = jdisc.DStyleGAN(input_size=size, channel_multiplier=1), \
            tdisc.DStyleGAN(size, 1, device="cpu")
    else:
        jm, tm = jpose.DVolumeRender(input_size=size), tpose.DVolumeRender(size, device="cpu")
    x = (0.5 * np.random.default_rng(9).standard_normal((4, size, size, 3))).astype(np.float32)
    tmpl = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    rng = np.random.default_rng(10)
    params = jax.tree.map(lambda s: (0.2 * rng.standard_normal(s.shape)).astype(np.float32), tmpl)
    load_jax_params(tm, params, "d" if kind == "image" else "d_pose")
    want = jax.jit(jm.apply)({"params": jax.tree.map(jnp.asarray, params)}, jnp.asarray(x))
    got = tm(t(x))
    for g, w in zip(got if kind == "pose" else (got,), want if kind == "pose" else (want,)):
        np.testing.assert_allclose(a(g), a(w), **FWD)


@pytest.mark.parametrize("pretrained_size", [-1, 8])
def test_progressive_discriminators_pretrained_size_match_jax(pretrained_size):
    """The progressive Ds' other fade schedules: -1 never fades (alpha
    ignored), > 0 fades from that resolution (input 32^2, alpha 0.3)."""
    from cips3dpp_tpu.models import discriminator as jdisc
    from cips3dpp_tpu.models import discriminator_pose as jpose
    from cips3dpp_torch.io.jax_params import load_jax_params
    from cips3dpp_torch.models import discriminator as tdisc
    from cips3dpp_torch.models import discriminator_pose as tpose

    x = (0.5 * np.random.default_rng(11).standard_normal((2, 32, 32, 3))).astype(np.float32)
    pairs = (
        ("d", jdisc.DStyleGANProgressive(input_size=32, channel_multiplier=1,
                                         pretrained_size=pretrained_size),
         tdisc.DStyleGANProgressive(32, 1, pretrained_size, device="cpu")),
        ("d_pose", jpose.DVolumeRenderProgressive(input_size=32, pretrained_size=pretrained_size),
         tpose.DVolumeRenderProgressive(32, pretrained_size=pretrained_size, device="cpu")))
    rng = np.random.default_rng(12)
    for kind, jm, tm in pairs:
        tmpl = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(x))["params"]
        params = jax.tree.map(lambda s: (0.2 * rng.standard_normal(s.shape)).astype(np.float32),
                              tmpl)
        load_jax_params(tm, params, kind)
        want = jax.jit(lambda p, im: jm.apply({"params": p}, im, alpha=0.3))(
            jax.tree.map(jnp.asarray, params), jnp.asarray(x))
        got = tm(t(x), 0.3)
        for g, w in zip(got if kind == "d_pose" else (got,), want if kind == "d_pose" else (want,)):
            np.testing.assert_allclose(a(g), a(w), err_msg=kind, **FWD)


# ------------------------------------------------------------- diffaug -----


def _ints(x):
    return torch.from_numpy(np.array(x, np.int64)).reshape(-1)


def jax_diffaug_draws(key, b, h, w):
    """The draws jax diff_augment takes from `key`, as the port's dict."""
    out = {}
    for name in ("brightness", "saturation", "contrast", "translation", "cutout"):
        key, sub = jax.random.split(key)
        if name in ("brightness", "saturation", "contrast"):
            out[name] = t(jax.random.uniform(sub, (b, 1, 1, 1))).reshape(b)
        elif name == "translation":
            kh, kw = jax.random.split(sub)
            sh, sw = int(h * 0.125 + 0.5), int(w * 0.125 + 0.5)
            out["ty"] = _ints(jax.random.randint(kh, (b, 1, 1), -sh, sh + 1))
            out["tx"] = _ints(jax.random.randint(kw, (b, 1, 1), -sw, sw + 1))
        else:
            kh, kw = jax.random.split(sub)
            ch, cw = int(h * 0.2 + 0.5), int(w * 0.2 + 0.5)
            out["oy"] = _ints(jax.random.randint(kh, (b, 1, 1), 0, h + (1 - ch % 2)))
            out["ox"] = _ints(jax.random.randint(kw, (b, 1, 1), 0, w + (1 - cw % 2)))
    return out


def test_diff_augment_matches_jax():
    from cips3dpp_tpu.models.diffaug import diff_augment as jaug
    from cips3dpp_torch.models.diffaug import diff_augment, diffaug_draws

    x = np.random.default_rng(5).standard_normal((4, 16, 16, 3)).astype(np.float32)
    key = jax.random.PRNGKey(11)
    want = jaug(jnp.asarray(x), key)
    got = diff_augment(t(x), jax_diffaug_draws(key, 4, 16, 16))
    np.testing.assert_allclose(a(got), a(want), **FWD)
    # torch's own draws: in range, and the image changes
    d = diffaug_draws(torch.Generator().manual_seed(0), 4, 16, 16)
    assert int(d["ty"].abs().max()) <= 2 and int(d["oy"].max()) <= 16
    assert not torch.equal(diff_augment(t(x), d), t(x))


# -------------------------------------------------------------- losses -----


def test_losses_and_their_gradients_match_jax():
    from cips3dpp_tpu.train import losses as jl
    from cips3dpp_torch.train import losses as tl

    rng = np.random.default_rng(6)
    p1, p2 = (rng.standard_normal((4, 1)).astype(np.float32) for _ in range(2))
    eik = rng.standard_normal((2, 5, 4, 3)).astype(np.float32)
    sdf = (0.05 * rng.standard_normal((2, 5, 4, 1))).astype(np.float32)
    view = (1.5 * rng.standard_normal((4, 2))).astype(np.float32)  # both Huber branches
    target = rng.standard_normal((4, 2)).astype(np.float32)
    img = rng.standard_normal((3, 8, 8, 3)).astype(np.float32)
    lat = rng.standard_normal((3, 6, 16)).astype(np.float32)
    cases = [
        ("d_logistic", lambda m, x, y: m.d_logistic_loss(x, y), (p1, p2)),
        ("g_nonsaturating", lambda m, x: m.g_nonsaturating_loss(x), (p1,)),
        ("eikonal", lambda m, x: m.eikonal_loss(x), (eik,)),
        ("minimal_surface", lambda m, x: m.minimal_surface_loss(x, 100.0), (sdf,)),
        ("viewpoint", lambda m, x, y: m.viewpoint_loss(x, y), (view, target)),
        ("path_length", lambda m, x, g: m.path_length_penalty(x, g, 0.7 + 0 * g.sum())[0],
         (img, lat)),
    ]
    for name, fn, args in cases:
        want, jg = jax.jit(jax.value_and_grad(lambda *xs: fn(jl, *xs),
                                              argnums=tuple(range(len(args)))))(
            *[jnp.asarray(x) for x in args])
        ts = [t(x).requires_grad_(True) for x in args]
        got = fn(tl, *ts)
        np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5, err_msg=name)
        tg = torch.autograd.grad(got, ts, allow_unused=True)
        for g, w in zip(tg, jg):
            if g is None:  # the image of path_length_penalty only sets its shape
                assert not np.abs(a(w)).any(), name
            else:
                assert_rel(g, w, name=name)
    pen, mean, plen = tl.path_length_penalty(t(img), t(lat), torch.tensor(0.7))
    jpen, jmean, jplen = jl.path_length_penalty(jnp.asarray(img), jnp.asarray(lat), 0.7)
    np.testing.assert_allclose(a(mean), a(jmean), rtol=1e-6)
    np.testing.assert_allclose(a(plen), a(jplen), rtol=1e-6)
    noise = tl.path_noise(torch.Generator().manual_seed(0), t(np.zeros((4, 64, 64, 3))))
    assert noise.shape == (4, 64, 64, 3) and abs(float(noise.std()) * 64 - 1) < 0.05


def test_thumbnail_resize_and_pixel_gathers_match_jax():
    from cips3dpp_tpu.train.steps import downsample_to as jdown
    from cips3dpp_tpu.train.steps import gather_image_pixels as jgather
    from cips3dpp_torch.train.steps import downsample_to, gather_image_pixels, \
        sample_pixel_idx

    rng = np.random.default_rng(7)
    for size, out in ((64, 16), (32, 8), (48, 16)):
        x = rng.standard_normal((2, size, size, 3)).astype(np.float32)
        np.testing.assert_allclose(a(downsample_to(t(x), out)), a(jdown(jnp.asarray(x), out)),
                                   **FWD)
    x = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
    for mode in ("default", "patch"):
        ih, iw = sample_pixel_idx(torch.Generator().manual_seed(1), 2, 8, 4, mode)
        assert ih.shape == iw.shape == (2, 4)
        assert bool((ih[:, 1:] > ih[:, :-1]).all()) and int(ih.max()) < 8
        if mode == "patch":
            assert bool((ih[:, 1:] - ih[:, :-1] == 1).all())
        want = jgather(jnp.asarray(x), jnp.asarray(ih.numpy()), jnp.asarray(iw.numpy()), 2)
        np.testing.assert_array_equal(a(gather_image_pixels(t(x), ih, iw, 2)), a(want))


# ----------------------------------------------------------- optimizer -----


@pytest.mark.parametrize("norm", [20.5, 19.5])
def test_clipped_adam_matches_optax(norm):
    """Two updates of a two-group optimizer against optax.multi_transform of
    clip_by_global_norm(20) + adam(b1=0), with one group's gradient norm
    just above the clip (`norm` 20.5) or just below it (19.5): the clip
    has no epsilon in its divisor, as optax's."""
    import optax

    from cips3dpp_torch.train.state import ClippedAdam

    rng = np.random.default_rng(8)
    shapes = {"a": [(5, 3), (7,)], "b": [(4,)]}
    params = {k: [rng.standard_normal(s).astype(np.float32) for s in v]
              for k, v in shapes.items()}
    grads_steps = []
    for _ in range(2):
        g = {k: [rng.standard_normal(s).astype(np.float32) for s in v]
             for k, v in shapes.items()}
        n = np.sqrt(sum(float((x.astype(np.float64) ** 2).sum()) for x in g["a"]))
        g["a"] = [(x * (norm / n)).astype(np.float32) for x in g["a"]]
        grads_steps.append(g)
    tx = optax.multi_transform(
        {"a": optax.chain(optax.clip_by_global_norm(20.0), optax.adam(2e-3, b1=0.0, b2=0.99)),
         "b": optax.chain(optax.clip_by_global_norm(20.0), optax.adam(2e-5, b1=0.0, b2=0.9))},
        {"a": ["a", "a"], "b": ["b"]})
    jp = jax.tree.map(jnp.asarray, params)
    state = tx.init(jp)
    tparams = {k: [torch.nn.Parameter(t(x)) for x in v] for k, v in params.items()}
    opt = ClippedAdam(tparams, {"a": 2e-3, "b": 2e-5}, {"a": 0.99, "b": 0.9}, 20.0)
    update = jax.jit(tx.update)
    for g in grads_steps:
        upd, state = update(jax.tree.map(jnp.asarray, g), state, jp)
        jp = optax.apply_updates(jp, upd)
        opt.step({k: [t(x) for x in v] for k, v in g.items()})
    for k in shapes:
        for p, w in zip(tparams[k], jp[k]):
            np.testing.assert_allclose(a(p), a(w), rtol=1e-6, atol=1e-7, err_msg=k)
    clipped = opt.clip([t(x) for x in grads_steps[0]["a"]])
    got_norm = float(torch.sqrt(sum(c.square().sum() for c in clipped)))
    assert got_norm == pytest.approx(min(norm, 20.0), rel=1e-6)
