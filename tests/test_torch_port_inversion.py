"""Flip-inversion in cips3dpp_torch against the JAX package on the CPU:
JAX's image resize, VGG16 features, the perceptual loss, LPIPS, PSNR,
SSIM, axis-angle cameras, the schedule functions, one projector step and
6-step runs in both camera parameterisations.

Tiny geometry: 8^2 rays x 4 samples, a SIREN of width 32, a decoder of
two blocks (size_end 16, upsampling at 16) to a 16^2 image. The VGG
weights are numpy draws handed to both packages (through
`jax_vgg_params_to_state_dict` on the port's side). The JAX projector is
given a test-local proxy of its flax generator that forces perturb=False;
the port gets t_rand = 0, which gives the unperturbed z-values exactly.
The mean latents are computed as JAX's init_state computes them (the same
key split) and handed to the port with JAX's noise buffers; both get the
same azim_init. Both render with the plain renderer (fused=False: JAX's
fused branch runs on a TPU only); the port's fused render (K1's plain
version on the CPU) is held to its plain render separately.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import a, np_tree, port_and_jax_generator, t
from torch_port_train_helpers import REL, assert_rel

from cips3dpp_torch.apps import inversion as tinv
from cips3dpp_torch.io.jax_params import jax_params_to_state_dict, jax_vgg_params_to_state_dict
from cips3dpp_torch.models.vgg import VGG16Features

IMG = 16  # the tiny generator's output size


def tiny_configs():
    """(JAX config, port config): the decoder runs two blocks to 16^2."""
    from cips3dpp_tpu.models import generator as jg
    from cips3dpp_torch.models import generator as tg

    def make(m):
        return m.GeneratorConfig(
            renderer=m.RendererConfig(n_layers=2, hidden_dim=32),
            decoder=m.DecoderConfig(size_end=16, upsample_list=(16,), style_dim=64,
                                    mapping_n_layers=2),
            img_size=8, n_samples=4)

    return make(jg), make(tg)


def vgg_tree(seed=0, lin=False):
    """A flax VGG16Features tree of numpy draws (He-scaled kernels, small
    biases); with `lin`, an LPIPS tree with positive lin weights."""
    from cips3dpp_tpu.models.vgg import _VGG16_PLAN

    rng = np.random.default_rng(seed)
    params, cin = {}, 3
    for idx, ch, _ in _VGG16_PLAN:
        params[f"conv_{idx}"] = {
            "kernel": (rng.standard_normal((3, 3, cin, ch)) * math.sqrt(2.0 / (9 * cin))
                       ).astype(np.float32),
            "bias": (0.1 * rng.standard_normal(ch)).astype(np.float32)}
        cin = ch
    tree = {"params": params}
    if lin:
        from cips3dpp_tpu.utils.lpips import LPIPS_CHANNELS

        return {"vgg": tree, "lin": {str(i): rng.uniform(0.0, 2.0 / c, c).astype(np.float32)
                                     for i, c in LPIPS_CHANNELS.items()}}
    return tree


def jnp_tree(tree):
    return jax.tree.map(jnp.asarray, tree)


@pytest.fixture(scope="module")
def vggs():
    tree = vgg_tree()
    vgg = VGG16Features().requires_grad_(False)
    vgg.load_state_dict(jax_vgg_params_to_state_dict(tree))
    return jnp_tree(tree), vgg


def images(seed, shape):
    return np.tanh(np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


# ------------------------------------------------------------------ resize --

@pytest.mark.parametrize("method,src,dst,ch", [
    ("cubic", (8, 8), (32, 32), 3), ("cubic", (5, 7), (13, 16), 3),
    ("cubic", (16, 16), (256, 256), 1),  # the mask's 16x (64^2 -> 1024^2)
    ("cubic", (24, 24), (8, 8), 3),
    ("lanczos3", (32, 32), (8, 8), 3), ("lanczos3", (13, 16), (5, 7), 3),
    ("lanczos3", (256, 256), (16, 16), 3),  # the target thumbnail's 1/16
    ("lanczos3", (8, 8), (24, 24), 3),
])
def test_resize_matches_jax(method, src, dst, ch):
    """Up and down, at the projector's factors 16 and 1/16 among others.
    Tolerance: atol 1e-5 on [-1, 1] images, f32 rounding (JAX's own
    result is up to 9.7e-6 off the f64 product of its weights at 64^2 ->
    1024^2, by its CPU contraction order); the port is also held within
    1e-6 of that f64 product, as its weight matrices are JAX's to f32."""
    from cips3dpp_torch.ops.resize import resize, resize_weights

    x = images(1, (2, *src, ch))
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, *dst, ch), method=method))
    got = a(resize(t(x), dst, method))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    wh = a(resize_weights(src[0], dst[0], method)).astype(np.float64)
    ww = a(resize_weights(src[1], dst[1], method)).astype(np.float64)
    exact = np.einsum("bhwc,hH,wW->bHWc", x.astype(np.float64), wh, ww)
    np.testing.assert_allclose(got, exact, atol=1e-6, rtol=0)


# --------------------------------------------------------- VGG and metrics --

@pytest.mark.parametrize("post_relu", [False, True])
def test_vgg16_features_match_jax(vggs, post_relu):
    """Every tap, pre- and post-ReLU, on the same weights; 24^2 pools to
    1^2 at conv5. Tolerance: 1e-4 of each tap's largest value (f32 sums of
    up to 4608 products in another order)."""
    from cips3dpp_tpu.models.vgg import TAP_LAYERS
    from cips3dpp_tpu.models.vgg import VGG16Features as JVGG

    jtree, vgg = vggs
    x = images(2, (2, 24, 24, 3))
    want = JVGG(taps=TAP_LAYERS, post_relu=post_relu).apply(jtree, jnp.asarray(x))
    got = vgg(t(x), post_relu=post_relu)
    assert sorted(got) == sorted(want)
    for i in TAP_LAYERS:
        assert got[i].shape == want[i].shape, i
        assert_rel(got[i], want[i], REL, f"tap {i}")


def test_perceptual_features_and_distance_match_jax(vggs):
    """The weighted feature vector (NHWC flatten order) with both weight
    tables, and the squared distance: 1e-4 of the largest value (as the
    taps). A 16^2 thumbnail pools to an empty conv5 in both packages."""
    from cips3dpp_tpu.models import vgg as jv
    from cips3dpp_torch.models import vgg as tv

    jtree, vgg = vggs
    for size, loss_w in ((32, jv.LOSS_W_1024), (16, jv.LOSS_W_256)):
        x, y = images(3, (2, size, size, 3)), images(4, (2, size, size, 3))
        want = jv.perceptual_features(jtree, jnp.asarray(x), loss_w)
        got = tv.perceptual_features(vgg, t(x), loss_w)
        assert_rel(got, want, REL, f"features {size}")
        want_d = jv.perceptual_distance(jtree, jnp.asarray(x), jnp.asarray(y), loss_w)
        got_d = tv.perceptual_distance(vgg, t(x), t(y), loss_w)
        np.testing.assert_allclose(float(got_d), float(want_d), rtol=1e-4)
    assert jv.LOSS_W_1024 == tv.LOSS_W_1024 and jv.LOSS_W_256 == tv.LOSS_W_256


def test_lpips_psnr_ssim_match_jax():
    """LPIPS on an LPIPS tree carried by jax_vgg_params_to_state_dict,
    PSNR (data_range 2) and SSIM (11x11, sigma 1.5, VALID), on a batch and
    on one HWC image; rtol 1e-4 (f32 reductions in another order)."""
    from cips3dpp_tpu.utils import lpips as jl
    from cips3dpp_tpu.utils import metrics as jm
    from cips3dpp_torch.utils import metrics as tm
    from cips3dpp_torch.utils.lpips import LPIPS

    tree = vgg_tree(5, lin=True)
    net = LPIPS().requires_grad_(False)
    net.load_state_dict(jax_vgg_params_to_state_dict(tree))
    x = images(6, (2, 24, 24, 3))
    y = np.clip(x + 0.2 * images(7, (2, 24, 24, 3)), -1, 1)
    np.testing.assert_allclose(float(net(t(x), t(y))),
                               float(jl.lpips(jnp_tree(tree), jnp.asarray(x), jnp.asarray(y))),
                               rtol=1e-4)
    for xa, ya in ((x, y), (x[0], y[0])):
        np.testing.assert_allclose(float(tm.psnr(t(xa), t(ya))),
                                   float(jm.psnr(jnp.asarray(xa), jnp.asarray(ya))), rtol=1e-5)
        np.testing.assert_allclose(float(tm.ssim(t(xa), t(ya))),
                                   float(jm.ssim(jnp.asarray(xa), jnp.asarray(ya))), rtol=1e-4)


def test_init_vgg_is_flax_lecun_normal():
    """init_vgg draws flax's default conv kernels: a normal truncated at 2
    of its standard deviations, rescaled to variance 1 / fan_in, zero
    biases. Held per layer to the variance 1 / fan_in (5% on the standard
    deviation) and the truncation bound, and to jax's lecun_normal draws
    of the first layer's and a 512-channel layer's shape (5%)."""
    from cips3dpp_torch.models.vgg import init_vgg

    vgg = init_vgg(torch.Generator().manual_seed(0), device="cpu")
    init = jax.nn.initializers.lecun_normal()
    for i, conv in enumerate(m for m in vgg.features if isinstance(m, torch.nn.Conv2d)):
        w = a(conv.weight)
        fan_in = conv.in_channels * 9
        if i in (0, 12):
            ref = init(jax.random.PRNGKey(i), (3, 3, conv.in_channels, conv.out_channels))
            np.testing.assert_allclose(w.std(), float(jnp.std(ref)), rtol=0.05)
        np.testing.assert_allclose(w.std(), math.sqrt(1.0 / fan_in), rtol=0.05)
        assert np.abs(w).max() <= 2.0 * math.sqrt(1.0 / fan_in) / 0.87962566103423978 + 1e-7
        assert not conv.bias.any() and not conv.weight.requires_grad


# ------------------------------------------------------------------ camera --

def test_axis_angle_matches_jax_with_finite_gradient_at_zero():
    """Rodrigues matrices (a zero, a tiny and ordinary rotations) and the
    camera-to-world, 1e-6; the gradient of a fixed linear function of the
    matrix at theta = 0 (the axis_angle inversion's start) is finite and
    equal to JAX's, 1e-6."""
    from cips3dpp_tpu.core import camera as jc
    from cips3dpp_torch.core import camera as tc

    rng = np.random.default_rng(8)
    rot = np.concatenate([np.zeros((1, 3)), 1e-7 * rng.standard_normal((1, 3)),
                          rng.standard_normal((4, 3))]).astype(np.float32)
    trans = rng.standard_normal((6, 3)).astype(np.float32)
    np.testing.assert_allclose(a(tc.axis_angle_to_matrix(t(rot))),
                               np.asarray(jc.axis_angle_to_matrix(jnp.asarray(rot))), atol=1e-6)
    np.testing.assert_allclose(
        a(tc.camera2world_from_axis_angle(t(rot), t(trans))),
        np.asarray(jc.camera2world_from_axis_angle(jnp.asarray(rot), jnp.asarray(trans))),
        atol=1e-6)
    c = rng.standard_normal((3, 3)).astype(np.float32)
    x = torch.zeros(3, requires_grad=True)
    (g,) = torch.autograd.grad((tc.axis_angle_to_matrix(x) * t(c)).sum(), x)
    want = jax.grad(lambda r: jnp.sum(jc.axis_angle_to_matrix(r) * c))(jnp.zeros(3))
    assert torch.isfinite(g).all()
    np.testing.assert_allclose(a(g), np.asarray(want), atol=1e-6)


# ---------------------------------------------------------------- schedule --

def test_schedule_and_noise_regularization_match_jax():
    """cosine_lr_mul, phase_lr_muls and the flip and masking rule of every
    step of two whole schedules (exact: the same float64 arithmetic), and
    the noise autocorrelation pyramid (rtol 1e-5)."""
    from cips3dpp_tpu.apps import inversion as jinv

    for kw in ({}, dict(n_steps_pose=3, n_steps_app=7, n_steps_multiview=2,
                        flip_w_decoder_every=3)):
        jcfg, tcfg = jinv.InversionConfig(**kw), tinv.InversionConfig(**kw)
        n = jcfg.n_steps_pose + jcfg.n_steps_app + jcfg.n_steps_multiview
        for step in range(n):
            lrs, flip, mask_bg = tinv.step_plan(step, tcfg)
            assert lrs == jinv.phase_lr_muls(step, jcfg), step
            # cips3dpp_tpu/apps/inversion.py:388-402
            in_app = jcfg.n_steps_pose <= step < jcfg.n_steps_pose + jcfg.n_steps_app
            every = jcfg.flip_w_decoder_every
            assert flip == (in_app and (step + every - 1) % every == 0 and step != n - 1)
            assert mask_bg == (jcfg.mask_background and step >= jcfg.n_steps_pose)
        for s in range(0, 50, 7):
            assert tinv.cosine_lr_mul(s, 50) == jinv.cosine_lr_mul(s, 50)
    defaults = lambda c: {f.name: f.default for f in dataclasses.fields(c)}
    assert defaults(tinv.InversionConfig) == defaults(jinv.InversionConfig)
    rng = np.random.default_rng(9)
    bufs = [rng.standard_normal(s).astype(np.float32)
            for s in ((1, 8, 8, 1), (1, 16, 16, 1), (2, 32, 32, 1))]
    np.testing.assert_allclose(
        float(tinv.noise_regularization([t(b) for b in bufs])),
        float(jinv.noise_regularization([jnp.asarray(b) for b in bufs])), rtol=1e-5)


# --------------------------------------------------------------- projector --

SCHEDULE = dict(n_steps_pose=2, n_steps_app=3, n_steps_multiview=1, flip_w_decoder_every=2,
                w_avg_samples=64)
N_STEPS = 6  # pose 0-1, appearance 2-4 (flip at 3, truncation before 2), multiview 5
AZIM_INIT = (0.1, -0.1)
FLIP_STEP = 3


class _NoPerturb:
    """The flax generator with perturb forced off (its mean_latents and
    bind pass through), so both packages render the unperturbed z-values."""

    def __init__(self, model):
        self.model, self.cfg = model, model.cfg

    def apply(self, params, *args, **kw):
        if "method" not in kw:
            kw["perturb"] = False
        return self.model.apply(params, *args, **kw)

    def bind(self, params):
        return self.model.bind(params)


def _adam_groups(opt):
    """{group: (count, mu subtree, nu subtree)} of the JAX projector's
    optax multi_transform state."""
    from cips3dpp_torch.io.jax_params import _adam_states

    out = {}
    for path, node in _adam_states(opt):
        g = next(k for k in path if k in ("cam", "render", "decoder"))
        out[g] = (int(np.asarray(node.count)), node.mu[g], node.nu[g])
    return out


def _port_leaves(tree_by_group):
    """The JAX optimisation tree {cam, render, decoder} -> the port's leaf
    names ("decoder.<state-dict name>", "noise.<i>")."""
    cam, render, dec = (tree_by_group[k] for k in ("cam", "render", "decoder"))
    out = {"azim": t(cam["azim"]), "elev": t(cam["elev"]), "w_render": t(render["w_render"]),
           "w_decoder": t(dec["w_decoder"])}
    params = jax_params_to_state_dict({"decoder": np_tree(dec["params"])})
    out.update({k: v for k, v in params.items()})
    out.update({f"noise.{i}": t(b) for i, b in enumerate(dec["noise"])})
    return out


def _jax_tree(state):
    return {"cam": {"azim": state.azim, "elev": state.elev},
            "render": {"w_render": state.w_render},
            "decoder": {"w_decoder": state.w_decoder, "params": state.decoder_params,
                        "noise": state.noise_bufs}}


def _port_state(jstate):
    """A JAX InversionState (with its Adam moments) as the port's."""
    from cips3dpp_torch.apps.inversion import InversionState, _from_leaves

    leaves = _port_leaves(_jax_tree(jstate))
    groups = _adam_groups(jstate.opt)
    counts = {c for c, _, _ in groups.values()}
    assert len(counts) == 1
    mu = _port_leaves({g: m for g, (_, m, _) in groups.items()})
    nu = _port_leaves({g: v for g, (_, _, v) in groups.items()})
    n = len(jstate.noise_bufs)
    base = InversionState(None, None, None, None, {}, [None] * n, {})
    return _from_leaves(base, leaves, {"count": counts.pop(), "mu": mu, "nu": nu})


@pytest.fixture(scope="module")
def projectors(vggs):
    """For each camera parameterisation: the port Projector and its draws,
    the target, and the JAX run of N_STEPS steps (its states and metrics
    after each step) through JAX's own step functions, as JAX's project
    drives them (inversion.py:385-405; its final eager render is left
    out). axis_angle runs without background masking, which the angles
    run covers; so it compiles two step variants, not three."""
    from cips3dpp_tpu.apps import inversion as jinv
    from cips3dpp_tpu.models.generator import Generator as JG
    from cips3dpp_tpu.models.vgg import LOSS_W_1024, perceptual_features

    jcfg, tcfg = tiny_configs()
    g, gvars = port_and_jax_generator(jcfg, tcfg, seed=31)
    gvars = jnp_tree(gvars)
    jmodel = JG(jcfg)
    jvgg, vgg = vggs
    target = images(10, (IMG, IMG, 3))
    out = {}
    for mode, extra in (("angles", {}), ("axis_angle", dict(mask_background=False))):
        kw = dict(SCHEDULE, cam_param=mode, **extra)
        jp = jinv.Projector(_NoPerturb(jmodel), gvars, jvgg, jinv.InversionConfig(**kw),
                            fused=False)
        key = jax.random.PRNGKey(1)
        state = jp.init_state(key, AZIM_INIT)
        jt = jnp.stack([jnp.asarray(target), jnp.asarray(target[:, ::-1])])
        thumb = jax.image.resize(jt, (2, 8, 8, 3), method="lanczos3")
        tf = perceptual_features(jvgg, jt)
        tft = perceptual_features(jvgg, thumb, LOSS_W_1024)
        states, metrics = [state], []
        for i in range(N_STEPS):
            lrs, flip, mask_bg = tinv.step_plan(i, tinv.InversionConfig(**kw))
            if i == jp.cfg.n_steps_pose:
                wr = jp._means[0][:, None, :]
                state = state.replace(w_render=wr + jp.cfg.truncation_psi * (state.w_render - wr))
            key, sub = jax.random.split(key)
            state, m = jp.step_fn(flip, mask_bg)(state, jt, thumb, tf, tft, sub, lrs)
            states.append(state)
            metrics.append({k: float(v) for k, v in m.items()})
        means = tuple(t(m) for m in jp._means)
        draws = tinv.InversionDraws(means=means, noise=[t(b) for b in states[0].noise_bufs],
                                    t_rand=torch.zeros((N_STEPS + 1, 2, 8, 8, 1)))
        proj = tinv.Projector(g, vgg, tinv.InversionConfig(**kw), fused=False)
        out[mode] = dict(jp=jp, states=states, metrics=metrics, proj=proj, draws=draws,
                         target=target, model=g)
    return out


def _grad_bound(g_want):
    return max(REL * float(np.abs(a(g_want)).max()), 1e-6)


def test_projector_step_matches_jax(projectors):
    """One appearance step with the decoder styles flipped and the
    background masked (step 3, lr > 0), from JAX's state after step 2 with
    its Adam moments: the loss terms (rtol 5e-5), the gradient of every
    leaf of every group, and the state after the update.

    JAX's gradients are read off its moments: g = (mu_new - 0.9 mu_old) /
    0.1, exact to f32 rounding of the moments' size. Gradients: within REL
    = 1e-4 of each tensor's largest |g| (1e-6 floor). The flipped decoder
    styles get none: zero in both. The update follows the steps test's
    rule (tests/test_torch_port_train_steps.py:11-25): where |g| is above
    its bound, the change new - old within rtol 1e-3 plus two f32 spacings
    of the parameter; elsewhere Adam's normalised update of a near-zero
    gradient may take either sign, so within the leaf's lr. The moments
    and the count are compared too: mu within REL of its largest value, nu
    (quadratic in g) within 2 REL."""
    run = projectors["angles"]
    proj, jstates = run["proj"], run["states"]
    before, after = _port_state(jstates[FLIP_STEP]), _port_state(jstates[FLIP_STEP + 1])
    targets = proj.prepare_targets(run["target"])
    lrs, flip, mask_bg = tinv.step_plan(FLIP_STEP, proj.cfg)
    assert flip and mask_bg and lrs["decoder"] > 0
    t_rand = torch.zeros((2, 8, 8, 1))
    metrics, grads = proj.loss_and_grads(before, targets, t_rand, flip, mask_bg)
    want_m = run["metrics"][FLIP_STEP]
    for k in ("percep", "noise_reg", "loss"):
        np.testing.assert_allclose(float(metrics[k]), want_m[k], rtol=5e-5, err_msg=k)
    mu_old, mu_new = before.opt["mu"], after.opt["mu"]
    assert set(grads) == set(mu_new)
    assert not grads["w_decoder"].any()
    for k, g in grads.items():
        want = (mu_new[k] - 0.9 * mu_old[k]) / 0.1
        err = float((g - want).abs().max())
        assert err <= _grad_bound(want), (k, err, _grad_bound(want))
    new, _ = proj.step(before, targets, t_rand, lrs, flip, mask_bg)
    assert new.opt["count"] == after.opt["count"]
    got_leaves, want_leaves = tinv._leaves(new), tinv._leaves(after)
    old_leaves = tinv._leaves(before)
    for k, g in grads.items():
        lr = proj._base_lr(k, lrs)
        old, got, want = (a(x[k]) for x in (old_leaves, got_leaves, want_leaves))
        big = np.abs(a(mu_new[k] - 0.9 * mu_old[k]) / 0.1) > _grad_bound(
            (mu_new[k] - 0.9 * mu_old[k]) / 0.1)
        spacing = 2 * np.spacing(np.abs(old).astype(np.float32))
        d_got, d_want = got - old, want - old
        ok = np.abs(d_got - d_want) <= 1e-3 * np.abs(d_want) + spacing
        assert ok[big].all(), (k, np.abs(d_got - d_want)[big].max())
        assert (np.abs(d_got - d_want)[~big] <= lr + spacing[~big]).all(), k
        assert_rel(new.opt["mu"][k], after.opt["mu"][k], REL, f"mu {k}")
        assert_rel(new.opt["nu"][k], after.opt["nu"][k], 2 * REL, f"nu {k}")


@pytest.mark.parametrize("mode", ["angles", "axis_angle"])
def test_projector_run_matches_jax(projectors, mode):
    """Six steps through the port's `project` (pose, the truncation, an
    appearance step with the decoder styles flipped, multiview) against
    JAX's steps. Step 0 has lr 0 (the cosine ramp), so steps 0 and 1 start
    from states equal to f32: their loss terms within rtol 1e-4 (f32 sums
    over the VGG features). From step 1 on, an element whose gradient is
    near zero moves by up to its lr with a sign that f32 noise decides,
    and the states drift apart through the renders: the later loss terms
    within rtol 5e-3 (measured: 1.7e-3, axis_angle step 4), and every leaf
    of the final state within its lr budget (the sum of its learning
    rates over the run, which bounds an element's move under Adam's
    normalised steps) and within 1% of it on average (measured: at most
    0.3%, axis_angle's decoder weights). A wrong lr, gate, flip or
    truncation moves whole leaves by a budget's order."""
    run = projectors[mode]
    proj, jstates = run["proj"], run["states"]
    logs = []
    state, img, report = proj.project(run["target"], azim_init=AZIM_INIT, draws=run["draws"],
                                      log_every=1, logger=lambda s, m: logs.append(m))
    assert [len(logs), img.shape] == [N_STEPS, (2, IMG, IMG, 3)]
    for i, (got, want) in enumerate(zip(logs, run["metrics"])):
        for k in ("percep", "noise_reg", "loss"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4 if i < 2 else 5e-3,
                                       err_msg=f"step {i} {k}")
    budget = {}
    for i in range(N_STEPS):
        lrs = tinv.step_plan(i, proj.cfg)[0]
        for k in tinv._leaves(state):
            budget[k] = budget.get(k, 0.0) + proj._base_lr(k, lrs)
    got, want = tinv._leaves(state), tinv._leaves(_port_state(jstates[-1]))
    for k, g in got.items():
        err = np.abs(a(g) - a(want[k]))
        assert err.max() <= budget[k] and err.mean() <= 0.01 * budget[k], (
            k, err.max(), err.mean(), budget[k])
    assert np.isfinite([report["psnr"], report["ssim"], report["lpips"]]).all()
    assert report["lpips_weights"] == "random" and len(report["azim"]) == (
        2 if mode == "angles" else 6)


def test_projector_leaves_the_model_unchanged(projectors):
    """What is optimised is a copy: after a run the caller's generator
    holds the weights it had."""
    run = projectors["angles"]
    model = run["model"]
    before = {k: v.clone() for k, v in model.state_dict().items()}
    run["proj"].project(run["target"], azim_init=AZIM_INIT, draws=run["draws"])
    assert all(torch.equal(v, before[k]) for k, v in model.state_dict().items())


def test_fused_projector_step_matches_plain(projectors):
    """The fused render, asked for explicitly (K1's plain version on the
    CPU: bf16 products, the polynomial sine; the default renders plainly
    off the card, test_torch_port_route.py) against the plain f32 render on one
    masked appearance step: the loss within 2% and each group's gradient
    at cosine > 0.99 (on the card, chip_smoke.py's INV_GRAD_BOUNDS split
    this comparison in two: test_fused_route_gradient_paths)."""
    run = projectors["angles"]
    cfg = run["proj"].cfg
    fused = tinv.Projector(run["model"], run["proj"].vgg, cfg, fused=True)
    assert fused.fused
    state = fused.init_state(None, AZIM_INIT, run["draws"])
    targets = fused.prepare_targets(run["target"])
    t_rand = torch.rand((2, 8, 8, 1), generator=torch.Generator().manual_seed(3))
    m_f, g_f = fused.loss_and_grads(state, targets, t_rand, False, True)
    m_p, g_p = run["proj"].loss_and_grads(state, targets, t_rand, False, True)
    np.testing.assert_allclose(float(m_f["loss"]), float(m_p["loss"]), rtol=2e-2)
    for group in (["azim", "elev"], ["w_render"], ["w_decoder"]):
        x = torch.cat([g_f[k].flatten() for k in group]).double()
        y = torch.cat([g_p[k].flatten() for k in group]).double()
        assert float(torch.nn.functional.cosine_similarity(x, y, dim=0)) > 0.99, group


def _group_gap(x, y, keys):
    x = torch.cat([x[k].flatten() for k in keys]).double()
    y = torch.cat([y[k].flatten() for k in keys]).double()
    return (float(torch.nn.functional.cosine_similarity(x, y, dim=0)),
            float((x - y).abs().max() / y.abs().max()))


def test_fused_route_gradient_paths(projectors, monkeypatch):
    """The fused route's gradient paths, as chip_smoke.py phase 9 checks
    them on the card, on one masked appearance step. With
    siren_render_reference at f32 products standing in for the fused
    call, the step's gradients equal the plain f32 renderer's (cosine
    above 1 - 1e-9, max difference within 1e-4 of the largest: f32 sums
    in other orders), so the renderer's fused branch carries every camera
    path. The fused route, asked for (K1's plain version forward, the
    replayed backward) agrees with autograd through the bf16 function it
    computes (chip_smoke's "bf16" bounds: cosine above 0.999, within 0.1
    of the largest value). Those bounds see a dropped path: with the
    sample points or the view directions detached before the fused call
    the camera's gradient fails them. Detaching rays_d or z_vals changes
    nothing that the bounds could see: rays_d enters only through its
    norm, which the camera's rotation keeps, and the z-values do not
    depend on the camera (within 1e-5 of the largest value)."""
    from cips3dpp_torch.kernels import siren_render as ksr

    run = projectors["angles"]
    plain = run["proj"]
    fused = tinv.Projector(run["model"], plain.vgg, plain.cfg, fused=True)
    state = fused.init_state(None, AZIM_INIT, run["draws"])
    targets = fused.prepare_targets(run["target"])
    t_rand = torch.rand((2, 8, 8, 1), generator=torch.Generator().manual_seed(3))
    real = ksr.siren_render_fused

    def grads(proj, stand_in=None):
        monkeypatch.setattr(ksr, "siren_render_fused", stand_in or real)
        return proj.loss_and_grads(state, targets, t_rand, False, True)[1]

    def reference(dtype):
        return lambda *args: ksr.siren_render_reference(*args, matmul_dtype=dtype)

    def detached(index):
        def call(*args):
            args = list(args)
            args[index] = args[index].detach()
            return real(*args)
        return call

    groups = (("azim", "elev"), ("w_render",), ("w_decoder",))
    g_plain, g_f32 = grads(plain), grads(fused, reference(torch.float32))
    for keys in groups:
        cos, rel = _group_gap(g_f32, g_plain, keys)
        assert cos > 1 - 1e-9 and rel <= 1e-4, (keys, cos, rel)
    g_fused, g_bf16 = grads(fused), grads(fused, reference(torch.bfloat16))
    for keys in groups:
        cos, rel = _group_gap(g_fused, g_bf16, keys)
        assert cos > 0.999 and rel <= 0.1, (keys, cos, rel)
    # siren_render_fused(renderer, styles, pts, viewdirs, z_vals, rays_d, near, far)
    for name, index in (("pts", 2), ("viewdirs", 3)):
        cos, rel = _group_gap(grads(fused, detached(index)), g_bf16, groups[0])
        assert not (cos > 0.999 and rel <= 0.1), (name, cos, rel)
    for name, index in (("z_vals", 4), ("rays_d", 5)):
        cos, rel = _group_gap(grads(fused, detached(index)), g_fused, groups[0])
        assert rel <= 1e-5, (name, cos, rel)


def test_inversion_self_recovery():
    """The port's counterpart of tests/test_apps.py::test_inversion_self_
    recovery: a target rendered by the same model from its mean latents
    at azim* = 0.3; pose steps from azim 0.02 with the gate's settings (no
    masking, no noise regularisation, lr_cam 0.1, lr_render_w 0.02, 512
    mean samples) must lower the loss and move azim toward azim*. Two
    differences, for its 20 s: 40 steps, not 150, and the z-values
    unperturbed (t_rand = 0 for the target and every step). With 40 steps
    the perturbation's jitter decides where azim ends after its first
    overshoot (4 of 6 model seeds end nearer azim*; unperturbed, 6 of 6),
    so the gate would test the draws, not the camera gradient."""
    from cips3dpp_torch.core.camera import camera_from_angles
    from cips3dpp_torch.models.generator import Generator
    from cips3dpp_torch.models.layers import randomize_zero_init_
    from cips3dpp_torch.models.vgg import init_vgg

    _, cfg = tiny_configs()
    model = Generator(cfg, device="cpu", seed=41)
    randomize_zero_init_(model, torch.Generator().manual_seed(41))
    azim_true, n_steps = 0.3, 40
    with torch.no_grad():
        wr, wd = model.mean_latents(torch.Generator().manual_seed(5), 512)
        sr = wr[:, None, :].repeat(1, cfg.renderer.n_layers + 1, 1)
        sd = wd[:, None, :].repeat(1, model.decoder.n_latent, 1)
        cam = camera_from_angles(torch.tensor([azim_true]), torch.zeros(1), cfg.img_size,
                                 fov_ang=cfg.fov_ang, dist_radius=cfg.dist_radius)
        noise = model.decoder.make_noise(torch.Generator().manual_seed(0), cfg.img_size)
        out = model(style_render=sr, style_decoder=sd, cam_poses=cam.extrinsics,
                    focals=cam.focal, near=cam.near, far=cam.far, noise_bufs=noise,
                    perturb=False)
    target = out["rgb"][0].numpy()
    icfg = tinv.InversionConfig(n_steps_pose=n_steps, n_steps_app=0, n_steps_multiview=0,
                                mask_background=False, w_avg_samples=512,
                                optim_noise_bufs=False, lr_cam=0.1, lr_render_w=0.02)
    proj = tinv.Projector(model, init_vgg(torch.Generator().manual_seed(0), device="cpu"),
                          icfg)
    logs = []
    draws = tinv.InversionDraws(t_rand=torch.zeros((n_steps + 1, 2, 8, 8, 1)))
    state, _, _ = proj.project(target, generator=torch.Generator().manual_seed(1),
                               azim_init=(0.02, 0.02), draws=draws, log_every=1,
                               logger=lambda s, m: logs.append(m))
    assert np.isfinite(logs[-1]["loss"]) and logs[-1]["loss"] < logs[0]["loss"]
    azim = float(state.azim.flatten()[0])
    assert abs(azim - azim_true) < abs(0.02 - azim_true), azim
