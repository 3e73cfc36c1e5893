"""The image D's training options of cips3dpp_torch against the JAX
package's own steps (cips3dpp_tpu.train.steps.make_train_steps) with the
same option, at the tiny size of tests/test_torch_port_train_steps.py
(depth-2 SIREN of width 32 at 8^2 rays x 4 samples, one upsample to 16^2;
DStyleGANProgressive(16, channel multiplier 1); DVolumeRenderProgressive
(8); batch 4, diffaug off; the plain renderer, as JAX renders off a TPU).

The JAX step draws its inputs from its key: the test draws the same zs and
cameras with the JAX package's `_sample_inputs` from the step's first key,
hands them to the port as `Draws`, and wraps the JAX generator so that it
renders with perturb off and the test's noise buffers (`FixedDraws`). The
JAX optimizers are swapped for one that keeps the gradient as its state
(`keep_grads`), so the gradients the JAX step hands its optimizer are read
off the new state; the port's are recorded where its step hands them to
ClippedAdam.

Bounds. f32 options (d_cat, d_seq, d_r1_chunk, remat_d; the depth-8 D step
with the default TrainConfig): metrics rtol 5e-5, every gradient within
REL = 1e-4 of its tensor's largest |gradient| (the step tests' bounds; both
sides f32, only summation orders differ) except where noted at REL_IN and
REL_G. bf16 (d_dtype="bfloat16", and the bf16 decoder of train_r1024_fast):
the image D rounds where the JAX D rounds, held layer by layer on the same
bf16 input (outputs and input gradients bit-equal but for a share of f32
sum-order flips). Over a whole step those flips spread: the losses that do
not pass through the bf16 image D keep the bf16 floor of
tests/test_mesh_equivalence.py:415-478 (rtol 2e-3, atol 1e-4); the image
D's logits and the losses on them (GAN, R1) get BF16_D_LOSS, gradients
BF16_GRAD_REL and BF16_COS (below, with the measurements they rest on).

Then two gloo ranks with d_cat and with d_seq against one process (the
form of tests/test_torch_port_parallel.py), with a planted per-rank
minibatch stddev under d_cat that must fail.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torch_port_helpers import a, np_tree, port_and_jax_generator, t
from torch_port_options_helpers import MESH_OPTIONS, _mesh_d_steps, _mesh_rank
from torch_port_train_helpers import REL, assert_rel, port_and_jax_d, port_and_jax_pose_d

B, ALPHA = 4, 0.5
# The image D's input convs (conv_in.16, and conv_in.8 on the fade path)
# take the fakes of the random
# decoder, up to |rgb| 20, which the two packages render 7.5e-5 apart (f32
# sum orders); its gradient, a sum over every pixel that cancels, carries
# that to 3.7e-4 (weight) and 4.9e-4 (bias) of its largest value, the
# same gap as the port's own D gives the two fakes (measured; 2.4e-3 with
# the depth-8 renderer's fakes).
REL_IN = 5e-3
# the G step's sdf-head bias is a sum with cancellation
# (tests/test_torch_port_train_steps.py: REL_G), and so is a decoder noise
# weight's gradient, a sum of noise x cotangent over every pixel (measured
# 3.1e-3 at conv1's; tests/test_torch_port_train_steps.py: REL_PATH)
REL_G, REL_NOISE = 2e-3, 1e-2
# bf16 over a whole step. The image D's logit is a bf16 value before its
# f32 bias (one ulp is 2^-8 to 2^-7 of it) and the GAN loss softplus(-+x)
# moves by up to |x| times that relative: measured 4.4e-3 (G step's GAN
# term, logit ~2.2) and 2.3e-3 (the R1 term) between the packages, and
# 6.8e-3 between JAX's own bf16 and f32 steps. Gradients: JAX's own bf16 D
# step lies 0.23 of a tensor's largest |gradient| and cosine 0.9935 from
# its f32 step; the port's bf16 step lies 0.27 / 0.9948 (D step) and 0.28 /
# 0.9946 (G step with the bf16 decoder) from JAX's bf16 step. A lost cast
# is caught by the port's own bf16 step against its f32 step and by the
# layer-by-layer test, not by these bounds. The image-D terms are held at
# rtol 2e-2, not the mesh test's floor of 2e-3, because the packages' gap
# there (4.4e-3) is above 2e-3.
BF16_LOSS = dict(rtol=2e-3, atol=1e-4)
BF16_D_LOSS = dict(rtol=2e-2, atol=1e-4)
BF16_GRAD_REL, BF16_COS = 0.5, 0.99
OPTIONS = {"d_cat": dict(d_cat=True), "d_seq": dict(d_seq=True),
           "d_r1_chunk": dict(d_r1_chunk=2), "remat_d": dict(remat_d=True)}


def keep_grads():
    """An optax transformation whose state is the last gradient and whose
    update is zero."""
    return optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))


class FixedDraws:
    """The JAX Generator rendering with perturb off and given noise buffers,
    whatever rngs its caller hands it."""

    def __init__(self, gen, noise):
        self.gen, self.noise = gen, noise

    def apply(self, params, *args, rngs=None, method=None, **kw):
        if method is not None:
            return self.gen.apply(params, *args, method=method, **kw)
        return self.gen.apply(params, *args, noise_bufs=self.noise, perturb=False, **kw)


def configs(depth=2, decoder_dtype="float32", with_sdf=True, kernel_size=1):
    from cips3dpp_tpu.models import generator as jg
    from cips3dpp_torch.models import generator as tg

    def make(m):
        return m.GeneratorConfig(
            renderer=m.RendererConfig(n_layers=depth, hidden_dim=32, with_sdf=with_sdf),
            decoder=m.DecoderConfig(channel_multiplier=2, kernel_size=kernel_size,
                                    upsample_list=(128,), style_dim=64, mapping_n_layers=2,
                                    dtype=decoder_dtype),
            img_size=8, n_samples=4)

    return make(jg), make(tg)


def build(depth=2, decoder_dtype="float32", seed=31, with_sdf=True, kernel_size=1):
    jcfg, tcfg = configs(depth, decoder_dtype, with_sdf, kernel_size)
    g, gvars = port_and_jax_generator(jcfg, tcfg, seed=seed)
    jd, pd, d = port_and_jax_d(seed=seed + 1, input_size=16)
    jdr, pdr, dr = port_and_jax_pose_d(seed=seed + 2, input_size=8)
    return dict(jcfg=jcfg, tcfg=tcfg, g=g, pg=np_tree(gvars["params"]), jd=jd, pd=pd, d=d,
                jdr=jdr, pdr=pdr, dr=dr)


@pytest.fixture(scope="module")
def tiny():
    return build()


def train_cfgs(**opts):
    """Both packages' TrainConfig; the plain renderer unless `opts` says
    otherwise (JAX's kernel runs on a TPU only)."""
    from cips3dpp_tpu.train.state import TrainConfig as JTC
    from cips3dpp_torch.train.state import TrainConfig

    kw = {**dict(batch=B, gen_img_size=16, cam_img_size=8, data_img_size=16,
                 fused_renderer_d=False), **opts}
    return JTC(**kw), TrainConfig(**kw)


def inputs(s, key, n_keys, seed):
    """The JAX step's zs and cameras (from the first of its n_keys keys),
    noise buffers and real images; the port's Draws of the same."""
    from cips3dpp_tpu.train.steps import _sample_inputs
    from cips3dpp_torch.core.camera import CameraParams
    from cips3dpp_torch.models.decoder import Decoder
    from cips3dpp_torch.train.steps import Draws

    zs, cam = _sample_inputs(jax.random.split(key, n_keys)[0], B, s["jcfg"])
    rng = np.random.default_rng(seed)
    shapes = Decoder(upsample_list=s["tcfg"].decoder.upsample_list).noise_shapes(8)
    noise = [rng.standard_normal((B,) + sh[1:]).astype(np.float32) for sh in shapes]
    real = (0.5 * rng.standard_normal((B, 16, 16, 3))).astype(np.float32)
    draws = Draws(zs=tuple(t(z) for z in zs), cam=CameraParams(*(t(c) for c in cam)),
                  t_rand=torch.zeros(B, 8, 8, 1), noise=[t(n) for n in noise])
    return noise, real, draws


def jax_state(s):
    from cips3dpp_tpu.train.state import TrainState

    tx = keep_grads()
    p = lambda tree: {"params": jax.tree.map(jnp.asarray, tree)}
    pg, pd, pdr = p(s["pg"]), p(s["pd"]), p(s["pdr"])
    return TrainState(step=jnp.zeros((), jnp.int32), params_g=pg, params_d=pd,
                      params_d_render=pdr, params_g_ema=pg, opt_g=tx.init(pg),
                      opt_d=tx.init(pd), opt_d_render=tx.init(pdr),
                      mean_path_length=jnp.zeros(()))


def jax_steps(s, jtrain, noise):
    from cips3dpp_tpu.models.generator import Generator as JG
    from cips3dpp_tpu.train.steps import make_train_steps

    gen = FixedDraws(JG(s["jcfg"]), [jnp.asarray(n) for n in noise])
    return make_train_steps(gen, s["jd"], s["jdr"], s["jcfg"], jtrain,
                            (keep_grads(), keep_grads(), keep_grads()))


def spy(opt, store, key):
    """Record the gradients a ClippedAdam is handed, by parameter name."""
    step, names = opt.step, {id(p): n for n, p in store.pop("named")}

    def wrapped(grads):
        store[key] = {names[id(p)]: (torch.zeros_like(p) if g is None else g.detach().clone())
                      for k, ps in opt.groups.items() for p, g in zip(ps, grads[k])}
        step(grads)

    opt.step = wrapped


def port_state(s, ttrain):
    from cips3dpp_torch.train.state import create_train_state

    return create_train_state(ttrain, copy.deepcopy(s["g"]), copy.deepcopy(s["d"]),
                              copy.deepcopy(s["dr"]))


def run_d(s, opts, d_regularize, seed=3):
    """(JAX metrics, JAX gradients by port name, port metrics, port
    gradients) of one D step with TrainConfig options `opts`."""
    from cips3dpp_torch.io.jax_params import jax_d_params_to_state_dict, \
        jax_d_pose_params_to_state_dict
    from cips3dpp_torch.train.steps import make_train_steps

    jtrain, ttrain = train_cfgs(**opts)
    key = jax.random.PRNGKey(seed)
    noise, real, draws = inputs(s, key, 6, seed)
    d_step = jax_steps(s, jtrain, noise)[0]
    js, jm = d_step(jax_state(s), jnp.asarray(real), key, ALPHA, d_regularize=d_regularize)
    jgrads = {**{f"d.{k}": v for k, v in jax_d_params_to_state_dict(
                  np_tree(js.opt_d["params"])).items()},
              **{f"dr.{k}": v for k, v in jax_d_pose_params_to_state_dict(
                  np_tree(js.opt_d_render["params"])).items()}}

    state = port_state(s, ttrain)
    store = {}
    store["named"] = [(f"d.{n}", p) for n, p in state.d.named_parameters()]
    spy(state.opt_d, store, "d")
    store["named"] = [(f"dr.{n}", p) for n, p in state.d_render.named_parameters()]
    spy(state.opt_d_render, store, "dr")
    _, pm = make_train_steps(s["tcfg"], ttrain)[0](state, t(real), None, ALPHA, d_regularize,
                                                   draws=draws)
    return ({k: float(v) for k, v in jm.items()}, jgrads, {k: float(v) for k, v in pm.items()},
            {**store["d"], **store["dr"]})


def run_g(s, opts, seed=4):
    """The same for one G step."""
    from cips3dpp_torch.io.jax_params import jax_params_to_state_dict
    from cips3dpp_torch.train.steps import make_train_steps

    jtrain, ttrain = train_cfgs(**opts)
    key = jax.random.PRNGKey(seed)
    noise, _, draws = inputs(s, key, 4, seed)
    g_step = jax_steps(s, jtrain, noise)[1]
    js, jm = g_step(jax_state(s), key, ALPHA)
    jgrads = jax_params_to_state_dict(np_tree(js.opt_g["params"]))
    state = port_state(s, ttrain)
    store = {"named": list(state.g.named_parameters())}
    spy(state.opt_g, store, "g")
    _, pm = make_train_steps(s["tcfg"], ttrain)[1](state, None, ALPHA, draws=draws)
    return ({k: float(v) for k, v in jm.items()}, {k: v for k, v in jgrads.items()},
            {k: float(v) for k, v in pm.items()}, store["g"])


def check_f32(jm, jg, pm, pg, rel=REL):
    assert jm.keys() <= pm.keys()
    for k in jm:
        np.testing.assert_allclose(pm[k], jm[k], rtol=5e-5, atol=1e-7, err_msg=k)
    assert jg.keys() == pg.keys()
    for k in jg:
        bound = REL_IN if k.startswith("d.conv_in.") else \
            REL_NOISE if k.endswith("noise.weight") else rel
        assert_rel(pg[k], jg[k], rel=bound, name=k)


def bf16_gaps(jg, pg):
    """(largest gap over its tensor's largest |gradient|, smallest cosine)."""
    worst, cos = 0.0, 1.0
    for k in jg:
        g, w = a(pg[k]).astype(np.float64).ravel(), a(jg[k]).astype(np.float64).ravel()
        scale = np.abs(w).max()
        if scale == 0:
            assert np.abs(g).max() == 0, k
            continue
        worst = max(worst, np.abs(g - w).max() / scale)
        cos = min(cos, float(g @ w / (np.linalg.norm(g) * np.linalg.norm(w))))
    return worst, cos


# ------------------------------------------------------------- options --

CASES = [(option, r1) for option in OPTIONS for r1 in (True, False)]


@pytest.mark.parametrize("option,d_regularize", CASES,
                         ids=[f"{o}-{'r1' if r else 'no_r1'}" for o, r in CASES])
def test_d_step_option_matches_jax(tiny, option, d_regularize):
    """d_cat, d_seq, d_r1_chunk and remat_d each give JAX's D step with the
    same option: metrics and every gradient of both discriminators."""
    jm, jg, pm, pg = run_d(tiny, OPTIONS[option], d_regularize)
    assert (jm["d_loss_gp_decoder"] > 0) == d_regularize
    check_f32(jm, jg, pm, pg)


def test_g_step_remat_d_matches_jax(tiny):
    """remat_d recomputes the image D in the G step too (the same result)."""
    check_f32(*run_g(tiny, dict(remat_d=True)), rel=REL_G)


def port_d_step(s, opts, d_regularize, seed=3):
    """The port's D step alone: (metrics, gradients by name)."""
    from cips3dpp_torch.train.steps import make_train_steps

    ttrain = train_cfgs(**opts)[1]
    _, real, draws = inputs(s, jax.random.PRNGKey(seed), 6, seed)
    state = port_state(s, ttrain)
    store = {"named": list(state.d.named_parameters())}
    spy(state.opt_d, store, "d")
    _, pm = make_train_steps(s["tcfg"], ttrain)[0](state, t(real), None, ALPHA, d_regularize,
                                                   draws=draws)
    return {k: float(v) for k, v in pm.items()}, store["d"]


def test_split_forms_equal_the_two_pass_form(tiny):
    """JAX calls d_cat and d_seq exact against the two-pass form
    (tests/test_train.py::test_d_cat_matches_fused); so are the port's, and
    R1 as one chunk of the whole batch, on one state and one set of draws."""
    base = port_d_step(tiny, {}, True)
    for opts in (dict(d_cat=True), dict(d_seq=True), dict(d_r1_chunk=B),
                 dict(d_cat=True, remat_d=True)):
        got = port_d_step(tiny, opts, True)
        check_f32(base[0], base[1], *got)


@pytest.mark.parametrize("opts", [{}, dict(d_r1_chunk=2), dict(d_seq=True)],
                         ids=["r1", "d_r1_chunk", "d_seq"])
def test_remat_d_r1_equals_the_plain_form(tiny, opts):
    """remat_d's R1 region (train/steps.py: _RematR1, the logit and its
    input gradient recomputed together in the backward) gives the plain
    form's R1 value and image-D gradients on one state and one set of
    draws, in each of the step's R1 paths: the same f32 operations run
    again, so they agree to relative 1e-6."""
    base = port_d_step(tiny, opts, True)
    got = port_d_step(tiny, {**opts, "remat_d": True}, True)
    assert base[0]["d_loss_gp_decoder"] > 0
    assert got[0]["d_loss_gp_decoder"] == pytest.approx(base[0]["d_loss_gp_decoder"], rel=1e-6)
    assert got[1].keys() == base[1].keys()
    for k, w in base[1].items():
        assert float((got[1][k] - w).abs().max()) <= 1e-6 * float(w.abs().max()), k


def test_default_d_step_at_depth_8_matches_jax(capsys):
    """The repair of the D step's route: with the default TrainConfig
    (fused_renderer_d=True) a depth-8 renderer, which K1 does not take,
    renders plainly (as the JAX renderer's gate does) and says so once;
    the step matches JAX's. K1 itself still raises at depth 8."""
    from cips3dpp_torch.train.state import TrainConfig

    assert TrainConfig().fused_renderer_d
    s = build(depth=8, seed=41)
    jm, jg, pm, pg = run_d(s, dict(fused_renderer_d=True), True)
    check_f32(jm, jg, pm, pg)
    assert capsys.readouterr().err.count("renders with the plain renderer") == 1
    with pytest.raises(ValueError, match="depth 8"):
        s["g"].renderer(torch.zeros(1, 4, 4, 3), torch.ones(1, 4, 3), torch.ones(1, 4, 3),
                        torch.ones(1, 4, 4), torch.full((1, 1, 1), 0.88),
                        torch.full((1, 1, 1), 1.12), torch.zeros(1, 9, 256), fused=True)


def test_kernel_route_refusal():
    from cips3dpp_torch.kernels.siren_render import kernel_route_refusal

    assert kernel_route_refusal(2, 256, 24, True, "cuda") is None
    assert kernel_route_refusal(2, 32, 4, True, "cpu") is None  # K1's plain version
    assert "depth 8" in kernel_route_refusal(8, 256, 24, True, "cpu")
    assert kernel_route_refusal(2, 128, 24, True, "cuda") is None
    # every width and any sample count take K1 (padded), past 2048 too
    for width, n in ((96, 24), (256, 65), (1024, 24), (2048, 96), (2049, 24), (4096, 8)):
        assert kernel_route_refusal(2, width, n, True, "cuda") is None
    assert kernel_route_refusal(2, 2049, 24, True, "cpu") is None  # the plain version
    why = kernel_route_refusal(2, 2049, 0, True, "cuda")
    assert "0 samples" in why and "1 or more samples" in why
    assert "no SDF" in kernel_route_refusal(2, 256, 24, False, "cuda")


# ---------------------------------------------------------------- bf16 --


def _bits_equal(name, jax_fn, port_fn, x, ct):
    """Shares of equal output and input-gradient values of one layer in
    bf16, JAX's against the port's, on the same bf16 input (NHWC) and
    cotangent."""
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    out, vjp = jax.vjp(jax_fn, xj)
    gj = np.asarray(vjp(jnp.asarray(ct).astype(out.dtype))[0].astype(jnp.float32))
    xt = torch.from_numpy(x.copy()).bfloat16().requires_grad_(True)
    ot = port_fn(xt.permute(0, 3, 1, 2))
    ot = ot.permute(0, 2, 3, 1) if ot.ndim == 4 else ot
    (gt,) = torch.autograd.grad(ot, xt, torch.from_numpy(ct.copy()).to(ot.dtype))
    assert ot.dtype == torch.bfloat16 or name == "head", (name, ot.dtype)
    return (float((np.asarray(out.astype(jnp.float32)) == a(ot)).mean()),
            float((gj == a(gt)).mean()))


def test_bf16_discriminator_rounds_where_jax_rounds():
    """Layer by layer, in bf16, on the same bf16 input: the input conv, a
    ResBlock (blur, down conv, skip, / bf16(sqrt 2)), the fused lrelu, the
    minibatch stddev and the head give JAX's bits but for the values an f32
    sum order flips (measured: all equal but 0.15% of a ResBlock's outputs,
    0.5% of its input gradients and 3% of the head's); the whole D's
    logits lie within one bf16 ulp of JAX's."""
    from cips3dpp_tpu.models import discriminator as jdm
    from cips3dpp_tpu.models.layers import ConvLayer
    from cips3dpp_tpu.ops.fused_act import fused_leaky_relu as jlrelu
    from cips3dpp_torch.models.discriminator import minibatch_stddev
    from cips3dpp_torch.ops.fused_act import fused_leaky_relu

    jd, pd, d = port_and_jax_d(seed=5, input_size=16)
    p = jax.tree.map(jnp.asarray, pd)
    rng = np.random.default_rng(0)
    bf = lambda *sh: np.asarray(jnp.asarray(rng.standard_normal(sh).astype(np.float32))
                                .astype(jnp.bfloat16).astype(jnp.float32))
    bias = rng.standard_normal(512).astype(np.float32)
    layers = {
        "conv_in": (lambda v: ConvLayer(512, 1).apply({"params": p["conv_in_16"]}, v),
                    d.conv_in["16"], bf(2, 16, 16, 3), bf(2, 16, 16, 512)),
        "resblock": (lambda v: jdm.ResBlock(512, 512).apply({"params": p["block_16"]}, v),
                     d.blocks["16"], bf(2, 16, 16, 512), bf(2, 8, 8, 512)),
        "lrelu": (lambda v: jlrelu(v, jnp.asarray(bias)),
                  lambda v: fused_leaky_relu(v, torch.from_numpy(bias), channel_axis=1),
                  bf(2, 8, 8, 512), bf(2, 8, 8, 512)),
        "stddev": (jdm.minibatch_stddev, minibatch_stddev, bf(4, 4, 4, 512), bf(4, 4, 4, 513)),
        "head": (lambda v: jdm._DFinal(512).apply({"params": p["final"]}, v).astype(jnp.float32),
                 lambda v: d.head(v).float(), bf(4, 4, 4, 512),
                 rng.standard_normal((4, 1)).astype(np.float32)),
    }
    floors = {"resblock": (0.99, 0.8), "head": (1.0, 0.9), "stddev": (1.0, 0.999)}
    for name, (jf, pf, x, ct) in layers.items():
        fwd, bwd = _bits_equal(name, jf, pf, x, ct)
        want = floors.get(name, (1.0, 1.0))
        assert fwd >= want[0] and bwd >= want[1], (name, fwd, bwd)
    x = bf(4, 16, 16, 3)
    for alpha in (1.0, 0.5):
        jl = np.asarray(jd.apply({"params": p}, jnp.asarray(x).astype(jnp.bfloat16), alpha=alpha)
                        .astype(jnp.float32))
        with torch.no_grad():
            tl = a(d(torch.from_numpy(x.copy()).bfloat16(), alpha))
            tf = a(d(torch.from_numpy(x.copy()), alpha))
        np.testing.assert_allclose(tl, jl, rtol=2.0**-7, atol=0)
        assert np.abs(tl - tf).max() > 0  # bf16 is not f32


def _check_bf16_metrics(jm, pm):
    for k in jm:
        on_d = "decoder" in k or k == "d_loss_total" or k.startswith("g_loss_total")
        np.testing.assert_allclose(pm[k], jm[k], err_msg=k,
                                   **(BF16_D_LOSS if on_d else BF16_LOSS))


def test_bf16_d_step_at_the_bf16_floor(tiny):
    """d_dtype="bfloat16" (the image D computes in bf16, its logit in f32;
    the pose D stays f32) against JAX's with the same option, with R1;
    the port's own f32 step differs from its bf16 step."""
    jm, jg, pm, pg = run_d(tiny, dict(d_dtype="bfloat16"), True)
    _check_bf16_metrics(jm, pm)
    f32 = port_d_step(tiny, {}, True)[0]
    assert abs(pm["d_loss_gp_decoder"] - f32["d_loss_gp_decoder"]) > 1e-3 * f32[
        "d_loss_gp_decoder"]
    for k in jg:  # the pose D is f32 in both: the f32 bound
        if k.startswith("dr."):
            assert_rel(pg[k], jg[k], name=k)
    worst, cos = bf16_gaps({k: v for k, v in jg.items() if k.startswith("d.")}, pg)
    assert worst <= BF16_GRAD_REL and cos >= BF16_COS, (worst, cos)


def port_g_step(s, opts, seed=4):
    """The port's G step alone: (metrics, gradients by name)."""
    from cips3dpp_torch.train.steps import make_train_steps

    ttrain = train_cfgs(**opts)[1]
    _, _, draws = inputs(s, jax.random.PRNGKey(seed), 4, seed)
    state = port_state(s, ttrain)
    store = {"named": list(state.g.named_parameters())}
    spy(state.opt_g, store, "g")
    _, pm = make_train_steps(s["tcfg"], ttrain)[1](state, None, ALPHA, draws=draws)
    return {k: float(v) for k, v in pm.items()}, store["g"]


def test_bf16_decoder_g_step_at_the_bf16_floor():
    """The G step of train_r1024_fast: a bf16-compute decoder (parameters
    and gradients f32) and the image D in bf16, against JAX's. The image-D
    GAN term is held at BF16_D_LOSS, not the mesh test's rtol 2e-3: the two
    packages' bf16 logits lie up to an ulp apart, which moves it by 4.4e-3
    (measured). So the bf16 of the step is checked on the port itself: the
    same step with the image D in f32 moves the GAN term by more than the
    2e-3 floor (measured 7.8e-3), and with the decoder in f32 moves the
    decoder's gradients by more than BF16_GRAD_REL (measured 1.41)."""
    s = build(decoder_dtype="bfloat16", seed=51)
    jm, jg, pm, pg = run_g(s, dict(d_dtype="bfloat16"))
    _check_bf16_metrics(jm, pm)
    assert all(v.dtype == torch.float32 for v in pg.values())
    worst, cos = bf16_gaps(jg, pg)
    assert worst <= BF16_GRAD_REL and cos >= BF16_COS, (worst, cos)
    f32_d = port_g_step(s, {})[0]["g_loss_gan_decoder"]
    assert abs(pm["g_loss_gan_decoder"] - f32_d) > BF16_LOSS["rtol"] * abs(f32_d)
    f32_dec = port_g_step(build(seed=51), dict(d_dtype="bfloat16"))[1]
    assert bf16_gaps(f32_dec, pg)[0] > BF16_GRAD_REL


def test_check_config():
    from cips3dpp_torch.train.state import TrainConfig, check_config

    check_config(TrainConfig(d_cat=True, d_seq=True, d_r1_chunk=2, remat_d=True,
                             d_dtype="bfloat16"))
    with pytest.raises(ValueError, match="d_dtype"):
        check_config(TrainConfig(d_dtype="float16"))
    with pytest.raises(ValueError, match="d_r1_chunk"):
        check_config(TrainConfig(d_r1_chunk=0))


# ---------------------------------------------------------------- mesh --

# the rank side (tiny state, one D step with R1 per option, the planted
# per-rank stddev) is in torch_port_options_helpers.py: the ranks import it
# without JAX
@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    from concurrent.futures import ThreadPoolExecutor

    from cips3dpp_torch.parallel import run_ranks

    tmp = tmp_path_factory.mktemp("options_mesh")
    with ThreadPoolExecutor(1) as pool:
        single = pool.submit(_mesh_d_steps, None, MESH_OPTIONS)
        ranks = run_ranks(_mesh_rank, 2, device="cpu", workdir=str(tmp), timeout=600)
        return ranks, single.result()


@pytest.mark.parametrize("option", list(MESH_OPTIONS))
def test_two_ranks_equal_one_process(mesh_runs, option):
    """d_cat (each half's minibatch stddev over its global half), d_seq,
    d_r1_chunk (chunks of the global batch, shared round the ranks) and
    remat_d (R1's recomputed region, its stddev gathered again in the
    backward) on two gloo ranks equal one process: every metric and every
    updated tensor of both discriminators within the parallel test's
    TOL."""
    import test_torch_port_parallel as par

    ranks, single = mesh_runs
    for r in ranks:
        for part in (0, 1):
            gap, bad = par._gap(r["steps"][option][part], single[option][part])
            assert not bad, (option, part, bad[:5], gap)


def test_run_ranks_kills_ranks_past_its_timeout(tmp_path):
    """A rank still running at run_ranks' timeout is killed and the call
    raises, so a hung collective fails its test instead of the run; with
    no timeout, ranks that end at different times are all waited for."""
    import time

    from cips3dpp_torch.parallel import run_ranks
    from torch_port_options_helpers import _sleep

    assert run_ranks(_sleep, 2, 1.0, device="cpu", workdir=str(tmp_path)) == [None, None]
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="_sleep"):
        run_ranks(_sleep, 2, 600, device="cpu", workdir=str(tmp_path), timeout=10)
    assert time.monotonic() - t0 < 60


def test_per_rank_stddev_under_d_cat_is_caught(mesh_runs):
    """The planted fault (each half's stddev over the rank's rows) moves the
    d_cat step outside TOL."""
    import test_torch_port_parallel as par

    ranks, single = mesh_runs
    for r in ranks:
        gap, bad = par._gap(r["planted"]["d_cat"][1], single["d_cat"][1])
        assert bad and gap > 1e3 * par.TOL["atol"], (gap, bad[:3])


def test_every_shipped_section_is_taken():
    """check_config and the generator config take every section of the
    three shipped configs (train_r1024_fast and train_r1024_b8 among them),
    and the D and G steps' routes follow K1's geometry: the r1024 sections
    render through K1 on the card, the depth-8 ones (train_r64, StyleSDF)
    plainly."""
    import glob
    import os

    from cips3dpp_torch.io.config import (
        generator_config_from_dict, load_command_config, read_yaml, train_config_from_dict,
    )
    from cips3dpp_torch.kernels.siren_render import kernel_route_refusal
    from cips3dpp_torch.train.state import check_config

    configs = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "configs")
    routes = {}
    for path in sorted(glob.glob(os.path.join(configs, "*.yaml"))):
        for section in read_yaml(path):
            if section.startswith("_"):
                continue
            cfg = load_command_config(path, section)
            check_config(train_config_from_dict(cfg))
            g = generator_config_from_dict(cfg.get("G_cfg", {}))
            routes[section] = kernel_route_refusal(g.renderer.n_layers, g.renderer.hidden_dim,
                                                   g.n_samples, g.renderer.with_sdf, "cuda")
    assert routes["train_r1024_fast"] is None and routes["train_r1024_b8"] is None
    assert "depth 8" in routes["train_r64"] and "depth 8" in routes["train_volume_renderer"]
    ffhq = os.path.join(configs, "ffhq.yaml")
    fast = train_config_from_dict(load_command_config(ffhq, "train_r1024_fast"))
    b8 = train_config_from_dict(load_command_config(ffhq, "train_r1024_b8"))
    assert (fast.d_dtype, fast.d_r1_chunk, fast.d_cat, fast.d_seq) == ("bfloat16", 2, True, False)
    assert (b8.batch, b8.d_cat, b8.d_seq) == (8, False, True)
