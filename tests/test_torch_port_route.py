"""K1's default route follows the JAX package's gate: the SIREN render
kernel only on the card and only for a geometry it takes. JAX's fused
flags are inert off the TPU (cips3dpp_tpu/train/state.py:76-78,
models/renderer.py:86-90, apps/inversion.py:132-139), so on the CPU the
port's default D step and default Projector render with the plain f32
renderer, as JAX's do; an explicit request still reaches K1's plain
version (tests/test_torch_port_train_steps.py,
tests/test_torch_port_inversion.py).
"""

import torch

import test_torch_port_train_options as opts


def test_default_d_step_matches_jax_default_d_step():
    """The default TrainConfig (fused_renderer_d=True in both packages) at
    depth 2, width 32, on the CPU: one D step with lazy R1 against JAX's,
    at the step tests' bounds (metrics rtol 5e-5, gradients within 1e-4
    of each tensor's largest). Through K1's plain version the losses lie
    up to 1.4e-3 apart (bf16 products), which fails them."""
    from cips3dpp_torch.train.state import TrainConfig

    assert TrainConfig().fused_renderer_d
    s = opts.build(seed=51)
    opts.check_f32(*opts.run_d(s, dict(fused_renderer_d=True), True))


def test_default_projector_renders_plainly_off_the_card(capsys):
    """A default Projector on the CPU gives the loss, gradients and image
    of Projector(fused=False) bit for bit, and says nothing."""
    from cips3dpp_torch.apps import inversion as tinv
    from cips3dpp_torch.models.generator import Generator
    from cips3dpp_torch.models.layers import randomize_zero_init_
    from cips3dpp_torch.models.vgg import init_vgg

    _, tcfg = opts.configs()
    g = Generator(tcfg, device="cpu", seed=52)
    randomize_zero_init_(g, torch.Generator().manual_seed(52))
    vgg = init_vgg(torch.Generator().manual_seed(0), device="cpu")
    cfg = tinv.InversionConfig(w_avg_samples=16)
    default, plain = tinv.Projector(g, vgg, cfg), tinv.Projector(g, vgg, cfg, fused=False)
    target = torch.rand((16, 16, 3), generator=torch.Generator().manual_seed(1)) * 2 - 1
    t_rand = torch.rand((2, 8, 8, 1), generator=torch.Generator().manual_seed(2))
    out = []
    for proj in (default, plain):
        state = proj.init_state(torch.Generator().manual_seed(3), (0.1, 0.1))
        targets = proj.prepare_targets(target)
        metrics, grads = proj.loss_and_grads(state, targets, t_rand, False, True)
        with torch.no_grad():
            rgb = proj.forward(tinv._leaves(state), t_rand, False)["rgb"]
        out.append((metrics, grads, rgb))
    (m_d, g_d, rgb_d), (m_p, g_p, rgb_p) = out
    assert torch.equal(rgb_d, rgb_p)
    assert all(torch.equal(m_d[k], m_p[k]) for k in m_p)
    assert all(torch.equal(g_d[k], g_p[k]) for k in g_p)
    assert not default.fused
    assert capsys.readouterr().err == ""


def test_default_route_rule():
    """`default_kernel_route` takes K1 on the card at K1's geometry only
    (a depth-2 SDF renderer of any width and sample count, as JAX's gate);
    off the card it renders plainly without a word, and a geometry K1
    does not take is refused with its reason on any device (only
    torch.device(...).type is read: no card needed). Widths past 2048
    take K1 too, at the next multiple of 128 in the run-time-width build."""
    from cips3dpp_torch.kernels.siren_render import (
        RUN_TIME_WIDTH_DEFINE, default_kernel_route, kernel_build, kernel_route_refusal,
    )

    assert default_kernel_route(2, 256, 24, True, "cuda") == (True, None)
    assert default_kernel_route(2, 256, 24, True, "cpu") == (False, None)
    assert default_kernel_route(2, 32, 4, True, "cpu") == (False, None)
    for width, kw in ((2049, 2176), (4096, 4096)):
        assert default_kernel_route(2, width, 24, True, "cuda") == (True, None)
        assert kernel_route_refusal(2, width, 24, True, torch.device("cuda", 0)) is None
        assert kernel_build(width, 24) == (kw, (RUN_TIME_WIDTH_DEFINE, "-DK1_FIXED_S=0"))
        assert default_kernel_route(2, width, 24, True, "cpu") == (False, None)
    for width, n in ((32, 1), (128, 24), (512, 64), (256, 48), (96, 24), (256, 65),
                     (1024, 24), (2048, 96), (1, 1), (700, 257)):
        assert default_kernel_route(2, width, n, True, "cuda") == (True, None)
    take, why = default_kernel_route(2, 256, 24, False, "cuda")
    assert not take and "no SDF" in why
    take, why = default_kernel_route(8, 256, 24, True, "cpu")
    assert not take and "depth 8" in why
