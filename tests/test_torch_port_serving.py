"""The serving slice end to end: the port's prepare_trajectory +
render_frame (F = 1 and F = 3) + render_trajectory_scan on the CPU
(the plain versions of both kernels) against cips3dpp_tpu.serving with
its Pallas kernels in interpret mode, at tests/test_serving.py's tiny
config, with nonzero noise weights and biases and the same noise maps.

Why not exact: both kernels round some matmul inputs to bf16 (the SIREN
layers, the decoder blocks' conv_b); where the two sides' f32 sums land an
activation on the other side of a bf16 rounding boundary, the rounded
input moves by one bf16 ulp (2^-8 relative) and the change propagates to
the image. The rest of this config's decoder is f32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import a, np_tree, port_and_jax_generator, t

# measured max |diff| 1.3e-2 on rgb (mean 3e-4) and 3e-5 on the thumbnail
ATOL = {"rgb": 3e-2, "thumb_rgb": 1e-3}


def _configs(channel_multiplier=2):
    from cips3dpp_tpu.models import generator as jg
    from cips3dpp_torch.models import generator as tg

    def make(m):
        return m.GeneratorConfig(
            renderer=m.RendererConfig(n_layers=2, hidden_dim=32),
            decoder=m.DecoderConfig(size_end=64, upsample_list=(32, 64),
                                    style_dim=64, mapping_n_layers=2,
                                    channel_multiplier=channel_multiplier),
            img_size=16, n_samples=8,
        )

    return jg, make(jg), make(tg)


def _served(channel_multiplier=2):
    from cips3dpp_tpu.serving import prepare_trajectory as jprep
    from cips3dpp_torch.serving import prepare_trajectory

    jg, jcfg, tcfg = _configs(channel_multiplier)
    tmodel, variables = port_and_jax_generator(jcfg, tcfg, seed=11)
    jmodel = jg.Generator(jcfg)
    rng = np.random.default_rng(12)
    zs = [rng.standard_normal((1, 256)).astype(np.float32) for _ in range(2)]
    noise = [rng.standard_normal(s).astype(np.float32)
             for s in tmodel.decoder.noise_shapes(jcfg.img_size)]
    jp = jprep(jmodel, variables, tuple(jnp.asarray(z) for z in zs),
               noise_bufs=[jnp.asarray(n) for n in noise])
    tp = prepare_trajectory(tmodel, [t(z) for z in zs],
                            noise_bufs=[t(n) for n in noise], device="cpu")
    return jmodel, jp, tmodel, tp, zs, noise


@pytest.fixture(scope="module")
def served():
    return _served()


def _compare(got, want):
    for k in ("rgb", "thumb_rgb"):
        assert tuple(got[k].shape) == want[k].shape, k
        np.testing.assert_allclose(a(got[k]), a(want[k]), rtol=0, atol=ATOL[k],
                                   err_msg=k)


def test_render_frame_and_scan_match_jax(served):
    from cips3dpp_tpu.serving import render_frame as jrender
    from cips3dpp_tpu.serving import render_trajectory_scan as jscan
    from cips3dpp_torch.serving import render_frame, render_trajectory_scan

    jmodel, jp, tmodel, tp, _, _ = served
    yaws = np.asarray([0.2, -0.3], np.float32)
    outs = []
    for yaw in yaws:
        want = jrender(jmodel, jp, jnp.full((1,), yaw), jnp.zeros((1,)),
                       interpret=True)
        got = render_frame(tmodel, tp, t([yaw]), torch.zeros(1), device="cpu")
        assert got["rgb"].shape == (1, 64, 64, 3)
        _compare(got, want)
        outs.append(got)
    # the camera steers the render
    assert float((outs[0]["rgb"] - outs[1]["rgb"]).abs().max()) > 1e-3

    want = jax.jit(lambda p, y: jscan(jmodel, p, y, interpret=True))(
        jp, jnp.asarray(yaws))
    got = render_trajectory_scan(tmodel, tp, t(yaws), device="cpu")
    # the sum of 2 per-frame means: 2x a mean |diff| bound of 1e-3
    np.testing.assert_allclose(float(got), float(want), rtol=0, atol=2e-3)
    own = sum(float(o["rgb"].mean()) for o in outs)
    np.testing.assert_allclose(float(got), own, rtol=0, atol=1e-5)


@pytest.mark.parametrize("m", [1, 4, 8])
def test_render_frame_at_channel_multipliers_match_jax(m):
    """The serving fixture at channel multiplier 1, 4 and 8 (its 64^2 block
    at C = 256, 1024 and 2048, its 32^2 block at 512), the JAX weights
    carried by io/jax_params.py: the frame at the fixture's ATOL of JAX's."""
    from cips3dpp_tpu.serving import render_frame as jrender
    from cips3dpp_torch.serving import render_frame

    jmodel, jp, tmodel, tp, _, _ = _served(m)
    assert [b["bp"]["w2t"].shape[0] for b in tp["dec"]["blocks"] if "bp" in b] == [512, 256 * m]
    want = jrender(jmodel, jp, jnp.full((1,), 0.2), jnp.zeros((1,)), interpret=True)
    got = render_frame(tmodel, tp, t([0.2]), torch.zeros(1), device="cpu")
    _compare(got, want)


@pytest.mark.parametrize("m", [8, 16])
def test_weight_bridge_loads_wide_multiplier_trees(m):
    """io/jax_params.py carries a JAX tree of the serving fixture at channel
    multiplier 8 and 16 (its 64^2 layers at C = 2048 and 4096) into the
    port's Generator: every tensor equal to the JAX package's exporter's,
    under the reference's names."""
    from cips3dpp_tpu.io.torch_import import export_generator_state_dict
    from cips3dpp_torch.io.jax_params import load_jax_params
    from cips3dpp_torch.models import generator as tg

    _, jcfg, tcfg = _configs(m)
    _, variables = port_and_jax_generator(jcfg, tcfg, seed=13)
    tmodel = load_jax_params(tg.Generator(tcfg, device="cpu", seed=99),
                             np_tree(variables["params"]))
    want = export_generator_state_dict(variables)
    mine = tmodel.state_dict()
    assert sorted(mine) == sorted(want)
    assert tuple(mine["decoder.convs.7.conv.weight"].shape)[1:3] == (256 * m, 256 * m)
    for k, w in want.items():
        np.testing.assert_array_equal(a(mine[k]), np.asarray(w, np.float32), err_msg=k)


def test_render_frame_batched_matches_jax(served):
    """F = 3 frames in one call (rays stacked for the SIREN, frames stacked
    on the decoder block's rows) against JAX's batched call, and equal to
    the frames rendered one by one."""
    from cips3dpp_tpu.serving import render_frame as jrender
    from cips3dpp_torch.serving import render_frame, render_trajectory_scan

    jmodel, jp, tmodel, tp, _, _ = served
    azims = np.asarray([0.25, 0.0, -0.25], np.float32)
    elevs = np.asarray([0.0, 0.1, -0.1], np.float32)
    want = jrender(jmodel, jp, jnp.asarray(azims), jnp.asarray(elevs),
                   interpret=True)
    got = render_frame(tmodel, tp, t(azims), t(elevs), device="cpu")
    assert got["rgb"].shape == (3, 64, 64, 3)
    _compare(got, want)
    for i in range(3):
        one = render_frame(tmodel, tp, t(azims[i:i + 1]), t(elevs[i:i + 1]),
                           device="cpu")
        for k in ("rgb", "thumb_rgb"):
            torch.testing.assert_close(got[k][i:i + 1], one[k], rtol=0, atol=1e-5)
    c1 = render_trajectory_scan(tmodel, tp, t(azims), t(elevs), device="cpu")
    c3 = render_trajectory_scan(tmodel, tp, t(azims), t(elevs), device="cpu",
                                frames_per_step=3)
    np.testing.assert_allclose(float(c1), float(c3), rtol=0, atol=1e-5)


def test_generator_fused_route_matches_render_frame(served):
    """Generator.forward(fused_renderer=True, fused_decoder=True) at batch 1
    is prepare_trajectory + render_frame in one call: the same kernel
    wrappers (here their plain versions) on the same folded weights, so
    only f32 noise is allowed."""
    from cips3dpp_torch.core.camera import camera_from_angles
    from cips3dpp_torch.serving import render_frame

    _, _, tmodel, tp, zs, noise = served
    cfg = tmodel.cfg
    azim, elev = t([0.15]), t([-0.05])
    cam = camera_from_angles(azim, elev, cfg.img_size, fov_ang=cfg.fov_ang,
                             dist_radius=cfg.dist_radius)
    with torch.no_grad():
        got = tmodel([t(z) for z in zs], cam.extrinsics, cam.focal, cam.near,
                     cam.far, noise_bufs=[t(n) for n in noise], perturb=False,
                     fused_renderer=True, fused_decoder=True)
    want = render_frame(tmodel, tp, azim, elev, device="cpu")
    for k in ("rgb", "thumb_rgb"):
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=1e-5)


def test_fused_flags_raise_where_the_kernels_cannot_run(served):
    """A fused flag that the kernels cannot serve raises; it never runs the
    plain network in the kernel's place."""
    from cips3dpp_torch.core.camera import camera_from_angles
    from cips3dpp_torch.models.renderer import VolumeFeatureRenderer

    _, _, tmodel, _, zs, noise = served
    cfg = tmodel.cfg
    cam = camera_from_angles(t([0.1, -0.1]), t([0.0, 0.0]), cfg.img_size)
    zs2 = [t(np.repeat(z, 2, axis=0)) for z in zs]
    with pytest.raises(ValueError, match="batch 1"):
        tmodel(zs2, cam.extrinsics, cam.focal, cam.near, cam.far,
               noise_bufs=[t(n) for n in noise], perturb=False, fused_decoder=True)
    rend = VolumeFeatureRenderer(depth=3, hidden_dim=16)
    r, n = 4, 8
    with pytest.raises(ValueError, match="depth-2"):
        rend(torch.zeros(1, r, n, 3), torch.ones(1, r, 3), torch.ones(1, r, 3),
             torch.ones(1, r, n), cam.near[:1], cam.far[:1],
             torch.zeros(1, 4, 256), fused=True)


def test_noise_seed_serving_matches_jax(served):
    """prepare_trajectory(noise_seed=...) (hash noise made by the block
    kernels, here their plain versions, and hash_noise_map buffers for the
    plain layers) against JAX's, and against the port fed the seed's own
    buffers; Generator.forward with the seed takes the same route."""
    from cips3dpp_tpu.serving import prepare_trajectory as jprep
    from cips3dpp_tpu.serving import render_frame as jrender
    from cips3dpp_torch.core.camera import camera_from_angles
    from cips3dpp_torch.serving import prepare_trajectory, render_frame

    jmodel, _, tmodel, _, zs, _ = served
    _, variables = port_and_jax_generator(jmodel.cfg, tmodel.cfg, seed=11)  # served's weights
    jp = jprep(jmodel, variables, tuple(jnp.asarray(z) for z in zs), noise_seed=9)
    tp = prepare_trajectory(tmodel, [t(z) for z in zs], noise_seed=9, device="cpu")
    azim, elev = np.asarray([0.1], np.float32), np.asarray([0.05], np.float32)
    want = jrender(jmodel, jp, jnp.asarray(azim), jnp.asarray(elev), interpret=True)
    got = render_frame(tmodel, tp, t(azim), t(elev), device="cpu")
    _compare(got, want)
    bufs = tmodel.decoder.hash_noise(9, tmodel.cfg.img_size, device="cpu")
    tb = prepare_trajectory(tmodel, [t(z) for z in zs], noise_bufs=bufs, device="cpu")
    by_bufs = render_frame(tmodel, tb, t(azim), t(elev), device="cpu")
    torch.testing.assert_close(got["rgb"], by_bufs["rgb"], rtol=0, atol=1e-5)
    cam = camera_from_angles(t(azim), t(elev), tmodel.cfg.img_size)
    with torch.no_grad():
        fwd = tmodel([t(z) for z in zs], cam.extrinsics, cam.focal, cam.near, cam.far,
                     perturb=False, fused_renderer=True, fused_decoder=True,
                     noise_seed=9)
    torch.testing.assert_close(fwd["rgb"], got["rgb"], rtol=0, atol=1e-5)
