"""The sampling apps: the port's apps/sample.py against the JAX package's
on the CPU: the four camera trajectories, slerp/lerp, render_trajectory on
a tiny model with the same noise buffers, the style-mixing grid with the
same z's, and the decoder interpolation; then the port's own seed and
fused routes through render_trajectory.

The tiny model's decoder is f32, so the plain paths of the two packages
agree to f32 rounding; the fused route adds the blocks' bf16 conv_b
operands (tests/test_torch_port_serving.py's bounds).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import a, port_and_jax_generator, t


def _cams_close(got, want, atol=1e-6):
    for name, g, w in zip(want._fields, got, want):
        assert tuple(g.shape) == w.shape, name
        np.testing.assert_allclose(a(g), a(w), rtol=0, atol=atol, err_msg=name)


@pytest.mark.parametrize("name,kw", [
    ("yaw_trajectory", dict(n_frames=12, img_size=64)),
    ("circle_trajectory", dict(n_frames=10, img_size=64, fov_range=(5.0, 7.0))),
    ("elev_circle_trajectory", dict(n_frames=10, img_size=64)),
    ("translate_rotate_trajectory", dict(n_frames=6, img_size=64)),
    ("translate_rotate_trajectory", dict(n_frames=6, img_size=64, only_rotate=True)),
])
def test_trajectories_match_jax(name, kw):
    from cips3dpp_tpu.apps import sample as js
    from cips3dpp_torch.apps import sample as ts

    _cams_close(getattr(ts, name)(**kw, device="cpu"), getattr(js, name)(**kw))


def test_slerp_lerp_match_jax():
    from cips3dpp_tpu.apps.sample import lerp as jlerp, slerp as jslerp
    from cips3dpp_torch.apps.sample import lerp, slerp

    rng = np.random.default_rng(0)
    z1, z2 = rng.standard_normal((2, 3, 16)).astype(np.float32)
    for tt in (0.0, 0.3, 1.0):
        np.testing.assert_allclose(a(slerp(t(z1), t(z2), tt)), a(jslerp(z1, z2, tt)),
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(a(lerp(t(z1), t(z2), tt)), a(jlerp(z1, z2, tt)),
                                   rtol=0, atol=1e-6)
    np.testing.assert_allclose(a(slerp(t(z1), t(z2), 0.0)), z1, atol=1e-5)
    np.testing.assert_allclose(a(slerp(t(z1), t(z2), 1.0)), z2, atol=1e-5)


@pytest.fixture(scope="module")
def tiny():
    from cips3dpp_tpu.models import generator as jg
    from cips3dpp_torch.models import generator as tg

    def make(m):
        return m.GeneratorConfig(
            renderer=m.RendererConfig(n_layers=2, hidden_dim=32),
            decoder=m.DecoderConfig(size_end=64, upsample_list=(32, 64), style_dim=64,
                                    mapping_n_layers=2),
            img_size=16, n_samples=8,
        )

    jcfg, tcfg = make(jg), make(tg)
    tmodel, variables = port_and_jax_generator(jcfg, tcfg, seed=21)
    rng = np.random.default_rng(22)
    zs = [rng.standard_normal((1, 256)).astype(np.float32) for _ in range(2)]
    noise = [rng.standard_normal(s).astype(np.float32)
             for s in tmodel.decoder.noise_shapes(jcfg.img_size)]
    return jg.Generator(jcfg), variables, tmodel, zs, noise


def test_render_trajectory_matches_jax(tiny):
    from cips3dpp_tpu.apps import sample as js
    from cips3dpp_torch.apps import sample as ts

    jmodel, variables, tmodel, zs, noise = tiny
    cams = ts.yaw_trajectory(3, 16, device="cpu")
    jcams = js.yaw_trajectory(3, 16)
    for kw in (dict(truncation=1.0), dict(zero_noise=True)):
        want = js.render_trajectory(jmodel, variables, tuple(jnp.asarray(z) for z in zs),
                                    jcams, noise_bufs=[jnp.asarray(n) for n in noise], **kw)
        got = ts.render_trajectory(tmodel, [t(z) for z in zs], cams,
                                   noise_bufs=[t(n) for n in noise], **kw)
        assert set(got) == set(want)
        for k in want:
            assert got[k].shape == want[k].shape and got[k].dtype == np.float32, k
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=2e-4, err_msg=k)
    assert np.abs(got["rgb"][0] - got["rgb"][1]).max() > 1e-3  # the camera moves


def test_render_trajectory_seed_and_fused_routes(tiny, monkeypatch):
    """noise_seed is the seed's hash_noise_map buffers; the fused route is
    the serving path (prepare_trajectory + render_frame with the same
    seed: the same kernel wrappers, here their plain versions); zero_noise
    overrides the seed; project_noise renders (its surface mesh from a 12^3
    SDF grid here, not the 128^3 of the app)."""
    from cips3dpp_torch import serving
    from cips3dpp_torch.apps import sample as ts

    _, _, tmodel, zs, _ = tiny
    zs = [t(z) for z in zs]
    cams = ts.yaw_trajectory(2, 16, device="cpu")
    by_seed = ts.render_trajectory(tmodel, zs, cams, noise_seed=77)
    bufs = tmodel.decoder.hash_noise(77, 16, device="cpu")
    by_bufs = ts.render_trajectory(tmodel, zs, cams, noise_bufs=bufs)
    np.testing.assert_array_equal(by_seed["rgb"], by_bufs["rgb"])
    fused = ts.render_trajectory(tmodel, zs, cams, noise_seed=77, fused=True)
    prep = serving.prepare_trajectory(tmodel, zs, noise_seed=77, device="cpu")
    for i in range(2):
        want = serving.render_frame(tmodel, prep, cams.viewpoint[i:i + 1, 0],
                                    cams.viewpoint[i:i + 1, 1], device="cpu")
        for k in ("rgb", "thumb_rgb"):
            np.testing.assert_allclose(fused[k][i], a(want[k][0]), rtol=0, atol=1e-5)
    zero = ts.render_trajectory(tmodel, zs, cams, noise_seed=77, zero_noise=True)
    assert np.abs(zero["rgb"] - by_seed["rgb"]).max() > 1e-3  # zero_noise wins
    projector = ts.make_noise_projector
    monkeypatch.setattr(ts, "make_noise_projector",
                        lambda *args, **kw: projector(*args, mesh_resolution=12, **kw))
    proj = ts.render_trajectory(tmodel, zs, cams, noise_bufs=bufs, project_noise=True,
                                project_noise_generator=torch.Generator().manual_seed(3),
                                project_noise_max_res=32)
    assert proj["rgb"].shape == by_bufs["rgb"].shape and np.isfinite(proj["rgb"]).all()


def test_style_mixing_grid_matches_jax(tiny):
    """The same z's (drawn as the JAX package draws them from its key) and
    the same noise buffers give the same grid."""
    from cips3dpp_tpu.apps.sample import style_mixing_grid as jgrid
    from cips3dpp_tpu.core.camera import camera_from_angles as jcam
    from cips3dpp_torch.apps.sample import style_mixing_grid
    from cips3dpp_torch.core.camera import camera_from_angles

    jmodel, variables, tmodel, _, _ = tiny
    key = jax.random.PRNGKey(6)
    kr, kc = jax.random.split(key)
    z_rows, z_cols = jax.random.normal(kr, (2, 256)), jax.random.normal(kc, (3, 256))
    noise = jmodel.bind(variables).decoder.make_noise(jax.random.PRNGKey(1), 16)
    azim, elev = np.asarray([0.1], np.float32), np.asarray([-0.05], np.float32)
    want = jgrid(jmodel, variables, key, 2, 3, jcam(jnp.asarray(azim), jnp.asarray(elev), 16),
                 truncation=1.0)
    got = style_mixing_grid(tmodel, None, 2, 3, camera_from_angles(t(azim), t(elev), 16),
                            truncation=1.0, noise_bufs=[t(n) for n in noise],
                            z_rows=t(z_rows), z_cols=t(z_cols))
    assert got.shape == want.shape == (2 * 64, 3 * 64, 3)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=2e-4)


def test_interpolate_decoder_params_matches_jax(tiny):
    from cips3dpp_tpu.apps.sample import interpolate_decoder_params as jinterp
    from cips3dpp_torch.apps.sample import interpolate_decoder_params
    from cips3dpp_torch.io.jax_params import jax_params_to_state_dict

    _, variables, _, _, _ = tiny
    jb = jax.tree.map(lambda x: x + 0.05, variables)
    sd_a, sd_b = (jax_params_to_state_dict(v["params"]) for v in (variables, jb))
    mid = interpolate_decoder_params(sd_a, sd_b, 0.5)
    want = jax_params_to_state_dict(jinterp(variables, jb, 0.5)["params"])
    assert mid.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_allclose(a(mid[k]), a(v), rtol=0, atol=1e-6, err_msg=k)
    for k in mid:
        w = 0.5 * (sd_a[k] + sd_b[k]) if k.startswith("decoder.") else sd_a[k]
        torch.testing.assert_close(mid[k], w, rtol=0, atol=1e-6)


def test_writers(tmp_path):
    """PNG grids from the standard library decode to the frames; videos
    fall back to what can be written. (The writer chooses each row's
    filter as PIL does, so the rows are read back through the reader of
    the five filters, `read_png`, which tests/test_torch_port_inversion_cli.py
    holds to PIL.)"""
    from cips3dpp_torch.apps.sample import read_png, save_image_grid, save_video, tile_grid

    rng = np.random.default_rng(1)
    frames = rng.uniform(-1, 1, (3, 4, 5, 3)).astype(np.float32)
    path = save_image_grid(frames, str(tmp_path / "g.png"), n_cols=2)
    raw = open(path, "rb").read()
    assert raw[:8] == b"\x89PNG\r\n\x1a\n"
    w, h = np.frombuffer(raw[16:24], ">u4")
    assert (h, w) == (8, 10)
    img = read_png(path)
    want = ((np.clip(frames, -1, 1) + 1) * 127.5).astype(np.uint8)
    np.testing.assert_array_equal(img[:4, :5], want[0])
    np.testing.assert_array_equal(img[4:, 5:], 127)  # the empty cell, 0 in [-1, 1]
    grid = tile_grid(frames, n_cols=2)
    assert grid.shape == (8, 10, 3) and (grid[4:, 5:] == -1).all()
    out = save_video(frames, str(tmp_path / "v.mp4"), fps=4)
    assert (tmp_path / out.split("/")[-1]).exists()
