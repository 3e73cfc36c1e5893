"""cips3dpp_torch core/ and ops/ against the JAX package in f32, plus the
port's import hygiene and device default.

Tolerances: both sides run the same f32 formulas; the differences are
summation order and libm (sin/cos/exp) last-bit differences, so 1e-5
relative / 1e-6 absolute unless a comment says otherwise.
"""

import pkgutil
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import a, t

TIGHT = dict(rtol=1e-5, atol=1e-6)


def _angles(seed, n=4):
    rng = np.random.default_rng(seed)
    return (0.4 * rng.standard_normal(n)).astype(np.float32), \
        (0.2 * rng.standard_normal(n)).astype(np.float32)


def test_camera_from_angles_matches_jax():
    from cips3dpp_tpu.core.camera import camera_from_angles as jcam
    from cips3dpp_torch.core.camera import camera_from_angles

    az, el = _angles(0)
    want = jcam(jnp.asarray(az), jnp.asarray(el), 64, fov_ang=6.0, dist_radius=0.12)
    got = camera_from_angles(t(az), t(el), 64, fov_ang=6.0, dist_radius=0.12)
    for name in want._fields:
        np.testing.assert_allclose(a(getattr(got, name)), a(getattr(want, name)),
                                   err_msg=name, **TIGHT)


def test_sweep_cameras_shape_and_shared_elevation():
    """The elevation draw comes from torch's stream (JAX's threefry cannot
    be matched); the azimuth sweep is deterministic and must equal JAX's."""
    from cips3dpp_tpu.core.camera import sweep_cameras as jsweep
    import jax
    from cips3dpp_torch.core.camera import sweep_cameras

    want = jsweep(jax.random.PRNGKey(0), 2, 32)
    got = sweep_cameras(torch.Generator().manual_seed(0), 2, 32)
    assert got.extrinsics.shape == want.extrinsics.shape == (16, 3, 4)
    np.testing.assert_allclose(a(got.viewpoint[:, 0]), a(want.viewpoint[:, 0]), **TIGHT)
    elev = a(got.viewpoint[:, 1]).reshape(2, 8)
    assert np.all(elev == elev[:, :1]) and np.all(np.abs(elev) <= 0.15)


def test_prepare_nerf_inputs_matches_jax():
    from cips3dpp_tpu.core.camera import camera_from_angles as jcam
    from cips3dpp_tpu.core.rays import prepare_nerf_inputs as jprep
    from cips3dpp_torch.core.camera import camera_from_angles
    from cips3dpp_torch.core.rays import prepare_nerf_inputs

    az, el = _angles(1, 2)
    jc = jcam(jnp.asarray(az), jnp.asarray(el), 16)
    c = camera_from_angles(t(az), t(el), 16)
    want = jprep(jc.focal, 16, jc.extrinsics, jc.near, jc.far, 24, perturb=False)
    got = prepare_nerf_inputs(c.focal, 16, c.extrinsics, c.near, c.far, 24)
    for name, g, w in zip(("pts", "rays_d", "viewdirs", "z_vals"), got, want):
        assert tuple(g.shape) == w.shape, name
        np.testing.assert_allclose(a(g), a(w), err_msg=name, **TIGHT)


def test_volume_integration_matches_jax():
    from cips3dpp_tpu.core.integration import sdf_to_sigma as jsig
    from cips3dpp_tpu.core.integration import volume_integration as jvi
    from cips3dpp_torch.core.integration import sdf_to_sigma, volume_integration

    rng = np.random.default_rng(2)
    r, n, c = 64, 24, 16
    rgb = rng.standard_normal((r, n, 3)).astype(np.float32)
    sdf = (0.05 * rng.standard_normal((r, n, 1))).astype(np.float32)
    feats = rng.standard_normal((r, n, c)).astype(np.float32)
    z = np.sort(rng.uniform(0.88, 1.12, (r, n)), axis=-1).astype(np.float32)
    rays_d = rng.standard_normal((r, 3)).astype(np.float32)
    pts = rng.standard_normal((r, n, 3)).astype(np.float32)
    beta = np.asarray([0.1], np.float32)
    want = jvi(rgb, sdf, feats, z, rays_d, pts, with_sdf=True, sigmoid_beta=beta)
    got = volume_integration(t(rgb), t(sdf), t(feats), t(z), t(rays_d), t(pts),
                             sigmoid_beta=t(beta))
    for name, g, w in zip(("rgb", "feat", "xyz", "mask_depth"), got, want):
        np.testing.assert_allclose(a(g), a(w), err_msg=name, rtol=1e-5, atol=2e-6)
    np.testing.assert_allclose(a(sdf_to_sigma(t(sdf), t(beta))), a(jsig(sdf, beta)),
                               **TIGHT)


def test_fused_leaky_relu_upsample_modulated_match_jax():
    from cips3dpp_tpu.ops import fused_leaky_relu as jlrelu, upsample2x as jup
    from cips3dpp_tpu.ops.modulated import modulate_weights_1x1 as jmw
    from cips3dpp_tpu.ops.modulated import modulated_matmul as jmm
    from cips3dpp_tpu.ops.upfirdn2d import make_blur_kernel as jblur
    from cips3dpp_torch.ops import (
        fused_leaky_relu, make_blur_kernel, modulated_matmul, upsample2x,
    )
    from cips3dpp_torch.ops.modulated import modulate_weights_1x1

    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 8, 12, 16)).astype(np.float32)
    b = rng.standard_normal(16).astype(np.float32)
    np.testing.assert_allclose(a(fused_leaky_relu(t(x), t(b))), a(jlrelu(x, b)), **TIGHT)
    np.testing.assert_allclose(a(fused_leaky_relu(t(x), None, scale=1.0)),
                               a(jlrelu(x, None, scale=1.0)), **TIGHT)
    # shift-adds with taps .25/.75: the same two products per output
    np.testing.assert_allclose(a(upsample2x(t(x))), a(jup(x)), **TIGHT)

    xm = rng.standard_normal((2, 40, 16)).astype(np.float32)
    w = rng.standard_normal((16, 24)).astype(np.float32)
    s = (1.0 + 0.3 * rng.standard_normal((2, 16))).astype(np.float32)
    for demod in (True, False):
        np.testing.assert_allclose(a(modulated_matmul(t(xm), t(w), t(s), demod)),
                                   a(jmm(xm, w, s, demod)), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(a(modulate_weights_1x1(t(w), t(s), demod)),
                                   a(jmw(w, s, demod)), **TIGHT)
    for kernel, up in (((1, 3, 3, 1), 1), ((1, 3, 3, 1), 2), ((1, 2, 1), 1)):
        np.testing.assert_allclose(a(make_blur_kernel(kernel, up)),
                                   a(jblur(kernel, up)), **TIGHT)


def test_port_imports_no_jax():
    """Importing the port and every submodule leaves jax, flax, optax, orbax
    and cips3dpp_tpu out of sys.modules (fresh interpreter)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import cips3dpp_torch\n"
        "for m in pkgutil.walk_packages(cips3dpp_torch.__path__, 'cips3dpp_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'optax', 'orbax', "
        "'cips3dpp_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok', len([m for m in sys.modules if m.startswith('cips3dpp_torch')]))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[1]) >= 29  # every submodule was imported
    import cips3dpp_torch

    names = {m.name for m in pkgutil.walk_packages(cips3dpp_torch.__path__, "cips3dpp_torch.")}
    for mod in ("apps.sample", "apps.cli", "utils.mesh", "utils.rasterize", "io.config",
                "tools.elem_dtype_probe", "models.discriminator", "models.discriminator_pose",
                "models.diffaug", "train.losses", "train.state", "train.steps",
                "train.train_loop", "io.yaml_lite", "io.checkpoint", "io.dataset",
                "io.jax_params", "parallel.prefetch", "utils.logging", "apps.cli_train_impl",
                "parallel.mesh", "models.inception", "apps.eval_fid", "io.native_loader",
                "io.weights"):
        assert f"cips3dpp_torch.{mod}" in names, mod


def test_entry_points_default_to_the_card():
    """With no device argument the entry points ask for CUDA and raise on a
    host without it; device="cpu" must be explicit."""
    from cips3dpp_torch.models.generator import (
        DecoderConfig, Generator, GeneratorConfig, RendererConfig,
    )
    from cips3dpp_torch.serving import (
        prepare_trajectory, render_frame, render_trajectory_scan,
    )

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    cfg = GeneratorConfig(
        renderer=RendererConfig(hidden_dim=16),
        decoder=DecoderConfig(size_end=32, upsample_list=(32,), style_dim=32,
                              mapping_n_layers=1),
        img_size=8, n_samples=4,
    )
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Generator(cfg)
    g = Generator(cfg, device="cpu")
    zs = (torch.zeros(1, 256), torch.zeros(1, 256))
    noise = g.decoder.make_noise(torch.Generator().manual_seed(0), 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        prepare_trajectory(g, zs, noise_bufs=noise)
    prep = prepare_trajectory(g, zs, noise_bufs=noise, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        render_frame(g, prep, torch.zeros(1), torch.zeros(1))
    assert render_frame(g, prep, torch.zeros(1), torch.zeros(1),
                        device="cpu")["rgb"].shape == (1, 16, 16, 3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        render_trajectory_scan(g, prep, torch.zeros(2))
    assert render_trajectory_scan(g, prep, torch.zeros(2), device="cpu").shape == ()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        prepare_trajectory(g, zs, noise_seed=5)

    from cips3dpp_torch.apps import cli, sample

    for traj in (sample.yaw_trajectory, sample.circle_trajectory,
                 sample.elev_circle_trajectory, sample.translate_rotate_trajectory):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            traj(4, 8)
        assert traj(4, 8, device="cpu").extrinsics.device.type == "cpu"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["style-mixing", "--n-rows", "1", "--n-cols", "1"])
