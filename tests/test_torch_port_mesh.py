"""Shape extraction and the software rasterizer of the sampling apps: the
port's utils/mesh.py and utils/rasterize.py against the JAX package's on
the CPU. The numpy parts (marching tetrahedra, the xyz mesh, normal
shading) are the same arithmetic and must agree exactly; the rasterizer
and the SDF grid run in torch against jnp and agree to f32 rounding.
"""

import jax.numpy as jnp
import numpy as np
import torch

from torch_port_helpers import a, port_and_jax_generator, t


def _sphere(res=20, r=0.6):
    lin = np.linspace(-1, 1, res, dtype=np.float32)
    x, y, z = np.meshgrid(lin, lin, lin, indexing="ij")
    return np.sqrt(x**2 + y**2 + z**2) - r, lin


def test_marching_tetrahedra_matches_jax(tmp_path):
    from cips3dpp_tpu.utils.mesh import marching_tetrahedra as jmt, save_obj as jsave
    from cips3dpp_torch.utils.mesh import marching_tetrahedra, save_obj

    vol, lin = _sphere()
    verts, faces = marching_tetrahedra(vol, coords=[lin] * 3)
    jverts, jfaces = jmt(vol, coords=[lin] * 3)
    assert len(faces) > 100
    np.testing.assert_array_equal(verts, jverts)
    np.testing.assert_array_equal(faces, jfaces)
    got = save_obj(verts, faces, str(tmp_path / "port.obj"))
    want = jsave(jverts, jfaces, str(tmp_path / "jax.obj"))
    assert open(got).read() == open(want).read()
    r = np.linalg.norm(verts, axis=-1)
    assert np.abs(r - 0.6).max() < 0.05
    empty = marching_tetrahedra(np.ones((4, 4, 4), np.float32))
    assert empty[0].shape == (0, 3) and empty[1].shape == (0, 3)


def test_xyz_mesh_shading_and_align_volume_match_jax():
    from cips3dpp_tpu.utils import mesh as jm
    from cips3dpp_torch.utils import mesh as tm

    rng = np.random.default_rng(0)
    xyz = rng.standard_normal((6, 7, 3)).astype(np.float32)
    mask = (rng.random((6, 7)) > 0.3).astype(np.float32)
    for m in (None, mask):
        for got, want in zip(tm.xyz_to_mesh(xyz, m), jm.xyz_to_mesh(xyz, m)):
            np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(tm.depth_to_normal_shading(xyz),
                               jm.depth_to_normal_shading(xyz), rtol=0, atol=1e-6)
    vol = rng.standard_normal((16, 12, 8)).astype(np.float32)
    np.testing.assert_allclose(tm.align_volume(vol), jm.align_volume(vol), rtol=0, atol=1e-5)


def _bumpy_grid(n=9, seed=0):
    rng = np.random.default_rng(seed)
    xs, ys = np.meshgrid(np.linspace(-0.15, 0.15, n), np.linspace(-0.15, 0.15, n),
                         indexing="ij")
    zs = rng.random((n, n)) * 0.02
    verts = np.stack([xs, ys, zs], -1).reshape(-1, 3).astype(np.float32)
    ii, jj = np.meshgrid(np.arange(n - 1), np.arange(n - 1), indexing="ij")
    tl = (ii * n + jj).ravel()
    faces = np.concatenate([np.stack([tl, tl + n, tl + 1], 1),
                            np.stack([tl + 1, tl + n, tl + n + 1], 1)]).astype(np.int32)
    return verts, faces


def test_rasterizer_matches_jax():
    """rasterize_mesh on a bumpy grid mesh with random colors, from a
    turned camera, in two face chunkings; the noise projection and the
    shaded image built on it."""
    from cips3dpp_tpu.core.camera import camera_from_angles as jcam
    from cips3dpp_tpu.utils import rasterize as jr
    from cips3dpp_torch.utils import rasterize as tr

    s = 24
    verts, faces = _bumpy_grid()
    colors = np.random.default_rng(1).standard_normal((len(verts), 2)).astype(np.float32)
    cam = jcam(jnp.asarray([0.2]), jnp.asarray([-0.1]), s, fov_ang=12.0)
    c2w, focal = np.asarray(cam.extrinsics[0]), float(cam.focal[0, 0, 0])
    want = jr.rasterize_mesh(jnp.asarray(verts), jnp.asarray(faces), jnp.asarray(colors),
                             jnp.asarray(c2w), focal, s)
    for chunk in (128, 7):
        got = tr.rasterize_mesh(t(verts), torch.from_numpy(faces), t(colors), t(c2w),
                                focal, s, face_chunk=chunk)
        np.testing.assert_array_equal(a(got[2]), np.asarray(want[2], np.float32))
        assert 0.2 < a(got[2]).mean() < 1.0  # the mesh covers part of the image
        np.testing.assert_allclose(a(got[0]), a(want[0]), rtol=0, atol=1e-4)
        np.testing.assert_allclose(a(got[1]), a(want[1]), rtol=0, atol=1e-5)

    noise = colors[:, :1]
    base = np.full((s, s, 1), -3.0, np.float32)
    got = tr.project_noise_map(verts, faces, noise, c2w, focal, s, base_noise=base,
                               device="cpu")
    want = jr.project_noise_map(verts, faces, noise, c2w, focal, s, base_noise=base)
    np.testing.assert_allclose(a(got), a(want), rtol=0, atol=1e-4)
    img, depth = tr.shaded_mesh_image(verts, faces, c2w, focal, s, device="cpu")
    jimg, jdepth = jr.shaded_mesh_image(verts, faces, c2w, focal, s)
    np.testing.assert_allclose(img, jimg, rtol=0, atol=1e-4)
    np.testing.assert_allclose(depth, jdepth, rtol=0, atol=1e-5)


def test_sdf_grid_and_shape_match_jax():
    """sample_sdf_grid through the port's renderer network against the
    JAX one with the same weights; the mesh of each grid."""
    from cips3dpp_tpu.models import generator as jg
    from cips3dpp_tpu.utils.mesh import marching_tetrahedra, sample_sdf_grid as jgrid
    from cips3dpp_torch.models import generator as tg
    from cips3dpp_torch.utils.mesh import extract_shape, sample_sdf_grid

    def make(m):
        return m.GeneratorConfig(
            renderer=m.RendererConfig(n_layers=2, hidden_dim=32),
            decoder=m.DecoderConfig(size_end=32, upsample_list=(32,), style_dim=32,
                                    mapping_n_layers=1),
            img_size=8, n_samples=4)

    jcfg = make(jg)
    model, variables = port_and_jax_generator(jcfg, make(tg), seed=3)
    z = np.random.default_rng(4).standard_normal((1, 256)).astype(np.float32)
    sr, _ = model.map_zs([t(z), t(z)])
    jsr, _ = jg.Generator(jcfg).apply(variables, (jnp.asarray(z),) * 2, method="map_zs")
    vol, lin = sample_sdf_grid(model, sr, resolution=12, chunk=1000)
    jvol, jlin = jgrid(jg.Generator(jcfg), variables, jsr, resolution=12, chunk=1000)
    np.testing.assert_array_equal(lin, jlin)
    np.testing.assert_allclose(vol, jvol, rtol=0, atol=1e-5)
    verts, faces = extract_shape(model, sr, resolution=12)
    want = marching_tetrahedra(vol, coords=[lin] * 3)
    np.testing.assert_array_equal(verts, want[0])
    np.testing.assert_array_equal(faces, want[1])
