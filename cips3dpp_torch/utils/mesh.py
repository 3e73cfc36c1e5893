"""Shape extraction and mesh utilities (counterpart of
cips3dpp_tpu/utils/mesh.py).

Behavioural contract: stylesdf/utils.py:183-242 (align_volume,
extract_mesh_with_marching_cubes, xyz2mesh) and
stylesdf/scripts/generate_shapes_and_images.py (the .obj export of the
SDF). The SDF grid is sampled through the renderer's network on the
model's device; the iso-surface comes from marching tetrahedra (table-free,
the same class of output as marching cubes), in numpy; the depth-surface
mesh triangulates the xyz map's pixel grid, two triangles a quad (what the
reference's Delaunay gives on a regular grid).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.rays import normalize_points

# ------------------------------------------------------------- SDF volume --


@torch.no_grad()
def sample_sdf_grid(model, style_render, resolution: int = 128, bounds: float = 0.24,
                    chunk: int = 65536):
    """The SDF on a cubic grid around the origin (bounds 0.24 = far - near,
    the volume the camera sweep sees), through `model.renderer.run_network`
    with zero view directions. Returns ((res, res, res) numpy SDF, the
    grid's 1-D coordinates)."""
    lin = np.linspace(-bounds, bounds, resolution, dtype=np.float32)
    xs, ys, zs = np.meshgrid(lin, lin, lin, indexing="ij")
    pts = np.stack([xs, ys, zs], axis=-1).reshape(-1, 3)
    dev = model.device
    near = torch.full((1, 1, 1), 1.0 - 0.12, device=dev)
    far = torch.full((1, 1, 1), 1.0 + 0.12, device=dev)
    style_render = style_render.to(dev)
    out = np.empty(len(pts), np.float32)
    for i in range(0, len(pts), chunk):
        p = torch.from_numpy(pts[i:i + chunk]).to(dev)[None, :, None, :]
        npts = normalize_points(p, near, far)
        dirs = torch.zeros_like(npts[:, :, 0, :])
        _, sdf, _ = model.renderer.run_network(npts, dirs, style_render)
        out[i:i + chunk] = sdf[0, :, 0, 0].float().cpu().numpy()
    return out.reshape(resolution, resolution, resolution), lin


# --------------------------------------------------- marching tetrahedra --

# each grid cube splits into 6 tetrahedra (corners of the cube's 8)
_TETS = np.array(
    [[0, 5, 1, 6], [0, 1, 2, 6], [0, 2, 3, 6], [0, 3, 7, 6], [0, 7, 4, 6], [0, 4, 5, 6]],
    np.int32,
)
# cube corner offsets
_CORNERS = np.array(
    [[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0], [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]],
    np.int32,
)


def marching_tetrahedra(volume: np.ndarray, level: float = 0.0, coords=None):
    """Iso-surface of a scalar grid by tetrahedral decomposition. Returns
    (verts (V, 3) f32, faces (F, 3) int32), duplicate vertices welded."""
    if coords is None:
        coords = [np.arange(s, dtype=np.float32) for s in volume.shape]
    idx = np.stack(np.meshgrid(*[np.arange(s - 1) for s in volume.shape], indexing="ij"),
                   axis=-1).reshape(-1, 3)
    corner_idx = idx[:, None, :] + _CORNERS[None, :, :]  # (cells, 8, 3)
    vals = volume[corner_idx[..., 0], corner_idx[..., 1], corner_idx[..., 2]]
    pos = np.stack([coords[d][corner_idx[..., d]] for d in range(3)],
                   axis=-1).astype(np.float32)

    verts_out, faces_out, n_verts = [], [], 0

    def emit(tris, per_cell):
        nonlocal n_verts
        verts_out.append(tris.reshape(-1, 3))
        faces_out.append(np.arange(len(tris) * per_cell, dtype=np.int32).reshape(-1, 3)
                         + n_verts)
        n_verts += len(tris) * per_cell

    for tet in _TETS:
        tv, tp = vals[:, tet], pos[:, tet]
        inside = tv < level
        code = inside[:, 0] * 1 + inside[:, 1] * 2 + inside[:, 2] * 4 + inside[:, 3] * 8

        def interp(sel, a, b):
            """The level crossing on edge a-b of the selected tetrahedra."""
            va, vb = tv[sel, a], tv[sel, b]
            t = (level - va) / np.where(np.abs(vb - va) < 1e-12, 1e-12, vb - va)
            return tp[sel, a] + t[:, None] * (tp[sel, b] - tp[sel, a])

        # one corner apart from the other three: one triangle
        for c in range(4):
            for cc in (1 << c, 15 - (1 << c)):
                sel = np.nonzero(code == cc)[0]
                if len(sel) == 0:
                    continue
                o = [k for k in range(4) if k != c]
                emit(np.stack([interp(sel, c, o[0]), interp(sel, c, o[1]),
                               interp(sel, c, o[2])], axis=1), 3)
        # two corners apart from two: a quad, two triangles
        for cc, (a, b) in [(3, (0, 1)), (5, (0, 2)), (9, (0, 3)),
                           (6, (1, 2)), (10, (1, 3)), (12, (2, 3))]:
            sel = np.nonzero(code == cc)[0]
            if len(sel) == 0:
                continue
            o = [k for k in range(4) if k not in (a, b)]
            v0, v1 = interp(sel, a, o[0]), interp(sel, a, o[1])
            v2, v3 = interp(sel, b, o[1]), interp(sel, b, o[0])
            emit(np.stack([v0, v1, v2, v0, v2, v3], axis=1), 6)

    if not verts_out:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)
    verts = np.concatenate(verts_out)
    faces = np.concatenate(faces_out)
    # weld duplicate vertices
    rounded = np.round(verts / 1e-5).astype(np.int64)
    uniq, inv = np.unique(rounded, axis=0, return_inverse=True)
    inv = inv.reshape(-1)
    welded = np.zeros((len(uniq), 3), np.float32)
    welded[inv] = verts
    return welded, inv[faces].astype(np.int32)


def extract_shape(model, style_render, resolution=128, bounds=0.24, level=0.0):
    """SDF grid -> mesh (extract_mesh_with_marching_cubes,
    stylesdf/utils.py:207-224)."""
    vol, lin = sample_sdf_grid(model, style_render, resolution, bounds)
    return marching_tetrahedra(vol, level=level, coords=[lin, lin, lin])


def save_obj(verts: np.ndarray, faces: np.ndarray, path: str) -> str:
    with open(path, "w") as f:
        for v in verts:
            f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for tri in faces + 1:  # obj indices start at 1
            f.write(f"f {tri[0]} {tri[1]} {tri[2]}\n")
    return path


def _trilinear(vol, iy, ix, iz):
    """Linear interpolation of vol at index-space points (map_coordinates
    with order=1; every point lies inside the grid)."""
    out = np.zeros(iy.shape, np.float32)
    lo, fr = [], []
    for q, n in zip((iy, ix, iz), vol.shape):
        q0 = np.clip(np.floor(q), 0, n - 1).astype(np.int64)
        lo.append(q0)
        fr.append((q - q0).astype(np.float32))
    for dy in (0, 1):
        for dx in (0, 1):
            for dz in (0, 1):
                w = ((fr[0] if dy else 1 - fr[0]) * (fr[1] if dx else 1 - fr[1])
                     * (fr[2] if dz else 1 - fr[2]))
                out += w * vol[np.minimum(lo[0] + dy, vol.shape[0] - 1),
                               np.minimum(lo[1] + dx, vol.shape[1] - 1),
                               np.minimum(lo[2] + dz, vol.shape[2] - 1)]
    return out


def align_volume(volume: np.ndarray, near: float = 0.88, far: float = 1.12):
    """Warp an axis-aligned sampled volume into the camera frustum
    (stylesdf/utils.py:172-196): x and y scale from far/near at the near
    plane to 1 at the far plane, trilinear resampling with border clamping;
    cells outside the frustum get SDF 1 so the surface ignores them."""
    h, w, d = volume.shape
    ys = np.linspace(-1.0, 1.0, h, dtype=np.float32)
    xs = np.linspace(-1.0, 1.0, w, dtype=np.float32)
    zs = np.linspace(-1.0, 1.0, d, dtype=np.float32)
    gy, gx, gz = np.meshgrid(ys, xs, zs, indexing="ij")
    coeff = np.linspace(far / near, 1.0, d, dtype=np.float32).reshape(1, 1, d)
    sx, sy = gx * coeff, gy * coeff
    oob = (np.abs(sx) > 1.0) | (np.abs(sy) > 1.0)
    iy = np.clip((sy + 1.0) * (h - 1) / 2.0, 0, h - 1)
    ix = np.clip((sx + 1.0) * (w - 1) / 2.0, 0, w - 1)
    iz = np.broadcast_to((gz + 1.0) * (d - 1) / 2.0, iy.shape)
    out = _trilinear(np.asarray(volume, np.float32), iy, ix, iz)
    return np.where(oob, np.float32(1.0), out)


# ------------------------------------------------------------ depth mesh --


def xyz_to_mesh(xyz: np.ndarray, mask: np.ndarray | None = None):
    """Surface point image (H, W, 3) -> triangle mesh, two triangles per
    pixel quad (stylesdf/utils.py:228-242); with a mask, only faces whose
    three vertices are kept."""
    h, w, _ = xyz.shape
    verts = xyz.reshape(-1, 3).astype(np.float32)
    ii, jj = np.meshgrid(np.arange(h - 1), np.arange(w - 1), indexing="ij")
    tl = (ii * w + jj).ravel()
    tr, bl = tl + 1, tl + w
    br = bl + 1
    faces = np.concatenate([np.stack([tl, bl, tr], 1),
                            np.stack([tr, bl, br], 1)]).astype(np.int32)
    if mask is not None:
        keep_v = mask.reshape(-1) > 0.5
        faces = faces[keep_v[faces].all(axis=1)]
    return verts, faces


def depth_to_normal_shading(xyz: np.ndarray, light=(0.0, 0.0, 5.0)):
    """Lambertian shading of the xyz map from finite-difference normals,
    in [-1, 1] (a cheap stand-in for the mesh render, visualization only)."""
    dx = np.gradient(xyz, axis=1)
    dy = np.gradient(xyz, axis=0)
    n = np.cross(dx, dy)
    n = n / (np.linalg.norm(n, axis=-1, keepdims=True) + 1e-8)
    ldir = np.asarray(light, np.float32)
    ldir = ldir / np.linalg.norm(ldir)
    shade = np.clip(n @ ldir, 0, 1)
    return np.repeat(shade[..., None], 3, axis=-1) * 2.0 - 1.0
