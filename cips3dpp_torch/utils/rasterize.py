"""Software triangle rasterizer: z-buffer, vertex colors interpolated
linearly (counterpart of cips3dpp_tpu/utils/rasterize.py).

It stands in for the reference's pytorch3d mesh renderer where that is
load-bearing: geometry-aware noise projection (model_v3.py:344-415) and
depth-surface videos (stylesdf/utils.py:246-354). A loop over chunks of
faces keeps a (z-buffer, color, hit) state; each chunk evaluates the edge
functions of all its faces at all pixels as one dense batch, then takes
the nearest face per pixel. The earliest face wins a depth tie, in every
chunking. The camera model inverts core/rays.py's ray generation (pixel
centres, y down, -z forward). Runs on the device of its tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device


def project_vertices(verts, c2w, focal, img_size: int):
    """World -> screen. verts (V, 3); c2w (3, 4) camera-to-world; focal a
    scalar. Returns (u, v, z): pixel-centre coordinates (u right, v down,
    origin at the image corner) and the positive view depth z."""
    r = c2w[:3, :3]
    t = c2w[:3, 3]
    pc = (verts - t) @ r  # R^T (p - t)
    z = -pc[:, 2]
    zs = torch.clamp(z, min=1e-8)
    u = img_size * 0.5 + focal * pc[:, 0] / zs
    v = img_size * 0.5 - focal * pc[:, 1] / zs
    return u, v, z


def _edge(ax, ay, bx, by, px, py):
    """Signed doubled area of (a, b, p)."""
    return (bx - ax) * (py - ay) - (by - ay) * (px - ax)


@torch.no_grad()
def rasterize_mesh(verts, faces, vert_colors, c2w, focal, img_size: int,
                   face_chunk: int = 128):
    """Render vertex-colored triangles with a z-buffer. verts (V, 3) f32,
    faces (F, 3) integer, vert_colors (V, C), c2w (3, 4), focal a scalar.

    Returns (color (S, S, C), depth (S, S), hit (S, S) bool). Attributes
    are interpolated linearly in screen space (not perspective-correct):
    both users are noise or visualization, with triangles tiny on screen."""
    s = img_size
    dev = verts.device
    u, v, z = project_vertices(verts.float(), c2w.float(), focal, s)
    faces = faces.long()
    ar = torch.arange(s, dtype=torch.float32, device=dev) + 0.5
    px = ar[None, :].expand(s, s).reshape(-1)
    py = ar[:, None].expand(s, s).reshape(-1)
    c = vert_colors.shape[-1]
    zbuf = torch.full((s * s,), float("inf"), device=dev)
    color = torch.zeros((s * s, c), device=dev)
    hit = torch.zeros((s * s,), dtype=torch.bool, device=dev)
    pix = torch.arange(s * s, device=dev)
    for f0 in range(0, faces.shape[0], face_chunk):
        tri = faces[f0:f0 + face_chunk]
        au, av, az = u[tri[:, 0]], v[tri[:, 0]], z[tri[:, 0]]
        bu, bv, bz = u[tri[:, 1]], v[tri[:, 1]], z[tri[:, 1]]
        cu, cv, cz = u[tri[:, 2]], v[tri[:, 2]], z[tri[:, 2]]
        area = _edge(au, av, bu, bv, cu, cv)
        valid = (area.abs() > 1e-9) & (az > 0) & (bz > 0) & (cz > 0)
        inv_area = torch.where(valid, 1.0 / torch.where(valid, area, 1.0), 0.0)
        # barycentrics of every pixel in every face: (Fc, P)
        wa = _edge(bu[:, None], bv[:, None], cu[:, None], cv[:, None], px, py) * inv_area[:, None]
        wb = _edge(cu[:, None], cv[:, None], au[:, None], av[:, None], px, py) * inv_area[:, None]
        wc = 1.0 - wa - wb
        # a small epsilon keeps shared-edge pixels (the z-test resolves overlaps)
        eps = 1e-5
        inside = (wa >= -eps) & (wb >= -eps) & (wc >= -eps) & valid[:, None]
        depth = wa * az[:, None] + wb * bz[:, None] + wc * cz[:, None]
        depth = torch.where(inside, depth, float("inf"))
        dmin, kmin = torch.min(depth, dim=0)  # first index of the minimum
        closer = dmin < zbuf
        ktri = tri[kmin]
        col = (wa[kmin, pix][:, None] * vert_colors[ktri[:, 0]]
               + wb[kmin, pix][:, None] * vert_colors[ktri[:, 1]]
               + wc[kmin, pix][:, None] * vert_colors[ktri[:, 2]])
        zbuf = torch.where(closer, dmin, zbuf)
        color = torch.where(closer[:, None], col, color)
        hit = hit | closer
    return (color.reshape(s, s, c), torch.where(hit, zbuf, 0.0).reshape(s, s),
            hit.reshape(s, s))


def _on(x, dtype, dev):
    return torch.as_tensor(x, dtype=dtype, device=dev)


def project_noise_map(verts, faces, vert_noise, c2w, focal, img_size: int,
                      base_noise=None, device=None):
    """Geometry-aware noise (model_v3.py:387-415): per-vertex noise (V, 1)
    rendered from the camera; pixels the surface does not cover keep
    `base_noise` (S, S, 1), zero when not given."""
    dev = resolve_device(device)
    color, _, hit = rasterize_mesh(
        _on(verts, torch.float32, dev), _on(faces, torch.int64, dev),
        _on(vert_noise, torch.float32, dev), _on(c2w, torch.float32, dev),
        _on(focal, torch.float32, dev), img_size)
    base = torch.zeros_like(color) if base_noise is None else _on(base_noise, torch.float32, dev)
    return torch.where(hit[..., None], color, base)


def shaded_mesh_image(verts, faces, c2w, focal, img_size: int,
                      light=(0.0, 0.0, 5.0), device=None):
    """Lambertian vertex-shaded render of a mesh in [-1, 1] (the
    reference's depth-mesh look, stylesdf/utils.py:246-354): white diffuse
    shading, black background. Returns numpy (S, S, 3) image and (S, S)
    depth."""
    verts = np.asarray(verts, np.float32)
    faces = np.asarray(faces, np.int32)
    # per-vertex normals: area-weighted sums of face normals
    fv = verts[faces]
    fn = np.cross(fv[:, 1] - fv[:, 0], fv[:, 2] - fv[:, 0])
    vn = np.zeros_like(verts)
    for k in range(3):
        np.add.at(vn, faces[:, k], fn)
    vn /= np.linalg.norm(vn, axis=-1, keepdims=True) + 1e-8
    ldir = np.asarray(light, np.float32)
    ldir = ldir / np.linalg.norm(ldir)
    shade = np.abs(vn @ ldir)[:, None].astype(np.float32)
    dev = resolve_device(device)
    color, depth, hit = rasterize_mesh(
        _on(verts, torch.float32, dev), _on(faces, torch.int64, dev),
        _on(shade, torch.float32, dev), _on(c2w, torch.float32, dev),
        _on(focal, torch.float32, dev), img_size)
    img = torch.where(hit[..., None], color * 2.0 - 1.0, -1.0).repeat(1, 1, 3)
    return img.cpu().numpy(), depth.cpu().numpy()
