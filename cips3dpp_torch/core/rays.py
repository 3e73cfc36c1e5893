"""Ray generation and depth sampling (counterpart of cips3dpp_tpu/core/rays.py).

Pinhole rays through pixel centres rotated into world space by the c2w
extrinsics; z-values by offset sampling (nerf_utils.py:17-218). NHWC-style
(B, H, W, ...) layouts as in the JAX package.
"""

from __future__ import annotations

import torch


def get_rays_in_world(
    focal: torch.Tensor,  # (B, 1, 1)
    img_size: int,
    c2w: torch.Tensor,  # (B, 3, 4)
    static_viewdirs: bool = False,
):
    """Returns rays_o, rays_d, viewdirs, each (B, H, W, 3)."""
    b = focal.shape[0]
    coords = torch.linspace(
        0.5, img_size - 0.5, img_size, dtype=focal.dtype, device=focal.device
    )
    x = coords[None, None, :].expand(b, img_size, img_size)
    y = coords[None, :, None].expand(b, img_size, img_size)
    rays_d_cam = torch.stack(
        [
            (x - img_size * 0.5) / focal,
            -(y - img_size * 0.5) / focal,
            -torch.ones_like(x),
        ],
        dim=-1,
    )
    # d_w[i] = sum_j d_c[j] * R[i, j] (nerf_utils.py:52-53)
    rays_d = torch.einsum("bhwj,bij->bhwi", rays_d_cam, c2w[:, :3, :3])
    rays_o = c2w[:, None, None, :3, -1].expand(rays_d.shape)
    viewdirs = rays_d_cam if static_viewdirs else rays_d
    norm = torch.linalg.norm(viewdirs, dim=-1, keepdim=True)
    viewdirs = viewdirs / torch.clamp(norm, min=1e-12)
    return rays_o, rays_d, viewdirs


def get_z_vals(
    near: torch.Tensor,  # (B, 1, 1)
    far: torch.Tensor,  # (B, 1, 1)
    rays_d: torch.Tensor,  # (B, H, W, 3)
    n_samples: int,
    perturb: bool = False,
    offset_sampling: bool = True,
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """Depths along each ray, (B, H, W, N) (nerf_utils.py:68-121).
    With perturb, the jitter is drawn from `generator` on the CPU."""
    b, h, w, _ = rays_d.shape
    kw = dict(dtype=rays_d.dtype, device=rays_d.device)
    ones = torch.ones((b, h, w, 1), **kw)
    near_ = near[..., None] * ones
    far_ = far[..., None] * ones
    if offset_sampling:
        t_vals = torch.linspace(0.0, 1.0 - 1.0 / n_samples, n_samples, **kw)
    else:
        t_vals = torch.linspace(0.0, 1.0, n_samples, **kw)
    t_vals = t_vals.reshape(1, 1, 1, -1)
    z_vals = near_ * (1.0 - t_vals) + far_ * t_vals
    if perturb:
        if offset_sampling:
            upper = torch.cat([z_vals[..., 1:], far_], dim=-1)
            lower = z_vals
            shape = (b, h, w, 1)
        else:
            mids = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
            upper = torch.cat([mids, z_vals[..., -1:]], dim=-1)
            lower = torch.cat([z_vals[..., :1], mids], dim=-1)
            shape = tuple(z_vals.shape)
        t_rand = torch.rand(shape, generator=generator, dtype=rays_d.dtype)
        z_vals = lower + (upper - lower) * t_rand.to(rays_d.device)
    return z_vals


def get_points(rays_o, rays_d, z_vals):
    """pts = o + d * z, (B, H, W, N, 3)."""
    return rays_o[..., None, :] + rays_d[..., None, :] * z_vals[..., None]


def normalize_points(pts, near, far):
    """pts * 2 / (far - near), batch-wise."""
    span = (far - near).reshape((-1,) + (1,) * (pts.ndim - 1))
    return pts * 2.0 / span


def prepare_nerf_inputs(
    focal, img_size, cam_poses, near, far, n_samples,
    perturb: bool = False, static_viewdirs: bool = False, generator=None,
):
    """rays -> z_vals -> points. Returns pts (B,H,W,N,3), rays_d (B,H,W,3),
    viewdirs (B,H,W,3), z_vals (B,H,W,N)."""
    rays_o, rays_d, viewdirs = get_rays_in_world(
        focal, img_size, cam_poses, static_viewdirs=static_viewdirs
    )
    z_vals = get_z_vals(
        near, far, rays_d, n_samples, perturb=perturb, offset_sampling=True,
        generator=generator,
    )
    pts = get_points(rays_o, rays_d, z_vals)
    return pts, rays_d, viewdirs, z_vals
