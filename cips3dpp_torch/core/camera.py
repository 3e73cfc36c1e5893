"""Camera from angles and 8-view sweeps (counterpart of cips3dpp_tpu/core/camera.py).

The camera sits on a unit sphere looking at the origin; azimuth/elevation
map to a position, a look-at frame gives R, intrinsics come from a fov
angle, near/far = dist -/+ dist_radius (nerf_utils.py:341-564).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


class CameraParams(NamedTuple):
    extrinsics: torch.Tensor  # (B, 3, 4) camera-to-world [R | t]
    focal: torch.Tensor  # (B, 1, 1)
    near: torch.Tensor  # (B, 1, 1)
    far: torch.Tensor  # (B, 1, 1)
    viewpoint: torch.Tensor  # (B, 2) (azim, elev)


def _normalize(v: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    # F.normalize(p=2, eps): v / max(|v|, eps)
    n = torch.linalg.norm(v, dim=-1, keepdim=True)
    return v / torch.clamp(n, min=eps)


def camera_from_angles(
    azim: torch.Tensor,
    elev: torch.Tensor,
    img_size: int,
    fov_ang: float | torch.Tensor = 6.0,
    dist_radius: float = 0.12,
    up: torch.Tensor | None = None,
) -> CameraParams:
    """Look-at extrinsics + intrinsics from (azim, elev) in radians, (B,).
    fov_ang (degrees) is a scalar or one per camera (B,); up is the world
    up vector, (3,) or one per camera (B, 3), default +y."""
    azim = azim.reshape(-1)
    elev = elev.reshape(-1)
    b = azim.shape[0]
    kw = dict(dtype=azim.dtype, device=azim.device)

    dist = torch.ones((b,), **kw)
    near = (dist - dist_radius).reshape(b, 1, 1)
    far = (dist + dist_radius).reshape(b, 1, 1)
    if isinstance(fov_ang, torch.Tensor):
        fov = (fov_ang.to(**kw) * math.pi / 180.0).reshape(-1).expand(b)
    else:
        fov = torch.full((b,), fov_ang * math.pi / 180.0, **kw)
    focal = (0.5 * img_size / torch.tan(fov)).reshape(b, 1, 1)

    x = torch.cos(elev) * torch.sin(azim)
    y = torch.sin(elev)
    z = torch.cos(elev) * torch.cos(azim)
    camera_dir = torch.stack([x, y, z], dim=-1)  # (B, 3)
    camera_loc = dist[:, None] * camera_dir

    up = torch.tensor([0.0, 1.0, 0.0], **kw) if up is None else up.to(**kw)
    up = up.expand(b, 3)

    z_axis = _normalize(camera_dir)
    x_axis = _normalize(torch.linalg.cross(up, z_axis))
    y_axis = _normalize(torch.linalg.cross(z_axis, x_axis))
    # degenerate up || z: rebuild x from y x z (nerf_utils.py:428-431)
    is_close = torch.all(torch.abs(x_axis) < 5e-3, dim=-1, keepdim=True)
    replacement = _normalize(torch.linalg.cross(y_axis, z_axis))
    x_axis = torch.where(is_close, replacement, x_axis)

    r = torch.stack([x_axis, y_axis, z_axis], dim=1)  # (B, 3, 3)
    extrinsics = torch.cat([r.transpose(1, 2), camera_loc[:, :, None]], dim=-1)
    viewpoint = torch.stack([azim, elev], dim=-1)
    return CameraParams(extrinsics, focal, near, far, viewpoint)


def sweep_cameras(
    generator: torch.Generator | None,
    batch: int,
    img_size: int,
    azim_range=0.3,
    elev_range=0.15,
    fov_ang: float = 6.0,
    dist_radius: float = 0.12,
    dtype=torch.float32,
    device=None,
) -> CameraParams:
    """8-view azimuth sweep with one random elevation per batch item
    (nerf_utils.py:379-392). Returns B*8 cameras. The elevation draw comes
    from `generator` (torch's stream, not JAX's)."""
    kw = dict(dtype=dtype, device=device)
    steps = torch.arange(8, **kw)
    if isinstance(azim_range, (list, tuple)):
        a0, a1 = azim_range
        azim1 = a0 + (a1 - a0) / 7.0 * steps
    else:
        azim1 = -azim_range + (2.0 * azim_range / 7.0) * steps
    azim = azim1.repeat(batch)
    u = torch.rand((batch, 1), generator=generator, dtype=dtype).to(device)
    if isinstance(elev_range, (list, tuple)):
        e0, e1 = elev_range
        elev_b = e0 + (e1 - e0) * u
    else:
        elev_b = -elev_range + 2 * elev_range * u
    elev = elev_b.repeat_interleave(8, dim=1).reshape(-1)
    return camera_from_angles(
        azim, elev, img_size, fov_ang=fov_ang, dist_radius=dist_radius
    )
