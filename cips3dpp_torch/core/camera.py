"""Camera from angles, random cameras, 8-view sweeps and axis-angle
cameras (counterpart of cips3dpp_tpu/core/camera.py).

The camera sits on a unit sphere looking at the origin; azimuth/elevation
map to a position, a look-at frame gives R, intrinsics come from a fov
angle, near/far = dist -/+ dist_radius (nerf_utils.py:341-564).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..utils.profiling import count


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

    if up is None:
        up = torch.tensor([0.0, 1.0, 0.0], **kw)
        if up.is_cuda:  # a copy from pageable host memory waits for the device
            count("host_sync")
    up = up.to(**kw).expand(b, 3)

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


def sample_cameras(
    generator: torch.Generator | None,
    batch: int,
    img_size: int,
    azim_range=0.3,
    elev_range=0.15,
    fov_ang: float = 6.0,
    dist_radius: float = 0.12,
    uniform: bool = False,
    dtype=torch.float32,
    device=None,
    draws: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> CameraParams:
    """Random cameras (nerf_utils.py:393-410): angle = range * N(0,1), or
    with `uniform` U(-range, range) (U(range[0], range[1]) for 2-lists).
    The unit draws (azim, elev), each (B,), N(0,1) or U(0,1), come from
    `generator` on its own device, or are given as `draws`."""
    if draws is None:
        gdev = generator.device if generator is not None else "cpu"
        draw = torch.rand if uniform else torch.randn
        draws = tuple(draw((batch,), generator=generator, dtype=dtype, device=gdev)
                      for _ in range(2))
    ua, ue = (d.to(device=device, dtype=dtype) for d in draws)
    if uniform:
        (a0, a1) = azim_range if isinstance(azim_range, (list, tuple)) else (-azim_range, azim_range)
        (e0, e1) = elev_range if isinstance(elev_range, (list, tuple)) else (-elev_range, elev_range)
        azim, elev = a0 + (a1 - a0) * ua, e0 + (e1 - e0) * ue
    else:
        azim, elev = azim_range * ua, elev_range * ue
    return camera_from_angles(
        azim, elev, img_size, fov_ang=fov_ang, dist_radius=dist_radius
    )


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


def axis_angle_to_matrix(axis_angle: torch.Tensor) -> torch.Tensor:
    """Rodrigues rotation: (..., 3) axis-angle -> (..., 3, 3) matrix, with
    the series forms of sin(t)/t and (1-cos(t))/t^2 near t = 0."""
    # double where: the sqrt never sees t^2 = 0, so the gradient at the
    # zero rotation (the axis_angle inversion's start) stays finite
    t2_raw = torch.sum(axis_angle * axis_angle, dim=-1, keepdim=True)
    small = t2_raw < 1e-12
    t2 = torch.where(small, torch.ones_like(t2_raw), t2_raw)
    theta = torch.sqrt(t2)
    sinc = torch.where(small, 1.0 - t2_raw / 6.0, torch.sin(theta) / theta)
    cosc = torch.where(small, 0.5 - t2_raw / 24.0, (1.0 - torch.cos(theta)) / t2)
    x, y, z = axis_angle.unbind(-1)
    zero = torch.zeros_like(x)
    k = torch.stack([
        torch.stack([zero, -z, y], dim=-1),
        torch.stack([z, zero, -x], dim=-1),
        torch.stack([-y, x, zero], dim=-1),
    ], dim=-2)  # (..., 3, 3) skew matrix
    eye = torch.eye(3, dtype=axis_angle.dtype, device=axis_angle.device).expand(k.shape)
    return eye + sinc[..., None] * k + cosc[..., None] * (k @ k)


def camera2world_from_axis_angle(rot: torch.Tensor, trans: torch.Tensor) -> torch.Tensor:
    """(B, 3) axis-angle + (B, 3) translation -> (B, 3, 4) camera-to-world
    (nerf_utils.py:438-463), differentiable in both."""
    prefix = rot.shape[:-1]
    return torch.cat([axis_angle_to_matrix(rot), trans.reshape(*prefix, 3, 1)], dim=-1)
