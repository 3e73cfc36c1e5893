"""Triplane volume renderer, the EG3D-style experimental renderer
(counterpart of cips3dpp_tpu/models/triplane.py; contract
exp/cips3d/models/volume_renderer_v8.py:728-1008).

Planes (B, 3, C, H, W) are sampled at the projected 3D points (bilinear,
zero padding, align_corners=False), the three planes' features are
concatenated and fed to a softplus MLP with an SDF head and a
view-conditioned rgb / feature head, then integrated by the shared volume
integration. The sampler is the JAX package's four-tap gather and lerp:
the eikonal loss takes its double backward, which `F.grid_sample` lacks
on the card (torch 2.11 with CUDA: "derivative for
aten::grid_sampler_2d_backward is not implemented"; the reference wrote
its own `grid_sample_cus` for the same reason). No shipped config builds
it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.integration import volume_integration
from ..core.rays import normalize_points
from ..device import resolve_device
from .layers import init_parameters, uniform_bound_

# ------------------------------------------------------------- sampling --


def grid_sample_bilinear(feat: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of NHWC features at [-1, 1] grid coords, as
    F.grid_sample(mode='bilinear', padding_mode='zeros',
    align_corners=False): coords[..., 0] is x (the width axis), pixel
    centres at half-integer grid positions, out-of-bounds taps count zero.
    Four gathers from the flattened map, blended by differentiable weights.
    feat (B, H, W, C), coords (B, N, 2) -> (B, N, C)."""
    b, h, w, c = feat.shape
    x = (coords[..., 0] + 1.0) * (w / 2.0) - 0.5
    y = (coords[..., 1] + 1.0) * (h / 2.0) - 0.5
    x0, y0 = torch.floor(x), torch.floor(y)
    wx, wy = x - x0, y - y0
    flat = feat.reshape(b * h * w, c)
    base = (torch.arange(b, device=feat.device) * (h * w))[:, None]

    def tap(ix, iy):
        inside = (ix >= 0) & (ix <= w - 1) & (iy >= 0) & (iy <= h - 1)
        idx = iy.clamp(0, h - 1).long() * w + ix.clamp(0, w - 1).long() + base  # (B, N)
        g = flat.index_select(0, idx.reshape(-1)).reshape(b, -1, c)
        return g * inside[..., None].to(feat.dtype)

    return (tap(x0, y0) * ((1 - wx) * (1 - wy))[..., None]
            + tap(x0 + 1, y0) * (wx * (1 - wy))[..., None]
            + tap(x0, y0 + 1) * ((1 - wx) * wy)[..., None]
            + tap(x0 + 1, y0 + 1) * (wx * wy)[..., None])


def generate_planes(mode: str = "xy_xz_yz") -> np.ndarray:
    """Plane axis triplets (volume_renderer_v8.py:832-868)."""
    if mode == "xy_xz_zx":
        axes = [
            [[1, 0, 0], [0, 1, 0], [0, 0, 1]],
            [[1, 0, 0], [0, 0, 1], [0, 1, 0]],
            [[0, 0, 1], [1, 0, 0], [0, 1, 0]],
        ]
    elif mode == "xy_xz_yz":
        axes = [
            [[1, 0, 0], [0, 1, 0], [0, 0, 1]],
            [[1, 0, 0], [0, 0, 1], [0, 1, 0]],
            [[0, 1, 0], [0, 0, 1], [1, 0, 0]],
        ]
    else:
        raise NotImplementedError(mode)
    return np.asarray(axes, np.float32)


def project_onto_planes(plane_axes: np.ndarray, coords: torch.Tensor) -> torch.Tensor:
    """3D points -> per-plane 2D coords (volume_renderer_v8.py:869-884):
    coords @ inv(axes), the first two components. coords (B, N, 3) ->
    (B, n_planes, N, 2)."""
    inv = torch.from_numpy(np.linalg.inv(plane_axes)).to(coords.device, coords.dtype)
    return torch.einsum("bnc,pcd->bpnd", coords, inv)[..., :2]


def sample_from_planes(plane_axes: np.ndarray, plane_features: torch.Tensor,
                       coords: torch.Tensor) -> torch.Tensor:
    """plane_features (B, P, C, H, W), coords (B, N, 3) in [-1, 1] ->
    (B, P, N, C) (volume_renderer_v8.py:885-918)."""
    b, p, c, h, w = plane_features.shape
    feat = plane_features.permute(0, 1, 3, 4, 2).reshape(b * p, h, w, c)
    proj = project_onto_planes(plane_axes, coords).reshape(b * p, -1, 2)
    return grid_sample_bilinear(feat, proj).reshape(b, p, -1, c)


# -------------------------------------------------------------- modules --


class PosEncoding:
    """x -> [x?, sin(2^k pi x)..., cos(2^k pi x)...] (volume_renderer_v8.py:
    656-726): all sines, then all cosines, on the last axis."""

    def __init__(self, n_freqs: int, append_xyz: bool = False):
        self.n_freqs = n_freqs
        self.append_xyz = append_xyz

    def __call__(self, x):
        freqs = [2.0**k * np.pi for k in range(self.n_freqs)]
        out = [x] if self.append_xyz else []
        for fn in (torch.sin, torch.cos):
            out += [fn(f * x) for f in freqs]
        return torch.cat(out, dim=-1)

    def out_dim(self, in_dim: int = 3) -> int:
        return in_dim * 2 * self.n_freqs + (in_dim if self.append_xyz else 0)


class _Linear(nn.Module):
    """LinearLayer (volume_renderer_v8.py:17-37), x @ weight + bias with the
    weight stored (in, out) as in the JAX tree; weight ~ U(-scale, scale)
    at the JAX package's scale 1.0, bias ~ U(+-1/sqrt(in))."""

    def __init__(self, in_dim, out_dim, scale=1.0):
        super().__init__()
        self.scale = scale
        self.weight = nn.Parameter(torch.empty(in_dim, out_dim))
        self.bias = nn.Parameter(torch.empty(out_dim))

    def reset_parameters(self, gen):
        uniform_bound_(self.weight, gen, self.scale)
        uniform_bound_(self.bias, gen, 1.0 / np.sqrt(self.weight.shape[0]))

    def forward(self, x):
        return x @ self.weight + self.bias


class TriplaneNet(nn.Module):
    """The sigma branch and the view-conditioned rgb / feature branch
    (volume_renderer_v8.py:600-653)."""

    def __init__(self, in_dim, view_dim=0, hidden_dim=256):
        super().__init__()
        self.sigma_0 = _Linear(in_dim, hidden_dim)
        self.sigma_1 = _Linear(hidden_dim, 1)
        self.views_0 = _Linear(in_dim + view_dim, hidden_dim)
        self.views_1 = _Linear(hidden_dim, hidden_dim)
        self.rgb = _Linear(hidden_dim, 3)

    def forward(self, feats, view_enc=None):
        sdf = self.sigma_1(F.softplus(self.sigma_0(feats)))
        x = feats if view_enc is None else torch.cat([feats, view_enc], dim=-1)
        x = self.views_1(F.softplus(self.views_0(x)))
        return self.rgb(x), sdf, x


@dataclasses.dataclass(frozen=True)
class TriplaneConfig:
    plane_channels: int = 32
    hidden_dim: int = 256
    with_sdf: bool = True
    view_n_freqs: int = 0  # 0 = no view encoding (reference default cfgs)
    triplane_mode: str = "xy_xz_yz"


class TriplaneRenderer(nn.Module):
    """Volume renderer over generator-made feature planes
    (volume_renderer_v8.py:728-831). Weights are drawn from `seed` on the
    CPU, then moved to `device` (default: the card)."""

    def __init__(self, cfg: TriplaneConfig = TriplaneConfig(), device=None, seed=0):
        super().__init__()
        self.cfg = cfg
        self.view_encoding = PosEncoding(cfg.view_n_freqs) if cfg.view_n_freqs > 0 else None
        view_dim = self.view_encoding.out_dim() if self.view_encoding else 0
        self.network = TriplaneNet(3 * cfg.plane_channels, view_dim, cfg.hidden_dim)
        self.sigmoid_beta = nn.Parameter(torch.full((1,), 0.1))
        self.plane_axes = generate_planes(cfg.triplane_mode)
        init_parameters(self, torch.Generator().manual_seed(seed))
        self.to(resolve_device(device))

    def run_network(self, planes, npts, viewdirs):
        """npts (B, R, S, 3) normalised to [-1, 1]; viewdirs (B, R, 3)."""
        b, r, s, _ = npts.shape
        sampled = sample_from_planes(self.plane_axes, planes, npts.reshape(b, r * s, 3))
        feats = sampled.permute(0, 2, 1, 3).reshape(b, r, s, -1)  # the planes' features
        view_enc = None
        if self.view_encoding is not None:
            view_enc = self.view_encoding(viewdirs[:, :, None, :].expand(npts.shape))
        return self.network(feats, view_enc)

    def forward(self, planes, pts, rays_d, viewdirs, z_vals, near, far,
                return_eikonal: bool = False):
        """planes (B, 3, C, H, W), pts (B, R, S, 3), rays_d / viewdirs
        (B, R, 3), z_vals (B, R, S), near / far (B, 1, 1). Returns
        (rgb (B,R,3), feat (B,R,hidden), sdf (B,R,S,1), mask_depth (B,R,2),
        xyz (B,R,3), eikonal (B,R,S,3) | None). The eikonal term
        d(sdf)/d(pts) keeps its graph under grad mode, so a loss on it
        differentiates again (through the sampler's double backward)."""
        if return_eikonal:
            create = torch.is_grad_enabled()
            with torch.enable_grad():
                p = pts if pts.requires_grad else pts.detach().requires_grad_(True)
                rgb, sdf, feats = self.run_network(planes, normalize_points(p, near, far),
                                                   viewdirs)
                (eik,) = torch.autograd.grad(sdf, p, torch.ones_like(sdf), create_graph=create)
        else:
            rgb, sdf, feats = self.run_network(planes, normalize_points(pts, near, far),
                                               viewdirs)
            eik = None
        thumb, feat, xyz, maskd = volume_integration(
            rgb, sdf, feats, z_vals, rays_d, pts, with_sdf=self.cfg.with_sdf,
            sigmoid_beta=self.sigmoid_beta)
        return thumb, feat, sdf, maskd, xyz, eik
