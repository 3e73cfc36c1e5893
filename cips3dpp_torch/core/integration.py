"""SDF-sigma volume integration (counterpart of cips3dpp_tpu/core/integration.py).

sigma = sigmoid(-sdf/beta)/beta, alpha = 1 - exp(-sigma*dist), exclusive
transmittance cumprod, weighted sums (nerf_utils.py:230-338). The SDF
branch only: the serving path never takes the density branch.
"""

from __future__ import annotations

import torch


def sdf_to_sigma(sdf: torch.Tensor, sigmoid_beta: torch.Tensor) -> torch.Tensor:
    return torch.sigmoid(-sdf / sigmoid_beta) / sigmoid_beta


def volume_integration(
    rgb: torch.Tensor,  # (..., N, 3)
    sdf: torch.Tensor,  # (..., N, 1)
    features: torch.Tensor | None,  # (..., N, C)
    z_vals: torch.Tensor,  # (..., N)
    rays_d: torch.Tensor,  # (..., 3)
    pts: torch.Tensor,  # (..., N, 3)
    sigmoid_beta: torch.Tensor,
):
    """Returns (rgb_map (...,3), feature_map (...,C) | None, xyz (...,3),
    mask_depth (...,2) = [background weight, -|xyz|])."""
    dists = z_vals[..., 1:] - z_vals[..., :-1]
    rays_d_norm = torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    inf = torch.full_like(rays_d_norm, 1e10)
    dists = torch.cat([dists, inf], dim=-1) * rays_d_norm  # (..., N)

    sigma = sdf_to_sigma(sdf, sigmoid_beta)
    alpha = 1.0 - torch.exp(-sigma * dists[..., None])  # (..., N, 1)

    # exclusive cumprod of (1 - alpha), +1e-10 as in nerf_utils
    trans = torch.cumprod(1.0 - alpha + 1e-10, dim=-2)
    visibility = torch.cat([torch.ones_like(alpha[..., :1, :]), trans[..., :-1, :]], dim=-2)
    weights = alpha * visibility  # (..., N, 1)

    rgb_map = -1.0 + 2.0 * torch.sum(weights * torch.sigmoid(rgb), dim=-2)
    feature_map = None
    if features is not None:
        feature_map = torch.sum(weights * features, dim=-2)
    xyz = torch.sum(weights * pts, dim=-2)
    mask = weights[..., -1, :]
    depth = -torch.linalg.norm(xyz, dim=-1, keepdim=True)
    return rgb_map, feature_map, xyz, torch.cat([mask, depth], dim=-1)
