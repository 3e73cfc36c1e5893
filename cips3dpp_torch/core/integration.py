"""Volume integration, alpha compositing (counterpart of
cips3dpp_tpu/core/integration.py).

SDF renderers: sigma = sigmoid(-sdf/beta)/beta, alpha = 1 - exp(-sigma*dist).
Density renderers (with_sdf=False): alpha = 1 - exp(-softplus(sdf + noise)
* dist). Then the exclusive transmittance cumprod and the weighted sums
(nerf_utils.py:230-338).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..utils.profiling import count


def _cumprod_backward_read(grad):
    """A hook on cumprod's input: torch's cumprod backward reads on the
    host whether that input holds a zero (`(input == 0).any().item()`)."""
    count("host_sync")


def sdf_to_sigma(sdf: torch.Tensor, sigmoid_beta: torch.Tensor) -> torch.Tensor:
    return torch.sigmoid(-sdf / sigmoid_beta) / sigmoid_beta


def volume_integration(
    rgb: torch.Tensor,  # (..., N, 3)
    sdf: torch.Tensor,  # (..., N, 1)
    features: torch.Tensor | None,  # (..., N, C)
    z_vals: torch.Tensor,  # (..., N)
    rays_d: torch.Tensor,  # (..., 3)
    pts: torch.Tensor,  # (..., N, 3)
    with_sdf: bool = True,
    sigmoid_beta: torch.Tensor | None = None,
    raw_noise_std: float = 0.0,
    force_background: bool = False,
    noise: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
):
    """Returns (rgb_map (...,3), feature_map (...,C) | None, xyz (...,3),
    mask_depth (...,2) = [background weight, -|xyz|]).

    With raw_noise_std > 0 the density branch adds raw_noise_std times
    `noise`, an N(0, 1) draw of sdf's shape, or one drawn from `generator`;
    one of the two is required, as JAX requires its key.
    `force_background` makes the last sample's weight one minus the others."""
    dists = z_vals[..., 1:] - z_vals[..., :-1]
    rays_d_norm = torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    inf = torch.full_like(rays_d_norm, 1e10)
    dists = torch.cat([dists, inf], dim=-1) * rays_d_norm  # (..., N)

    if with_sdf:
        sigma = sdf_to_sigma(sdf, sigmoid_beta)
    else:
        raw = sdf
        if raw_noise_std > 0.0:
            if noise is None:
                if generator is None:
                    raise ValueError("raw_noise_std > 0 requires noise or a generator")
                noise = torch.randn(sdf.shape, generator=generator, device=generator.device,
                                    dtype=sdf.dtype).to(sdf.device)
            raw = sdf + raw_noise_std * noise
        sigma = F.softplus(raw)
    alpha = 1.0 - torch.exp(-sigma * dists[..., None])  # (..., N, 1)

    # exclusive cumprod of (1 - alpha), +1e-10 as in nerf_utils
    kept = 1.0 - alpha + 1e-10
    if kept.requires_grad:
        kept.register_hook(_cumprod_backward_read)
    trans = torch.cumprod(kept, dim=-2)
    visibility = torch.cat([torch.ones_like(alpha[..., :1, :]), trans[..., :-1, :]], dim=-2)
    weights = alpha * visibility  # (..., N, 1)
    if force_background:
        last = 1.0 - torch.sum(weights[..., :-1, :], dim=-2, keepdim=True)
        weights = torch.cat([weights[..., :-1, :], last], dim=-2)

    rgb_map = -1.0 + 2.0 * torch.sum(weights * torch.sigmoid(rgb), dim=-2)
    feature_map = None
    if features is not None:
        feature_map = torch.sum(weights * features, dim=-2)
    xyz = torch.sum(weights * pts, dim=-2)
    mask = weights[..., -1, :]
    depth = -torch.linalg.norm(xyz, dim=-1, keepdim=True)
    return rgb_map, feature_map, xyz, torch.cat([mask, depth], dim=-1)
