"""Volume feature renderer: SIREN MLP + SDF-sigma compositing
(counterpart of cips3dpp_tpu/models/renderer.py).

`with_sdf=False` makes it a density renderer: alpha from softplus of the
network's fourth output (`volume_integration`); `sigmoid_beta` stays a
parameter, unused, as in the JAX package, so state dicts keep their keys.

`fused=True` routes a depth-2 SDF renderer through the SIREN render
kernel (`kernels/siren_render.py`), one call per batch item, and raises for
any renderer K1 does not take (another depth, no SDF, on the card another
width or sample count); under grad the call is the `SirenRender` autograd
Function (kernel forward, replayed backward). Otherwise the plain network
+ `volume_integration`, over tiles of `ray_chunk` rays when it is given
(same result, less memory).

The eikonal term d(sdf)/d(pts) is taken by autograd with create_graph, so
the eikonal loss trains the renderer; with `fused=True` it is a standalone
trunk pass over the same points beside the kernel's render. `remat`
recomputes the SIREN in the backward (torch.utils.checkpoint).
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..core.integration import volume_integration
from ..core.rays import normalize_points
from .siren import SirenGenerator


class VolumeFeatureRenderer(nn.Module):
    def __init__(self, depth=8, hidden_dim=256, input_dim=3, view_dim=3,
                 style_dim=256, with_sdf=True, dtype=torch.float32,
                 remat: bool = False):
        super().__init__()
        self.depth = depth
        self.hidden_dim = hidden_dim
        self.with_sdf = with_sdf
        self.dtype = dtype
        self.remat = remat
        self.sigmoid_beta = nn.Parameter(torch.full((1,), 0.1))
        self.network = SirenGenerator(depth, hidden_dim, input_dim, view_dim,
                                      style_dim)

    def reset_parameters(self, gen):
        with torch.no_grad():
            self.sigmoid_beta.fill_(0.1)

    def run_network(self, normalized_pts, viewdirs, styles):
        dirs = viewdirs[..., None, :].expand(normalized_pts.shape)
        net_in = torch.cat([normalized_pts, dirs], dim=-1).to(self.dtype)
        if self.remat and torch.is_grad_enabled():
            rgb, sdf, feats = checkpoint(self.network, net_in, styles,
                                         use_reentrant=False)
        else:
            rgb, sdf, feats = self.network(net_in, styles)
        return rgb.float(), sdf.float(), feats.float()

    def _network_eikonal(self, pts, viewdirs, near, far, styles):
        """(rgb, sdf, feats, d(sdf)/d(pts)); the gradient keeps its graph
        when grad mode is on, so a loss on it differentiates again."""
        create = torch.is_grad_enabled()
        with torch.enable_grad():
            p = pts if pts.requires_grad else pts.detach().requires_grad_(True)
            rgb, sdf, feats = self.run_network(normalize_points(p, near, far),
                                               viewdirs, styles)
            (eik,) = torch.autograd.grad(sdf, p, torch.ones_like(sdf),
                                         create_graph=create)
        return rgb, sdf, feats, eik

    def forward(self, pts, rays_d, viewdirs, z_vals, near, far, styles,
                fused: bool = False, ray_chunk: int | None = None,
                return_eikonal: bool = False):
        """pts (B,R,N,3), rays_d/viewdirs (B,R,3), z_vals (B,R,N),
        near/far (B,1,1), styles (B, depth+1, style_dim); ray_chunk must
        divide R (the fused kernel ignores it). Returns
        (thumb (B,R,3), feat (B,R,C), sdf (B,R,N,1), mask_depth (B,R,2),
        xyz (B,R,3), eikonal (B,R,N,3) | None)."""
        if fused:
            from ..kernels.siren_render import kernel_route_refusal, siren_render_fused

            why = kernel_route_refusal(self.depth, self.hidden_dim, pts.shape[2],
                                       self.with_sdf, pts.device)
            if why is not None:
                raise ValueError(f"fused=True: the SIREN render kernel takes a depth-2 "
                                 f"SDF renderer of its geometry: {why}")

            near_s = near.reshape(-1)[0]
            far_s = far.reshape(-1)[0]
            outs = [
                siren_render_fused(self, styles[i], pts[i], viewdirs[i],
                                   z_vals[i], rays_d[i], near_s, far_s)
                for i in range(pts.shape[0])
            ]
            thumb, feat, sdf, maskd, xyz = (torch.stack(o) for o in zip(*outs))
            eik = None
            if return_eikonal:
                # the kernel computes no eikonal term: a trunk pass over
                # the same points gives it, differentiable as on the plain path
                eik = self._network_eikonal(pts, viewdirs, near, far, styles)[3]
            return thumb, feat, sdf, maskd, xyz, eik

        r = pts.shape[1]
        if ray_chunk is None or ray_chunk >= r:
            return self._render_tile(pts, rays_d, viewdirs, z_vals, near, far,
                                     styles, return_eikonal)
        if r % ray_chunk:
            raise ValueError(f"ray_chunk {ray_chunk} does not divide {r} rays")
        tiles = [
            self._render_tile(pts[:, i:i + ray_chunk], rays_d[:, i:i + ray_chunk],
                              viewdirs[:, i:i + ray_chunk], z_vals[:, i:i + ray_chunk],
                              near, far, styles, return_eikonal)
            for i in range(0, r, ray_chunk)
        ]
        outs = list(zip(*tiles))
        return tuple(None if o[0] is None else torch.cat(o, dim=1) for o in outs)

    def _render_tile(self, pts, rays_d, viewdirs, z_vals, near, far, styles,
                     return_eikonal=False):
        if return_eikonal:
            rgb, sdf, feats, eik = self._network_eikonal(pts, viewdirs, near, far, styles)
        else:
            rgb, sdf, feats = self.run_network(normalize_points(pts, near, far),
                                               viewdirs, styles)
            eik = None
        thumb, feat, xyz, maskd = volume_integration(
            rgb, sdf, feats, z_vals, rays_d, pts, with_sdf=self.with_sdf,
            sigmoid_beta=self.sigmoid_beta,
        )
        return thumb, feat, sdf, maskd, xyz, eik

    def mlp_init_pass(self, pts, viewdirs, near, far, styles):
        """Sphere-init targets (volume_renderer.py:569-634): the network's
        sdf at the caller's points and |pts| - (far-near)/4."""
        _, sdf, _ = self.run_network(normalize_points(pts, near, far), viewdirs, styles)
        sdf = sdf[..., 0]
        span = (far - near).reshape((-1,) + (1,) * (sdf.ndim - 1))
        target = torch.linalg.norm(pts.detach(), dim=-1) - span / 4.0
        return sdf, target
