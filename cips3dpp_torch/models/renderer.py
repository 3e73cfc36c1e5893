"""Volume feature renderer: SIREN MLP + SDF-sigma compositing
(counterpart of cips3dpp_tpu/models/renderer.py, forward only).

`fused=True` routes a depth-2 SDF renderer through the SIREN render
kernel (`kernels/siren_render.py`), one call per batch item, and raises for
any other depth; otherwise the plain network + `volume_integration`, over
tiles of `ray_chunk` rays when it is given (same result, less memory). The
eikonal term and remat are training features and are not part of this
module yet.
"""

from __future__ import annotations

import torch
from torch import nn

from ..core.integration import volume_integration
from ..core.rays import normalize_points
from .siren import SirenGenerator


class VolumeFeatureRenderer(nn.Module):
    def __init__(self, depth=8, hidden_dim=256, input_dim=3, view_dim=3,
                 style_dim=256, with_sdf=True, dtype=torch.float32):
        super().__init__()
        if not with_sdf:
            raise NotImplementedError("only the SDF renderer is ported")
        self.depth = depth
        self.dtype = dtype
        self.sigmoid_beta = nn.Parameter(torch.full((1,), 0.1))
        self.network = SirenGenerator(depth, hidden_dim, input_dim, view_dim,
                                      style_dim)

    def reset_parameters(self, gen):
        with torch.no_grad():
            self.sigmoid_beta.fill_(0.1)

    def run_network(self, normalized_pts, viewdirs, styles):
        dirs = viewdirs[..., None, :].expand(normalized_pts.shape)
        net_in = torch.cat([normalized_pts, dirs], dim=-1).to(self.dtype)
        rgb, sdf, feats = self.network(net_in, styles)
        return rgb.float(), sdf.float(), feats.float()

    def forward(self, pts, rays_d, viewdirs, z_vals, near, far, styles,
                fused: bool = False, ray_chunk: int | None = None):
        """pts (B,R,N,3), rays_d/viewdirs (B,R,3), z_vals (B,R,N),
        near/far (B,1,1), styles (B, depth+1, style_dim); ray_chunk must
        divide R (the fused kernel ignores it). Returns
        (thumb (B,R,3), feat (B,R,C), sdf (B,R,N,1), mask_depth (B,R,2),
        xyz (B,R,3), None)."""
        if fused:
            if self.depth != 2:
                raise ValueError(f"fused=True: the SIREN render kernel takes a "
                                 f"depth-2 renderer, this one has depth {self.depth}")
            from ..kernels.siren_render import siren_render_fused

            near_s = near.reshape(-1)[0]
            far_s = far.reshape(-1)[0]
            outs = [
                siren_render_fused(self, styles[i], pts[i], viewdirs[i],
                                   z_vals[i], rays_d[i], near_s, far_s)
                for i in range(pts.shape[0])
            ]
            thumb, feat, sdf, maskd, xyz = (torch.stack(o) for o in zip(*outs))
            return thumb, feat, sdf, maskd, xyz, None

        r = pts.shape[1]
        if ray_chunk is None or ray_chunk >= r:
            return self._render_tile(pts, rays_d, viewdirs, z_vals, near, far, styles)
        if r % ray_chunk:
            raise ValueError(f"ray_chunk {ray_chunk} does not divide {r} rays")
        tiles = [
            self._render_tile(pts[:, i:i + ray_chunk], rays_d[:, i:i + ray_chunk],
                              viewdirs[:, i:i + ray_chunk], z_vals[:, i:i + ray_chunk],
                              near, far, styles)
            for i in range(0, r, ray_chunk)
        ]
        outs = list(zip(*tiles))[:5]
        return tuple(torch.cat(o, dim=1) for o in outs) + (None,)

    def _render_tile(self, pts, rays_d, viewdirs, z_vals, near, far, styles):
        npts = normalize_points(pts, near, far)
        rgb, sdf, feats = self.run_network(npts, viewdirs, styles)
        thumb, feat, xyz, maskd = volume_integration(
            rgb, sdf, feats, z_vals, rays_d, pts, self.sigmoid_beta
        )
        return thumb, feat, sdf, maskd, xyz, None
