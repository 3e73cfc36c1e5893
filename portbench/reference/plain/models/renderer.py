# Frozen copy of cips3dpp_torch/models/renderer.py at commit af17e715d5a8,
# the plain path only: the yardstick keeps this copy whatever the program
# becomes. Edits from the source are marked "portbench:".
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
            # portbench: in place of the kernel, its precision computed
            # plainly (`k1_precision_network`), through the same integration
            rgb, sdf, feats = k1_precision_network(
                self.network, normalize_points(pts, near, far), viewdirs, styles)
            thumb, feat, xyz, maskd = volume_integration(
                rgb, sdf, feats, z_vals, rays_d, pts, with_sdf=self.with_sdf,
                sigmoid_beta=self.sigmoid_beta)
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


def _bdot(a, w):
    """a @ w.t() with both operands rounded to bf16, summed in f32."""
    return a.to(torch.bfloat16).float() @ w.t().to(torch.bfloat16).float()


def _film(layer, lin, style):
    gamma, beta = layer.gamma(style), layer.beta(style)
    shape = gamma.shape[:1] + (1,) * (lin.ndim - gamma.ndim) + gamma.shape[1:]
    return torch.sin(gamma.reshape(shape) * lin + beta.reshape(shape))


def k1_precision_network(net, pts, viewdirs, styles):
    """portbench: the depth-2 SIREN at the precision of the program's SIREN
    render kernel (csrc/siren_render.cu; kernels/siren_render.py folds its
    operands): layer 1 and the view layer's hidden rows on bf16 operands
    with f32 sums (the tensor-core products), layer 0, the view rows, the
    sdf and rgb heads and every phase in f32. Returns (rgb, sdf, feats)."""
    p0, p1 = net.pts_linears
    views = viewdirs[..., None, :].expand(pts.shape)
    h = _film(p0, pts @ p0.weight.t() + p0.bias, styles[:, 0])
    h = _film(p1, _bdot(h, p1.weight) + p1.bias, styles[:, 1])
    sdf = net.sigma_linear(h)
    v, w = net.views_linears, p1.weight.shape[0]
    feats = _film(v, _bdot(h, v.weight[:, :w]) + views @ v.weight[:, w:].t() + v.bias,
                  styles[:, -1])
    return net.rgb_linear(feats), sdf, feats
