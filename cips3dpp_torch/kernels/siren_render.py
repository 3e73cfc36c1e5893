"""Fused FiLM-SIREN + SDF volume integration, the "NeRF block"
(counterpart of cips3dpp_tpu/kernels/siren_render.py).

Per ray: normalised points -> two FiLM-SIREN layers sin(g*(x@W) + g*b + beta)
-> sdf head; view layer with the per-ray view term split out -> rgb head;
sigma = sigmoid(-sdf/beta)/beta, alpha, exclusive transmittance product,
weights; outputs thumb = 2*sum(w*sigmoid(rgb)) - 1, feat = sum(w*feats),
xyz, [mask, depth], sdf.

`siren_render_prepared` launches the CUDA kernel `csrc/siren_render.cu`
for tensors on the card and runs `siren_render_plain`, the same function
written step by step, for tensors on the CPU. Both round the matmul inputs
to bf16 and accumulate in f32, keep phase math and compositing in f32, and
use the same degree-9 polynomial sin, so they agree to f32 summation order.
"""

from __future__ import annotations

import ctypes

import torch

from . import _lib

_INV_2PI = 0.15915494309189535
_2PI = 6.283185307179586
# degree-9 odd minimax polynomial for sin on [-pi, pi], max err 8e-6
_SIN_C = (
    0.9999727636431689,
    -0.16661501432840328,
    0.008305441787505873,
    -0.00019215724206787978,
    2.125150239026409e-06,
)


def fast_sin(x: torch.Tensor) -> torch.Tensor:
    """Range-reduced degree-9 odd polynomial sin (8e-6 absolute error), the
    sin of the kernel; round-half-even range reduction as in jnp.round."""
    k = torch.round(x * _INV_2PI)
    r = x - k * _2PI
    r2 = r * r
    c = _SIN_C
    return r * (c[0] + r2 * (c[1] + r2 * (c[2] + r2 * (c[3] + r2 * c[4]))))


def _bdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """bf16-rounded inputs, f32 product and accumulation (TF32 is off for
    the plain path, see `plain_precision`)."""
    return a.to(torch.bfloat16).float() @ b.to(torch.bfloat16).float()


def plain_precision() -> None:
    """The plain versions are the f32 reference on the card too: TF32 would
    keep ~3 decimal digits in their f32 products."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _pack_siren_params(net, styles):
    """Kernel operands from a depth-2 SirenGenerator and per-layer styles
    (L+1, style_dim) of ONE sample, in the JAX layout (in, out).

    g = 15*(s@Wg+bg)+30, e = 0.25*(s@We+be); the bias is folded as
    beff = g*bias + e while the weights stay unfolded, so bf16 rounding
    hits the same values as the unfused path. The view layer's (W+3) input
    rows are split into h-rows and view-rows (the view term is per ray)."""

    def coeffs(layer, style):
        g = 15.0 * (style @ layer.gamma.weight.t() + layer.gamma.bias) + 30.0
        e = 0.25 * (style @ layer.beta.weight.t() + layer.beta.bias)
        return g[None, :], (g * layer.bias + e)[None, :]

    p0, p1 = net.pts_linears[0], net.pts_linears[1]
    pv = net.views_linears
    width = p1.weight.shape[0]
    g0, be0 = coeffs(p0, styles[0])
    g1, be1 = coeffs(p1, styles[1])
    gv, bev = coeffs(pv, styles[-1])
    return (
        p0.weight.t(), g0, be0,
        p1.weight.t(), g1, be1,
        pv.weight[:, :width].t(), pv.weight[:, width:].t(), gv, bev,
        net.sigma_linear.weight.t(), net.sigma_linear.bias[None, :],
        net.rgb_linear.weight.t(), net.rgb_linear.bias[None, :],
    )


@torch.no_grad()
def siren_prepare(renderer, styles, near, far):
    """Trajectory-invariant half: FiLM folds, f32 weights, the kernel's
    bf16 (out, in) copies of the two W x W weights, and the constants
    [2/(far-near), sigmoid_beta]. `renderer` is a VolumeFeatureRenderer
    of depth 2."""
    weights = tuple(w.float().contiguous() for w in
                    _pack_siren_params(renderer.network, styles))
    scale = (2.0 / (far - near)).reshape(()).float()
    sbeta = renderer.sigmoid_beta.reshape(()).float()
    return {
        "weights": weights,
        # f32 values as Python floats: the kernel takes them by value
        "consts": (float(scale), float(sbeta)),
        # (out, in) bf16 for the tensor-core B operand
        "w1t": weights[3].t().contiguous().to(torch.bfloat16),
        "wvht": weights[6].t().contiguous().to(torch.bfloat16),
    }


def siren_render_plain(prepared, pts, viewdirs, z_vals, dnorm):
    """Plain PyTorch version of the kernel, same rounding points. pts
    (R,S,3), viewdirs (R,3), z_vals (R,S), dnorm (R,1)."""
    (w0, g0, be0, w1, g1, be1, wvh, wvv, gv, bev,
     wsdf, bsdf, wrgb, brgb) = prepared["weights"]
    scale, sbeta = prepared["consts"]
    x = pts * scale
    h = fast_sin(g0 * _bdot(x, w0) + be0)  # (R,S,W)
    h = fast_sin(g1 * _bdot(h, w1) + be1)
    sdf = (_bdot(h, wsdf) + bsdf)[..., 0]  # (R,S)
    vphase = gv * _bdot(viewdirs, wvv) + bev  # (R,W) per-ray view term
    feats = fast_sin(gv * _bdot(h, wvh) + vphase[:, None, :])
    rgb = _bdot(feats, wrgb) + brgb  # (R,S,3)

    r = z_vals.shape[0]
    far_gap = torch.full((r, 1), 1e10, dtype=z_vals.dtype, device=z_vals.device)
    dists = torch.cat([z_vals[:, 1:] - z_vals[:, :-1], far_gap], dim=1) * dnorm
    sigma = torch.sigmoid(-sdf / sbeta) / sbeta
    alpha = 1.0 - torch.exp(-sigma * dists)
    # exclusive running product of (1 - alpha + 1e-10) over the samples
    trans = torch.cumprod(1.0 - alpha + 1e-10, dim=1)
    vis = torch.cat([torch.ones_like(trans[:, :1]), trans[:, :-1]], dim=1)
    w = (alpha * vis)[..., None]  # (R,S,1)
    thumb = -1.0 + 2.0 * torch.sum(w * torch.sigmoid(rgb), dim=1)
    feat = torch.sum(w * feats, dim=1)
    xyz = torch.sum(w * pts, dim=1)
    depth = -torch.sqrt(torch.sum(xyz * xyz, dim=-1, keepdim=True))
    maskd = torch.cat([w[:, -1], depth], dim=-1)
    return thumb, feat, sdf[..., None], maskd, xyz


# the one geometry the CUDA kernel is built for
KERNEL_WIDTH, KERNEL_SAMPLES = 256, 24


def kernel_route_refusal(depth: int, width: int, n_samples: int, with_sdf: bool,
                         device) -> str | None:
    """Why a renderer of this geometry cannot render through K1 on
    `device`, or None if it can. K1 renders a depth-2 SDF SIREN; on the
    card its kernel is built for width 256 and 24 samples, on the CPU its
    plain version takes any width. The training steps decide their route
    with it once, from the configuration (the JAX package's gate,
    cips3dpp_tpu/models/renderer.py:86-90)."""
    if not with_sdf:
        return "the renderer has no SDF"
    if depth != 2:
        return f"the renderer has depth {depth}, K1 renders depth 2"
    if torch.device(device).type == "cuda" and (width, n_samples) != (
            KERNEL_WIDTH, KERNEL_SAMPLES):
        return (f"the renderer has width {width} and {n_samples} samples, K1 is built "
                f"for width {KERNEL_WIDTH} and {KERNEL_SAMPLES} samples")
    return None


def _launch(prepared, pts, viewdirs, z_vals, dnorm, defines=()):
    """The kernel on the card; `defines` selects an instrumented build
    (`_lib.load`)."""
    dev = pts.device
    r, s, _ = pts.shape
    weights = prepared["weights"]
    width = weights[3].shape[1]
    if width != KERNEL_WIDTH or s != KERNEL_SAMPLES:
        raise ValueError(f"siren_render kernel is built for width 256 and 24 "
                         f"samples, got width {width}, {s} samples")
    f32 = torch.float32
    _lib.check(pts, "pts", (r, s, 3), f32, dev)
    _lib.check(viewdirs, "viewdirs", (r, 3), f32, dev)
    _lib.check(z_vals, "z_vals", (r, s), f32, dev)
    _lib.check(dnorm, "dnorm", (r, 1), f32, dev)
    shapes = [(3, width), (1, width), (1, width), (width, width), (1, width),
              (1, width), (width, width), (3, width), (1, width), (1, width),
              (width, 1), (1, 1), (width, 3), (1, 3)]
    for i, (wt, shp) in enumerate(zip(weights, shapes)):
        _lib.check(wt, f"weights[{i}]", shp, f32, dev)
    bf16 = torch.bfloat16
    _lib.check(prepared["w1t"], "w1t", (width, width), bf16, dev)
    _lib.check(prepared["wvht"], "wvht", (width, width), bf16, dev)

    thumb = torch.empty((r, 3), dtype=f32, device=dev)
    feat = torch.empty((r, width), dtype=f32, device=dev)
    xyz = torch.empty((r, 3), dtype=f32, device=dev)
    maskd = torch.empty((r, 2), dtype=f32, device=dev)
    sdf = torch.empty((r, s), dtype=f32, device=dev)
    if r == 0:
        return thumb, feat, sdf[..., None], maskd, xyz
    lib = _lib.load("siren_render", defines)
    fn = lib.siren_render_forward
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 18 + [ctypes.c_float] * 2 + \
        [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_void_p]
    (w0, g0, be0, _, g1, be1, _, wvv, gv, bev,
     wsdf, bsdf, wrgb, brgb) = weights
    scale, sbeta = prepared["consts"]
    p = _lib.ptr
    code = fn(
        p(pts), p(viewdirs), p(z_vals), p(dnorm),
        p(w0), p(g0), p(be0), p(prepared["w1t"]), p(g1), p(be1),
        p(prepared["wvht"]), p(wvv), p(gv), p(bev),
        p(wsdf), p(bsdf), p(wrgb), p(brgb),
        scale, sbeta,
        p(thumb), p(feat), p(xyz), p(maskd), p(sdf),
        r, _lib.stream_ptr(dev),
    )
    _lib.raise_on_error(code, "siren_render")
    _lib.LAUNCHES["siren_render"] += 1
    return thumb, feat, sdf[..., None], maskd, xyz


def siren_render_prepared(prepared, pts, viewdirs, z_vals, rays_d):
    """Per-frame half (camera-dependent inputs only). pts (R,S,3),
    viewdirs (R,3), z_vals (R,S), rays_d (R,3). Returns (thumb (R,3),
    feat (R,W), sdf (R,S,1), mask_depth (R,2), xyz (R,3)).

    Tensors on the card go through the CUDA kernel; tensors on the CPU
    through `siren_render_plain`."""
    dnorm = torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    if pts.device.type == "cuda":
        return _launch(prepared, pts.contiguous(), viewdirs.contiguous(),
                       z_vals.contiguous(), dnorm.contiguous())
    if pts.device.type == "cpu":
        return siren_render_plain(prepared, pts, viewdirs, z_vals, dnorm)
    raise ValueError(f"siren_render: no kernel for device {pts.device}")


class SirenRender(torch.autograd.Function):
    """Differentiable fused render of one batch item (the counterpart of
    JAX's `siren_render` custom_vjp): the forward is the kernel on the card
    (its plain version on the CPU); the backward replays
    `siren_render_reference`, the same function layer by layer with
    torch.sin, under autograd, as JAX's backward replays its jnp reference.
    There is no backward kernel.

    apply(renderer, styles, pts, viewdirs, z_vals, rays_d, near, far,
    *params) with params = tuple(renderer.parameters()); gradients reach
    the renderer's parameters, styles, pts, viewdirs, z_vals, rays_d, near
    and far, and the replay is itself differentiable under create_graph."""

    @staticmethod
    def forward(ctx, renderer, styles, pts, viewdirs, z_vals, rays_d, near, far,
                *params):
        ctx.renderer = renderer
        ctx.save_for_backward(styles, pts, viewdirs, z_vals, rays_d, near, far)
        prepared = siren_prepare(renderer, styles, near, far)
        return siren_render_prepared(prepared, pts, viewdirs, z_vals, rays_d)

    @staticmethod
    def backward(ctx, *cotangents):
        renderer = ctx.renderer
        params = tuple(renderer.parameters())
        create = torch.is_grad_enabled()  # backward under create_graph
        with torch.enable_grad():
            # fresh leaves for the saved inputs; the parameters are the
            # renderer's own, so the FiLM folds replay differentiably
            ins = [x.detach().requires_grad_(need)
                   for x, need in zip(ctx.saved_tensors, ctx.needs_input_grad[1:8])]
            outs = siren_render_reference(renderer, *ins)
            wrt = [x for x in ins if x.requires_grad] + [
                p for p, need in zip(params, ctx.needs_input_grad[8:]) if need]
            grads = iter(torch.autograd.grad(
                outs, wrt, cotangents, allow_unused=True, create_graph=create))
        in_grads = [next(grads) if x.requires_grad else None for x in ins]
        p_grads = [next(grads) if need else None for need in ctx.needs_input_grad[8:]]
        return (None, *in_grads, *p_grads)


def siren_render_fused(renderer, styles, pts, viewdirs, z_vals, rays_d,
                       near, far):
    """Prepare + render of one batch item. Under grad mode with any input
    or renderer parameter requiring grad it goes through `SirenRender`
    (kernel forward, replayed backward); otherwise it is the no-grad
    serving path."""
    params = tuple(renderer.parameters())
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (styles, pts, viewdirs, z_vals, rays_d, *params)):
        return SirenRender.apply(renderer, styles, pts, viewdirs, z_vals, rays_d,
                                 near, far, *params)
    with torch.no_grad():
        prepared = siren_prepare(renderer, styles, near, far)
        return siren_render_prepared(prepared, pts, viewdirs, z_vals, rays_d)


def siren_render_reference(renderer, styles, pts, viewdirs, z_vals, rays_d,
                           near, far, matmul_dtype=torch.bfloat16):
    """Unfused oracle with the same signature: the network layer by layer
    (torch.sin, bias unfolded, the view concat) + `volume_integration`.
    Matmul inputs round to `matmul_dtype` (f32 accumulation)."""
    from ..core.integration import volume_integration

    net = renderer.network
    scale = (2.0 / (far - near)).reshape(())
    x = pts * scale
    dirs = viewdirs[:, None, :].expand(pts.shape)

    def dot(a, b):
        return a.to(matmul_dtype).float() @ b.to(matmul_dtype).float()

    def film(layer, h, style):
        g = 15.0 * (style @ layer.gamma.weight.t() + layer.gamma.bias) + 30.0
        e = 0.25 * (style @ layer.beta.weight.t() + layer.beta.bias)
        return torch.sin(g * (dot(h, layer.weight.t()) + layer.bias) + e)

    h = film(net.pts_linears[0], x, styles[0])
    h = film(net.pts_linears[1], h, styles[1])
    sdf = dot(h, net.sigma_linear.weight.t()) + net.sigma_linear.bias
    feats = film(net.views_linears, torch.cat([h, dirs], dim=-1), styles[-1])
    rgb = dot(feats, net.rgb_linear.weight.t()) + net.rgb_linear.bias
    thumb, feat, xyz, maskd = volume_integration(
        rgb, sdf, feats, z_vals, rays_d, pts, renderer.sigmoid_beta
    )
    return thumb, feat, sdf, maskd, xyz
