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
from typing import NamedTuple

import torch

from ..utils.profiling import count, span
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


@span("k1.prepare")
@torch.no_grad()
def siren_prepare(renderer, styles, near, far):
    """Trajectory-invariant half: FiLM folds, f32 weights, the kernel's
    bf16 (out, in) copies of the two W x W weights, and the constants
    [2/(far-near), sigmoid_beta]. `renderer` is a VolumeFeatureRenderer
    of depth 2. The folded operands are zero-padded to the width of the
    build that renders this width (`kernel_build`): columns of w0, g*, be*, wvv,
    rows and columns of w1 and wvh, rows of wsdf and wrgb. A padded unit
    has g = 0 and beff = 0, so its phase is 0 and its sine exactly 0, and
    it meets zero weight rows: the padding changes no output but the f32
    order of the real terms' sums. `width` is the renderer's own; feat
    comes out at it. At the wide kernel's widths (512 and up) the two bf16
    weights are also laid out as it streams them (`w1c`, `wvhc`:
    `chunk_weight`)."""
    from .decoder_block import chunk_weight

    weights = tuple(w.float().contiguous() for w in
                    _pack_siren_params(renderer.network, styles))
    width = weights[3].shape[1]
    build = kernel_build(width, 1)
    kw = build.width
    if kw != width:
        # (rows, columns) of zeros to add to each operand, in _pack order
        grow = [(0, 1), (0, 1), (0, 1), (1, 1), (0, 1), (0, 1), (1, 1), (0, 1), (0, 1),
                (0, 1), (1, 0), (0, 0), (1, 0), (0, 0)]
        weights = tuple(torch.nn.functional.pad(w, (0, c * (kw - width), 0, r * (kw - width)))
                        for w, (r, c) in zip(weights, grow))
    scale = (2.0 / (far - near)).reshape(()).float()
    sbeta = renderer.sigmoid_beta.reshape(()).float()
    count("host_sync", 2)
    prepared = {
        "weights": weights,
        "width": width,
        # f32 values as Python floats: the kernel takes them by value (two
        # reads of the device on the host)
        "consts": (float(scale), float(sbeta)),
        # (out, in) bf16 for the tensor-core B operand
        "w1t": weights[3].t().contiguous().to(torch.bfloat16),
        "wvht": weights[6].t().contiguous().to(torch.bfloat16),
    }
    if kw >= WIDE_WIDTH:
        # 16 KB chunks of 128 output x 64 input features, pass by pass,
        # pre-swizzled: the wgmma A operand, one bulk copy a chunk
        prepared["w1c"] = chunk_weight(prepared["w1t"])
        prepared["wvhc"] = chunk_weight(prepared["wvht"])
    return prepared


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
    feat = torch.sum(w * feats, dim=1)[:, :prepared["width"]]  # the padded units' go
    xyz = torch.sum(w * pts, dim=1)
    depth = -torch.sqrt(torch.sum(xyz * xyz, dim=-1, keepdim=True))
    maskd = torch.cat([w[:, -1], depth], dim=-1)
    return thumb, feat, sdf[..., None], maskd, xyz


# The geometries K1 renders on the card: a depth-2 SDF SIREN of any width
# >= 1 with any sample count >= 1. csrc/siren_render.cu is built once a
# width build (the sample count taken at launch) and once more for the
# serving geometry, whose build fixes the sample count at compile time. A
# width runs at the next width a build takes, its operands zero-padded by
# siren_prepare: 32, 64, 128 or 256 (the mma.sync template), 512
# (siren_render_kernel_wide, its width fixed at compile time), and past
# 512 the next multiple of 128 in the wide kernel's run-time-width build
# (-DK1_W=0: 64-row units of 8 rays x 8 samples, h0 and h1 staged through
# a scratch in 64-feature K-chunks, so its shared memory does not grow
# with the width).
NARROW_WIDTHS = (32, 64, 128, 256)
WIDE_WIDTH = 512
BUILD_WIDTHS = NARROW_WIDTHS + (WIDE_WIDTH,)
RUN_TIME_WIDTH_DEFINE = "-DK1_W=0"
SERVING_GEOMETRY = (256, 24)
# the wide kernel's unit: 8 rays x 8 samples, the rows of its activation tiles
WIDE_UNIT_ROWS = 64


class K1Build(NamedTuple):
    width: int  # the width the kernel runs at: the operands padded to it
    defines: tuple[str, ...]  # the nvcc flags of its library


def kernel_build(width: int, n_samples: int) -> K1Build | str:
    """The K1 build that renders a depth-2 SDF SIREN of `width` with
    `n_samples` samples a ray on the card: every width >= 1 and every
    sample count >= 1 has one. Anything else (a count < 1) gets the
    reason as a string."""
    if width < 1 or n_samples < 1:
        return (f"the renderer has width {width} and {n_samples} samples, K1 takes widths "
                f"1 and up and 1 or more samples")
    if width <= WIDE_WIDTH:
        kw = next(w for w in BUILD_WIDTHS if w >= width)
        defines = (f"-DK1_W={kw}", "-DK1_FIXED_S=0")
    else:
        kw = -(-width // 128) * 128
        defines = (RUN_TIME_WIDTH_DEFINE, "-DK1_FIXED_S=0")
    if (kw, n_samples) == SERVING_GEOMETRY:
        return K1Build(kw, ())
    return K1Build(kw, defines)


def kernel_defines(width: int, n_samples: int) -> tuple[str, ...]:
    """The nvcc flags of the K1 library that renders `width` x
    `n_samples` (`kernel_build`); raises for a count < 1."""
    build = kernel_build(width, n_samples)
    if isinstance(build, str):
        raise ValueError(f"siren_render kernel: {build}")
    return build.defines


def kernel_builds() -> list[tuple[str, tuple[str, ...]]]:
    """(source, defines) of every K1 library, for `_lib.build`: the
    serving build, one a build width, and the run-time-width build."""
    return [("siren_render", ())] + [("siren_render", kernel_defines(w, 1))
                                     for w in BUILD_WIDTHS + (WIDE_WIDTH + 128,)]


def wide_scratch_bytes(kernel_width: int) -> int:
    """Bytes of scratch one CTA of the run-time-width build uses: its h0
    and h1 tiles, each WIDE_UNIT_ROWS rows x `kernel_width` bf16
    (`wide_activation_layout`)."""
    return 2 * WIDE_UNIT_ROWS * kernel_width * 2


def wide_activation_layout(h: torch.Tensor) -> torch.Tensor:
    """An activation tile (WIDE_UNIT_ROWS rows x W features, W a multiple
    of 64) as the run-time-width build keeps it in its scratch: W / 64
    K-chunks of 64 rows x 64 features (8 KB in bf16), in order; within a
    chunk, row n's 16-byte group j of 8 features sits at j ^ (n % 8), the
    swizzle of `chunk_weight`'s chunks, so one bulk copy puts a chunk in a
    ring slot as wgmma reads it. Returns the tile flat."""
    m, w = h.shape
    x = h.reshape(m, w // 64, 8, 8).permute(1, 0, 2, 3)  # chunk, row, group, value
    rows = torch.arange(m, device=h.device)[:, None]
    swizzle = torch.arange(8, device=h.device)[None, :] ^ (rows % 8)
    return torch.gather(x, 2, swizzle[None, :, :, None].expand(x.shape)).reshape(-1)


def kernel_route_refusal(depth: int, width: int, n_samples: int, with_sdf: bool,
                         device) -> str | None:
    """Why a renderer of this geometry cannot render through K1 on
    `device`, or None if it can. K1 renders a depth-2 SDF SIREN; on the
    card its kernel takes every width and sample count (`kernel_build`),
    on the CPU its plain version too.
    The training steps decide their route with it once, from the
    configuration (the JAX package's gate,
    cips3dpp_tpu/models/renderer.py:86-90)."""
    if not with_sdf:
        return "the renderer has no SDF"
    if depth != 2:
        return f"the renderer has depth {depth}, K1 renders depth 2"
    if torch.device(device).type == "cuda":
        build = kernel_build(width, n_samples)
        return build if isinstance(build, str) else None
    return None


def default_kernel_route(depth: int, width: int, n_samples: int, with_sdf: bool,
                         device) -> tuple[bool, str | None]:
    """(take K1, why not) for a route left at its default: the train
    steps' fused flags and `Projector(fused=None)`. The JAX package takes
    its kernel only on the TPU and only for a geometry the kernel renders
    (cips3dpp_tpu/models/renderer.py:86-90, apps/inversion.py:132-139), so
    a default route takes K1 only on the card and only where
    `kernel_route_refusal` passes; off the card it renders plainly. `why`
    is K1's refusal of the geometry, if any, for the caller to print once.
    An explicit request may still reach K1's plain version on the CPU."""
    why = kernel_route_refusal(depth, width, n_samples, with_sdf, device)
    return why is None and torch.device(device).type == "cuda", why


def _launch(prepared, pts, viewdirs, z_vals, dnorm, defines=(), scratch=None):
    """The kernel on the card, from the library of the geometry's build;
    `defines` selects an instrumented build of it (`_lib.load`). The
    operands are at the build's width; feat comes out at the renderer's.
    Past width 512 the kernel stages h0 and h1 through a scratch of
    `wide_scratch_bytes` a CTA, one CTA an SM at most: allocated here, or
    `scratch` (uint8 on the card) for a caller that reads it back."""
    dev = pts.device
    r, s, _ = pts.shape
    weights = prepared["weights"]
    width = prepared["width"]
    build = kernel_build(width, s)
    if isinstance(build, str):
        raise ValueError(f"siren_render kernel: {build}")
    kw = build.width
    f32 = torch.float32
    _lib.check(pts, "pts", (r, s, 3), f32, dev)
    _lib.check(viewdirs, "viewdirs", (r, 3), f32, dev)
    _lib.check(z_vals, "z_vals", (r, s), f32, dev)
    _lib.check(dnorm, "dnorm", (r, 1), f32, dev)
    shapes = [(3, kw), (1, kw), (1, kw), (kw, kw), (1, kw), (1, kw), (kw, kw), (3, kw),
              (1, kw), (1, kw), (kw, 1), (1, 1), (kw, 3), (1, 3)]
    for i, (wt, shp) in enumerate(zip(weights, shapes)):
        _lib.check(wt, f"weights[{i}]", shp, f32, dev)
    bf16 = torch.bfloat16
    if kw >= WIDE_WIDTH:  # the wide kernel reads the chunked layout
        w1, wvh = prepared["w1c"], prepared["wvhc"]
        _lib.check(w1, "w1c", (kw * kw,), bf16, dev)
        _lib.check(wvh, "wvhc", (kw * kw,), bf16, dev)
    else:
        w1, wvh = prepared["w1t"], prepared["wvht"]
        _lib.check(w1, "w1t", (kw, kw), bf16, dev)
        _lib.check(wvh, "wvht", (kw, kw), bf16, dev)

    if kw > WIDE_WIDTH and scratch is None:
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        scratch = torch.empty(sms * wide_scratch_bytes(kw), dtype=torch.uint8, device=dev)
    elif scratch is not None:
        _lib.check(scratch, "scratch", (scratch.numel(),), torch.uint8, dev)
    thumb = torch.empty((r, 3), dtype=f32, device=dev)
    feat = torch.empty((r, width), dtype=f32, device=dev)
    xyz = torch.empty((r, 3), dtype=f32, device=dev)
    maskd = torch.empty((r, 2), dtype=f32, device=dev)
    sdf = torch.empty((r, s), dtype=f32, device=dev)
    if r == 0:
        return thumb, feat, sdf[..., None], maskd, xyz
    lib = _lib.load("siren_render", build.defines + tuple(defines))
    fn = lib.siren_render_forward
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 18 + [ctypes.c_float] * 2 + \
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2 + \
        [ctypes.c_longlong]
    (w0, g0, be0, _, g1, be1, _, wvv, gv, bev,
     wsdf, bsdf, wrgb, brgb) = weights
    scale, sbeta = prepared["consts"]
    p = _lib.ptr
    code = fn(
        p(pts), p(viewdirs), p(z_vals), p(dnorm),
        p(w0), p(g0), p(be0), p(w1), p(g1), p(be1),
        p(wvh), p(wvv), p(gv), p(bev),
        p(wsdf), p(bsdf), p(wrgb), p(brgb),
        scale, sbeta,
        p(thumb), p(feat), p(xyz), p(maskd), p(sdf),
        r, s, kw, width, _lib.stream_ptr(dev),
        p(scratch), 0 if scratch is None else scratch.numel(),
    )
    _lib.raise_on_error(code, "siren_render")
    _lib.LAUNCHES["siren_render"] += 1
    return thumb, feat, sdf[..., None], maskd, xyz


@span("k1.render")
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
        rgb, sdf, feats, z_vals, rays_d, pts, sigmoid_beta=renderer.sigmoid_beta
    )
    return thumb, feat, sdf, maskd, xyz
