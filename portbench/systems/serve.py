"""Serving cells: one client in a closed loop, each request a new
identity rendered through `serving.prepare_trajectory` and then
`serving.render_frame` calls of the mix's frames a call; each call's
images are copied to pinned host memory as the call is enqueued, and a
request ends when its last frame has reached the host, as a user gets
it.

The window's checked requests keep their frames (each its own host
buffer); once the window has closed and the peak memory is read, the
program is freed and the plain reference renders the same frames from
the same inputs."""

from __future__ import annotations

import contextlib
import time

import torch

from portbench.lib import traffic as T
from portbench.lib.common import Phases, derive
from portbench.lib.weights import draw_weights
from portbench.reference import serve as ref


class Inputs:
    """What the harness hands the program and the reference: the
    weights' seed, the mean-latent z's and each request's z's and noise."""

    def __init__(self, config: dict, seed: int, device, noise_shapes):
        self.config, self.seed, self.device = config, seed, device
        self.noise_shapes = noise_shapes
        self.gen = torch.Generator(device=device)
        self.z_dim = config["model"]["mapping"]["z_dim"]

    def weights(self, modules):
        draw_weights(modules, derive(self.seed, "weights"), self.device)

    def mean_zs(self):
        n = self.config["serving"]["mean_latent_samples"]
        self.gen.manual_seed(derive(self.seed, "mean_latents"))
        return [torch.randn((n, self.z_dim), generator=self.gen, device=self.device)
                for _ in range(2)]

    def request(self, index: int):
        """(zs, noise buffers) of request `index`: two (1, z_dim) latents and
        one (1, h, w, 1) buffer a decoder layer."""
        self.gen.manual_seed(T.request_seed(self.seed, index))
        zs = [torch.randn((1, self.z_dim), generator=self.gen, device=self.device)
              for _ in range(2)]
        noise = [torch.randn(s, generator=self.gen, device=self.device)
                 for s in self.noise_shapes]
        return zs, noise


class HostFrames:
    """Where a request's images go: each render call's copied to pinned
    host memory on a stream of its own once the call is enqueued, so the
    copy of one call overlaps the render of the next; `wait()` returns
    when the last copy has landed. Off the card, a plain copy."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        self.stream = torch.cuda.Stream(device) if self.cuda else None

    def buffer(self, like: torch.Tensor, frames: int) -> torch.Tensor:
        return torch.empty((frames, *like.shape[1:]), dtype=like.dtype, pin_memory=self.cuda)

    def copy(self, dst: torch.Tensor, src: torch.Tensor) -> None:
        if not self.cuda:
            dst.copy_(src)
            return
        self.stream.wait_stream(torch.cuda.current_stream(src.device))
        with torch.cuda.stream(self.stream):
            dst.copy_(src, non_blocking=True)
        src.record_stream(self.stream)  # its memory is not reused before the copy

    def wait(self) -> None:
        if self.cuda:
            self.stream.synchronize()


def run(ctx):
    from cips3dpp_torch import serving
    from cips3dpp_torch.models import generator as PG

    cfg, mix, dev = ctx.config, ctx.traffic, ctx.device
    model = cfg["model"]
    torch.backends.cuda.matmul.allow_tf32 = cfg["precision"]["tf32"]
    torch.backends.cudnn.allow_tf32 = cfg["precision"]["tf32"]
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    phases = Phases(ctx.t_start, sync)
    phases.mark("imports")

    # weights from the seed, on the device, through the reference's
    # initialisers; the program loads them
    probe = ref.build(model, dev, lambda ms: None)
    inputs = Inputs(cfg, ctx.seed, dev, probe.decoder.noise_shapes(model["img_size"]))
    inputs.weights([probe])
    weights = probe.state_dict()
    del probe
    g = PG.Generator(ref.generator_config(model, module=PG), device=dev, seed=0)
    g.load_state_dict(weights)
    g.requires_grad_(False)
    del weights
    with torch.no_grad():
        z1, z2 = inputs.mean_zs()
        means = (g.mapping_renderer_w(z1).mean(0, keepdim=True),
                 g.mapping_decoder_w(z2).mean(0, keepdim=True))
        del z1, z2
    phases.mark("model")
    trunc = cfg["serving"]["truncation"]
    calls = [(torch.tensor(a, device=dev), torch.tensor(e, device=dev))
             for a, e in T.video_plan(mix)]
    frames_per_request = sum(a.shape[0] for a, _ in calls)
    host = HostFrames(dev)
    shared = []  # the host buffer of every request whose frames are not kept

    def request(index, dst=None, thumbs=None, trace=None):
        zs, noise = inputs.request(index)
        t0 = time.perf_counter()
        with _span(trace, "prepare"):
            prep = serving.prepare_trajectory(g, zs, noise_bufs=noise, truncation=trunc,
                                              mean_latents=means, device=dev)
            if trace is not None:
                sync()
        with _span(trace, "calls"):
            at = 0
            for az, el in calls:
                out = serving.render_frame(g, prep, az, el, device=dev)
                rgb = out["rgb"]
                if dst is None:
                    if not shared:  # made in the warm-up
                        shared.append(host.buffer(rgb, frames_per_request))
                    dst = shared[0]
                host.copy(dst[at:at + rgb.shape[0]], rgb)
                at += rgb.shape[0]
                if thumbs is not None:
                    thumbs.append(out["thumb_rgb"])
            host.wait()
        t1 = time.perf_counter()
        return {"t0": t0, "t1": t1, "frames": frames_per_request, "calls": len(calls)}

    for i in range(mix["warmup_requests"]):
        request(-1 - i)
    phases.mark("warm-up")
    # the checked requests' frames: (host images, device thumbnails)
    kept = {i: (host.buffer(shared[0], frames_per_request), [])
            for i in T.checked_requests(ctx.seed, mix)}
    phases.mark("host buffers")
    setup_s = time.perf_counter() - ctx.t_start
    phases.report()
    units, trace = [], ctx.new_trace()
    index = 0
    if trace is not None:
        trace.start()
    t_w0 = time.perf_counter()
    while True:
        tracing = trace is not None and index < mix["trace_requests"]
        units.append(request(index, *kept.get(index, (None, None)),
                             trace=trace if tracing else None))
        index += 1
        if tracing and index == mix["trace_requests"]:
            trace.stop()
            trace.units = index
        if units[-1]["t1"] - t_w0 >= ctx.seconds:
            break
    window_s = units[-1]["t1"] - t_w0
    if trace is not None and trace.prof is not None:
        trace.stop()
        trace.units = index
    while index <= max(kept):  # a checked request past the window: served
        request(index, *kept.get(index, (None, None)))  # and checked, not counted
        index += 1
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    del g, means, shared
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    checks = check(ctx, inputs, kept, calls, trunc)
    return {"setup_s": setup_s, "window_s": window_s, "units": units, "trace": trace,
            "memory_peak_bytes": peak, "checks": checks, "attempted": len(units),
            "failed": 0, "frames_per_call": calls[0][0].shape[0]}


def check(ctx, inputs, kept, calls, trunc):
    """[(name, value, limit)]: the worst checked frame's mean gap to the
    plain reference, of the image and of the thumbnail (K1's output).
    `ctx.precision` the config's control ("fp8") puts the control's frames
    in the program's place; "calibrate" reads both, the control's as
    "control.<name>"."""
    cfg = ctx.config
    chk, model, control = cfg["check"], cfg["model"], cfg["precision"]["control"]
    sides = {"program": ctx.precision in ("program", "calibrate"),
             "control": ctx.precision in (control, "calibrate")}
    g = ref.build(model, ctx.device, inputs.weights)
    means = ref.mean_latents(g, *inputs.mean_zs())
    if sides["control"]:
        ctl = ref.build(model, ctx.device, inputs.weights, control)
        cmeans = ref.mean_latents(ctl, *inputs.mean_zs())
    azim = torch.cat([a for a, _ in calls])
    elev = torch.cat([e for _, e in calls])
    render = lambda m, zs, noise, mean: [torch.cat(x) for x in zip(*ref.frames(
        m, zs, noise, azim, elev, trunc, mean, chk["ref_block"]))]
    inf = float("inf")
    errs = {s: ([], []) for s in sides}
    for index, (images, thumbs) in kept.items():
        zs, noise = inputs.request(index)
        r_rgb, r_thumb = render(g, zs, noise, means)
        got = {}
        if sides["program"]:
            got["program"] = [images.to(ctx.device), torch.cat(thumbs)]
        if sides["control"]:
            got["control"] = render(ctl, zs, noise, cmeans)
        for side, (rgb, thumb) in got.items():
            if rgb.shape != r_rgb.shape or thumb.shape != r_thumb.shape:
                er, et = [inf], [inf]  # frames missing or extra
            else:
                er, et = ref.frame_errors(rgb, thumb, r_rgb, r_thumb)
            errs[side][0].extend(er)
            errs[side][1].extend(et)
    lim = chk["limits"]
    out = []
    for side in ("program", "control"):
        if sides[side]:
            prefix = "control." if side == "control" and sides["program"] else ""
            out += [(prefix + n, max(errs[side][i], default=inf), lim[n])
                    for i, n in enumerate(("rgb_err", "thumb_err"))]
    return out


def _span(trace, name):
    return contextlib.nullcontext() if trace is None else trace.span(name)
