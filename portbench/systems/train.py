"""The training cell: the program's Trainer (`train.train_loop`) over the
port's data path (`io.dataset.data_iterator`, `parallel.prefetch`) on a
synthetic shard of uint8 images, from a state past sphere-init, fade-in,
warm-up and ema_start, so every iteration is a steady-state one.

Set-up builds the state from the seed's weights and drives it through
the check's first iterations by the Trainer's own call (the first alone,
so the optimizers' state after one step can be read), then hands the
same state to the window. The window runs the Trainer until the data
feed's deadline; the batches in flight are finished, so every batch
drawn is an iteration done. Once the window has closed and the peak is
read, the program is freed and the plain reference follows the check's
iterations from the same weights, batches and draws."""

from __future__ import annotations

import contextlib
import os
import time
from pathlib import Path

import numpy as np
import torch

from portbench.lib import readings as R
from portbench.lib.common import Phases, derive
from portbench.lib.weights import draw_weights
from portbench.reference import serve as ref_serve
from portbench.reference import train as ref


class Feed:
    """The batches the Trainer takes: `data_iterator`'s, each call's kept
    (for the check), the window's ended at its deadline."""

    def __init__(self, batches):
        self.batches = batches
        self.calls = []
        self.deadline = None

    def begin(self, deadline=None):
        self.calls.append([])
        self.deadline = deadline
        self.keep = deadline is None
        return self

    def __iter__(self):
        return self

    def __next__(self):
        if self.deadline is not None and time.perf_counter() >= self.deadline:
            raise StopIteration
        b = next(self.batches)
        self.calls[-1].append(b if self.keep else None)
        return b


def dataset_dir(cache: Path, name: str, config: dict) -> Path:
    """A shard of `images` uint8 images of the data size, made once in
    `cache` from a fixed seed (the rows each run takes, their order and
    flips come from the run's seed)."""
    data = config["data"]
    size = config["train"]["data_img_size"]
    out = Path(cache) / f"{name}-data"
    path = out / f"images-{size}-0000.npy"
    if not path.exists():
        out.mkdir(parents=True, exist_ok=True)
        gen = np.random.default_rng(data["seed"])
        imgs = gen.integers(0, 256, (data["images"], size, size, 3), dtype=np.uint8)
        tmp = out / f"images-{size}-0000.tmp.npy"
        np.save(tmp, imgs)
        os.replace(tmp, path)
    return out


def run(ctx):
    from cips3dpp_torch.io.dataset import data_iterator, open_dataset
    from cips3dpp_torch.models import discriminator as PD
    from cips3dpp_torch.models import discriminator_pose as PDR
    from cips3dpp_torch.models import generator as PG
    from cips3dpp_torch.train import train_loop
    from cips3dpp_torch.train.state import TrainConfig

    cfg, mix, dev = ctx.config, ctx.traffic, ctx.device
    torch.backends.cuda.matmul.allow_tf32 = cfg["precision"]["tf32"]
    torch.backends.cudnn.allow_tf32 = cfg["precision"]["tf32"]
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    weights = lambda ms: draw_weights(ms, derive(ctx.seed, "weights"), dev)
    phases = Phases(ctx.t_start, sync)
    phases.mark("imports")

    probes = ref.modules(cfg, dev)
    weights(list(probes))
    sds = [m.state_dict() for m in probes]
    del probes
    g = PG.Generator(ref_serve.generator_config(cfg["model"], module=PG), device=dev, seed=0)
    d = PD.DStyleGANProgressive(device=dev, **cfg["d"])
    dr = PDR.DVolumeRenderProgressive(device=dev, **cfg["d_render"])
    for m, sd in zip((g, d, dr), sds):
        m.load_state_dict(sd)
    del sds
    phases.mark("modules")
    tcfg = TrainConfig(**cfg["train"])
    outdir = Path(ctx.cache) / f"{ctx.cell['config']}-logs"  # the Trainer's logs
    trainer = train_loop.Trainer(g, d, dr, g.cfg, tcfg, str(outdir), log_every=1,
                                 ckpt_every=1 << 40)
    state = trainer.init_state()
    phases.mark("init_state")
    ds = open_dataset(str(dataset_dir(ctx.cache, ctx.cell["config"], cfg)),
                      resolution=tcfg.data_img_size)
    batches = data_iterator(ds, tcfg.batch, seed=derive(ctx.seed, "data") % (1 << 31))
    feed = Feed(batches)
    draws = torch.Generator(device=dev).manual_seed(derive(ctx.seed, "draws"))
    s0 = mix["start_iter"]
    seen = []
    hooks = train_loop.TrainHooks(on_metrics=lambda step, m: seen.append(R.losses(m)))
    phases.mark("data")

    # the check's iterations, through the window's own call and feed: the
    # first alone (the optimizers' state after one step), then the rest
    n_check = mix["check_iters"]
    snap = R.snapshot(state)
    fakes = R.FirstFakes(state.g)
    state = trainer.train(state, feed.begin(), draws, start_iter=s0, total_iters=s0 + 1,
                          hooks=hooks)
    grad1 = R.first_grads(state)
    first_fakes = fakes.close()
    phases.mark("iteration 1")
    state = trainer.train(state, feed.begin(), draws, start_iter=s0 + 1,
                          total_iters=s0 + n_check, hooks=hooks)
    prog = {"losses": list(seen), "grad1": grad1, "delta": R.change_norms(state, snap),
            "fakes": first_fakes}
    del snap
    reals = [feed.calls[0][0]] + feed.calls[1][:n_check - 1]
    trainer.log_every = 1 << 40
    phases.mark("iterations 2-3")
    setup_s = time.perf_counter() - ctx.t_start
    phases.report()

    trace = ctx.new_trace()
    start = s0 + n_check
    spans = _Instrument(trainer, train_loop, trace, mix["trace_iters"])
    with spans:
        t_w0 = time.perf_counter()
        try:
            state = trainer.train(state, feed.begin(t_w0 + ctx.seconds), draws,
                                  start_iter=start, total_iters=start + (1 << 30))
        except StopIteration:  # the feed's deadline: every batch drawn is done
            pass
        sync()
    window_s = time.perf_counter() - t_w0
    n = len(feed.calls[-1])
    units = [{"idx": start + k, "images": tcfg.batch} for k in range(n)]
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    batches.close()
    del state, trainer, g, d, dr, feed
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    checks = check(ctx, weights, reals, prog, s0, n_check)
    return {"setup_s": setup_s, "window_s": window_s, "units": units, "trace": trace,
            "memory_peak_bytes": peak, "checks": checks, "attempted": n, "failed": 0}


def follow(ctx, weights, reals, s0, n_check, precision):
    """The reference's readings over the check's iterations."""
    state, steps, tcfg = ref.build(ctx.config, ctx.device, weights, precision)
    draws = torch.Generator(device=ctx.device).manual_seed(derive(ctx.seed, "draws"))
    snap = R.snapshot(state)
    fakes = R.FirstFakes(state.g)
    out = {"losses": []}
    for k in range(n_check):
        real = torch.as_tensor(np.asarray(reals[k], np.float32)).to(ctx.device)
        out["losses"].append(R.losses(ref.iterate(state, steps, tcfg, s0 + k, real, draws)))
        if k == 0:
            out["grad1"] = R.first_grads(state)
            out["fakes"] = fakes.close()
    out["delta"] = R.change_norms(state, snap)
    return out


def check(ctx, weights, reals, prog, s0, n_check):
    """[(name, value, limit)]: the check iterations' readings against the
    reference's (`readings.compare`), each number the config gives a
    limit. `ctx.precision` naming a precision of the reference (the
    config's control "tf32", or "decoder_bf16") puts the reference at that
    precision in the program's place; "calibrate" reads every number, the
    config's control's as "control.<name>" (limit None: not compared)."""
    lim = ctx.config["check"]["limits"]
    calibrate = ctx.precision == "calibrate"
    control = ctx.config["precision"]["control"] if calibrate else ctx.precision
    base = follow(ctx, weights, reals, s0, n_check, "float32")
    sides = []
    if ctx.precision in ("program", "calibrate"):
        sides.append(("", prog))
    if control != "program":
        sides.append(("control." if calibrate else "",
                      follow(ctx, weights, reals, s0, n_check, control)))
    out = []
    for prefix, readings in sides:
        gaps = R.compare(readings, base)
        out += [(prefix + k, v, lim.get(k)) for k, v in gaps.items() if calibrate or k in lim]
    return out


class _Instrument(contextlib.AbstractContextManager):
    """With a trace: the profiler over the window's first `iters`
    iterations, a span around each step timed on the device by CUDA events
    (no host synchronisation, so the loop runs as untraced) and a host
    span around the loop's wait for each batch. Without, nothing."""

    def __init__(self, trainer, loop_module, trace, iters):
        self.trainer, self.loop, self.trace = trainer, loop_module, trace
        self.iters = iters
        self.count = 0

    def __enter__(self):
        if self.trace is None:
            return self
        self.saved = (self.trainer.steps, self.loop.prefetch_to_device)
        d_step, g_step, path_step, sphere = self.trainer.steps
        real_prefetch = self.loop.prefetch_to_device

        def d_wrapped(state, real, generator, alpha, d_regularize, **kw):
            if self.count == self.iters and self.trace.prof is not None:
                self.trace.stop()
                self.trace.units = self.count
            self.count += 1
            return self._span("d_step_r1" if d_regularize else "d_step", d_step,
                              state, real, generator, alpha, d_regularize=d_regularize, **kw)

        def prefetch(*a, **k):
            inner = real_prefetch(*a, **k)
            while True:
                with self._maybe("data_wait"):
                    try:
                        b = next(inner)
                    except StopIteration:
                        return
                yield b

        self.trainer.steps = (d_wrapped, lambda *a, **k: self._span("g_step", g_step, *a, **k),
                              lambda *a, **k: self._span("path_step", path_step, *a, **k),
                              sphere)
        self.loop.prefetch_to_device = prefetch
        self.trace.start()
        return self

    def _maybe(self, name):
        return (self.trace.span(name) if self.trace.prof is not None
                else contextlib.nullcontext())

    def _span(self, name, fn, *a, **k):
        if self.trace.prof is None:
            return fn(*a, **k)
        with self.trace.timed(name):
            return fn(*a, **k)

    def __exit__(self, *exc):
        if self.trace is None:
            return False
        if self.trace.prof is not None:
            self.trace.stop()
            self.trace.units = self.count
        self.trainer.steps, self.loop.prefetch_to_device = self.saved
        return False


