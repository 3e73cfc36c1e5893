"""Training orchestration: the host loop around the train steps
(counterpart of cips3dpp_tpu/train/train_loop.py).

Behavioural contract: exp/cips3d/scripts/train_v10.py:805-1060 (train()):
sphere-init warmup, fade-in alpha, a D step and a G step an iteration,
path reg every g_reg_every, lazy R1 every d_reg_every, EMA after
ema_start, renderer_detach during warmup, periodic checkpoints with an
evaluation hook and best-FID tracking, resume. The cadence is the JAX
loop's, index for index. The steps update the state's modules and
optimizers in place; their random draws come from one `torch.Generator`
that the caller passes in place of JAX's key.

Under a data `mesh` (parallel/mesh.py) every rank runs this loop on its
own device: the state is replicated from rank 0 at init and on resume,
each rank reads the global batch stream and keeps its rows (the images
JAX's mesh puts on each device, cips3dpp_tpu/train/train_loop.py:183-191),
the steps are data-parallel, and rank 0 alone writes checkpoints,
best_fid.pt and logs while the others wait at a barrier.

`auto_remat` (cips3dpp_tpu/train/train_loop.py:103-135) switches remat_d
on when the lazy-R1 D step would not fit: JAX compares XLA's ahead-of-time
peak (temporaries + arguments) with 97% of the device's bytes_limit. The
port has no ahead-of-time analysis, so `init_state` runs one R1 D step at
the config's batch and reads its peak allocated memory against 97% of the
limit the caching allocator enforces (the card's memory times the
process's memory fraction); a step that runs out of memory does not fit.
The step runs on the state itself, which is copied to the host first and
restored after, with a generator of its own and the global generators
forked, so a run the probe does not switch is bit-equal to a run without
it. Off the card no limit is reported and the probe does nothing, as
JAX's where the device reports no bytes_limit.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Iterable

import torch
import torch.distributed as dist

from ..models.layers import init_parameters
from ..parallel.mesh import barrier, replicate, shard_batch
from ..parallel.prefetch import prefetch_to_device
from ..utils.logging import MetricLogger
from ..utils.profiling import count, span
from .state import TrainConfig, TrainState, create_train_state
from .steps import ema_update, fade_alpha, make_train_steps


# the share of the device's limit the R1 step's peak may take (JAX's rule)
AUTO_REMAT_SHARE = 0.97


def device_memory_limit(device) -> int | None:
    """Bytes the caching allocator lets this process allocate on `device`:
    the card's memory times the process's memory fraction
    (`torch.cuda.set_per_process_memory_fraction`). None off the card."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    total = torch.cuda.get_device_properties(dev).total_memory
    return int(total * torch.cuda.get_per_process_memory_fraction(dev))


def peak_memory(fn, device) -> int | None:
    """The peak bytes allocated on the card while fn() runs, or None if it
    ran out of memory."""
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    try:
        fn()
        torch.cuda.synchronize(device)
    except torch.cuda.OutOfMemoryError:
        torch.cuda.empty_cache()
        return None
    return torch.cuda.max_memory_allocated(device)


def _host_copy(tree):
    """A copy of a state dict's tree with every tensor copied to the CPU."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _host_copy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_host_copy(v) for v in tree)
    return tree


@dataclasses.dataclass
class TrainHooks:
    """Optional callbacks so apps/tests can observe the loop."""

    on_metrics: Callable | None = None  # (step, dict) every log_every
    on_checkpoint: Callable | None = None  # (step, state)
    eval_fid: Callable | None = None  # (state) -> float | None


class Trainer:
    def __init__(
        self,
        generator,
        d_decoder,
        d_render,
        gen_cfg,
        train_cfg: TrainConfig,
        outdir: str,
        mesh=None,
        keep_ckpts: int = 3,
        log_every: int = 10,
        ckpt_every: int = 500,
        config_snapshot: dict | None = None,
        auto_remat: bool = False,
    ):
        self.generator = generator
        self.d_decoder = d_decoder
        self.d_render = d_render
        self.gen_cfg = gen_cfg
        self.cfg = train_cfg
        self.outdir = outdir
        self.log_every = log_every
        self.ckpt_every = ckpt_every
        self.config_snapshot = config_snapshot
        self.device = generator.device
        self.mesh = mesh
        # the rank that writes (every process off the mesh)
        self.main = mesh is None or mesh.is_main

        self.logger = None
        if self.main:
            os.makedirs(outdir, exist_ok=True)
            self.logger = MetricLogger(os.path.join(outdir, "logs"))
        self._ckpt = None
        self._keep = keep_ckpts
        self.auto_remat = auto_remat
        # what init_state's probe found: {"peak", "limit", "switched"}
        self.auto_remat_probe = None
        self.steps = make_train_steps(gen_cfg, train_cfg, mesh)

    # ----- setup ----------------------------------------------------------

    def init_state(self, generator: torch.Generator | None = None) -> TrainState:
        """A fresh TrainState around the trainer's modules: with
        `generator` (a CPU generator), G, D and the pose D are drawn anew
        from it, in that order; without, they keep their weights. The EMA
        generator starts as a copy of G. Under a mesh the state is then
        broadcast from rank 0. (The JAX package's second argument, an
        example batch shape, has no use here: the modules are built.)"""
        if generator is not None:
            for m in (self.generator, self.d_decoder, self.d_render):
                init_parameters(m, generator)
        state = create_train_state(self.cfg, self.generator, self.d_decoder, self.d_render,
                                   self.mesh)
        state = replicate(state, self.mesh)
        if self.auto_remat and not self.cfg.remat_d:
            self._auto_remat(state)
        return state

    def r1_step_peak(self, state: TrainState) -> int | None:
        """The peak bytes allocated on the card by one lazy-R1 D step of
        this trainer's steps at the config's batch (zero images of
        data_img_size, its own generator, the global generators forked),
        or None if it runs out of memory. The state comes back as it was,
        from a copy on the host."""
        rows = self.cfg.batch // (1 if self.mesh is None else self.mesh.data)
        size = self.cfg.data_img_size
        real = torch.zeros((rows, size, size, 3), device=self.device)
        saved = _host_copy(state.state_dict())
        devices = [self.device.index or 0] if self.device.type == "cuda" else []
        try:
            with torch.random.fork_rng(devices=devices):
                draws = torch.Generator(device=self.device).manual_seed(0)
                return peak_memory(lambda: self.steps[0](
                    state, real, draws, 1.0, d_regularize=True), self.device)
        finally:
            state.load_state_dict(saved)

    def _auto_remat(self, state: TrainState) -> None:
        """Switch remat_d on (and rebuild the steps) when one lazy-R1 D step
        at the config's batch peaks above AUTO_REMAT_SHARE of the device's
        limit or runs out of memory; the state comes back as it was. Under
        a mesh every rank probes and the ranks switch together."""
        limit = device_memory_limit(self.device)
        if limit is None:
            return
        peak = self.r1_step_peak(state)
        switch = peak is None or peak > AUTO_REMAT_SHARE * limit
        if self.mesh is not None:
            flag = torch.tensor([float(switch)], device=self.device)
            dist.all_reduce(flag, op=dist.ReduceOp.MAX)
            count("host_sync")
            switch = bool(flag.item())
        self.auto_remat_probe = {"peak": peak, "limit": limit, "switched": switch}
        if not switch:
            return
        if self.main:
            said = ("ran out of memory under" if peak is None
                    else f"peak {peak / 2**30:.2f} GiB > {AUTO_REMAT_SHARE:.0%} of")
            self.logger.log_text(f"auto_remat: d_step_r1 {said} {limit / 2**30:.2f} GiB "
                                 "- enabling remat_d")
        self.cfg = dataclasses.replace(self.cfg, remat_d=True)
        self.steps = make_train_steps(self.gen_cfg, self.cfg, self.mesh)

    def checkpointer(self):
        if self._ckpt is None:
            from ..io.checkpoint import CheckpointManager

            self._ckpt = CheckpointManager(os.path.join(self.outdir, "ckpt"),
                                           keep=self._keep)
        return self._ckpt

    def save(self, step: int, state: TrainState, metrics=None, best: bool = False) -> None:
        """Checkpoint `step` with the config snapshot (and the best-FID slot
        when `best`), written by rank 0 while the other ranks wait."""
        if self.main:
            self.checkpointer().save(step, state, config=self.config_snapshot,
                                     metrics=metrics)
            if best:
                from ..io.checkpoint import save_best

                save_best(os.path.join(self.outdir, "ckpt"), state)
        barrier(self.mesh)

    # ----- phases ---------------------------------------------------------

    def sphere_init(self, state: TrainState, generator: torch.Generator, n_iters=None,
                    log_every=200) -> TrainState:
        """SDF sphere-init phase (train_v10.py:850-875)."""
        sphere_step = self.steps[3]
        n = n_iters if n_iters is not None else self.cfg.init_iters
        for i in range(n):
            state, m = sphere_step(state, generator)
            if i % log_every == 0 and self.main:
                self.logger.log_jsonl(i, m, name="sphere_init")
        return state

    def train(
        self,
        state: TrainState,
        data: Iterable,
        generator: torch.Generator,
        start_iter: int = 0,
        total_iters: int | None = None,
        hooks: TrainHooks | None = None,
        fade: bool = True,
        sphere_init_done: bool = True,
    ) -> TrainState:
        """Main GAN loop (train_v10.py:892-1060); `data` yields (B, H, W, 3)
        batches of the global batch in [-1, 1], `generator` (on the state's
        device, seeded alike on every rank) gives every step's draws."""
        cfg = self.cfg
        hooks = hooks or TrainHooks()
        d_step, g_step, path_step, _ = self.steps
        total = total_iters if total_iters is not None else cfg.total_iters
        best_fid = float("inf")
        t0 = time.time()

        # batches are copied to the device ahead of the step that takes them
        batches = prefetch_to_device((shard_batch(b, self.mesh) for b in data),
                                     self.device)
        # Metrics stay on the device until the NEXT log point: reading them
        # at once would stall the host on the step just issued and drain
        # the queue of work ahead of the device.
        pending = None  # (idx, alpha, device metrics, dispatch time)

        @span("train.log")
        def emit(p):
            if not self.main:
                return
            p_idx, p_alpha, dev, p_time = p
            count("host_sync", sum(isinstance(v, torch.Tensor) for v in dev.values()))
            metrics = {k: float(v) for k, v in dev.items()}
            metrics["alpha"] = p_alpha
            # the rate as of when this log point was issued, not when its
            # metrics were read one interval later
            metrics["iters_per_sec"] = (p_idx + 1 - start_iter) / (p_time - t0)
            self.logger.log_jsonl(p_idx, metrics)
            self.logger.log(p_idx, metrics)
            if hooks.on_metrics:
                hooks.on_metrics(p_idx, metrics)

        for idx in range(start_iter, total):
            alpha = fade_alpha(idx, cfg.fade_steps, fade)
            # warmup: the decoder's view of the renderer features is frozen
            renderer_detach = True if (idx < cfg.warmup_iters and sphere_init_done) else None

            with span("train.data_wait"):
                real = next(batches)

            d_regularize = cfg.d_reg_every > 0 and (idx + 1) % cfg.d_reg_every == 0
            with span("train.d_step_r1" if d_regularize else "train.d_step"):
                state, dm = d_step(state, real, generator, alpha, d_regularize=d_regularize)
            with span("train.g_step"):
                state, gm = g_step(state, generator, alpha, renderer_detach=renderer_detach)

            g_regularize = cfg.g_reg_every > 0 and (idx + 1) % cfg.g_reg_every == 0
            if g_regularize:
                with span("train.path_step"):
                    state, pm = path_step(state, generator)
            else:
                pm = {}

            decay = cfg.ema_decay if idx >= cfg.ema_start else 0.0
            state = ema_update(state, decay)

            if (idx + 1) % self.log_every == 0 or idx == total - 1:
                if pending is not None:
                    emit(pending)
                pending = (idx, alpha, {**dm, **gm, **pm}, time.time())

            if (idx + 1) % self.ckpt_every == 0:
                # every rank evaluates (the hook may gather across ranks)
                fid = hooks.eval_fid(state) if hooks.eval_fid else None
                metrics = {"fid": fid} if fid is not None else None
                best = fid is not None and fid < best_fid
                if best:
                    best_fid = fid
                if fid is not None and self.main:
                    self.logger.log_jsonl(idx + 1, metrics, name="fid")
                self.save(idx + 1, state, metrics=metrics, best=best)
                if hooks.on_checkpoint:
                    hooks.on_checkpoint(idx, state)
                if self.main:
                    self.logger.save_figures()

        if pending is not None:
            emit(pending)
        if self.main:
            self.logger.flush()
        return state

    def resume(self, state: TrainState):
        """Restore the latest checkpoint into `state`, if there is one:
        (state, step), or (None, 0). Every rank reads the file; under a
        mesh the state is then broadcast from rank 0."""
        mgr = self.checkpointer()
        step = mgr.latest_step()
        if step is None:
            return None, 0
        return replicate(mgr.restore(state, step), self.mesh), step

