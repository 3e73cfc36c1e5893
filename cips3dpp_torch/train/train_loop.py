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
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Iterable

import torch

from ..models.layers import init_parameters
from ..parallel.mesh import barrier, replicate, shard_batch
from ..parallel.prefetch import prefetch_to_device
from ..utils.logging import MetricLogger
from .state import TrainConfig, TrainState, create_train_state
from .steps import ema_update, fade_alpha, make_train_steps


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
        if auto_remat:
            raise NotImplementedError(
                "auto_remat (switch remat_d on when the R1 step's memory would not fit) "
                "is not ported: its JAX form reads XLA's ahead-of-time memory analysis, "
                "which PyTorch has no counterpart of short of running the step; set "
                "remat_d in the config instead (ROADMAP queue 1, \"auto_remat\")")
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
        return replicate(state, self.mesh)

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

        def emit(p):
            if not self.main:
                return
            p_idx, p_alpha, dev, p_time = p
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

            real = next(batches)

            d_regularize = cfg.d_reg_every > 0 and (idx + 1) % cfg.d_reg_every == 0
            state, dm = d_step(state, real, generator, alpha, d_regularize=d_regularize)
            state, gm = g_step(state, generator, alpha, renderer_detach=renderer_detach)

            g_regularize = cfg.g_reg_every > 0 and (idx + 1) % cfg.g_reg_every == 0
            if g_regularize:
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

