"""Data parallelism over ranks (counterpart of cips3dpp_tpu/parallel/mesh.py).

The JAX package runs one process over a mesh of devices: the batch axis is
sharded over "data", the parameters are replicated, and losses written as
global means make XLA insert the collectives. A step on N devices equals
the step on one device at the same global batch
(tests/test_mesh_equivalence.py). The reference gets there with one
process a GPU and explicit collectives (exp/stylesdf/models/
distributed.py; tl2 ddp_utils.sync_gradients / sync_models,
train_v10.py:381, 880). So does the port, with the same global result:

- every rank draws the random inputs of the global batch from the same
  generator and keeps its rows (`shard_batch`);
- the gradients are averaged by one all-reduce before the optimizer's clip
  (`sync_grads`, called by `train.state.ClippedAdam.step`);
- a statistic over the batch inside the model (the discriminator's
  minibatch stddev) gathers the batch from every rank (`all_gather_batch`,
  differentiable to the second order, for R1);
- a mean over the batch that enters a loss is global (`global_mean`);
- the state starts equal on every rank (`replicate`, a broadcast from
  rank 0).

Not `nn.parallel.DistributedDataParallel`: its hooks reduce gradients in
`.backward()`, while the train steps take `torch.autograd.grad`
themselves and R1 differentiates a gradient. The collectives run at world
size 1 too, so a one-GPU run goes through the code that N GPUs run.

The gathering and mean functions are collectives in their backward as
well: every rank must differentiate the same graph in step.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import os
import shutil
import tempfile
import time

import torch
import torch.distributed as dist

from ..device import resolve_device


@dataclasses.dataclass
class Mesh:
    """One rank's view of a 1-axis data mesh: its rank, the world size,
    its device and the process group. `counts` counts the collectives
    issued by kind ("grad_all_reduce" once an optimizer step)."""

    rank: int
    world: int
    device: torch.device
    group: object
    backend: str
    counts: collections.Counter = dataclasses.field(default_factory=collections.Counter)
    _tmpdir: str | None = None

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def close(self) -> None:
        """Destroy the process group (and the rendezvous directory this
        mesh made)."""
        if dist.is_initialized():
            dist.destroy_process_group()
        if self._tmpdir is not None:
            shutil.rmtree(self._tmpdir, ignore_errors=True)
            self._tmpdir = None


def make_mesh(n_devices: int | None = None, ray: int = 1, device=None, *, rank: int = 0,
              init_method: str | None = None, backend: str | None = None) -> Mesh:
    """Join a data mesh of `n_devices` ranks (default: every visible GPU)
    as rank `rank`. On the card each rank takes `cuda:<rank>` and the group
    runs NCCL; with `device="cpu"` it runs gloo. An explicit device with an
    index (e.g. "cuda:0") puts every rank on that device, which only gloo
    allows. `init_method` is the rendezvous every rank shares (a `file://`
    URL, so concurrent runs cannot collide on a port); a one-rank mesh
    makes its own. Raises when fewer GPUs than ranks are visible, or when
    the group cannot start."""
    if ray > 1:
        raise NotImplementedError(
            f"ray={ray}: sharding the rays over a second mesh axis is not ported "
            "(ROADMAP queue 1 item 7, the mesh's ray axis)")
    dev = resolve_device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if n_devices is None:
        n_devices = torch.cuda.device_count() if dev.type == "cuda" else 1
    world = int(n_devices)
    if world < 1 or not 0 <= rank < world:
        raise ValueError(f"rank {rank} of a mesh of {world}")
    if dev.type == "cuda" and dev.index is None:
        have = torch.cuda.device_count()
        if have < world:
            raise RuntimeError(f"a mesh of {world} GPUs, but {have} visible")
        dev = torch.device("cuda", rank)
    elif backend == "nccl" and world > 1:
        raise ValueError(f"NCCL takes one device a rank; {world} ranks on {dev}")
    if dist.is_initialized():
        raise RuntimeError("a process group is already running in this process")
    tmpdir = None
    if init_method is None:
        if world > 1:
            raise ValueError(f"a mesh of {world} ranks needs the rendezvous its ranks "
                             "share (init_method; run_ranks makes one)")
        tmpdir = tempfile.mkdtemp(prefix="cips3dpp_mesh_")
        init_method = f"file://{os.path.join(tmpdir, 'rendezvous')}"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world)
    return Mesh(rank, world, dev, dist.group.WORLD, backend, _tmpdir=tmpdir)


def _rank_main(rank, fn, world, tmp, device, backend, args):
    mesh = make_mesh(world, device=device, rank=rank, backend=backend,
                     init_method=f"file://{os.path.join(tmp, 'rendezvous')}")
    try:
        out = fn(mesh, *args)
        torch.save(out, os.path.join(tmp, f"result-{rank}.pt"))
    finally:
        mesh.close()


def run_ranks(fn, world: int, *args, device=None, backend: str | None = None,
              workdir: str | None = None, timeout: float | None = None) -> list:
    """Run `fn(mesh, *args)` on `world` ranks, one spawned process each,
    and return their results in rank order. `fn` must be importable by
    name (it is pickled by reference) and return tensors, numbers, strings
    and containers of them. The rendezvous file and the results (removed
    once read) go to `workdir` (default: a temporary directory, removed
    after). With `timeout` (seconds), ranks still running then are killed
    and TimeoutError is raised."""
    import torch.multiprocessing as tmp_mp

    with contextlib.ExitStack() as stack:
        if workdir is None:
            workdir = stack.enter_context(tempfile.TemporaryDirectory(prefix="cips3dpp_ranks_"))
        os.makedirs(workdir, exist_ok=True)
        ctx = tmp_mp.spawn(_rank_main, args=(fn, world, workdir, device, backend, args),
                           nprocs=world, join=False)
        deadline = None if timeout is None else time.monotonic() + timeout
        while not ctx.join(None if deadline is None else 1.0):
            if deadline is not None and time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                    p.join()
                raise TimeoutError(f"{world} ranks of {fn.__name__} ran past {timeout} s")
        results = []
        for r in range(world):
            path = os.path.join(workdir, f"result-{r}.pt")
            results.append(torch.load(path, weights_only=True))
            os.remove(path)
        return results


# ------------------------------------------------------------ collectives --


def shard_batch(x, mesh: Mesh | None):
    """The rank's rows of a global batch (a tensor or numpy array); the
    batch itself off the mesh or on one rank (a slice of every row would
    add a node to the autograd graph, whose backward hands the next node a
    contiguous copy, so the sums after it could round otherwise)."""
    if mesh is None or mesh.world == 1:
        return x
    b = x.shape[0]
    if b % mesh.world:
        raise ValueError(f"batch {b} does not split over {mesh.world} ranks")
    n = b // mesh.world
    return x[mesh.rank * n:(mesh.rank + 1) * n]


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def replicate(module_or_state, mesh: Mesh | None):
    """Broadcast every tensor of `module_or_state.state_dict()` from rank 0,
    in place (the reference's sync_models): a module's parameters and
    buffers, or a TrainState's modules, optimizer moments and
    mean_path_length. Integer counters are equal by construction."""
    if mesh is None:
        return module_or_state
    for t in _tensors(module_or_state.state_dict()):
        if t.device == mesh.device:
            dist.broadcast(t, 0, group=mesh.group)
        else:  # e.g. Adam's step counts, kept on the CPU
            buf = t.to(mesh.device)
            dist.broadcast(buf, 0, group=mesh.group)
            t.copy_(buf)
    mesh.counts["broadcast"] += 1
    return module_or_state


def sync_grads(grads: list[torch.Tensor], mesh: Mesh) -> list[torch.Tensor]:
    """The ranks' mean of each gradient, by one all-reduce of the
    flattened list (the reference's sync_gradients). Returns new tensors
    shaped as `grads`."""
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=mesh.group)
    mesh.counts["grad_all_reduce"] += 1
    flat = flat / mesh.world
    return [part.view_as(g).clone()
            for part, g in zip(flat.split([g.numel() for g in grads]), grads)]


class _GatherRows(torch.autograd.Function):
    """Forward: the ranks' tensors concatenated along dim 0. Backward: the
    sum over ranks of the cotangents, the rows of this rank."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(mesh.world)]
        dist.all_gather(parts, x, group=mesh.group)
        mesh.counts["all_gather"] += 1
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, grad):
        return _SumOwnRows.apply(grad, ctx.mesh), None


class _SumOwnRows(torch.autograd.Function):
    """The adjoint of `_GatherRows`: an all-reduce, then this rank's rows.
    Its own adjoint is the gather, so the pair differentiates to any
    order."""

    @staticmethod
    def forward(ctx, grad, mesh):
        ctx.mesh = mesh
        total = grad.contiguous().clone()
        dist.all_reduce(total, group=mesh.group)
        mesh.counts["all_reduce"] += 1
        return shard_batch(total, mesh).clone()

    @staticmethod
    def backward(ctx, grad):
        return _GatherRows.apply(grad, ctx.mesh), None


def all_gather_batch(x: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """The global batch from every rank's rows (in rank order), on every
    rank; gradients flow back to each rank's rows, to any order."""
    return x if mesh is None else _GatherRows.apply(x, mesh)


class _GlobalMean(torch.autograd.Function):
    """The mean over ranks; its adjoint is itself."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        total = x.contiguous().clone()
        dist.all_reduce(total, group=mesh.group)
        mesh.counts["all_reduce"] += 1
        return total / mesh.world

    @staticmethod
    def backward(ctx, grad):
        return _GlobalMean.apply(grad, ctx.mesh), None


def global_mean(x: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """The mean of `x` over ranks (each rank's `x` a mean over its rows,
    so the result is the mean over the global batch); differentiable."""
    return x if mesh is None else _GlobalMean.apply(x, mesh)


def global_means(metrics: dict, mesh: Mesh | None) -> dict:
    """Detached 0-d metrics averaged over ranks by one all-reduce."""
    if mesh is None or not metrics:
        return metrics
    stacked = torch.stack([v.detach().float() for v in metrics.values()])
    dist.all_reduce(stacked, group=mesh.group)
    mesh.counts["metric_all_reduce"] += 1
    return dict(zip(metrics, stacked / mesh.world))


def barrier(mesh: Mesh | None) -> None:
    if mesh is not None:
        kw = dict(device_ids=[mesh.device.index]) if mesh.backend == "nccl" else {}
        dist.barrier(group=mesh.group, **kw)
