"""Data and ray parallelism over ranks (`mesh.py`) and host-to-device
input pipelining (`prefetch.py`)."""

from .mesh import (
    Mesh,
    all_gather_batch,
    barrier,
    gather_rays,
    global_mean,
    global_means,
    make_mesh,
    replicate,
    run_ranks,
    shard_batch,
    shard_rays,
    sync_grads,
)
from .prefetch import prefetch_to_device

__all__ = ["Mesh", "all_gather_batch", "barrier", "gather_rays", "global_mean", "global_means",
           "make_mesh", "prefetch_to_device", "replicate", "run_ranks", "shard_batch",
           "shard_rays", "sync_grads"]
