"""Host-to-device input pipelining for the training loop (counterpart of
cips3dpp_tpu/parallel/prefetch.py).

The reference's train loop `.to(device)`s each batch synchronously
(exp/cips3d/scripts/train_v10.py:905-918), which puts the copy on the
step's critical path. Here `size` batches are kept in flight: each is
copied from page-locked host memory by a `non_blocking` copy on a side
stream, and the stream that consumes it waits on the copy's event, so the
copy overlaps the steps already queued. `record_stream` tells the caching
allocator that the consuming stream uses the batch, so its memory is not
handed out again before the consumer's work on it has run.
"""

from __future__ import annotations

import collections
from typing import Iterable, Iterator

import numpy as np
import torch

from ..device import resolve_device


def prefetch_to_device(data: Iterable, device=None, size: int = 2) -> Iterator[torch.Tensor]:
    """Yield the batches of `data` (numpy arrays or CPU tensors) as float32
    tensors on `device` (default: the card), `size` of them in flight. On
    the CPU the same tensors come in the same order, with no copy."""
    if size < 1:
        raise ValueError(f"size={size}: at least one batch is kept in flight")
    dev = resolve_device(device)
    it = iter(data)
    as_tensor = lambda b: torch.as_tensor(np.asarray(b, np.float32))
    if dev.type != "cuda":
        for batch in it:
            yield as_tensor(batch).to(dev)
        return

    copy_stream = torch.cuda.Stream(device=dev)
    queue: collections.deque = collections.deque()

    def put():
        try:
            host = as_tensor(next(it)).pin_memory()
        except StopIteration:
            return
        # `out` comes from the side stream's pool: the allocator hands
        # none of the consumer's live blocks to it
        with torch.cuda.stream(copy_stream):
            out = host.to(dev, non_blocking=True)
            done = torch.cuda.Event()
            done.record(copy_stream)
        queue.append((out, done))

    for _ in range(size):
        put()
    while queue:
        out, done = queue.popleft()
        consumer = torch.cuda.current_stream(dev)
        consumer.wait_event(done)
        out.record_stream(consumer)
        put()
        yield out
