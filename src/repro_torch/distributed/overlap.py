"""Host-to-device input pipeline: the paper's DMA prefetch (§IV-C) at the
framework layer.

Port of ``repro.distributed.overlap.prefetch``. On CUDA a batch is copied
from pinned host buffers with ``non_blocking`` copies on a side stream; an
event recorded after the copies is joined by the compute stream before the
step that reads the batch, so the copies of the next batches overlap the
step in flight.
"""
from __future__ import annotations

import collections
import time
from typing import Callable, Iterable, Iterator, NamedTuple

import numpy as np
import torch


class DeviceBatch(NamedTuple):
    """A batch whose host->device copy has been issued."""
    host: object                    # the host batch (stream.EdgeBatch)
    dev: tuple                      # (src, dst, eid, ts, valid) tensors
    ready: torch.cuda.Event | None  # recorded after the copies (CUDA only)
    enq_s: float                    # host time spent issuing the copies


def to_device(batch, device: torch.device,
              copy_stream: torch.cuda.Stream | None = None) -> DeviceBatch:
    """Issue the copy of ``batch``'s (src, dst, eid, ts, valid) arrays to
    ``device`` without waiting for it (on ``copy_stream`` when on CUDA)."""
    t0 = time.perf_counter()
    arrays = (batch.src, batch.dst, batch.eid, batch.ts, batch.valid)
    host = [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]
    if device.type != "cuda":
        return DeviceBatch(batch, tuple(h.to(device) for h in host), None,
                           time.perf_counter() - t0)
    pinned = [h.pin_memory() for h in host]
    with torch.cuda.stream(copy_stream):
        dev = tuple(p.to(device, non_blocking=True) for p in pinned)
        ready = torch.cuda.Event()
        ready.record(copy_stream)
    return DeviceBatch(batch, dev, ready, time.perf_counter() - t0)


def join(db: DeviceBatch) -> None:
    """Make the current stream wait for ``db``'s copies; the host blocks
    until they are done, so the caller can time what the step could not
    hide. The tensors are marked as used on the current stream, which keeps
    the allocator from reusing them while the step runs."""
    if db.ready is None:
        return
    db.ready.synchronize()
    stream = torch.cuda.current_stream(db.dev[0].device)
    stream.wait_event(db.ready)
    for t in db.dev:
        t.record_stream(stream)


def prefetch(it: Iterable, size: int,
             device_put: Callable) -> Iterator:
    """Keeps ``size`` batches' copies in flight while the consumer steps."""
    buf = collections.deque()
    it = iter(it)
    try:
        for _ in range(size):
            buf.append(device_put(next(it)))
    except StopIteration:
        pass
    while buf:
        out = buf.popleft()
        try:
            buf.append(device_put(next(it)))
        except StopIteration:
            pass
        yield out
