"""The input pipeline (tecogan_tpu/data/prefetch.py): the host producer
runs in a thread behind a bounded queue, and batches are copied to the
device ahead of the step that consumes them.

On a CUDA device each copy is from pinned host memory, ``non_blocking``,
on a side stream; the item carries an event that the consumer's stream
waits on before it reads the batch, so the copy of batch i+1 overlaps the
step on batch i.  ``--queue_thread`` sizes both the decode pool
(``TrainDataset.batches(workers=)``) and, here, whether the producer runs
in a thread at all.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np
import torch

from ..engine.state import resolve_device

_SENTINEL = object()


def threaded_batches(batch_iter: Iterator, depth: int = 2) -> Iterator:
    """Run ``batch_iter`` in a daemon thread, buffering ``depth`` items; an
    exception in the producer is raised in the consumer."""
    q: "queue.Queue" = queue.Queue(maxsize=max(depth, 1))
    err: list = []

    def worker():
        try:
            for item in batch_iter:
                q.put(item)
        except BaseException as e:  # surfaced on the consumer side
            err.append(e)
        finally:
            q.put(_SENTINEL)

    threading.Thread(target=worker, daemon=True).start()
    while True:
        item = q.get()
        if item is _SENTINEL:
            if err:
                raise err[0]
            return
        yield item


def device_prefetch(batch_iter: Iterator, size: int = 2, device=None) -> Iterator:
    """Tuples of arrays or tensors -> the same tuples as tensors on
    ``device`` (default: the card, see ``engine.state.resolve_device``;
    it raises here when no GPU is visible), copied ``size`` items ahead of
    consumption.  On a CUDA device the copies run on a side stream from
    pinned memory; the consumer's current stream waits for an item's copy
    when the item is handed over."""
    return _prefetch(batch_iter, size, resolve_device(device))


def _prefetch(batch_iter: Iterator, size: int, dev: torch.device) -> Iterator:
    side = torch.cuda.Stream(dev) if dev.type == "cuda" else None

    def put(item):
        host = tuple(torch.as_tensor(np.asarray(x)) if not isinstance(x, torch.Tensor)
                     else x for x in item)
        if side is None:
            return tuple(x.to(dev) for x in host), None
        done = torch.cuda.Event()
        with torch.cuda.stream(side):
            out = tuple(x.pin_memory().to(dev, non_blocking=True) for x in host)
            done.record(side)
        return out, done

    def hand_over(pending):
        out, done = pending
        if done is not None:
            torch.cuda.current_stream(dev).wait_event(done)
            for x in out:
                x.record_stream(torch.cuda.current_stream(dev))
        return out

    buf = []
    it = iter(batch_iter)
    for item in it:
        buf.append(put(item))
        if len(buf) > size:
            yield hand_over(buf.pop(0))
    while buf:
        yield hand_over(buf.pop(0))


def make_input_pipeline(batch_iter: Iterator, queue_threads: int = 8, prefetch: int = 2,
                        device=None) -> Iterator:
    """Host-side threading, then device prefetch (``prefetch`` items ahead
    onto ``device``, as :func:`device_prefetch`; 0 hands the host items
    over unchanged)."""
    it = batch_iter
    if queue_threads > 0:
        it = threaded_batches(it, depth=max(prefetch, 1))
    if prefetch > 0:
        it = device_prefetch(it, size=prefetch, device=device)
    return it
