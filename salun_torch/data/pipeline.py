"""Parallel, prefetching host input pipeline (counterpart of
``salun/data/pipeline.py``).

Three layers, so that host input overlaps device compute at ImageNet
scale (the reference decodes serially on the main thread,
Classification/imagenet.py:135-166):

1. :func:`parallel_decode`: a thread pool decodes and resizes records (PIL
   releases the GIL in its C paths, so threads scale with the cores);
2. :func:`prefetch`: a bounded background producer queue, so batch
   assembly overlaps the step;
3. :func:`device_prefetch`: each batch is copied from pinned host memory
   to the card on a side CUDA stream, one batch ahead, so the next
   batch's transfer overlaps the current step.

For packed datasets the fast path is spack (``salun_torch.data.pack``):
pre-sized uint8 records gathered by the C++ reader, no decode at all.
"""

from __future__ import annotations

import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Iterator, Optional

import numpy as np
import torch

from salun_torch.utils.device import resolve_device

_SENTINEL = object()


def prefetch(it: Iterable, depth: int = 4) -> Iterator:
    """Run ``it`` in a background thread with a bounded queue.

    Exceptions in the producer are re-raised at the consumer. When the
    consumer abandons the iterator early (break, exception, garbage
    collection), the producer is told to stop: a plain ``q.put`` would
    block forever on the full queue, leaking the thread and up to
    ``depth`` batches."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    err = []
    stop = threading.Event()

    def produce():
        try:
            for item in it:
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if stop.is_set():
                    return
        except BaseException as e:  # handed to the consumer, re-raised there
            err.append(e)
        finally:
            while not stop.is_set():
                try:
                    q.put(_SENTINEL, timeout=0.1)
                    break
                except queue.Full:
                    continue

    t = threading.Thread(target=produce, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is _SENTINEL:
                if err:
                    raise err[0]
                return
            yield item
    finally:
        stop.set()


class parallel_decode:
    """Decode records with a shared thread pool: ``fn`` maps one record
    (PIL image, bytes, path …) to an ndarray; :meth:`map` applies it to a
    batch in parallel, keeps the order and stacks."""

    def __init__(self, fn: Callable, workers: Optional[int] = None):
        self.fn = fn
        self.pool = ThreadPoolExecutor(
            max_workers=workers or min(32, (os.cpu_count() or 8)))

    def map(self, records) -> np.ndarray:
        return np.stack(list(self.pool.map(self.fn, records)))

    def close(self) -> None:
        self.pool.shutdown(wait=False)


def _tree_map(fn, batch):
    if isinstance(batch, dict):
        return {k: _tree_map(fn, v) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(_tree_map(fn, v) for v in batch)
    if isinstance(batch, np.ndarray):
        batch = np.ascontiguousarray(batch)
    return fn(torch.as_tensor(batch))


def device_prefetch(it: Iterable, device=None) -> Iterator:
    """Batches of ``it`` (tensors or numpy arrays, or dicts, lists and
    tuples of them) on ``device`` (default ``cuda``; raises without a
    card), one batch ahead.

    On a CUDA device each batch is copied into its own pinned host buffer
    and sent with a ``non_blocking`` copy on a side stream. Before a batch
    is handed over, the consumer's current stream waits on the event that
    ends its copy, and its tensors are marked as used on that stream. A
    pinned buffer is released only after its copy has completed, so no
    buffer is reused while its copy is in flight. On the CPU (asked for
    explicitly) batches are converted in turn."""
    device = resolve_device(device)
    if device.type != "cuda":
        for batch in it:
            yield _tree_map(lambda x: x.to(device), batch)
        return
    stream = torch.cuda.Stream(device)

    def send(batch):
        with torch.cuda.stream(stream):
            host = _tree_map(lambda x: x.pin_memory(), batch)
            dev = _tree_map(lambda x: x.to(device, non_blocking=True), host)
        done = torch.cuda.Event()
        done.record(stream)
        return host, dev, done

    def hand_over(sent):
        _, dev, done = sent
        consumer = torch.cuda.current_stream(device)
        consumer.wait_event(done)
        _tree_map(lambda x: x.record_stream(consumer), dev)
        return dev

    ahead = None
    for batch in it:
        sent = send(batch)
        if ahead is not None:
            yield hand_over(ahead)
            ahead[2].synchronize()  # its pinned buffer may go now
        ahead = sent
    if ahead is not None:
        yield hand_over(ahead)
