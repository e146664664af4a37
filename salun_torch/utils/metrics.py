"""Structured metrics, the program's spans and profiling (counterpart of
``salun/utils/metrics.py``).

A JSONL metrics writer with in-memory curves; :func:`span`, a named range
of the program recorded between :func:`start_tracing` and
:func:`stop_tracing`; and :func:`maybe_profile`, a ``torch.profiler``
trace with the spans merged in, behind a directory argument or
``SALUN_TRACE_DIR`` (the JAX package's uses ``jax.profiler``).

The spans the program opens, by name (each reader in parentheses):

- ``step`` (attr ``rows``), one training step, with the children
  ``step.zero_grad``, ``step.forward``, ``step.backward`` and
  ``step.optimizer`` (grads zero-filled, clipped and masked, then Adam);
  ``step.inputs`` (a DDPM batch's upload), ``vae.encode`` and
  ``clip.encode`` inside the forward;
- ``mask.grad`` (one batch's gradient pass), ``mask.sort`` (attr
  ``elements``) and ``mask.threshold``, in each mask generation;
- ``sample`` (attr ``rows``), one SD sampling request, with
  ``clip.encode``, one ``sample.transition`` a step of the chain (of the
  DDPM samplers too) and ``vae.decode``.

Each closed span is a dict: ``name``; ``id``; ``parent`` (the id of the
innermost span open in its thread, or None); ``unit`` (advanced by each
``step`` or ``sample`` opened outside any span, so shared by the spans of
one step or request); ``thread``; ``start_ns`` and ``end_ns`` on the host
clock that ``torch.profiler`` stamps its events with (``time.time_ns``);
``device_s``, the time between two CUDA events recorded on the current
stream at entry and exit (None without a card); ``peak_bytes``,
``torch.cuda.max_memory_allocated()`` read at exit (None without a card;
the peak statistics are never reset here); ``attrs``, the counts given.
"""

from __future__ import annotations

import json
import os
import threading
import time
from contextlib import contextmanager
from typing import Optional

import torch


class MetricsWriter:
    """Append-only JSONL metrics stream + in-memory curves."""

    def __init__(self, save_dir: str, name: str = "metrics"):
        os.makedirs(save_dir, exist_ok=True)
        self.path = os.path.join(save_dir, f"{name}.jsonl")
        self._f = open(self.path, "a")
        self.curves: dict = {}
        self._t0 = time.time()

    def log(self, step: int, **values):
        rec = {"step": int(step), "time": round(time.time() - self._t0, 3)}
        for k, v in values.items():
            v = float(v)
            rec[k] = v
            self.curves.setdefault(k, []).append(v)
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def close(self):
        self._f.close()

    def dump_curves(self, prefix: str = "train"):
        """Loss/accuracy curve files: ``<name>_<prefix>_curves.json``, and
        ``<name>_<prefix>.png`` where matplotlib is installed (the
        reference dumps matplotlib PNGs, unlearn/impl.py:12-18)."""
        base = os.path.splitext(self.path)[0]
        with open(f"{base}_{prefix}_curves.json", "w") as f:
            json.dump(self.curves, f)
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt

            for k, ys in self.curves.items():
                plt.plot(ys, label=k)
            plt.legend()
            plt.savefig(f"{base}_{prefix}.png")
            plt.close()
        except Exception:
            pass


class _NoSpan:
    """What :func:`span` returns while tracing is off: nothing happens."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


NO_SPAN = _NoSpan()
UNIT_SPANS = ("step", "sample")
_tracer = None  # the recording _Tracer, between start and stop


class _Tracer:
    def __init__(self):
        self.cuda = torch.cuda.is_available()
        self.spans = []    # every span opened, in order of entry
        self.events = {}   # span id -> (start event, end event)
        self.unit = 0
        self.lock = threading.Lock()
        self.open = threading.local()  # .stack: this thread's open spans


class _Span:
    __slots__ = ("tracer", "name", "attrs", "rec", "end_event")

    def __init__(self, tracer: _Tracer, name: str, attrs: dict):
        self.tracer, self.name, self.attrs = tracer, name, attrs

    def __enter__(self):
        tr = self.tracer
        stack = getattr(tr.open, "stack", None)
        if stack is None:
            stack = tr.open.stack = []
        parent = stack[-1]["id"] if stack else None
        with tr.lock:
            if parent is None and self.name in UNIT_SPANS:
                tr.unit += 1
            rec = {"name": self.name, "id": len(tr.spans), "parent": parent,
                   "unit": tr.unit, "thread": threading.get_ident(),
                   "start_ns": None, "end_ns": None, "device_s": None,
                   "peak_bytes": None, "attrs": self.attrs}
            tr.spans.append(rec)
        stack.append(rec)
        self.rec = rec
        rec["start_ns"] = time.time_ns()
        if tr.cuda:
            start = torch.cuda.Event(enable_timing=True)
            self.end_event = torch.cuda.Event(enable_timing=True)
            start.record()
            tr.events[rec["id"]] = (start, self.end_event)

    def __exit__(self, *exc):
        rec = self.rec
        if self.tracer.cuda:
            self.end_event.record()
            # max_memory_allocated()'s number, without the ~0.1 ms it
            # spends flattening every statistic into one dict
            rec["peak_bytes"] = torch.cuda.memory_stats_as_nested_dict()[
                "allocated_bytes"]["all"]["peak"]
        rec["end_ns"] = time.time_ns()
        self.tracer.open.stack.pop()
        return False


def span(name: str, **attrs):
    """A context manager around a named range of the program, recorded
    while tracing is on; ``attrs`` are counts kept with it (``rows``,
    ``elements``). While tracing is off it is one shared context that
    does nothing."""
    if _tracer is None:
        return NO_SPAN
    return _Span(_tracer, name, attrs)


def start_tracing() -> None:
    """Record every span from now on; where a card is present, with CUDA
    events and the allocator's peak too."""
    global _tracer
    if _tracer is not None:
        raise RuntimeError("tracing is already on")
    _tracer = _Tracer()


def stop_tracing() -> list:
    """Stop recording; the spans closed since :func:`start_tracing`, in
    order of entry (see the module's docstring). On a card this waits
    for the device, then reads the CUDA events' elapsed times."""
    global _tracer
    tr, _tracer = _tracer, None
    if tr is None:
        return []
    if tr.cuda:
        torch.cuda.synchronize()
    spans = [rec for rec in tr.spans if rec["end_ns"] is not None]
    for rec in spans:
        if rec["id"] in tr.events:
            start, end = tr.events[rec["id"]]
            rec["device_s"] = start.elapsed_time(end) * 1e-3
    return spans


SPAN_PROCESS = "salun_torch spans"


def _merge_spans(path: str, spans: list) -> None:
    """Write ``spans`` into the Chrome trace at ``path``, each an ``X``
    event on the profiler's time base (``ts`` = (start_ns −
    baseTimeNanoseconds) / 1000 µs), one row a thread, in a process of
    their own sorted above the others."""
    with open(path) as f:
        trace = json.load(f)
    base = int(trace.get("baseTimeNanoseconds", 0))
    meta = {"ph": "M", "pid": SPAN_PROCESS, "tid": 0}
    events = [dict(meta, name="process_name", args={"name": SPAN_PROCESS}),
              dict(meta, name="process_sort_index", args={"sort_index": -1})]
    for rec in spans:
        args = dict(rec["attrs"], unit=rec["unit"], id=rec["id"],
                    parent=rec["parent"])
        if rec["device_s"] is not None:
            args["device_ms"] = rec["device_s"] * 1e3
            args["peak_bytes"] = rec["peak_bytes"]
        events.append({"ph": "X", "cat": "span", "name": rec["name"],
                       "pid": SPAN_PROCESS, "tid": rec["thread"],
                       "ts": (rec["start_ns"] - base) / 1000,
                       "dur": (rec["end_ns"] - rec["start_ns"]) / 1000,
                       "args": args})
    trace["traceEvents"].extend(events)
    with open(path, "w") as f:
        json.dump(trace, f)


@contextmanager
def maybe_profile(trace_dir: Optional[str] = None):
    """A ``torch.profiler`` trace of the body when a directory is given (or
    ``SALUN_TRACE_DIR`` is set): CPU activity, and CUDA activity when a card
    is present, with tracing on (turned on here if it is off, and off
    again at the end); on exit a Chrome trace (open it in
    Perfetto or chrome://tracing) with the spans merged in (see
    :func:`_merge_spans`) goes into the directory. Yields the trace file's
    path, or None (and profiles nothing) without a directory."""
    trace_dir = trace_dir or os.environ.get("SALUN_TRACE_DIR")
    if not trace_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, f"trace.{os.getpid()}."
                        f"{time.time_ns()}.pt.trace.json")
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    # tracing a caller turned on stays on, and its spans stay the caller's
    own, t0 = _tracer is None, time.time_ns()
    if own:
        start_tracing()
    try:
        prof.start()
    except BaseException:
        if own:
            stop_tracing()
        raise
    try:
        yield path
    finally:
        prof.stop()
        spans = stop_tracing() if own else _closed_since(t0)
        prof.export_chrome_trace(path)
        _merge_spans(path, spans)


def _closed_since(t0_ns: int) -> list:
    """Copies of the spans the running tracer has closed that opened at
    ``t0_ns`` or later (their ``device_s`` not read yet)."""
    tr = _tracer
    return [dict(rec) for rec in (tr.spans if tr is not None else [])
            if rec["end_ns"] is not None and rec["start_ns"] >= t0_ns]
