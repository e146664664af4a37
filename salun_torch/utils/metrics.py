"""Structured metrics and profiling (counterpart of
``salun/utils/metrics.py``).

A JSONL metrics writer with in-memory curves, a step timer, and
:func:`maybe_profile`, a ``torch.profiler`` trace behind a directory
argument or ``SALUN_TRACE_DIR`` (the JAX package's uses ``jax.profiler``).
"""

from __future__ import annotations

import json
import os
import time
from contextlib import contextmanager
from typing import Optional


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


@contextmanager
def maybe_profile(trace_dir: Optional[str] = None):
    """A ``torch.profiler`` trace of the body when a directory is given (or
    ``SALUN_TRACE_DIR`` is set): CPU activity, and CUDA activity when a card
    is present; on exit a Chrome trace (open it in Perfetto or
    chrome://tracing) goes into the directory. Yields the trace file's
    path, or None (and profiles nothing) without a directory."""
    trace_dir = trace_dir or os.environ.get("SALUN_TRACE_DIR")
    if not trace_dir:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, f"trace.{os.getpid()}."
                        f"{time.time_ns()}.pt.trace.json")
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield path
    finally:
        prof.stop()
        prof.export_chrome_trace(path)


@contextmanager
def step_timer(meter_list: list):
    t0 = time.perf_counter()
    yield
    meter_list.append(time.perf_counter() - t0)
