"""One run of one cell: set-up, the measured (or traced) window, the check.

A driver (``benchmark_h100/drivers/<name>.py``, named by the traffic
file's ``driver``) builds the system under test in ``setup``, does one
unit of work (a step, a request) in ``unit``, says what a unit costs in
``work``, frees the system in ``release`` and compares with the plain
reference in ``check``. The cell's metrics are read from the ``Record``
this module fills, each by ``benchmark_h100/metrics/<metric>.py``.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

import torch

HERE = Path(__file__).resolve().parents[1]


@dataclass
class Record:
    """What a run saw, for the metric readers."""

    kind: str                       # "train" or "sample"
    setup_seconds: float
    window_s: float
    units: int                      # units of work done in the window
    rows: int                       # rows trained or images made in them
    peak_bytes: int
    timings: dict = field(default_factory=dict)   # the driver's own
    work: Optional[object] = None   # flops.Work of one unit (traced runs)
    trace: Optional[object] = None  # harness.trace.Trace (traced runs)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_files(bench: dict, workload: str, root: Path) -> dict:
    """The cell's entry, its configuration, traffic and limits, by name."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    return {"cell": cell,
            "config": load_json(root / configs[cell["config"]]["file"]),
            "traffic": load_json(HERE / "traffic" / f"{cell['traffic']}.json"),
            "limits": load_json(HERE / "limits" / f"{workload}.json")}


def driver_module(traffic: dict):
    return importlib.import_module(
        f"benchmark_h100.drivers.{traffic['driver']}")


def metric_reader(name: str):
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark_h100.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(bench: dict, workload: str, traced: bool) -> list:
    """The metric entries this cell reports in this kind of run."""
    group = bench["per_layer" if traced else "end_to_end"]
    return [m for m in group
            if "workloads" not in m or workload in m["workloads"]]


def execute(driver, seconds: float, traced: bool, trace_units: int):
    """Run a driver: set-up, then the window (or the traced units), then
    the check. Returns (record, checks, attempted, failed)."""
    cuda = driver.device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(driver.device)

    if cuda:  # the allocator exists once the device has been touched
        torch.cuda.set_device(driver.device)
        torch.empty(1, device=driver.device)
        torch.cuda.reset_peak_memory_stats(driver.device)
    t0 = time.perf_counter()
    driver.setup(sync)
    sync()
    setup_seconds = time.perf_counter() - t0
    # what set-up left behind is never garbage: keep the collector's
    # passes in the window short
    gc.collect()
    gc.freeze()
    outputs, rows = [], 0
    if traced:
        from torch.profiler import ProfilerActivity, profile

        device_only = [ProfilerActivity.CUDA] if cuda else []
        # one unit with host activity too, outside the window: it names the
        # host's work in the device's idle gaps, and keeps the tracer's own
        # start-up out of the window
        with profile(activities=[ProfilerActivity.CPU]
                     + device_only) as host_trace:
            driver.unit()
            sync()
        # the window with device activity alone: tracing the host's
        # operations would slow a host-bound unit
        with profile(activities=device_only or [ProfilerActivity.CPU]) \
                as prof:
            tw = time.perf_counter()
            for _ in range(trace_units):
                n, out = driver.unit()
                rows += n
                outputs.append(out)
            sync()
            window_s = time.perf_counter() - tw
    else:
        tw = time.perf_counter()
        while True:
            n, out = driver.unit()
            rows += n
            outputs.append(out)
            if time.perf_counter() - tw >= seconds:
                break
        sync()
        window_s = time.perf_counter() - tw
    failed = sum(not bool(torch.isfinite(o).all()) for o in outputs)
    peak = torch.cuda.max_memory_allocated(driver.device) if cuda else 0
    record = Record(kind=driver.kind, setup_seconds=setup_seconds,
                    window_s=window_s, units=len(outputs), rows=rows,
                    peak_bytes=peak, timings=dict(driver.timings))
    del outputs
    if traced:
        from .trace import Trace

        record.trace = Trace(prof, window_s, Trace(host_trace, None))
        record.work = driver.work()
        del prof, host_trace
    gc.unfreeze()
    driver.release()
    t0 = time.perf_counter()
    checks = driver.check()
    record.timings["check_s"] = time.perf_counter() - t0
    return record, checks, record.units, failed
