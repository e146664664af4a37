"""The port's own spans in one run of a cell: ``run.py``'s run with the
port's tracer (``salun_torch.utils.metrics``) on from before set-up, or
left off, and in a traced run the spans laid over the window's device
trace (``harness/spans.py``).

    python3 benchmark_h100/span_report.py --workload <name> --seed <n> \
        --seconds <s> --trace <0|1> [--tracer 0|1]

Prints ``run.py``'s result line with a key ``spans`` added: the readings
of the span metrics in ``metrics/`` that have something to read; each
span name's count and summed CUDA-event time over the run; the span whose
exit first read the run's peak memory; the cost of a span call with the
tracer off and on; and in a traced run ``by_span`` (the ten span names
with the most device time in the window: device s, launches, idle s) and
how much of the window's device time lies in a span. With ``--tracer 0``
the run is ``run.py``'s, for the tracer's cost end to end. A traced run
gives the window's device time and its length a unit either way.

Exits non-zero, with no result, without a CUDA device, or if JAX or the
JAX package ``salun`` was loaded (as ``run.py`` does).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
METRICS = ("optimizer_ms.train", "optimizer_launches.train",
           "optimizer_idle_pct.train", "mask_sort_s", "mask_peak_gib",
           "transition_ms.sample")


def span_cost_ns(calls_off: int = 10 ** 6, calls_on: int = 2000) -> dict:
    """Host ns a ``with span(...)`` costs: tracing off, on, and on inside
    a device-only ``torch.profiler`` window (as in a traced run)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from salun_torch.utils import metrics

    def loop(n):
        t0 = time.perf_counter_ns()
        for _ in range(n):
            with metrics.span("step"):
                pass
        return (time.perf_counter_ns() - t0) / n

    out = {"off_ns": loop(calls_off)}
    metrics.start_tracing()
    out["on_ns"] = loop(calls_on)
    metrics.stop_tracing()
    if torch.cuda.is_available():
        with profile(activities=[ProfilerActivity.CUDA]):
            metrics.start_tracing()
            out["on_traced_ns"] = loop(calls_on)
            metrics.stop_tracing()
    return out


def first_at_peak(spans):
    """The span whose exit first read the largest peak of them all."""
    read = [s for s in spans if s["peak_bytes"] is not None]
    if not read:
        return None
    top = max(s["peak_bytes"] for s in read)
    first = min((s for s in read if s["peak_bytes"] == top),
                key=lambda s: s["end_ns"])
    by_id = {s["id"]: s for s in spans}
    chain, s = [], first
    while s is not None:
        chain.append(s["name"])
        s = by_id.get(s["parent"])
    return {"span": " < ".join(chain), "unit": first["unit"],
            "peak_bytes": top}


def report(bench: dict, files: dict, workload: str, seed: int,
           seconds: float, traced: bool, tracer: bool, device) -> dict:
    """One run of the cell (``run.run_cell``) with the tracer on or off;
    its result object with the key ``spans``."""
    from benchmark_h100 import run
    from benchmark_h100.harness import runner, spans, trace
    from salun_torch.utils import metrics

    kept = {}
    execute, window_trace = runner.execute, trace.Trace

    def execute_with_spans(driver, *args):
        setup = driver.setup

        def setup_traced(sync):
            metrics.start_tracing()
            setup(sync)

        if tracer:
            driver.setup = setup_traced
        try:
            out = execute(driver, *args)
        finally:
            recorded = metrics.stop_tracing()
        kept["record"] = out[0]
        out[0].spans = recorded if tracer else None
        return out

    # until ``runner.execute`` records the spans and ``Trace`` the
    # launches itself
    runner.execute, trace.Trace = execute_with_spans, spans.LaunchTrace
    try:
        result, lines = run.run_cell(bench, files, workload, seed, seconds,
                                     traced, device)
    finally:
        runner.execute, trace.Trace = execute, window_trace
    rec = kept["record"]
    out = {"tracer": tracer, "metrics": {}, "cost": span_cost_ns()}
    if tracer:
        names = defaultdict(lambda: [0, 0.0])
        for s in rec.spans:
            names[s["name"]][0] += 1
            names[s["name"]][1] += s["device_s"] or 0.0
        out["event_s"] = dict(names)
        out["first_at_peak"] = first_at_peak(rec.spans)
    if traced:
        out["window"] = {"busy_s": rec.trace.busy_s,
                         "unit_s": rec.trace.window_s / max(rec.units, 1)}
    if tracer and traced:
        att = rec.attribution = spans.Attribution(rec.trace, rec.spans)
        out["by_span"] = att.by_span()
        out["window"].update({
            "attributed_s": att.busy_s, "in_a_span_s": att.named_s,
            "rest": {k: att.shares[k].device_s for k in (spans.NO_SPAN,
                                                         spans.NO_LAUNCH)
                     if k in att.shares},
            "spans_per_unit": len(att.spans) / max(rec.units, 1)})
    for name in METRICS:
        value = runner.metric_reader(name)(rec)
        if value is not None:
            out["metrics"][name] = value
    result["spans"] = out
    result["lines"] = lines
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--tracer", type=int, choices=(0, 1), default=1)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from benchmark_h100 import run
    from benchmark_h100.harness import runner

    run.set_environment()
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    bench = runner.load_json(ROOT / "BENCHMARK.json")
    files = runner.cell_files(bench, args.workload, ROOT)
    result = report(bench, files, args.workload, args.seed, args.seconds,
                    bool(args.trace), bool(args.tracer), "cuda:0")
    found = run.forbidden_modules()
    if found:
        print(f"loaded in this process: {', '.join(found)} (JAX or the JAX "
              f"package); no result", file=sys.stderr)
        return 3
    print("\n".join(result.pop("lines")), file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
