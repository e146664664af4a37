"""CPU tests of the spans' readings (``harness/spans.py``, the span
metrics in ``metrics/`` and ``span_report.py``), on hand-made profiler
events and spans, as ``test_bench_harness.py::test_trace_reading_by_hand``
does for ``harness/trace.py``.

    python -m pytest benchmark_h100/tests -q -p no:cacheprovider
"""

from __future__ import annotations

import sys
from pathlib import Path

import pytest
import torch

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import tiny  # noqa: E402

from benchmark_h100 import span_report  # noqa: E402
from benchmark_h100.harness import runner, spans, trace  # noqa: E402

CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
BENCH = runner.load_json(HERE.parent / "BENCHMARK.json")


class _Event:
    def __init__(self, kind, start, dur, name, corr=0, thread=1):
        self._k, self._s, self._d, self._n = kind, start, dur, name
        self._c, self._t = corr, thread

    def device_type(self):
        return self._k

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def name(self):
        return self._n

    def correlation_id(self):
        return self._c

    def start_thread_id(self):
        return self._t

    def is_user_annotation(self):
        return False


def _span(i, name, start, end, parent=None, unit=1, device_s=None,
          peak=None, **attrs):
    return {"name": name, "id": i, "parent": parent, "unit": unit,
            "thread": 1, "start_ns": start, "end_ns": end,
            "device_s": device_s, "peak_bytes": peak, "attrs": attrs}


# one step on the host, ns: forward 0-100, backward 100-300 (its kernel
# launched from autograd's thread 2), optimizer 300-400, then zero_grad
# at 400-450; a stray launch at 1000, outside every span
SPANS = [_span(0, "step", 0, 460, rows=8),
         _span(1, "step.forward", 0, 100, parent=0),
         _span(2, "vae.encode", 10, 40, parent=1),
         _span(3, "step.backward", 100, 300, parent=0),
         _span(4, "step.optimizer", 300, 400, parent=0),
         _span(5, "step.zero_grad", 400, 450, parent=0)]
EVENTS = [
    # launches: (host start, correlation id)
    _Event(CPU, 20, 5, "cudaLaunchKernel", 1),       # vae.encode
    _Event(CPU, 20, 50, "Activity Buffer Request", 1),
    _Event(CPU, 60, 5, "cudaLaunchKernel", 2),       # step.forward
    _Event(CPU, 150, 5, "cuLaunchKernel", 3, thread=2),  # backward
    _Event(CPU, 310, 5, "cudaLaunchKernel", 4),      # optimizer
    _Event(CPU, 320, 5, "cudaMemsetAsync", 5),       # optimizer
    _Event(CPU, 1000, 5, "cudaLaunchKernel", 7),     # outside the spans
    _Event(CPU, 330, 5, "aten::add_", 6),            # not a launch
    # device operations: (start, duration, correlation id)
    _Event(CUDA, 100, 100, "conv_fwd", 1),           # 100-200
    _Event(CUDA, 150, 100, "elementwise", 2),        # 150-250: 50 new
    _Event(CUDA, 340, 50, "gemm_bwd", 3),            # gap 250-340
    _Event(CUDA, 420, 20, "adam", 4),                # gap 390-420
    _Event(CUDA, 440, 10, "Memset (Device)", 5),     # gap 440-440: none
    _Event(CUDA, 500, 10, "copy", 6),                # no launch: gap 450-500
    _Event(CUDA, 1100, 10, "stray", 7),              # gap 510-1100
]


def _trace_of(events):
    class Prof:
        class profiler:
            class kineto_results:
                @staticmethod
                def events():
                    return events
    return Prof


def _attribution(events, recorded):
    return spans.Attribution(spans.LaunchTrace(_trace_of(events), 2e-6),
                             recorded)


def test_device_time_and_gaps_go_to_the_innermost_span():
    att = _attribution(EVENTS, SPANS)
    assert att.window == (20, 1110)
    rows = {n: (d * 1e9, k, i * 1e9) for n, d, k, i in att.by_span()}
    # device time: the part of each operation no earlier one covers
    assert rows["vae.encode"] == pytest.approx((100, 1, 0))
    # idle: the innermost span open at the gap's middle (295 and 405)
    assert rows["step.forward"] == pytest.approx((50, 1, 0))
    assert rows["step.backward"] == pytest.approx((50, 1, 90))
    assert rows["step.optimizer"] == pytest.approx((30, 2, 0))
    assert rows["step.zero_grad"] == pytest.approx((0, 0, 30))
    assert rows[spans.NO_LAUNCH] == pytest.approx((10, 1, 0))
    # gaps at 475 (after every span) and 805 fall outside the spans
    assert rows[spans.NO_SPAN] == pytest.approx((10, 1, 50 + 590))
    # by span and the rest add up to the trace's own busy time
    tr = trace.Trace(_trace_of(EVENTS), 1e-6)
    assert att.busy_s == pytest.approx(tr.busy_s)
    assert att.named_s == pytest.approx(tr.busy_s - 20e-9)


def test_a_span_takes_in_the_spans_inside_it():
    att = _attribution(EVENTS, SPANS)
    opt = att.within(spans.OPTIMIZER)
    assert (opt.device_s * 1e9, opt.launches, opt.idle_s * 1e9) == (
        pytest.approx(30), 2, pytest.approx(30))
    fwd = att.within(("step.forward",))
    assert (fwd.device_s * 1e9, fwd.launches) == (pytest.approx(150), 2)
    whole = att.within(("step",))
    assert whole.launches == 5
    assert att.count("step") == 1 and att.count("step.inputs") == 0


def test_the_span_metrics_read_hand_made_spans():
    rec = runner.Record("train", 1.0, 1e-6, 1, 8, 0)
    rec.trace = spans.LaunchTrace(_trace_of(EVENTS), 2e-6)
    rec.spans = SPANS + [
        _span(6, "mask.sort", -90, -50, unit=0, device_s=0.25,
              elements=10),
        _span(7, "mask.sort", -50, -40, unit=0, device_s=0.5, elements=9),
        _span(8, "mask.threshold", -40, -30, unit=0, peak=3 * 2 ** 30),
        _span(9, "sample.transition", 990, 1200, unit=2)]
    rec.attribution = spans.Attribution(rec.trace, rec.spans)
    read = {m: runner.metric_reader(m)(rec) for m in span_report.METRICS}
    assert read["optimizer_ms.train"] == pytest.approx(30e-6)
    assert read["optimizer_launches.train"] == 2
    assert read["optimizer_idle_pct.train"] == pytest.approx(1.5)
    assert read["mask_sort_s"] == pytest.approx(0.75)
    assert read["mask_peak_gib"] == pytest.approx(3.0)
    assert read["transition_ms.sample"] == pytest.approx(10e-6)


@pytest.mark.parametrize("metric", span_report.METRICS)
def test_each_span_metric_reads_none_without_its_spans(metric):
    reader = runner.metric_reader(metric)
    rec = runner.Record("train", 1.0, 1.0, 1, 8, 0)
    assert reader(rec) is None  # a run without the tracer
    rec.trace = spans.LaunchTrace(_trace_of(EVENTS), 2e-6)
    rec.spans = [_span(0, "other", 0, 2000, device_s=1.0, peak=1)]
    rec.attribution = spans.Attribution(rec.trace, rec.spans)
    assert reader(rec) is None  # spans, but none of its own
    rec.spans, rec.attribution = [], _attribution([], [])
    assert reader(rec) is None  # no device operation in the window


def test_the_span_report_of_a_tiny_traced_run():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        res = span_report.report(BENCH, tiny.files("ddpm-salun-rl"),
                                 "ddpm-salun-rl", 7, 0.1, True, True, "cpu")
    finally:
        torch.set_num_threads(before)
    assert res["correct"]
    out = res["spans"]
    # set-up's mask and the steps are recorded; the CPU has no device
    # events, so no device metric is read
    assert {"mask.grad", "mask.sort", "mask.threshold", "step",
            "step.optimizer", "step.inputs"} <= set(out["event_s"])
    assert out["metrics"] == {} and out["by_span"] == []
    assert out["cost"]["off_ns"] > 0 and out["cost"]["on_ns"] > 0
    from salun_torch.utils import metrics

    assert metrics._tracer is None


def test_the_span_report_gives_no_result_with_jax_loaded(monkeypatch,
                                                         capsys):
    from benchmark_h100 import run

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(span_report, "report",
                        lambda *a: {"correct": True, "lines": []})
    monkeypatch.setattr(run, "set_environment", lambda: None)
    monkeypatch.setattr(run, "forbidden_modules", lambda: ["jax"])
    assert span_report.main(["--workload", "ddpm-salun-rl", "--seed", "1",
                             "--seconds", "1"]) == 3
    out = capsys.readouterr()
    assert out.out == "" and "jax" in out.err
