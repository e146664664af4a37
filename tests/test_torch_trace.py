"""The port's spans (``salun_torch.utils.metrics``: ``span``,
``start_tracing``, ``stop_tracing``, and ``maybe_profile``, which merges
them into its Chrome trace) on the CPU:

- off, ``span`` hands back one shared context and records nothing;
- on, each span keeps its name, parent, unit and attrs, and its host
  interval is on the clock ``torch.profiler`` stamps its events with;
- the program opens the spans its readers expect: a DDPM saliency step,
  a DDIM chain and a mask's sort.
"""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from _torch_port import one_torch_thread  # noqa: F401
from salun_torch.core.mask import generate_masks
from salun_torch.diffusion import DiffusionSchedule
from salun_torch.diffusion.runner import (DDPMRunner, DDPMTrainConfig,
                                          make_optimizer)
from salun_torch.diffusion.sampling import generalized_steps
from salun_torch.diffusion.unet import UNetConfig
from salun_torch.utils import (maybe_profile, metrics, span, start_tracing,
                               stop_tracing)


@pytest.fixture
def tracing():
    """Tracing on for the test, off after it."""
    start_tracing()
    yield
    stop_tracing()


def _tree(spans):
    by_id = {s["id"]: s for s in spans}
    return [(s["name"], by_id[s["parent"]]["name"] if s["parent"] is not None
             else None) for s in spans]


def test_off_span_records_nothing_and_is_shared():
    assert metrics._tracer is None
    a, b = span("step", rows=3), span("mask.sort")
    assert a is b is metrics.NO_SPAN
    with a as rec:
        assert rec is None
    assert stop_tracing() == []


def test_spans_nest_with_parents_and_units(tracing):
    with span("mask.grad"):
        pass
    for _ in range(2):
        with span("step", rows=4):
            with span("step.forward"):
                with span("vae.encode"):
                    pass
            with span("step.optimizer"):
                pass
    with span("sample", rows=2):
        with span("sample.transition"):
            pass
    spans = stop_tracing()
    assert _tree(spans) == [
        ("mask.grad", None),
        ("step", None), ("step.forward", "step"), ("vae.encode",
                                                   "step.forward"),
        ("step.optimizer", "step"),
        ("step", None), ("step.forward", "step"), ("vae.encode",
                                                   "step.forward"),
        ("step.optimizer", "step"),
        ("sample", None), ("sample.transition", "sample")]
    assert [s["unit"] for s in spans] == [0, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3]
    for s in spans:
        assert s["start_ns"] <= s["end_ns"]
    assert metrics._tracer is None  # stopped: spans are no-ops again
    assert span("step") is metrics.NO_SPAN


def test_attrs_are_kept(tracing):
    with span("step", rows=8):
        with span("mask.sort", elements=1234):
            pass
    with pytest.raises(RuntimeError):  # one tracer at a time
        start_tracing()
    spans = stop_tracing()
    assert [s["attrs"] for s in spans] == [{"rows": 8}, {"elements": 1234}]


def test_a_span_shares_the_profilers_clock(tracing):
    a = torch.randn(64, 64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("step.forward"):
            torch.mm(a, a)
    (rec,) = stop_tracing()
    (mm,) = [e for e in prof.profiler.kineto_results.events()
             if e.name() == "aten::mm"]
    assert rec["start_ns"] <= mm.start_ns()
    assert mm.start_ns() + mm.duration_ns() <= rec["end_ns"]


def test_maybe_profile_merges_the_spans_into_its_trace(tmp_path):
    a = torch.randn(64, 64)
    with maybe_profile(str(tmp_path)) as path:
        with span("step", rows=64):
            torch.mm(a, a)
    assert metrics._tracer is None
    events = json.load(open(path))["traceEvents"]
    (mm,) = [e for e in events if e.get("name") == "aten::mm"]
    (rec,) = [e for e in events if e.get("cat") == "span"]
    assert rec["ph"] == "X" and rec["name"] == "step"
    assert rec["pid"] == metrics.SPAN_PROCESS
    assert rec["args"]["rows"] == 64
    assert rec["ts"] <= mm["ts"]
    assert mm["ts"] + mm["dur"] <= rec["ts"] + rec["dur"] + 1e-3
    assert any(e.get("name") == "process_name" and e.get("pid")
               == metrics.SPAN_PROCESS for e in events)


def test_maybe_profile_leaves_a_callers_tracing_on(tmp_path):
    start_tracing()
    try:
        with span("sample"):
            pass
        with maybe_profile(str(tmp_path)) as path:
            with span("step"):
                torch.mm(torch.ones(8, 8), torch.ones(8, 8))
        assert metrics._tracer is not None
        names = [e["name"] for e in json.load(open(path))["traceEvents"]
                 if e.get("cat") == "span"]
        assert names == ["step"]
    finally:
        spans = stop_tracing()
    assert [s["name"] for s in spans] == ["sample", "step"]


def test_maybe_profile_stops_its_tracing_when_the_profiler_fails(
        tmp_path, monkeypatch):
    def fail(self):
        raise RuntimeError("profiler refused")

    monkeypatch.setattr(torch.profiler.profile, "start", fail)
    with pytest.raises(RuntimeError, match="profiler refused"):
        with maybe_profile(str(tmp_path)):
            pass
    assert metrics._tracer is None


def _ddpm_batch(rng, n=4, label=None):
    img = rng.integers(0, 256, (n, 16, 16, 3)).astype(np.uint8)
    lab = (np.full(n, label) if label is not None
           else rng.integers(0, 4, n)).astype(np.int32)
    return {"image": img, "label": lab}


def test_a_ddpm_saliency_step_opens_the_step_spans(tracing):
    cfg = UNetConfig(ch=32, ch_mult=(1, 2), num_res_blocks=1,
                     attn_resolutions=(8,), dropout=0.0, image_size=16,
                     n_classes=4, cond_drop_prob=0.0)
    runner = DDPMRunner(cfg, DiffusionSchedule.create(
        num_diffusion_timesteps=50), DDPMTrainConfig(
            batch_size=4, lr=1e-3, method="rl", label_to_forget=1,
            alpha=0.5, cond_drop_prob=0.0))
    model = runner.init(0)
    step = runner.make_saliency_unlearn_step(
        model, make_optimizer(model, runner.cfg))
    rng = np.random.default_rng(0)
    for _ in range(2):
        step(_ddpm_batch(rng), _ddpm_batch(rng, label=1),
             torch.Generator().manual_seed(0))
    spans = stop_tracing()
    by_id = {s["id"]: s for s in spans}
    for unit in (1, 2):
        mine = [s for s in spans if s["unit"] == unit]
        names = [s["name"] for s in mine]
        (top,) = [s for s in mine if s["name"] == "step"]
        assert top["parent"] is None and top["attrs"] == {"rows": 8}
        for name in ("step.zero_grad", "step.forward", "step.backward",
                     "step.optimizer"):
            assert names.count(name) == 1
            (s,) = [s for s in mine if s["name"] == name]
            assert s["parent"] == top["id"]
        # one upload a batch (remain, then forget), inside the forward
        inputs = [s for s in mine if s["name"] == "step.inputs"]
        assert len(inputs) == 2
        for s in inputs:
            assert by_id[s["parent"]]["name"] == "step.forward"
        assert set(names) == {"step", "step.zero_grad", "step.forward",
                              "step.inputs", "step.backward",
                              "step.optimizer"}


def test_a_ddim_chain_opens_one_span_a_transition(tracing):
    sched = DiffusionSchedule.create(num_diffusion_timesteps=20)
    seq = [0, 5, 10, 15]
    generalized_steps(lambda x, t: 0.1 * x, torch.randn(2, 3, 4, 4), seq,
                      sched)
    spans = stop_tracing()
    assert [s["name"] for s in spans] == ["sample.transition"] * len(seq)


def test_generate_masks_opens_one_sort_over_every_element(tracing):
    sal = [torch.rand(3, 4), torch.rand(7), torch.rand(2, 2, 2)]
    generate_masks(sal, (0.3, 0.5))
    spans = stop_tracing()
    assert [s["name"] for s in spans] == ["mask.sort", "mask.threshold"]
    assert spans[0]["attrs"] == {"elements": 12 + 7 + 8}
