"""The port's logging, trace and fan-out utilities
(``salun_torch.utils.{meters,metrics,fanout}``) on the CPU, against
``salun.utils``' (``tests/test_aux.py:12,27,169``):

- ``AverageMeter``: the same val, avg, sum, count and text after the
  same updates;
- ``MetricsWriter``: for the same logs, the JSONL stream equal to
  ``salun``'s record for record apart from the ``time`` field, and the
  curve JSON file equal byte for byte;
- ``run_commands``: the same scripts as ``salun``'s with ``env_var``
  passed on both sides; with ``call=True`` two workers each run their
  jobs under their own ``CUDA_VISIBLE_DEVICES`` (the port's default; the
  JAX package's is ``TPU_VISIBLE_DEVICES``);
- ``maybe_profile``: with ``SALUN_TRACE_DIR`` set, one Chrome trace file
  in the directory holding the profiled ops; unset, nothing written;
- ``step_timer``: one non-negative duration a step.
"""

import json
import os
import sys

import torch

from _torch_port import one_torch_thread  # noqa: F401
from salun.utils.fanout import run_commands as jax_run_commands
from salun.utils.meters import AverageMeter as JaxAverageMeter
from salun.utils.metrics import MetricsWriter as JaxMetricsWriter
from salun_torch.utils import (AverageMeter, MetricsWriter, maybe_profile,
                               run_commands, step_timer)

LOGS = [(0, {"loss": 1.5, "acc": 10.0}), (1, {"loss": 1.0, "acc": 20.0}),
        (7, {"loss": torch.tensor(0.25), "acc": 33.5, "lr": 0.013})]


def test_average_meter_matches_salun():
    a, b = AverageMeter("loss", ":.3f"), JaxAverageMeter("loss", ":.3f")
    for val, n in ((1.5, 4), (0.25, 2), (3, 1)):
        a.update(val, n)
        b.update(val, n)
        assert (a.val, a.avg, a.sum, a.count, str(a)) == (
            b.val, b.avg, b.sum, b.count, str(b))
    a.reset()
    assert (a.val, a.avg, a.sum, a.count) == (0.0, 0.0, 0.0, 0)


def test_metrics_writer_matches_salun(tmp_path):
    files = {}
    for name, cls in (("port", MetricsWriter), ("jax", JaxMetricsWriter)):
        w = cls(str(tmp_path / name))
        for step, values in LOGS:
            w.log(step, **{k: (float(v) if name == "jax" else v)
                           for k, v in values.items()})
        w.dump_curves()
        w.close()
        recs = [json.loads(line) for line in open(w.path)]
        assert all(r.pop("time") >= 0 for r in recs)
        base = os.path.splitext(w.path)[0]
        files[name] = (recs, open(f"{base}_train_curves.json").read())
    assert files["port"] == files["jax"]
    assert files["port"][0][2] == {"step": 7, "loss": 0.25, "acc": 33.5,
                                   "lr": 0.013}


def test_run_commands_writes_salun_scripts(tmp_path):
    cmds = [f"echo {i}" for i in range(5)]
    got = run_commands(["0", "1"], cmds, dir=str(tmp_path / "port"),
                       shuffle=False, env_var="CUDA_VISIBLE_DEVICES")
    want = jax_run_commands(["0", "1"], cmds, dir=str(tmp_path / "jax"),
                            shuffle=False, env_var="CUDA_VISIBLE_DEVICES")
    assert [os.path.basename(p) for p in got] == [
        os.path.basename(p) for p in want] == ["run_0.sh", "run_1.sh"]
    for g, w in zip(got, want):
        assert open(g).read() == open(w).read()
        assert os.access(g, os.X_OK)
    assert "CUDA_VISIBLE_DEVICES=0 echo 0\nsleep 0.5\n" in open(got[0]).read()


def test_run_commands_executes_two_workers(tmp_path):
    out = tmp_path / "out"
    out.mkdir()
    # each job records the device its own process sees (read inside the
    # child: a $VAR on the command line expands before the assignment)
    py = (f"{sys.executable} -c \"import os; open('{out}/job_%d.txt','w')"
          f".write(os.environ['CUDA_VISIBLE_DEVICES'])\"")
    run_commands(["0", "1"], [py % i for i in range(4)], call=True,
                 dir=str(tmp_path / "scripts"), shuffle=False, delay=0)
    got = {i: open(out / f"job_{i}.txt").read() for i in range(4)}
    assert got == {0: "0", 1: "1", 2: "0", 3: "1"}  # round robin


def test_maybe_profile_writes_a_trace_when_asked(tmp_path, monkeypatch):
    trace_dir = tmp_path / "trace"
    monkeypatch.setenv("SALUN_TRACE_DIR", str(trace_dir))
    with maybe_profile() as path:
        torch.mm(torch.ones(8, 8), torch.ones(8, 8)).sum()
    assert os.listdir(trace_dir) == [os.path.basename(path)]
    events = json.load(open(path))["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)


def test_maybe_profile_does_nothing_unasked(tmp_path, monkeypatch):
    monkeypatch.delenv("SALUN_TRACE_DIR", raising=False)
    monkeypatch.chdir(tmp_path)
    with maybe_profile() as path:
        torch.ones(2).sum()
    assert path is None and os.listdir(tmp_path) == []


def test_step_timer_appends_one_duration_a_step():
    times = []
    for _ in range(3):
        with step_timer(times):
            torch.ones(4).sum()
    assert len(times) == 3 and all(t >= 0 for t in times)
