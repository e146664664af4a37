"""CPU tests of the benchmark harness: it finds every piece by name, counts
work as a hand count and ``torch.utils.flop_counter`` do, loads neither
JAX nor the JAX package, prints the result line the contract asks for,
and its check passes the system at a tiny size and fails each fault and
the bfloat16 control.

    python -m pytest benchmark_h100/tests -q -p no:cacheprovider
"""

from __future__ import annotations

import ast
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import tiny  # noqa: E402

from benchmark_h100 import control, run  # noqa: E402
from benchmark_h100.harness import compare, flops, runner, trace  # noqa: E402
from benchmark_h100.reference import ddpm, sd_v1  # noqa: E402

BENCH = runner.load_json(ROOT / "BENCHMARK.json")
CELLS = [w["name"] for w in BENCH["workloads"]]
SEED = 3_000_000_019  # above 2**31, as the driver's are


@pytest.fixture(autouse=True)
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


# --------------------------------------------------------- found by name


@pytest.mark.parametrize("cell", CELLS)
def test_every_piece_is_found_by_name(cell):
    files = runner.cell_files(BENCH, cell, ROOT)
    drv = runner.driver_module(files["traffic"])
    assert drv.Driver.kind in ("train", "sample")
    assert set(files["limits"]) >= {"image_gap"} or set(files["limits"]) >= {
        "mask_mismatch", "loss_gap", "grad_gap", "change_gap"}
    for traced in (False, True):
        metrics = runner.cell_metrics(BENCH, cell, traced)
        assert metrics
        empty = runner.Record("train", 1.0, 1.0, 0, 0, 0)
        for m in metrics:
            runner.metric_reader(m["name"])(empty)


def test_run_py_names_no_cell_config_or_metric():
    text = (HERE / "run.py").read_text() + (HERE / "harness" /
                                             "runner.py").read_text()
    names = ([c["name"] for c in BENCH["configs"]] + CELLS
             + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
             + [w["traffic"] for w in BENCH["workloads"]])
    assert [n for n in names
            if re.search(rf"(?<![\w.]){re.escape(n)}(?![\w.])", text)] == []


def test_an_added_file_is_picked_up(tmp_path, monkeypatch):
    for sub in ("traffic", "limits", "metrics"):
        (tmp_path / sub).mkdir()
    (tmp_path / "traffic" / "new_mix.json").write_text(json.dumps(
        {"driver": "ddpm_train", "per_class": 1}))
    (tmp_path / "limits" / "new-cell.json").write_text("{}")
    (tmp_path / "metrics" / "new_metric.x.py").write_text(
        "def read(rec):\n    return rec.units + 1\n")
    cfg = tmp_path / "c.json"
    cfg.write_text("{}")
    bench = {"workloads": [{"name": "new-cell", "config": "c",
                            "traffic": "new_mix", "chips": 1}],
             "configs": [{"name": "c", "file": str(cfg)}],
             "end_to_end": [], "per_layer": [{"name": "new_metric.x"}]}
    monkeypatch.setattr(runner, "HERE", tmp_path)
    files = runner.cell_files(bench, "new-cell", tmp_path)
    assert files["traffic"]["per_class"] == 1
    assert runner.driver_module(files["traffic"]).Driver.kind == "train"
    reader = runner.metric_reader("new_metric.x")
    assert reader(runner.Record("train", 0, 1, 41, 0, 0)) == 42
    assert runner.cell_metrics(bench, "new-cell", True) == bench["per_layer"]


# ------------------------------------------------------------- counting


def test_counts_match_hand_counts():
    assert flops.conv2d_flops(2, 4, 8, 5, 5, 3, 3) == 2 * 2 * 8 * 25 * 4 * 9
    assert flops.linear_flops(6, 10, 3) == 360
    assert flops.attention_flops(2, 16, 8, 4) == 4 * 2 * 16 * 8 * 4
    assert flops.attention_flops(2, 16, 8, 4, True) == 8 * 2 * 16 * 8 * 4
    assert flops.attention_bytes(2, 16, 8, 4) == 4 * (2 * 128 + 2 * 64)
    assert flops.attention_bytes(2, 16, 8, 4, True) == 4 * (4 * 128
                                                            + 4 * 64)
    assert flops.gn_silu_bytes(100) == 800
    assert flops.gn_silu_bytes(100, True) == 1200

    conv = torch.nn.Conv2d(4, 8, 3, padding=1, device="meta")
    lin = torch.nn.Linear(8, 3, device="meta")
    w = flops.count(lambda: lin(conv(flops.meta((2, 4, 5, 5))).permute(
        0, 2, 3, 1)), False)
    assert w.flops == 2 * 2 * 8 * 25 * 4 * 9 + 2 * 50 * 8 * 3
    assert flops.count(lambda: conv(flops.meta((2, 4, 5, 5))),
                       True).flops == 3 * 2 * 2 * 8 * 25 * 4 * 9


@pytest.mark.parametrize("model", ["sd_unet", "ddpm_unet"])
def test_counts_match_flop_counter_on_a_tiny_unet(model):
    from torch.utils.flop_counter import FlopCounterMode

    torch.manual_seed(0)
    if model == "sd_unet":
        cfg = tiny.sd_config()
        net = sd_v1.UNet(cfg["unet"])
        args = (torch.randn(2, 4, 8, 8), torch.tensor([3.0, 500.0]),
                torch.randn(2, 77, cfg["unet"]["context_dim"]))
        kwargs = {}
    else:
        d = tiny.ddpm_config()
        ucfg = {"ch": 32, "out_ch": 3, "ch_mult": [1, 2],
                "num_res_blocks": 1, "attn_resolutions": [8],
                "dropout": 0.1, "in_channels": 3, "image_size": 16,
                "n_classes": 10, "cond_drop_prob": 0.1}
        assert d["model"]["ch"] == ucfg["ch"]
        net = ddpm.ConditionalUNet(ucfg)
        args = (torch.randn(2, 3, 16, 16), torch.tensor([3.0, 500.0]),
                torch.tensor([1, 2]))
        kwargs = {"keep": torch.tensor([True, False])}
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        net(*args, **kwargs)
    meta_net = net.to("meta")
    ours = flops.count(lambda: meta_net(
        *[a.to("meta") for a in args],
        **{k: v.to("meta") for k, v in kwargs.items()}), False)
    assert ours.flops == fc.get_total_flops()


# -------------------------------------------------------------- imports


def test_nothing_loads_jax_or_the_jax_package():
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "import torch; torch.set_num_threads(2)\n"
        "import tiny\n"
        "from benchmark_h100 import run, control\n"
        "from benchmark_h100.harness import runner\n"
        "bench = runner.load_json(run.ROOT / 'BENCHMARK.json')\n"
        "for cell in %r:\n"
        "    run.run_cell(bench, tiny.files(cell), cell, 7, 0.1, True, "
        "'cpu')\n"
        "print(run.forbidden_modules())\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] == "
        "'salun_torch')[:1])\n"
    ) % (str(ROOT), str(Path(__file__).resolve().parent), CELLS)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    forbidden, port = out.stdout.strip().splitlines()[-2:]
    assert forbidden == "[]"
    assert port != "[]"  # the port itself is loaded: names compared whole


def test_the_reference_imports_nothing_of_the_program():
    allowed = {"torch", "numpy", "math", "re", "html", "contextlib",
               "__future__"}
    for path in (HERE / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                tops = {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom):
                if node.level:
                    continue
                tops = {node.module.split(".")[0]}
            else:
                continue
            assert tops <= allowed, (path.name, tops)
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import benchmark_h100.reference.sd_v1, "
            "benchmark_h100.reference.ddpm\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'salun_torch', 'salun', 'jax'}))") % str(ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.stdout.strip() == "[]", out.stderr[-2000:]


def test_weights_agree_between_program_and_reference():
    from benchmark_h100.drivers import sd_common

    cfg = tiny.sd_config()
    prog = sd_common.build_program(cfg, "cpu", 5)
    ref = sd_common.build_reference(cfg, "cpu", 5)
    for part in ("unet", "vae", "clip"):
        a = dict(getattr(prog, part).named_parameters())
        b = dict(getattr(ref, part).named_parameters())
        assert list(a) == list(b)
        for n in a:
            assert torch.equal(a[n], b[n]), n
            assert bool(a[n].any()), n


# ---------------------------------------------------------- result line


def test_main_refuses_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    rc = run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1",
                   "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""


def test_main_refuses_in_a_bare_checkout(tmp_path):
    import shutil

    shutil.copytree(HERE, tmp_path / "benchmark_h100",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    out = subprocess.run([sys.executable, "benchmark_h100/run.py",
                          "--workload", CELLS[0], "--seed", "1",
                          "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300,
                         cwd=tmp_path)
    assert out.returncode != 0 and out.stdout == ""


@pytest.mark.parametrize("traced", [False, True])
def test_result_line_has_the_contract_keys(traced):
    res, lines = run.run_cell(BENCH, tiny.files("ddpm-salun-rl"),
                              "ddpm-salun-rl", SEED, 0.2, traced, "cpu")
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(res) == keys + (["breakdown"] if traced else []) + [
        "checks"]
    text = json.dumps(res)
    assert json.loads(text) == res and "\n" not in text
    assert set(res["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    if traced:
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
        assert {"busy_s", "window_s"} <= set(res["device"])
    for name, c in res["checks"].items():
        assert any(line.startswith(f"{name} ") and "limit" in line
                   for line in lines)


# ----------------------------------------------------------- the check


@pytest.mark.parametrize("cell", CELLS)
def test_a_tiny_run_of_each_cell_is_correct(cell):
    res, _ = run.run_cell(BENCH, tiny.files(cell), cell, SEED, 0.2, False,
                          "cpu")
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0


def _fault(monkeypatch, cell, fault):
    """Break the system under test underneath the harness."""
    import salun_torch.diffusion.runner as ddpm_runner
    import salun_torch.diffusion.sampling as sampling
    import salun_torch.sd.ldm as ldm
    import salun_torch.sd.trainers as trainers

    if fault == "state_unchanged" and cell == "sd-ddim-sample":
        # the sampler's step hands its state on unchanged
        def still(eps_fn, x, seq, schedule, **kw):
            return x, x
        monkeypatch.setattr(ldm, "generalized_steps", still)
    elif fault == "state_unchanged":
        monkeypatch.setattr(torch.optim.Adam, "step",
                            lambda self, closure=None: None)
    elif fault == "half_batch" and cell == "sd-salun-rl":
        real = trainers.random_label_loss

        def half(sd, batch, alpha=0.5, *, draws=None, **kw):
            h = len(batch["forget_images"]) // 2
            return real(sd, {k: v[:h] for k, v in batch.items()}, alpha,
                        draws={k: v[:h] for k, v in draws.items()}, **kw)
        monkeypatch.setattr(trainers, "random_label_loss", half)
    elif fault == "half_batch" and cell == "ddpm-salun-rl":
        real = ddpm_runner.DDPMRunner.unlearn_loss

        def half(self, model, remain, forget, *, generator=None,
                 draws=None):
            h = len(remain["label"]) // 2

            def cut(d):
                return {k: v[:h] for k, v in d.items()}
            return real(self, model, cut(remain), cut(forget),
                        generator=generator,
                        draws={k: cut(v) for k, v in draws.items()})
        monkeypatch.setattr(ddpm_runner.DDPMRunner, "unlearn_loss", half)
    elif fault == "half_batch":
        real = ldm.SDModules.sample

        def half(self, prompts, **kw):
            z = kw.pop("initial_latents")
            h = len(prompts) // 2
            out = real(self, prompts[:h], initial_latents=z[:h], **kw)
            return torch.cat([out, out])
        monkeypatch.setattr(ldm.SDModules, "sample", half)
    elif fault == "answer_altered" and cell == "sd-ddim-sample":
        real = ldm.SDModules.sample

        def altered(self, *a, **kw):
            out = real(self, *a, **kw)
            out[:, :, :4] = 1.0 - out[:, :, :4]
            return out
        monkeypatch.setattr(ldm.SDModules, "sample", altered)
    elif fault == "answer_altered":
        from salun_torch.diffusion.unet import ConditionalUNet
        from salun_torch.sd.unet import SDUNet

        from benchmark_h100.harness.compare import alter_first_row

        for cls in (SDUNet, ConditionalUNet):
            real_fwd = cls.forward

            def altered(self, *a, _real=real_fwd, **kw):
                return alter_first_row(self, a, _real(self, *a, **kw))
            monkeypatch.setattr(cls, "forward", altered)
    del sampling


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "answer_altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_each_fault_comes_out_not_correct(cell, fault, monkeypatch):
    _fault(monkeypatch, cell, fault)
    res, lines = run.run_cell(BENCH, tiny.files(cell), cell, SEED, 0.1,
                              False, "cpu")
    assert not res["correct"], lines


@pytest.mark.parametrize("cell", CELLS)
def test_the_bfloat16_control_comes_out_not_correct(cell):
    checks = control.control_checks(tiny.files(cell), SEED, "cpu")
    assert not checks["control"].correct, checks["control"].lines()


def test_every_check_of_a_request_covers_both_halves_of_it():
    from benchmark_h100.drivers import sd_sample

    files = runner.cell_files(BENCH, "sd-ddim-sample", ROOT)
    n = files["traffic"]["images"]
    for seed in range(SEED, SEED + 200):
        d = sd_sample.Driver(files["config"], files["traffic"],
                             files["limits"], seed, "cpu")
        rows = [row for _, row in d.picks(3)]
        assert min(rows) < n // 2 <= max(rows), rows


def test_the_gradient_gap_is_taken_as_a_vector():
    gen = torch.Generator().manual_seed(0)
    ref = {"a": torch.randn(64, generator=gen),
           "b": torch.randn(8, generator=gen)}
    mask = {n: torch.ones_like(v, dtype=torch.bool) for n, v in ref.items()}
    same, _ = compare.grad_gaps(ref, ref, mask, mask, list(ref))
    assert same == 0.0
    # the same norms, another direction: leaf norms alone would not see it
    turned = {n: v.flip(0) for n, v in ref.items()}
    whole, leaves = compare.grad_gaps(turned, ref, mask, mask, list(ref))
    assert whole > 0.5 and max(leaves.values()) > 0.5
    # a weight whose mask bits differ is mask_mismatch's to count
    other = {n: m.clone() for n, m in mask.items()}
    other["a"][0] = False
    moved = {n: v.clone() for n, v in ref.items()}
    moved["a"][0] += 100.0
    assert compare.grad_gaps(moved, ref, other, mask, list(ref))[0] == 0.0
    # a leaf the optimizer holds no state for reads as a zero gradient
    missing, _ = compare.grad_gaps({"b": ref["b"]}, ref, mask, mask,
                                   list(ref))
    assert missing == pytest.approx(
        float(ref["a"].norm()) / float(torch.cat(list(ref.values())).norm()))


# ----------------------------------------------------------------- trace


class _Event:
    def __init__(self, kind, start, dur, name):
        self._k, self._s, self._d, self._n = kind, start, dur, name

    def device_type(self):
        return self._k

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def name(self):
        return self._n

    def is_user_annotation(self):
        return self._n.startswith("span")


def test_trace_reading_by_hand():
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    events = [_Event(cuda, 0, 100, "flash_fwd_kernel<40>"),
              _Event(cuda, 50, 100, "gn_fwd"),
              _Event(cuda, 400, 100, "flash_bwd_dq_kernel"),
              _Event(cpu, 140, 300, "aten::copy_"),
              _Event(cpu, 0, 1000, "step"),
              _Event(cuda, 0, 2000, "span: a range of the program's"),
              _Event(cpu, 0, 3000, "ProfilerStep#1")]

    class Prof:
        class profiler:
            class kineto_results:
                @staticmethod
                def events():
                    return events

    tr = trace.Trace(Prof, 1e-6)
    assert tr.busy_s == pytest.approx(250e-9)
    assert tr.kernel_seconds(("flash_",)) == pytest.approx(200e-9)
    bd = tr.breakdown()
    assert bd["idle_gaps"] == [["aten::copy_", pytest.approx(250e-9)]]
    assert [n for n, _ in bd["device_ops"]][0] == "flash_fwd_kernel<40>"
    # a window traced on the device alone takes its gaps' names from a
    # unit traced with the host

    def traced(evs):
        class P:
            class profiler:
                class kineto_results:
                    @staticmethod
                    def events():
                        return evs
        return P

    device_only = traced([e for e in events if e.device_type() == cuda])
    alone = trace.Trace(device_only, 1e-6)
    assert alone.breakdown()["idle_gaps"] == [
        ["no host operation", pytest.approx(250e-9)]]
    named = trace.Trace(device_only, 1e-6, trace.Trace(Prof, None))
    assert named.breakdown()["idle_gaps"] == bd["idle_gaps"]


@pytest.mark.cuda
def test_a_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run([sys.executable, "benchmark_h100/run.py",
                          "--workload", "ddpm-salun-rl", "--seed", str(SEED),
                          "--seconds", "2", "--trace", "0"],
                         capture_output=True, text=True, timeout=600,
                         cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.splitlines()[-1])["correct"]
