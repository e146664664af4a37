"""The benchmark of the PyTorch/CUDA port ``salun_torch`` on NVIDIA GPUs.

    python3 benchmark_h100/run.py --workload <name> --seed <n> \
        --seconds <s> --trace <0|1>

Runs one cell of ``BENCHMARK.json`` on the cards of this machine: the
cell's configuration (``configs``), traffic (``benchmark_h100/traffic/
<traffic>.json``, whose ``driver`` names the code in ``drivers/`` that
drives it) and limits (``benchmark_h100/limits/<cell>.json``) are found by
name. Set-up, then ``--seconds`` of work (``--trace 0``, the end-to-end
metrics) or the traffic's ``trace_units`` under ``torch.profiler``
(``--trace 1``, the per-layer metrics and a breakdown), then the
comparison with the plain reference that decides ``correct``. The last
line of standard output is one JSON object; the numbers compared, each
beside its limit, are the last lines of standard error and the last key
of that object.

Exits non-zero, with no result, without enough CUDA devices, or if JAX or
the JAX package ``salun`` was loaded.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BUILD = ROOT / "build" / "benchmark_h100"
FORBIDDEN = {"jax", "jaxlib", "flax", "salun"}


def set_environment() -> None:
    """Every build and kernel cache at a fixed path inside the checkout;
    libraries kept from loading JAX."""
    os.environ["SALUN_TORCH_BUILD_DIR"] = str(ROOT / "build" /
                                              "salun_torch_kernels")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(BUILD / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(BUILD / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(BUILD / "cuda_cache")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (``salun_torch`` is not ``salun``)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & FORBIDDEN)


def power_limit_w():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=30, check=True).stdout.split()
        return float(out[0])
    except (OSError, subprocess.SubprocessError, IndexError, ValueError):
        return None


def run_cell(bench: dict, files: dict, workload: str, seed: int,
             seconds: float, traced: bool, device) -> tuple:
    """One run of a cell on ``device``: (result object, lines for standard
    error)."""
    import torch

    from benchmark_h100.harness import runner

    traffic = files["traffic"]
    driver = runner.driver_module(traffic).Driver(
        files["config"], traffic, files["limits"], seed, device)
    record, checks, attempted, failed = runner.execute(
        driver, seconds, traced, traffic["trace_units"])
    metrics = {}
    for m in runner.cell_metrics(bench, workload, traced):
        value = runner.metric_reader(m["name"])(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    info = {"platform": "gpu" if cuda else "cpu",
            "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
            "count": files["cell"]["chips"],
            "memory_peak_bytes": record.peak_bytes}
    if cuda:
        info["power_limit_w"] = power_limit_w()
    result = {"correct": checks.correct and failed == 0,
              "attempted": attempted, "failed": failed, "metrics": metrics,
              "device": info}
    if traced:
        info["busy_s"] = record.trace.busy_s
        info["window_s"] = record.trace.window_s
        result["breakdown"] = record.trace.breakdown()
    result["checks"] = checks.items
    lines = [f"set-up {record.setup_seconds!r} s, window "
             f"{record.window_s!r} s, {attempted} units, check "
             f"{record.timings['check_s']!r} s",
             f"failed units {failed} of {attempted} limit 0"] + checks.lines()
    return result, lines


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    set_environment()
    sys.path.insert(0, str(ROOT))
    from benchmark_h100.harness import runner

    bench = runner.load_json(ROOT / "BENCHMARK.json")
    files = runner.cell_files(bench, args.workload, ROOT)
    import torch

    chips = files["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result, lines = run_cell(bench, files, args.workload, args.seed,
                             args.seconds, bool(args.trace), "cuda:0")
    found = forbidden_modules()
    if found:
        print(f"loaded in this process: {', '.join(found)} (JAX or the JAX "
              f"package); no result", file=sys.stderr)
        return 3
    sys.stderr.flush()
    print("\n".join(lines), file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
