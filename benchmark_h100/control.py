"""The control of a cell's check: the plain reference computed in bfloat16
(``torch.autocast``; the configurations state fp32 with TF32, and bfloat16
is the next precision below) put in the system's place, compared with the
fp32 reference by the cell's own numbers and limits. A sound check calls
the control not correct on every seed.

    python3 benchmark_h100/control.py --workload <name> --seeds 1,2,3

prints one JSON line a seed: the numbers compared, each beside its limit,
and whether the control passed. With ``--faults`` (training cells) the
fp32 reference is also run with each fault of ``FAULTS`` planted in its
steps, and compared the same way.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


FAULTS = ("half_batch", "answer_altered")


def control_checks(files: dict, seed: int, device, faults=()):
    """The cell's checks of the bfloat16 reference against the fp32 one;
    with ``faults`` (training cells), also of the fp32 reference with each
    fault planted, as {"control": checks, fault: checks, ...}."""
    import torch

    from benchmark_h100.harness import runner
    from benchmark_h100.reference import ops

    driver = runner.driver_module(files["traffic"]).Driver(
        files["config"], files["traffic"], files["limits"], seed, device)
    out = {}
    with ops.fp32_exact():
        if driver.kind == "sample":
            picks = driver.picks(1)
            truth = driver.reference(picks)
            out["control"] = driver.compare(
                truth, driver.reference(picks, autocast=True))
            return out
        truth = driver.reference()
        for what in ("control",) + tuple(faults):
            if torch.device(device).type == "cuda":
                torch.cuda.empty_cache()
            seen = (driver.reference(autocast=True) if what == "control"
                    else driver.reference(mask=truth["mask"], fault=what))
            out[what] = driver.compare(truth, seen)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--faults", action="store_true",
                   help="also plant each fault in the reference")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from benchmark_h100 import run
    from benchmark_h100.harness import runner

    run.set_environment()
    bench = runner.load_json(ROOT / "BENCHMARK.json")
    files = runner.cell_files(bench, args.workload, ROOT)
    for seed in map(int, args.seeds.split(",")):
        found = control_checks(files, seed, "cuda:0",
                               FAULTS if args.faults else ())
        for what, checks in found.items():
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "planted": what, "correct": checks.correct,
                              "checks": checks.items}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
