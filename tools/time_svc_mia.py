#!/usr/bin/env python3
"""Time the port's SVC-MIA solver against scikit-learn's on the same inputs.

The JAX package fits ``sklearn.svm.SVC(C=3, gamma='auto')`` (libsvm, in C,
with shrinking and a kernel cache); the port fits its own NumPy SMO,
``salun_torch.evalx.svc_mia.RBFSVC``, because scikit-learn is not installed
where the port runs. Both run on the host CPU. This script makes softmax
outputs of a 10-class model from a seed (members more confident than
non-members, as after training; equal margins give the indistinguishable
outputs of an untrained model, and a small logit scale its near-uniform
ones, the solver's hardest case), builds the five attack features of
SVC-MIA, and for each shadow size fits both solvers on every feature,
timing each fit and prediction and counting the target predictions on which
they disagree. Where scikit-learn is not installed it times the port's
solver alone, which compares hosts::

    python3 tools/time_svc_mia.py --shadow 4000 20000 --targets 4500
    python3 tools/time_svc_mia.py --margins 0 0 --scale 0.02
"""

from __future__ import annotations

import argparse
import json
import platform
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from salun_torch.evalx.svc_mia import RBFSVC, features  # noqa: E402

FEATURES = ("correctness", "confidence", "entropy", "m_entropy", "prob")


def softmax_outputs(rng, n: int, margin: float, scale: float,
                    n_classes: int = 10):
    """Softmax of ``scale`` × logits whose labelled class is ahead by
    ~``margin``."""
    labels = rng.integers(0, n_classes, n)
    logits = rng.standard_normal((n, n_classes))
    logits[np.arange(n), labels] += rng.normal(margin, 2.0, n)
    logits *= scale
    z = np.exp(logits - logits.max(1, keepdims=True))
    return (z / z.sum(1, keepdims=True)).astype(np.float32), labels


def cpu_name() -> str:
    try:
        for line in open("/proc/cpuinfo"):
            if line.startswith("model name"):
                return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.processor() or "unknown"


def time_fit(make, X, Y, targets):
    t0 = time.perf_counter()
    clf = make().fit(X, Y)
    fit_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pred = clf.predict(targets)
    return fit_s, time.perf_counter() - t0, pred


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shadow", type=int, nargs="+", default=[4000, 20000],
                    help="shadow samples per fit (half members, half not)")
    ap.add_argument("--targets", type=int, default=4500,
                    help="target samples scored by each fit")
    ap.add_argument("--margins", type=float, nargs=2, default=[6.0, 4.0],
                    metavar=("MEMBER", "NONMEMBER"),
                    help="mean lead of the labelled class's logit")
    ap.add_argument("--scale", type=float, default=1.0,
                    help="factor on every logit (small: near-uniform outputs)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    try:
        import sklearn
        from sklearn.svm import SVC
        have = f"scikit-learn {sklearn.__version__}"
    except ImportError:
        SVC, have = None, "no scikit-learn"

    print(f"host CPU: {cpu_name()}, numpy {np.__version__}, "
          f"{have}, margins {args.margins}, "
          f"logit scale {args.scale}",
          flush=True)
    rows = []
    for n in args.shadow:
        rng = np.random.default_rng(args.seed)
        m_in, m_out = args.margins
        member = features(*softmax_outputs(rng, n // 2, m_in, args.scale))
        nonmember = features(*softmax_outputs(rng, n - n // 2, m_out,
                                              args.scale))
        target = features(*softmax_outputs(rng, args.targets,
                                           (m_in + m_out) / 2, args.scale))
        for name in FEATURES:
            X = np.concatenate([member[name], nonmember[name]]).reshape(n, -1)
            Y = np.concatenate([np.ones(n // 2), np.zeros(n - n // 2)])
            T = target[name].reshape(args.targets, -1)
            port = time_fit(lambda: RBFSVC(C=3), X, Y, T)
            row = {"shadow": n, "feature": name,
                   "port_fit_s": port[0], "port_predict_s": port[1]}
            if SVC is not None:
                ref = time_fit(lambda: SVC(C=3, gamma="auto"), X, Y, T)
                row.update(sklearn_fit_s=ref[0], sklearn_predict_s=ref[1],
                           disagree=int((port[2] != ref[2]).sum()))
            rows.append(row)
            print(json.dumps(row), flush=True)
        here = [r for r in rows if r["shadow"] == n]
        port_s = sum(r["port_fit_s"] + r["port_predict_s"] for r in here)
        line = f"shadow {n}: five attacks take {port_s:.3f} s (port)"
        if SVC is not None:
            ref_s = sum(r["sklearn_fit_s"] + r["sklearn_predict_s"]
                        for r in here)
            line += (f" vs {ref_s:.3f} s (scikit-learn), "
                     f"{port_s / ref_s:.2f}x")
        print(line, flush=True)


if __name__ == "__main__":
    main()
