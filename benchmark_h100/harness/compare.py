"""The comparisons that decide ``correct``.

Each number compared is a gap between what the system under test produced
and what the plain reference works out from the same inputs; lower is
better, and a number passes when it is at or below its limit. The limits
of a cell live in ``benchmark_h100/limits/<cell>.json``.
"""

from __future__ import annotations

import math
import statistics

import torch

# a leaf whose reference gradient norm is below this share of the median
# leaf's is rounding noise (a key's bias under softmax), left out of the
# leaf-norm comparisons: Adam moves it by its sign alone
NOISE_LEAF = 1e-3
NOT_FINITE = 1e30


def relative_gap(a: float, b: float) -> float:
    """|a − b| / |b|."""
    return abs(a - b) / abs(b) if b else abs(a - b)


def leaves_kept(ref_grad_norms: dict) -> list:
    """The leaves compared: those whose reference gradient norm is at least
    ``NOISE_LEAF`` times the median leaf's."""
    median = statistics.median(ref_grad_norms.values())
    return [n for n, v in ref_grad_norms.items() if v >= NOISE_LEAF * median]


def leaf_gaps(prog: dict, ref: dict, keep) -> dict:
    """{leaf: |‖prog‖ − ‖ref‖| / max(‖ref‖, median ‖ref‖)} over ``keep``.
    A leaf missing on the program's side, or not finite, reads 1."""
    median = statistics.median(ref[n] for n in keep)
    out = {}
    for n in keep:
        p = prog.get(n, math.nan)
        gap = (abs(p - ref[n]) / max(ref[n], median)
               if math.isfinite(p) else 1.0)
        out[n] = gap if math.isfinite(gap) else 1.0
    return out


def alter_first_row(module, args, out):
    """A forward hook that plants a wrong answer in a forward the step
    learns from (one with a gradient): the first row of the output
    negated."""
    if not torch.is_grad_enabled():
        return out
    sign = torch.ones_like(out)
    sign[0] = -1.0
    return out * sign


class Checks:
    """Numbers compared, each beside its limit."""

    def __init__(self, limits: dict):
        self.limits = limits
        self.items = {}

    def add(self, name: str, value: float, note: str = "") -> None:
        if not math.isfinite(value):  # JSON has no inf or nan
            value, note = NOT_FINITE, (note + " not finite").strip()
        self.items[name] = {"value": float(value),
                            "limit": self.limits[name]}
        if note:
            self.items[name]["at"] = note

    @property
    def correct(self) -> bool:
        return bool(self.items) and all(
            c["value"] <= c["limit"] for c in self.items.values())

    def lines(self) -> list:
        return [f"{n} {c['value']!r} limit {c['limit']!r}"
                + (f" ({c['at']})" if "at" in c else "")
                for n, c in self.items.items()]


def grad_gaps(prog: dict, ref: dict, prog_mask: dict, ref_mask: dict,
              keep) -> tuple:
    """The first gradient compared as a vector: over the leaves ``keep``
    and the weights whose mask bit the two sides agree on, ‖g − g_ref‖ /
    ‖g_ref‖ over all of them together, and {leaf: that gap over max(the
    leaf's ‖g_ref‖, the median leaf's)}. A leaf the program's optimizer
    holds no state for is taken as a zero gradient."""
    norms = {n: float(ref[n].norm()) for n in keep}
    median = statistics.median(norms.values())
    diff2 = ref2 = 0.0
    leaves = {}
    for n in keep:
        r = ref[n]
        agree = prog_mask[n].to(r.device) == ref_mask[n].to(r.device)
        p = (prog[n].to(r.device) if n in prog
             else torch.zeros_like(r))
        d = float(((p - r) * agree).norm())
        diff2 += d * d
        ref2 += float((r * agree).norm()) ** 2
        leaves[n] = d / max(norms[n], median)
    total = math.sqrt(diff2 / ref2) if ref2 > 0 else math.sqrt(diff2)
    return total, leaves


def training_checks(limits: dict, ref: dict, prog: dict) -> Checks:
    """A training cell's numbers from the program's and the reference's
    readings (``mask``: {leaf: bool tensor}, ``losses``, ``grad``: {leaf:
    the first step's masked gradient}, ``change_norms``: {leaf: norm}):

    - ``mask_mismatch``: the share of weights whose mask bit differs;
    - ``loss_gap``: the relative gap of the first step's loss (the later
      steps' gaps, given beside it, carry Adam's sign-like first updates of
      coordinates whose gradient is rounding noise, and swing from seed to
      seed);
    - ``grad_gap``: the relative gap of the first gradient as a vector
      (:func:`grad_gaps`; the worst leaf's is given beside it);
    - ``change_gap``: the worst leaf's gap of the change's norm
      (:func:`leaf_gaps`);
    both over the leaves :func:`leaves_kept` keeps."""
    checks = Checks(limits)
    differ = total = 0
    for n, m in ref["mask"].items():
        differ += int((prog["mask"][n].to(m.device) != m).sum())
        total += m.numel()
    checks.add("mask_mismatch", differ / total)
    gaps = [relative_gap(a, b) for a, b in zip(prog["losses"],
                                               ref["losses"])]
    checks.add("loss_gap", gaps[0], "later steps " + ", ".join(
        f"{g:.3g}" for g in gaps[1:]))
    keep = leaves_kept({n: float(g.norm()) for n, g in ref["grad"].items()})
    whole, grad = grad_gaps(prog["grad"], ref["grad"], prog["mask"],
                            ref["mask"], keep)
    worst = max(grad, key=grad.get)
    checks.add("grad_gap", whole, f"worst leaf {grad[worst]:.3g} at {worst}")
    change = leaf_gaps(prog["change_norms"], ref["change_norms"], keep)
    worst = max(change, key=change.get)
    checks.add("change_gap", change[worst], worst)
    return checks
