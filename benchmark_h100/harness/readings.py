"""Arithmetic shared by the metric readers in ``benchmark_h100/metrics``.

Each returns None where the run has nothing to read."""

from __future__ import annotations

from . import flops


def idle_pct(rec):
    """The share of the traced window in which no device operation ran."""
    if rec.trace is None or rec.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - rec.trace.busy_s / rec.trace.window_s)


def mfu_pct(rec):
    """The model FLOPs of the traced units over the traced window, as a
    share of the card's dense TF32 peak."""
    if (rec.trace is None or rec.trace.busy_s <= 0 or rec.work is None
            or rec.units == 0):
        return None
    return (100.0 * rec.work.flops * rec.units / rec.trace.window_s
            / flops.PEAK_TF32_FLOPS)


def roofline_pct(rec, which: str, patterns):
    """The least time the traced units' ``which`` calls need (each the
    larger of FLOPs / peak and bytes / bandwidth) over the device time of
    the kernels whose names hold one of ``patterns``."""
    if rec.trace is None or rec.work is None or rec.units == 0:
        return None
    spent = rec.trace.kernel_seconds(patterns)
    least = rec.work.least_seconds(which) * rec.units
    if spent <= 0 or least <= 0:
        return None
    return 100.0 * least / spent
