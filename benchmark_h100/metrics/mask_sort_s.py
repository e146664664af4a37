"""The ``mask.sort`` spans' device time, between the CUDA events recorded
at their ends, summed over the set-up's mask generation (the exact top-k's
one sort of every |saliency| value)."""

from benchmark_h100.harness.spans import spans_named


def read(rec):
    times = [s["device_s"] for s in spans_named(rec, "mask.sort")]
    if not times or None in times:
        return None
    return sum(times)
