"""The GroupNorm → SiLU calls' least time (their bytes over the HBM
bandwidth) over the device time of the fused kernels, forward and
backward."""

from benchmark_h100.harness.readings import roofline_pct

KERNELS = ("gn_fwd", "gn_bwd")


def read(rec):
    return roofline_pct(rec, "gn_silu", KERNELS)
