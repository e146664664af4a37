"""The attention calls' least time over the device time of the flash
attention forward kernel."""

from benchmark_h100.harness.readings import roofline_pct

KERNELS = ("flash_fwd_kernel",)


def read(rec):
    return roofline_pct(rec, "attention", KERNELS)
