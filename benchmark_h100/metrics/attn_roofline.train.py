"""The attention calls' least time over the device time of the flash
attention kernels (forward, and the backward's dq and dk/dv passes)."""

from benchmark_h100.harness.readings import roofline_pct

KERNELS = ("flash_fwd_kernel", "flash_bwd_dq_kernel", "flash_bwd_dkv")


def read(rec):
    return roofline_pct(rec, "attention", KERNELS)
