"""The model FLOPs of the traced units (counted from the configuration's
shapes; no-grad forwards once, recomputation not counted) over the traced
window, as a share of 495 TFLOP/s, the H100's dense TF32 peak."""

from benchmark_h100.harness.readings import mfu_pct


def read(rec):
    return mfu_pct(rec)
