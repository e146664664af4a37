"""Device time of the operations launched inside the masked optimizer's
spans (``step.optimizer``, ``step.zero_grad``) of the traced window, per
``step`` span, in ms (``harness/spans.py``)."""

from benchmark_h100.harness.spans import OPTIMIZER


def read(rec):
    att = getattr(rec, "attribution", None)
    if att is None or not att.count("step") or not att.within(
            OPTIMIZER).launches:
        return None
    return 1e3 * att.within(OPTIMIZER).device_s / att.count("step")
