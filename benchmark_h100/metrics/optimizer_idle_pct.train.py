"""The idle gaps between device operations put down to the masked
optimizer's spans (``step.optimizer``, ``step.zero_grad``, and the spans
inside them), as a share of the traced window (the window of
``idle_pct.train``; ``harness/spans.py``)."""

from benchmark_h100.harness.spans import OPTIMIZER


def read(rec):
    att = getattr(rec, "attribution", None)
    if att is None or rec.trace is None or not att.count("step.optimizer"):
        return None
    return 100.0 * att.within(OPTIMIZER).idle_s / rec.trace.window_s
