"""``torch.cuda.max_memory_allocated()`` as read at the exit of the last
``mask.threshold`` span, GiB: the peak up to the end of mask generation
(the gradient pass and the sort)."""

from benchmark_h100.harness.spans import spans_named


def read(rec):
    last = spans_named(rec, "mask.threshold")[-1:]
    if not last or last[0]["peak_bytes"] is None:
        return None
    return last[0]["peak_bytes"] / 2 ** 30
