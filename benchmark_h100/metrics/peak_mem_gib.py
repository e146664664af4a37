"""``torch.cuda.max_memory_allocated()`` over set-up and window, GiB."""


def read(rec):
    return rec.peak_bytes / 2 ** 30 if rec.peak_bytes else None
