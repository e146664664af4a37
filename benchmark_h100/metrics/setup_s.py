"""Set-up: from the start of the driver's set-up (weights, data, the
mask, the warm-up and checked steps) to the first unit of the window,
on the host clock after a synchronize."""


def read(rec):
    return rec.setup_seconds
