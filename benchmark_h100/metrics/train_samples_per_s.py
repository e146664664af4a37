"""Rows through a U-Net forward and backward (forget + remain) of every
optimizer step of the window, over the window's time, which ends at a
synchronize."""


def read(rec):
    if rec.kind != "train" or rec.trace is not None:
        return None
    return rec.rows / rec.window_s
