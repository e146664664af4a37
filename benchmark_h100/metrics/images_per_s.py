"""Decoded images of the window's requests over the time from the window's
start to the end of the last of them (a synchronize)."""


def read(rec):
    if rec.kind != "sample" or rec.trace is not None:
        return None
    return rec.rows / rec.window_s
