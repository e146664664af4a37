"""The set-up's mask call on the host clock between synchronizes: the
gradient pass over the forget set and the exact top-k."""


def read(rec):
    return rec.timings.get("mask_s")
