"""Device time of the operations launched inside the ``sample.transition``
spans of the traced window (one DDIM step: a CFG-doubled U-Net forward
and the update), over the number of those spans, in ms
(``harness/spans.py``)."""


def read(rec):
    att = getattr(rec, "attribution", None)
    n = att.count("sample.transition") if att is not None else 0
    if not n or not att.within(("sample.transition",)).launches:
        return None
    return 1e3 * att.within(("sample.transition",)).device_s / n
