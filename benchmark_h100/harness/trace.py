"""What a ``torch.profiler`` trace of the measured window says.

The window is traced with device activity alone; one unit outside it is
traced with host activity too, and names the idle gaps. Device operations
are the events on a CUDA device (kernels, copies, fills); host operations
are the CPU events. From them:

- ``busy_s``: the length of the union of the device operations' intervals;
- ``kernel_seconds(patterns)``: device time of the operations whose names
  contain any of ``patterns``;
- ``breakdown()``: the ten device operations of the window that took the
  most time, and the ten longest gaps between device operations in the
  trace that has host operations (the window's own where no other is
  given), each named after the innermost host operation open at its
  middle.
"""

from __future__ import annotations

import re
from collections import defaultdict

TOP = 10


class Trace:
    def __init__(self, prof, window_s, host_unit=None):
        import torch

        self.window_s, self.host_unit = window_s, host_unit
        device, host = [], []
        for e in prof.profiler.kineto_results.events():
            item = (e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                if not e.is_user_annotation():  # a span, not an operation
                    device.append(item)
            elif (e.device_type() == torch.autograd.DeviceType.CPU
                  and not item[2].startswith("ProfilerStep")):
                host.append(item)
        self.device = sorted(device)
        self.host = sorted(host)
        self.spans = self._union()

    def _union(self):
        spans = []
        for start, end, _ in self.device:
            if spans and start <= spans[-1][1]:
                spans[-1][1] = max(spans[-1][1], end)
            else:
                spans.append([start, end])
        return spans

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.spans) * 1e-9

    def kernel_seconds(self, patterns) -> float:
        rx = re.compile("|".join(re.escape(p) for p in patterns))
        return sum(e - s for s, e, name in self.device
                   if rx.search(name)) * 1e-9

    def by_name(self) -> dict:
        out = defaultdict(float)
        for s, e, name in self.device:
            out[name] += (e - s) * 1e-9
        return out

    def _host_during(self, start: int, end: int) -> str:
        """The innermost (latest started) host operation open at the
        middle of [start, end)."""
        mid, best = (start + end) // 2, "no host operation"
        for s, e, name in self.host:
            if s > mid:
                break
            if e > mid:
                best = name
        return best

    def gaps(self):
        """(start_ns, end_ns) of the gaps between device operations."""
        return [(a[1], b[0]) for a, b in zip(self.spans, self.spans[1:])]

    def breakdown(self) -> dict:
        ops = sorted(self.by_name().items(), key=lambda kv: -kv[1])[:TOP]
        named = self.host_unit or self
        longest = sorted(named.gaps(), key=lambda g: g[0] - g[1])[:TOP]
        idle = [[_short(named._host_during(s, e)), (e - s) * 1e-9]
                for s, e in longest]
        return {"device_ops": [[_short(n), s] for n, s in ops],
                "idle_gaps": idle}


def _short(name: str, limit: int = 120) -> str:
    return name if len(name) <= limit else name[:limit - 3] + "..."
