"""The program's own spans (``salun_torch.utils.metrics.span``) laid over a
``torch.profiler`` trace of the window (``harness/trace.py``'s ``Trace``),
on the profiler's clock.

- A device operation belongs to the innermost span that was open on the
  host when its launch was issued: the device event is joined to the CUDA
  runtime or driver call (``cudaLaunchKernel``, ``cuLaunchKernel``,
  ``cudaMemcpyAsync`` ...) of the same correlation id (``LaunchTrace``),
  and that call's host start is looked up in the spans by time, whatever
  the thread: autograd launches the backward's kernels from a thread of its
  own while the main thread sits inside ``step.backward``.
- An idle gap between device operations (``Trace.gaps``) belongs to the
  innermost span open at the gap's middle.

Both look-ups are ``Trace``'s rule for host operations (``_host_during``:
the latest started of those open at that instant), applied to the spans.
Device time: each operation is given the part of its interval no earlier
one covers, so the seconds by span and the unattributed rest add up to
``Trace.busy_s``. A device operation whose launch is not in the trace goes
under ``NO_LAUNCH``; one launched outside every span, and a gap outside
every span, under ``NO_SPAN``.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass
from types import SimpleNamespace

from .trace import Trace

TOP = 10
NO_SPAN, NO_LAUNCH = "no span", "no launch"
# the spans of the masked optimizer (the optimizer layer)
OPTIMIZER = ("step.optimizer", "step.zero_grad")


def _is_launch(name: str) -> bool:
    # CUDA runtime and driver calls; kineto's own "Activity Buffer Request"
    # carries a launch's correlation id too
    return name.startswith("cu")


class LaunchTrace(Trace):
    """``Trace``, with ``launch_ns``: the host start of each device
    operation's launch, in the order of ``device`` (None where the launch
    is not in the trace)."""

    def __init__(self, prof, window_s, host_unit=None):
        import torch

        super().__init__(prof, window_s, host_unit)
        launches, ops = {}, []
        for e in prof.profiler.kineto_results.events():
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                if not e.is_user_annotation():  # as ``Trace`` keeps them
                    ops.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                                e.name(), e.correlation_id()))
            elif (e.device_type() == torch.autograd.DeviceType.CPU
                  and _is_launch(e.name())):
                launches[e.correlation_id()] = e.start_ns()
        self.launch_ns = [launches.get(c) for *_, c in sorted(ops)]


@dataclass
class Share:
    device_s: float = 0.0
    launches: int = 0
    idle_s: float = 0.0

    def add(self, other: "Share") -> None:
        self.device_s += other.device_s
        self.launches += other.launches
        self.idle_s += other.idle_s


class Attribution:
    """``trace``: the window's ``LaunchTrace``; ``spans``: the spans
    recorded around it (``stop_tracing()``)."""

    def __init__(self, trace: LaunchTrace, spans):
        self.by_id = {s["id"]: s for s in spans}
        self.shares = defaultdict(Share)  # span id, NO_SPAN or NO_LAUNCH
        self.window, self.spans = None, []
        if not trace.device:
            return
        self.window = (min([trace.device[0][0]] + [
            t for t in trace.launch_ns if t is not None]), trace.spans[-1][1])
        self.spans = [s for s in spans if s["end_ns"] >= self.window[0]
                      and s["start_ns"] <= self.window[1]]
        # the spans as ``Trace``'s host list, ties in start going to the
        # later opened (ids count up in order of entry)
        host = SimpleNamespace(host=sorted(
            ((s["start_ns"], s["end_ns"], s["id"]) for s in self.spans),
            key=lambda h: (h[0], h[2])))

        def owner(start, end):
            key = Trace._host_during(host, start, end)
            return key if isinstance(key, int) else NO_SPAN

        reach = None
        for (start, end, _), launch in zip(trace.device, trace.launch_ns):
            share = self.shares[NO_LAUNCH if launch is None
                                else owner(launch, launch)]
            share.launches += 1
            covered = start if reach is None else max(start, reach)
            share.device_s += max(0, end - covered) * 1e-9
            reach = end if reach is None else max(reach, end)
        for start, end in trace.gaps():
            self.shares[owner(start, end)].idle_s += (end - start) * 1e-9

    def _names(self, key) -> list:
        """The names of ``key``'s span and its ancestors, innermost
        first."""
        out, s = [], self.by_id.get(key)
        while s is not None:
            out.append(s["name"])
            s = self.by_id.get(s["parent"])
        return out or [key]

    def within(self, names) -> Share:
        """Device time, launches and idle of the spans named ``names`` and
        of the spans inside them."""
        total = Share()
        for key, share in self.shares.items():
            if set(self._names(key)) & set(names):
                total.add(share)
        return total

    def count(self, name: str) -> int:
        """Spans named ``name`` that overlap the window."""
        return sum(s["name"] == name for s in self.spans)

    def by_span(self, top: int = TOP) -> list:
        """[[name, device s, launches, idle s]] of the ``top`` names with
        the most device time, each operation and gap under its innermost
        span's name."""
        named = defaultdict(Share)
        for key, share in self.shares.items():
            named[self._names(key)[0]].add(share)
        rows = sorted(named.items(), key=lambda kv: -kv[1].device_s)[:top]
        return [[n, s.device_s, s.launches, s.idle_s] for n, s in rows]

    @property
    def busy_s(self) -> float:
        return sum(s.device_s for s in self.shares.values())

    @property
    def named_s(self) -> float:
        """Device seconds launched inside some span."""
        return sum(s.device_s for k, s in self.shares.items()
                   if k not in (NO_SPAN, NO_LAUNCH))


def spans_named(rec, name: str) -> list:
    """The run's closed spans named ``name`` (``rec.spans``; none where the
    run recorded none)."""
    return [s for s in getattr(rec, "spans", None) or [] if s["name"] == name]
