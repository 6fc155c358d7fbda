"""A traced window: ``torch.profiler`` over a fixed piece of a cell's
work, reduced to what the per-layer metrics and the result line read.

Kineto keeps a window's device records only where their timestamps,
moved onto the host's clock, fall inside the window, and on the H100's
host that clock's lag grows over a process's life.  So the window is
bracketed by two marker kernels (``torch.cuda._sleep``, whose kernel is
``spin_kernel``) after a pause on the host, and taken again after a
longer pause until both markers show.  The device time between the end
of the first marker and the start of the last is the traced window.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import torch

MARKER = "spin_kernel"
TOP = 10
# the profiler's own host work, which says nothing of the program's
PROFILER_OWN = ("Activity Buffer Request",)


@dataclass
class Trace:
    """What one traced window saw on the device."""
    window_s: float
    busy_s: float
    # kernel name -> [device seconds, launches]
    kernels: dict = field(default_factory=dict)
    # the longest idle gaps: [what the host was doing, seconds]
    gaps: list = field(default_factory=list)

    def breakdown(self) -> dict:
        ops = sorted(([n, s] for n, (s, _) in self.kernels.items()),
                     key=lambda r: -r[1])[:TOP]
        return {"device_ops": ops, "idle_gaps": self.gaps[:TOP]}

    def matching(self, patterns) -> tuple[float, int, int]:
        """(device seconds, launches, launches of the first pattern) of the
        kernels whose names hold any of ``patterns``."""
        secs, calls, first = 0.0, 0, 0
        for name, (s, n) in self.kernels.items():
            if any(p in name for p in patterns):
                secs += s
                calls += n
                if patterns[0] in name:
                    first += n
        return secs, calls, first


# windows a traced run tries, and the pause before the first one's markers
TRIES, PAUSE_S = 4, 0.2


def traced(fn) -> Trace | None:
    """``fn()`` under the profiler, bracketed by markers; ``fn`` is run
    again in a new window, after a pause twice as long, while a window
    lost a marker.  None if every window lost one."""
    from torch.profiler import ProfilerActivity, profile, record_function

    pause_s = PAUSE_S
    for _ in range(TRIES):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(pause_s)
            torch.cuda._sleep(1)
            with record_function("bench.window"):
                fn()
            torch.cuda._sleep(1)
            torch.cuda.synchronize()
        out = reduce(prof.events())
        if out is not None:
            return out
        pause_s *= 2
    return None


def _is_device(e) -> bool:
    """A kernel, copy or set on the card; not the device-side shadow of a
    host span (``record_function``), which spans the whole window."""
    return e.device_type == torch.autograd.DeviceType.CUDA and \
        not getattr(e, "is_user_annotation", False) and \
        not e.name.startswith("bench.")


def reduce(events) -> Trace | None:
    """The Trace of a profiled window's events, or None where its first or
    last device record is not a marker (records were lost)."""
    dev = sorted((e for e in events if _is_device(e)),
                 key=lambda e: e.time_range.start)
    if len(dev) < 3 or MARKER not in dev[0].name or \
            MARKER not in dev[-1].name:
        return None
    lo, hi = dev[0].time_range.end, dev[-1].time_range.start
    work = [e for e in dev[1:-1] if MARKER not in e.name]
    kernels: dict = {}
    busy, gaps, cursor = 0.0, [], lo
    for e in work:
        s, t = max(e.time_range.start, lo), min(e.time_range.end, hi)
        k = kernels.setdefault(e.name, [0.0, 0])
        k[0] += (e.time_range.end - e.time_range.start) / 1e6
        k[1] += 1
        if s > cursor:
            gaps.append((s - cursor, (s + cursor) / 2))
        if t > cursor:
            busy += t - max(s, cursor)
            cursor = t
    if hi > cursor:
        gaps.append((hi - cursor, (hi + cursor) / 2))
    gaps.sort(key=lambda g: -g[0])
    host = [e for e in events
            if e.device_type == torch.autograd.DeviceType.CPU
            and e.name not in PROFILER_OWN]
    labelled = [[_host_at(host, at), length / 1e6]
                for length, at in gaps[:TOP]]
    return Trace(window_s=(hi - lo) / 1e6, busy_s=busy / 1e6,
                 kernels=kernels, gaps=labelled)


def _host_at(host, t: float) -> str:
    """What the host was running at time ``t`` (a gap's middle): the
    innermost ``bench.`` span and the innermost op open then."""
    span, op, span_start, op_start = "", "idle", -1.0, -1.0
    for e in host:
        r = e.time_range
        if r.start <= t < r.end:
            if e.name.startswith("bench.") and r.start > span_start:
                span, span_start = e.name, r.start
            elif not e.name.startswith("bench.") and r.start > op_start:
                op, op_start = e.name, r.start
    return f"{span} > {op}" if span else op
