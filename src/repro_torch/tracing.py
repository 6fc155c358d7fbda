"""The program's own spans and counters, on the profiler's clock.

Tracing is on while a ``torch.profiler`` records
(``torch.autograd._profiler_enabled()``) and off otherwise; there is no
other switch.  Off, ``span`` returns one shared context that does nothing
and ``count`` returns at once.  On, a span:

- opens a ``torch.profiler.record_function`` range under its name, so it
  lies in the profiler's timeline beside the kernels it enqueued;
- keeps its host start and end (``time.perf_counter_ns``) and the name of
  the span it opened in (on the same thread);
- given a CUDA tensor (``like``), records a pair of timing events on that
  tensor's device's current stream: its device interval.  Only the spans
  whose device time is read are given one: ``moe.layer`` and the MoE
  routing, dispatch and combine.

A stage of a differentiable computation also gets a span in the backward,
named ``<name>.bwd``: ``bwd_end(x)`` marks the stage's input and
``bwd_start(y)`` its output, and the autograd engine opens the span where
the gradient reaches ``y`` and closes it where it has passed back to
``x``.  The marks are identity functions inserted only while tracing is
on, so the graph with tracing off is unchanged.

Counters sum what ``count`` is given, an ``int`` or a tensor, without
reading a tensor back.  They count forward work: a count made while the
autograd engine runs a backward (activation checkpointing's recompute) is
skipped.  ``records()`` synchronises once and returns the sums; records
stay in memory, as sums and a bounded number of pending events, until
``reset()``.

Spans: ``serve.prefill``, ``serve.first_decode``, ``serve.decode`` and
``serve.readback`` (``launch.serve.serve``); ``train.step``,
``train.grad`` and ``train.update`` (``runtime.trainstep``);
``moe.layer`` (a layer of the MoE family, or its recompute),
``moe.route``, ``moe.dispatch``, ``moe.experts`` and ``moe.combine``,
each with its ``.bwd`` (``models.moe``).  Counters: ``moe.assignments``,
``moe.dropped``.
"""
from __future__ import annotations

import threading
import time
from collections import defaultdict

import torch
from torch.autograd.profiler import record_function

on = torch.autograd._profiler_enabled

# timed spans (or a counter's tensors) held before those the card has
# reached are read into sums (or summed into one), which bounds what a long
# profile keeps
FOLD_AT = 1024


class _Off:
    """Every span while tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def bwd_end(self, x):
        return x

    def bwd_start(self, y):
        return y


_OFF = _Off()


class _Timed:
    """A timed span's pair of events until its device interval is read;
    the intervals of the timed spans inside it are taken off its self
    time as they are read."""

    __slots__ = ("name", "device", "start", "end", "kid_ms", "kids_left",
                 "parent")

    def __init__(self, name: str, stream):
        self.name = name
        self.device = stream.device
        self.start = _STORE.event(self.device)
        self.start.record(stream)
        self.end = None
        self.kid_ms = 0.0
        self.kids_left = 0
        self.parent = None


class _Store:
    """What the spans and counters recorded since the last ``reset``."""

    def __init__(self):
        self.lock = threading.Lock()
        self.local = threading.local()
        self.calls = defaultdict(int)
        self.host_ns = defaultdict(int)
        self.child_ns = defaultdict(int)
        self.parents = defaultdict(set)
        self.pending = []                    # _Timed, in the order closed
        self.device_ms = defaultdict(float)
        self.device_self_ms = defaultdict(float)
        self.timed = defaultdict(int)
        self.free = defaultdict(list)        # device -> events to reuse
        self.counts = defaultdict(int)       # name -> sum of ints
        self.tensors = defaultdict(list)     # name -> [0-d tensor]
        self.devices = set()                 # the cards records wait on

    def stack(self) -> list:
        st = getattr(self.local, "stack", None)
        if st is None:
            st = self.local.stack = []
        return st

    def event(self, device) -> torch.cuda.Event:
        free = self.free[device]
        return free.pop() if free else torch.cuda.Event(enable_timing=True)

    def fold(self, wait: bool) -> None:
        """Read the device intervals of the closed timed spans, those the
        card has reached (all, after a synchronise, with ``wait``) and
        whose timed spans inside are read, into the sums; their events go
        back to the pool.  A span closes after those inside it, so one
        pass reads them first.  Called with the lock held."""
        keep = []
        for t in self.pending:
            if t.kids_left or not (wait or t.end.query()):
                keep.append(t)
                continue
            ms = t.start.elapsed_time(t.end)
            self.device_ms[t.name] += ms
            self.device_self_ms[t.name] += ms - t.kid_ms
            self.timed[t.name] += 1
            if t.parent is not None:
                t.parent.kid_ms += ms
                t.parent.kids_left -= 1
            self.free[t.device] += (t.start, t.end)
        self.pending = keep


_STORE = _Store()


class _Span:
    """One span while tracing is on (see the module's docstring)."""

    __slots__ = ("name", "stream", "range", "parent", "child_ns", "t0",
                 "timed", "grad_span")

    def __init__(self, name: str, stream):
        self.name = name
        self.stream = stream
        self.grad_span = None

    def __enter__(self):
        st = _STORE.stack()
        self.parent = st[-1] if st else None
        st.append(self)
        self.child_ns = 0
        self.range = record_function(self.name)
        self.range.__enter__()
        self.timed = None
        if self.stream is not None:
            with _STORE.lock:
                self.timed = _Timed(self.name, self.stream)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        ns = time.perf_counter_ns() - self.t0
        t = self.timed
        if t is not None:
            with _STORE.lock:
                t.end = _STORE.event(t.device)
            t.end.record(self.stream)
        self.range.__exit__(*exc)
        st = _STORE.stack()
        if self in st:
            st.remove(self)
        parent = self.parent
        if parent is not None:
            parent.child_ns += ns
        with _STORE.lock:
            _STORE.calls[self.name] += 1
            _STORE.host_ns[self.name] += ns
            _STORE.child_ns[self.name] += self.child_ns
            _STORE.parents[self.name].add(
                parent.name if parent is not None else None)
            if t is not None:
                if parent is not None and parent.timed is not None:
                    t.parent = parent.timed
                    t.parent.kids_left += 1
                _STORE.pending.append(t)
                _STORE.devices.add(t.device)
                if len(_STORE.pending) >= FOLD_AT:
                    _STORE.fold(wait=False)
        return False

    def _grad(self) -> "_GradSpan":
        if self.grad_span is None:
            self.grad_span = _GradSpan(_Span(self.name + ".bwd",
                                             self.stream))
        return self.grad_span

    def bwd_end(self, x):
        """``x``, a stage input, marked to close the stage's backward span
        once the gradient has passed back to it."""
        if not (torch.is_grad_enabled() and x.requires_grad):
            return x
        return _Mark.apply(x, self._grad().close)

    def bwd_start(self, y):
        """``y``, a stage output, marked to open the stage's backward span
        when the gradient reaches it."""
        if not (torch.is_grad_enabled() and y.requires_grad):
            return y
        return _Mark.apply(y, self._grad().open)


class _GradSpan:
    """A stage's backward span, opened and closed by two marks."""

    def __init__(self, span: _Span):
        self.span = span
        self.opened = False

    def open(self):
        if not self.opened and on():
            self.span.__enter__()
            self.opened = True

    def close(self):
        if self.opened:
            self.opened = False
            self.span.__exit__(None, None, None)


class _Mark(torch.autograd.Function):
    """Identity whose backward calls ``hook`` first."""

    @staticmethod
    def forward(ctx, x, hook):
        ctx.hook = hook
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        ctx.hook()
        return grad, None


def span(name: str, like: torch.Tensor | None = None):
    """A context over the enclosed work, recorded under ``name`` while
    tracing is on; given a CUDA tensor ``like``, also timed on its
    stream."""
    if not on():
        return _OFF
    return _Span(name, torch.cuda.current_stream(like.device)
                 if like is not None and like.is_cuda else None)


def count(name: str, value) -> None:
    """Add ``value`` (an int, or a tensor summed over its elements) to the
    counter ``name`` while tracing is on, outside a backward.  A counter's
    tensors share a device and a dtype."""
    if not on() or torch._C._current_graph_task_id() != -1:
        return
    if not isinstance(value, torch.Tensor):
        with _STORE.lock:
            _STORE.counts[name] += value
        return
    value = value.detach()
    if value.dim():
        value = value.sum()
    with _STORE.lock:
        held = _STORE.tensors[name]
        held.append(value)
        if len(held) >= FOLD_AT:
            held[:] = [torch.stack(held).sum()]
        if value.is_cuda:
            _STORE.devices.add(value.device)


def records() -> dict:
    """``{"spans": {name: {"calls", "host_s", "self_s", "device_s",
    "device_self_s", "parents"}}, "counters": {name: sum}}`` of everything
    recorded since the last ``reset()``.  ``device_s`` sums the spans'
    device intervals (None for a span never timed on a card); a ``self``
    time is the span's less that of the spans opened inside it on its
    thread (such as activation checkpointing's recompute inside a
    backward span)."""
    with _STORE.lock:
        for d in _STORE.devices:
            torch.cuda.synchronize(d)
        _STORE.fold(wait=True)
        spans = {}
        for name, n in _STORE.calls.items():
            timed = _STORE.timed.get(name, 0)
            spans[name] = {
                "calls": n, "host_s": _STORE.host_ns[name] / 1e9,
                "self_s": (_STORE.host_ns[name] - _STORE.child_ns[name])
                / 1e9,
                "device_s": _STORE.device_ms[name] / 1e3 if timed else None,
                "device_self_s": _STORE.device_self_ms[name] / 1e3
                if timed else None,
                "parents": sorted(_STORE.parents[name], key=str)}
        counters = dict(_STORE.counts)
        for name, held in _STORE.tensors.items():
            counters[name] = counters.get(name, 0) + \
                sum(v.item() for v in held)
    return {"spans": spans, "counters": counters}


def reset() -> None:
    """Forget every record."""
    global _STORE
    _STORE = _Store()


__all__ = ["count", "on", "records", "reset", "span"]
