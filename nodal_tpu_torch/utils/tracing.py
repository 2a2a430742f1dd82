"""Spans and counters at the port's layer boundaries, kept in memory.

One call into an entry point (``BatchedSolver.__call__``, ``grid_solve``)
is a root span; while it runs, every span and counter inside it goes into
its call record.  A span records its name, its start and end on
``time.perf_counter_ns()`` and its parent; the record also keeps the
root's start on ``time.time_ns()``, the clock ``torch.profiler`` exports
its trace on (``baseTimeNanoseconds`` + ``ts`` µs), so a record maps onto
an exported trace's timeline (:meth:`Call.wall_ns`).

Tracing is on for a root call while ``torch.profiler`` records (each span
is then also a ``record_function`` range, a ``user_annotation`` event of
the trace), and after :func:`enable` until :func:`disable`.  When it is
off, a span is one check of a module global and a shared no-op context,
and a counter returns at once.

A span given a CUDA tensor (``like``) also times its stream with a pair of
CUDA events; the elapsed time is read when the records are
(:func:`recent`), never inside the call.  The last ``KEEP_CALLS`` call
records are kept, one thread's calls at a time.

    from nodal_tpu_torch.utils import tracing
    tracing.enable()
    solver(params)
    call = tracing.recent(1)[0]
    call.counters          # {'contract_passes': 1, 'host_syncs': 2, ...}
    [(s.name, s.host_ms, s.device_ms) for s in call.spans]
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from itertools import count as _ids

import torch
from torch.autograd.profiler import record_function

#: Root calls whose records are kept, oldest dropped first.
KEEP_CALLS = 64

_profiling = torch._C._autograd._profiler_enabled
_forced = False
_call = None  # the open call record, or None
_stack: list = []  # indices of its open spans, innermost last
_profiled = False  # whether its spans are profiler ranges too
_ring: deque = deque(maxlen=KEEP_CALLS)
_next_id = _ids()


@dataclass(eq=False)
class Span:
    """One span of a call record: ``parent`` is the index of the span
    that encloses it in :attr:`Call.spans` (None for the root)."""

    name: str
    parent: int | None
    start_ns: int
    end_ns: int = 0
    _events: tuple | None = field(default=None, repr=False)
    _device_ms: float | None = field(default=None, repr=False)

    @property
    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6

    @property
    def device_ms(self) -> float | None:
        """Elapsed ms between the span's CUDA events on its stream, or
        None for a host-only span.  Waits for the end event."""
        if self._events is not None:
            start, end = self._events
            end.synchronize()
            self._device_ms = start.elapsed_time(end)
            self._events = None
        return self._device_ms


@dataclass
class Call:
    """The record of one root call: its spans in the order they opened
    (``spans[0]`` is the root) and its counters."""

    id: int
    wall_start_ns: int
    spans: list = field(default_factory=list)
    counters: dict = field(default_factory=dict)

    @property
    def name(self) -> str:
        return self.spans[0].name

    def find(self, name: str) -> list:
        return [s for s in self.spans if s.name == name]

    def children(self, span: Span) -> list:
        i = self.spans.index(span)
        return [s for s in self.spans if s.parent == i]

    def wall_ns(self, span: Span) -> int:
        """The span's start on ``time.time_ns()``'s clock."""
        return self.wall_start_ns + span.start_ns - self.spans[0].start_ns


class _Off:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Open:
    """A span of the open call record."""

    __slots__ = ("name", "like", "index", "range", "events")

    def __init__(self, name, like):
        self.name, self.like = name, like

    def __enter__(self):
        call = _call
        self.range = None
        if _profiled:
            self.range = record_function(self.name)
            self.range.__enter__()
        self.index = len(call.spans)
        call.spans.append(Span(self.name, _stack[-1] if _stack else None,
                               time.perf_counter_ns()))
        _stack.append(self.index)
        self.events = None
        like = self.like
        if like is not None and like.is_cuda:
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record(torch.cuda.current_stream(like.device))
        return None

    def __exit__(self, *exc):
        call = _call
        span = call.spans[self.index]
        if self.events is not None:
            self.events[1].record(torch.cuda.current_stream(
                self.like.device))
            span._events = self.events
        span.end_ns = time.perf_counter_ns()
        _stack.pop()
        if self.range is not None:
            self.range.__exit__(None, None, None)
        return False


class _Root(_Open):
    """A root span: opens the call record and keeps it on exit."""

    __slots__ = ()

    def __enter__(self):
        global _call, _profiled
        _call = Call(next(_next_id), 0)
        _stack.clear()
        _profiled = _profiling()
        super().__enter__()
        # The wall clock at the root's own start, after its profiler range
        # opened.
        _call.wall_start_ns = time.time_ns() - (time.perf_counter_ns()
                                                - _call.spans[0].start_ns)
        return None

    def __exit__(self, *exc):
        global _call
        super().__exit__(*exc)
        _ring.append(_call)
        _call = None
        return False


def enable() -> None:
    """Trace every root call until :func:`disable` (without a profiler)."""
    global _forced
    _forced = True


def disable() -> None:
    global _forced
    _forced = False


def root(name: str):
    """The span of one call into an entry point: it opens a call record
    when tracing is on and none is open, and is a plain span inside an
    open one."""
    if _call is not None:
        return _Open(name, None)
    if not (_forced or _profiling()):
        return _OFF
    return _Root(name, None)


def span(name: str, like: torch.Tensor | None = None):
    """A span of the open call record, device-timed when ``like`` is a
    CUDA tensor; a no-op when no record is open."""
    if _call is None:
        return _OFF
    return _Open(name, like)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the open call record's counter ``name``."""
    call = _call
    if call is None:
        return
    call.counters[name] = call.counters.get(name, 0) + n


def recent(n: int) -> list:
    """The newest ``n`` call records, oldest first, device times read."""
    calls = list(_ring)[-n:] if n > 0 else []
    for call in calls:
        for s in call.spans:
            s.device_ms  # noqa: B018 - reads the events once
    return calls


def self_ms(call: Call, span: Span, device: bool = False) -> float | None:
    """A span's time less what its child spans cover, ms.  Spans of one
    call run one after another, so children never overlap.  On the host
    clock the children are its direct children; on the device clock its
    nearest descendants that carry a device time.  None for a span with
    no device time on the device clock."""
    if not device:
        return span.host_ms - sum(s.host_ms for s in call.children(span))
    total = span.device_ms
    if total is None:
        return None
    todo = call.children(span)
    while todo:
        s = todo.pop()
        if s.device_ms is None:
            todo += call.children(s)
        else:
            total -= s.device_ms
    return total
