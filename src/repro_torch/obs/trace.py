"""Host-side spans: the program's own timeline, as Chrome trace-event JSON.

A :class:`SpanTracer` records complete ("ph": "X") spans into a bounded
ring buffer and counts what the ring drops (:attr:`SpanTracer.dropped`);
:meth:`SpanTracer.export` renders the Chrome trace-event format that
``chrome://tracing`` and Perfetto load directly.  Each span holds its
name, start, end, its own ``id``, the ``parent`` id (the innermost span
open in the same tracer when it began) and its args.  An engine built
with ``trace=...`` records its tick and the tick's four phases
(``tick_begin`` / ``decode_dispatch`` / ``decode_collect`` /
``tick_end``); each shard engine traces under its own ``pid`` so a
cluster export shows the per-shard overlap the
dispatch-all-before-collect-any tick is supposed to buy.

Two switches, both off by default, are set by :func:`enable` and
:func:`disable`:

* **The program's spans.**  :func:`span` records one span, named
  ``<layer>.<what>`` (``pageio.read``, ``model.decode``,
  ``kernel.fused_crypt_mac``, ...), into the active tracer: inside a
  tick of an engine built with ``trace=...`` that engine's tracer,
  elsewhere the process tracer handed to :func:`enable`.  While they are
  off :func:`span` checks one module global and returns a shared no-op
  context: no clock call, no profiler call.  While they are on, a
  ``gc.callbacks`` hook also records each pass of the cyclic collector
  as a ``gc`` span with its ``generation``.
* **Profiler ranges** (``ranges=True``).  Every span, the engine's own
  too, also opens a ``torch.profiler.record_function`` range of its
  name, so a profiler's device trace carries the program's spans: a
  kernel is put down to the innermost one open at its launch, on the
  profiler's own clock.  A range costs about 10 µs a call even with no
  profiler recording, hence a switch of its own.

Timing uses ``time.perf_counter_ns`` against a per-process origin, so
spans from tracers created at different times still land on one
comparable timeline.
"""

from __future__ import annotations

import gc
import json
import time
from collections import deque
from typing import Optional

__all__ = ["SpanTracer", "span", "record", "activate", "enable", "disable",
           "perf_counter_of"]

# One origin per process: every tracer's timestamps are offsets from
# here, so multi-tracer (cluster) exports share a timeline.
_ORIGIN_NS = time.perf_counter_ns()

# The switches (see the module docstring).  ``_active`` is None exactly
# while the program's spans are off.
_ranges = False
_process: Optional["SpanTracer"] = None
_active: Optional["SpanTracer"] = None


class _Off:
    """The shared context :func:`span` returns while spans are off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()


def _record_function(name: str):
    import torch
    return torch.profiler.record_function(name)


class _Span:
    """One open span of a tracer; ``seconds`` holds its length once it
    closed.  ``args`` may still be added to while it is open."""

    __slots__ = ("tracer", "name", "args", "id", "parent", "t0", "seconds",
                 "_range")

    def __init__(self, tracer: "SpanTracer", name: str, args: dict):
        self.tracer, self.name, self.args = tracer, name, args
        self._range = None
        self.seconds = 0.0

    def __enter__(self) -> "_Span":
        tr = self.tracer
        tr._next_id += 1
        self.id = tr._next_id
        self.parent = tr._open[-1].id if tr._open else None
        tr._open.append(self)
        if _ranges:
            self._range = _record_function(self.name)
            self._range.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = time.perf_counter_ns()
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None
        tr = self.tracer
        tr._open.remove(self)
        tr._record(self.name, self.t0, t1, self.id, self.parent, self.args)
        self.seconds = (t1 - self.t0) / 1e9
        return False


class SpanTracer:
    """Ring buffer of completed spans, Chrome-trace exportable.

    ``dropped`` counts the spans the ring let go, oldest first, since it
    was made or last cleared: a reader of a stretch of time whose spans
    may be among them reads nothing rather than a short sum.
    """

    def __init__(self, *, pid: int = 0, tid: int = 0,
                 capacity: int = 65536):
        self.pid, self.tid = pid, tid
        self._events: deque = deque(maxlen=capacity)
        self._open: list = []
        self._next_id = 0
        self.dropped = 0

    def __len__(self) -> int:
        return len(self._events)

    def _record(self, name, t0_ns, t1_ns, span_id, parent, args) -> None:
        if len(self._events) == self._events.maxlen:
            self.dropped += 1
        self._events.append((name, t0_ns, t1_ns, span_id, parent, args))

    def add(self, name: str, t0_ns: int, t1_ns: int,
            args: Optional[dict] = None) -> None:
        """Record one completed span (absolute perf_counter_ns pair); its
        parent is the innermost span open now."""
        self._next_id += 1
        self._record(name, t0_ns, t1_ns, self._next_id,
                     self._open[-1].id if self._open else None,
                     args or None)

    def span(self, name: str, **args) -> _Span:
        """Context manager recording one span around its body."""
        return _Span(self, name, args)

    def annotate(self, **args) -> None:
        """Add ``args`` to the innermost open span (nothing if none)."""
        if self._open:
            self._open[-1].args.update(args)

    def events(self) -> list:
        """The buffered spans as Chrome trace-event dicts (oldest first)."""
        out = []
        # A snapshot: building the dicts may run the collector, whose
        # ``gc`` span lands in this ring while it is read.
        for name, t0, t1, span_id, parent, args in list(self._events):
            event = {
                "name": name,
                "ph": "X",
                "ts": (t0 - _ORIGIN_NS) / 1000.0,     # microseconds
                "dur": (t1 - t0) / 1000.0,
                "pid": self.pid,
                "tid": self.tid,
                "id": span_id,
                "parent": parent,
            }
            if args:
                event["args"] = dict(args)
            out.append(event)
        return out

    def clear(self) -> None:
        self._events.clear()
        self.dropped = 0

    def export(self, path: Optional[str] = None, *,
               extra_events: Optional[list] = None) -> dict:
        """The Chrome trace-event JSON document; written when ``path``.

        ``extra_events`` lets a cluster merge its shard tracers into
        one file (every tracer stamps its own ``pid``).
        """
        events = self.events() + list(extra_events or [])
        events.sort(key=lambda e: e["ts"])
        doc = {"traceEvents": events, "displayTimeUnit": "ms"}
        if path is not None:
            with open(path, "w") as f:
                json.dump(doc, f)
        return doc


def perf_counter_of(ts_us: float) -> float:
    """A span's ``ts`` (or ``ts + dur``) as a ``time.perf_counter()``
    reading."""
    return (_ORIGIN_NS + ts_us * 1000.0) / 1e9


# -- the program's spans ------------------------------------------------------


def span(name: str, **args):
    """One span of the program into the active tracer; a shared no-op
    context while the program's spans are off."""
    tracer = _active
    if tracer is None:
        return _OFF
    return _Span(tracer, name, args)


def record(name: str, t0_ns: int, **args) -> None:
    """Record a span of the program that began at ``t0_ns``
    (``perf_counter_ns``) and ends now, such as a request's wait in its
    queue; nothing while the program's spans are off."""
    tracer = _active
    if tracer is not None:
        tracer.add(name, t0_ns, time.perf_counter_ns(), args)


class _Activate:
    __slots__ = ("tracer", "prev")

    def __init__(self, tracer: SpanTracer):
        self.tracer = tracer

    def __enter__(self):
        global _active
        self.prev, _active = _active, self.tracer
        return self

    def __exit__(self, *exc) -> bool:
        global _active
        # A disable() inside the context leaves the spans off.
        _active = self.prev if _active is not None else None
        return False


def activate(tracer: Optional[SpanTracer]):
    """Inside the returned context the program's spans go to ``tracer``
    (an engine's, for its tick); a no-op while they are off or without a
    tracer."""
    if _active is None or tracer is None:
        return _OFF
    return _Activate(tracer)


_gc_open: list = []


def _on_gc(phase: str, info: dict) -> None:
    if phase == "start":
        tracer = _active
        if tracer is not None:
            sp = _Span(tracer, "gc", {"generation": info["generation"]})
            sp.__enter__()
            _gc_open.append(sp)
    elif _gc_open:
        _gc_open.pop().__exit__(None, None, None)


def enable(tracer: Optional[SpanTracer] = None, *,
           ranges: bool = False) -> SpanTracer:
    """Turn the program's spans on (and with ``ranges`` the profiler
    ranges); outside an engine's tick they go to ``tracer``, the process
    tracer (a new one when None and none is set).  Returns it.  Calling
    it again changes the switches and keeps the process tracer unless
    given another."""
    global _ranges, _process, _active
    if tracer is not None or _process is None:
        _process = tracer if tracer is not None else SpanTracer(tid=1)
    _active = _process
    _ranges = bool(ranges)
    if _on_gc not in gc.callbacks:
        gc.callbacks.append(_on_gc)
    return _process


def disable() -> Optional[SpanTracer]:
    """Turn both switches off; returns the process tracer (kept for
    export) or None."""
    global _ranges, _process, _active
    _active, _ranges = None, False
    if _on_gc in gc.callbacks:
        gc.callbacks.remove(_on_gc)
    while _gc_open:
        _gc_open.pop().__exit__(None, None, None)
    process, _process = _process, None
    return process
