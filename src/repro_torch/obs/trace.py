"""Host-side span tracer: tick phases -> Chrome trace-event JSON.

A :class:`SpanTracer` records complete ("ph": "X") spans into a
bounded ring buffer; :meth:`SpanTracer.export` renders the Chrome
trace-event format that ``chrome://tracing`` and Perfetto load
directly.  The engine wraps its tick phases (``_tick_begin`` /
``_decode_dispatch`` / ``_decode_collect`` / ``_tick_end``) in spans
when constructed with ``trace=...``; each shard engine traces under
its own ``pid`` so a cluster export shows the per-shard overlap the
dispatch-all-before-collect-any tick is supposed to buy.

Timing uses ``time.perf_counter_ns`` against a per-process origin, so
spans from tracers created at different times still land on one
comparable timeline.
"""

from __future__ import annotations

import json
import time
from collections import deque
from contextlib import contextmanager
from typing import Optional

__all__ = ["SpanTracer"]

# One origin per process: every tracer's timestamps are offsets from
# here, so multi-tracer (cluster) exports share a timeline.
_ORIGIN_NS = time.perf_counter_ns()


class SpanTracer:
    """Ring buffer of completed spans, Chrome-trace exportable."""

    def __init__(self, *, pid: int = 0, tid: int = 0,
                 capacity: int = 65536):
        self.pid, self.tid = pid, tid
        self._events: deque = deque(maxlen=capacity)

    def __len__(self) -> int:
        return len(self._events)

    def add(self, name: str, t0_ns: int, t1_ns: int,
            args: Optional[dict] = None) -> None:
        """Record one completed span (absolute perf_counter_ns pair)."""
        event = {
            "name": name,
            "ph": "X",
            "ts": (t0_ns - _ORIGIN_NS) / 1000.0,     # microseconds
            "dur": (t1_ns - t0_ns) / 1000.0,
            "pid": self.pid,
            "tid": self.tid,
        }
        if args:
            event["args"] = args
        self._events.append(event)

    @contextmanager
    def span(self, name: str, **args):
        """Context manager recording one span around its body."""
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            self.add(name, t0, time.perf_counter_ns(), args or None)

    def events(self) -> list:
        """The buffered spans as Chrome trace-event dicts (oldest first)."""
        return list(self._events)

    def clear(self) -> None:
        self._events.clear()

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
