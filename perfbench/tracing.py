"""Traced runs: named ranges around the program's layers, profiler
segments, and the reduction of a CUPTI trace to device intervals.

:class:`Ranges` wraps functions of the program, found by module and
attribute name, so that each call opens a ``torch.profiler``
``record_function`` range named after its layer while a segment records.
A name that no longer exists is listed in ``missing``; every metric of
its layer then reads nothing.

A segment is a number of ticks (or steps) under ``torch.profiler``:
``device`` segments trace the card alone (busy time, launches, the
kernels that took most time), ``layers`` segments trace the host too,
so each kernel is attributed, through the launch that queued it, to the
range open on the host at that moment.
"""

from __future__ import annotations

import bisect
import importlib
import json
import os
import tempfile
import time
from collections import defaultdict

from perfbench import stats

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


class Ranges:
    """Wrap ``targets`` = ``[(layer, "module:Attr.path"), ...]`` in
    ranges named after their layer, active only while ``self.on``."""

    def __init__(self, targets, on_call=None):
        import torch
        self.on = False
        self.missing: list = []
        self.layers = sorted({layer for layer, _ in targets})
        self._restore: list = []
        self._on_call = on_call or {}
        for layer, path in targets:
            mod_name, attr = path.split(":")
            try:
                owner = importlib.import_module(mod_name)
                parts = attr.split(".")
                for p in parts[:-1]:
                    owner = getattr(owner, p)
                fn = getattr(owner, parts[-1])
            except (ImportError, AttributeError):
                self.missing.append(path)
                continue
            self._restore.append((owner, parts[-1], fn))
            setattr(owner, parts[-1],
                    self._wrap(fn, layer, path, torch.profiler.record_function))

    def _wrap(self, fn, layer, path, record_function):
        hook = self._on_call.get(path)

        def wrapper(*a, **kw):
            if not self.on:
                return fn(*a, **kw)
            if hook is not None:
                hook(*a, **kw)
            with record_function(layer):
                return fn(*a, **kw)

        wrapper.__wrapped__ = fn
        return wrapper

    def close(self) -> None:
        for owner, name, fn in reversed(self._restore):
            setattr(owner, name, fn)
        self._restore = []

    def missing_for(self, layer: str, targets) -> list:
        return [p for lay, p in targets if lay == layer and p in self.missing]


class Segment:
    """One profiled stretch: device intervals, launches, attributed
    device time per range, and the host ranges around idle gaps."""

    def __init__(self, doc: dict, wall_s: float, units: int, layers):
        self.wall_s = wall_s
        self.units = units
        events = doc.get("traceEvents", [])
        launches: dict = {}
        ranges: dict = defaultdict(list)
        self.device: list = []      # (start_us, end_us, name, correlation)
        self.launch_count = 0       # kernels (copies and fills excluded)
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = str(e.get("cat", "")).lower()
            args = e.get("args") or {}
            if cat in DEVICE_CATS:
                self.launch_count += cat == "kernel"
                self.device.append((float(e["ts"]), float(e["ts"])
                                    + float(e.get("dur", 0.0)), e["name"],
                                    args.get("correlation")))
            elif cat in LAUNCH_CATS and "correlation" in args:
                launches[args["correlation"]] = (float(e["ts"]), e.get("tid"))
            elif cat == "user_annotation" and e.get("name") in layers:
                ranges[e["name"]].append((float(e["ts"]), float(e["ts"])
                                          + float(e.get("dur", 0.0))))
        self.device.sort()
        self._ranges = {k: stats.merged(v) for k, v in ranges.items()}
        self._starts = {k: [s for s, _ in v] for k, v in self._ranges.items()}
        self.unattributed = 0
        self.layer_us: dict = defaultdict(float)
        for s, e, _name, corr in self.device:
            launch = launches.get(corr)
            if launch is None:
                self.unattributed += 1
                continue
            layer = self.range_at(launch[0])
            if layer is not None:
                self.layer_us[layer] += e - s

    def range_at(self, t: float):
        """The innermost layer range open at host time ``t``, else
        None."""
        best, best_key = None, None
        for layer, starts in self._starts.items():
            i = bisect.bisect_right(starts, t) - 1
            if i < 0 or self._ranges[layer][i][1] < t:
                continue
            start, end = self._ranges[layer][i]
            if best_key is None or (start, -end) > best_key:
                best, best_key = layer, (start, -end)
        return best

    def busy_s(self) -> float:
        return stats.union_length((s, e) for s, e, _, _ in self.device) / 1e6

    def top_ops(self, n: int = 10) -> list:
        by: dict = defaultdict(float)
        for s, e, name, _ in self.device:
            by[name[:96]] += (e - s) / 1e6
        return sorted(([k, v] for k, v in by.items()), key=lambda kv: -kv[1])[:n]

    def idle_gaps(self, n: int = 10) -> list:
        """Idle device seconds between kernels, by the layer range open
        on the host when the gap began ("outside the named layers"
        otherwise), largest first."""
        busy = stats.merged((s, e) for s, e, _, _ in self.device)
        by: dict = defaultdict(float)
        for (_, end), (start, _) in zip(busy, busy[1:]):
            label = self.range_at(end) or "outside the named layers"
            by[label] += (start - end) / 1e6
        return sorted(([k, v] for k, v in by.items()), key=lambda kv: -kv[1])[:n]


def profile(run_units, units: int, *, host: bool, layers=(), ranges=None):
    """Run ``run_units(units)`` under the profiler and reduce the trace.

    ``host`` adds the host activity (ranges and launches) to the card's;
    ``ranges`` (a :class:`Ranges`) is switched on for the segment.  The
    trace goes through a file in the temporary directory, deleted once
    read.
    """
    import torch
    from torch.profiler import ProfilerActivity
    cuda = torch.cuda.is_available()
    acts = (([ProfilerActivity.CUDA] if cuda else [])
            + ([ProfilerActivity.CPU] if host or not cuda else []))

    def sync():
        if cuda:
            torch.cuda.synchronize()

    sync()
    if ranges is not None:
        ranges.on = True
    try:
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            run_units(units)
            sync()
            wall = time.perf_counter() - t0
    finally:
        if ranges is not None:
            ranges.on = False
    fd, path = tempfile.mkstemp(suffix=".json", prefix="perfbench-trace-")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            doc = json.load(f)
    finally:
        os.remove(path)
    return Segment(doc, wall, units, set(layers))
