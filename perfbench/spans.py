"""Where the port's own spans put the time: one cell, traced from inside.

    python3 perfbench/spans.py --workload minitron-4b.tenant-steady \\
        --seed 2147483777 --seconds 45 [--spans alt] [--out PATH]

One process, one run of the cell as ``run.py`` sets it up (the drivers'
own set-up and traffic), with the program's spans
(:mod:`repro_torch.obs.trace`) recorded where ``run.py`` records none:

* **The window** (``--seconds``): the engine's tick and phase spans as
  in a traced run, and the program's spans inside the ticks too (host
  clock only).  ``--spans alt`` (serving) turns the program's spans on
  for every other tick only, so what they cost the tick's phases is read
  in pairs of neighbouring ticks, beside the host's drift.
  Read: host ms a tick by span (self time, children taken out), host ms
  inside the outermost ``model.*`` and ``pageio.*`` spans, the share of
  the pages each decode crossed that held a live token
  (``decode_dispatch``'s ``pages_live`` over ``pages_crossed``), and the
  p90 of ``request.queued`` over the requests submitted in the window,
  one not admitted by its end counting with its wait so far.
* **The layers segment** (the cell's ``layer_ticks`` or
  ``layer_steps``): the card and the host under ``torch.profiler`` with
  the drivers' layer ranges on and the program's spans opening profiler
  ranges.  Each kernel is put down, by the launch that queued it, to the
  innermost program span open on the host then, and each idle gap of the
  card to the innermost one open when it began (else the layer range,
  else "outside the named layers").  Read: device ms a unit by span,
  the page crossings' and the weights crossing's plumbing (their kernels
  outside ``kernel.*`` spans), the kernels that took most time with the
  span that launched each.

It also times the span helper itself on this host: off, on, and on with
profiler ranges.  The last line of standard output is one JSON object;
``--out`` writes it indented too.  Needs the card for device numbers; on
the CPU (tests) the window's readings and the span tables still come.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

# Prefixes of the program's span names (``<layer>.<what>``), and the
# collector's span.
PROGRAM_LAYERS = ("pageio", "kernel", "model", "crossing", "train",
                  "optimizer", "request")
OUTSIDE = "outside the named layers"


def is_program_span(name: str) -> bool:
    layer, dot, _ = name.partition(".")
    return name == "gc" or (bool(dot) and layer in PROGRAM_LAYERS)


# -- the window: host spans ---------------------------------------------------


class WindowSpans:
    """The spans of one tracer's events whose tick (the ``tick`` arg of
    the ``tick`` span they sit under) is in ``ticks``; ``request.queued``,
    a wait that began before the tick that ends it, is left out."""

    def __init__(self, events, ticks):
        ticks = set(ticks)
        by_id = {e["id"]: e for e in events}
        tick_of: dict = {}

        def tick(e):
            chain = []
            while e is not None and e["id"] not in tick_of:
                if e["name"] == "tick":
                    tick_of[e["id"]] = (e.get("args") or {}).get("tick")
                    break
                chain.append(e)
                e = by_id.get(e.get("parent"))
            t = tick_of.get(e["id"]) if e is not None else None
            for c in chain:
                tick_of[c["id"]] = t
            return t

        self.events = [e for e in events if e["name"] != "request.queued"
                       and tick(e) in ticks]
        self.by_id = by_id
        self.n_ticks = len(ticks)

    def _outermost(self, e, prefix: str) -> bool:
        p = self.by_id.get(e.get("parent"))
        while p is not None:
            if p["name"].startswith(prefix):
                return False
            p = self.by_id.get(p.get("parent"))
        return True

    def ms_per_tick(self, prefix: str):
        """Host ms a tick inside the outermost spans named ``prefix*``."""
        if not self.n_ticks:
            return None
        us = sum(e["dur"] for e in self.events
                 if e["name"].startswith(prefix)
                 and self._outermost(e, prefix))
        return us / 1e3 / self.n_ticks

    def self_ms_per_tick(self) -> dict:
        """Host ms a tick by span name, each span's children taken out."""
        child_us: dict = defaultdict(float)
        for e in self.events:
            if e.get("parent") is not None:
                child_us[e["parent"]] += e["dur"]
        out: dict = defaultdict(float)
        for e in self.events:
            out[e["name"]] += (e["dur"] - child_us[e["id"]]) / 1e3
        return {k: v / self.n_ticks for k, v in
                sorted(out.items(), key=lambda kv: -kv[1])}

    def live_page_share(self):
        """Percent of the pages the window's decodes crossed that hold a
        live token."""
        crossed = live = 0
        for e in self.events:
            args = e.get("args") or {}
            if e["name"] == "decode_dispatch" and "pages_crossed" in args:
                crossed += args["pages_crossed"]
                live += args["pages_live"]
        return 100.0 * live / crossed if crossed else None


def queue_waits(events, recs, t0: float, t1: float) -> list:
    """Seconds each request submitted in ``[t0, t1)`` waited for a slot:
    its ``request.queued`` span, or, not admitted by ``t1``, the time it
    has waited so far."""
    from repro_torch.obs.trace import perf_counter_of
    admitted = {}
    for e in events:
        if e["name"] == "request.queued":
            end = perf_counter_of(e["ts"] + e["dur"])
            admitted[e["args"]["rid"]] = (e["dur"] / 1e6, end)
    out = []
    for r in recs:
        if r["failed"] or not t0 <= r["submit"] < t1:
            continue
        wait, end = admitted.get(r["rid"], (None, None))
        out.append(wait if end is not None and end <= t1
                   else t1 - r["submit"])
    return out


# -- the layers segment: device trace ------------------------------------------


def innermost(spans, times) -> list:
    """For each time in ``times``, the name of the innermost of
    ``spans`` (``(start, end, name)``, properly nested) open at it, or
    None."""
    spans = sorted(spans, key=lambda s: (s[0], -s[1]))
    order = sorted(range(len(times)), key=lambda i: times[i])
    out = [None] * len(times)
    stack: list = []
    k = 0
    for i in order:
        t = times[i]
        while k < len(spans) and spans[k][0] <= t:
            while stack and stack[-1][1] < spans[k][0]:
                stack.pop()
            stack.append(spans[k])
            k += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out[i] = stack[-1][2] if stack else None
    return out


class ProgramAttribution:
    """A profiler trace (Chrome JSON) read by the program's spans: each
    device operation under the innermost program span open at its
    launch, each idle gap under the one open when it began.

    ``layer_at`` (a time -> layer range or None, such as
    ``perfbench.tracing.Segment.range_at``) labels the gaps no program
    span covers."""

    def __init__(self, doc: dict, units: int, layer_at=None):
        self.units = units
        spans, launches, device = [], {}, []
        for e in doc.get("traceEvents", []):
            if e.get("ph") != "X":
                continue
            cat = str(e.get("cat", "")).lower()
            args = e.get("args") or {}
            ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
            if cat in ("kernel", "gpu_memcpy", "gpu_memset"):
                device.append((ts, ts + dur, e["name"],
                               args.get("correlation")))
            elif cat in ("cuda_runtime", "cuda_driver") and \
                    "correlation" in args:
                launches[args["correlation"]] = ts
            elif cat == "user_annotation" and is_program_span(e["name"]):
                spans.append((ts, ts + dur, e["name"]))
        device.sort()
        self.device = device
        keyed = [(i, launches[d[3]]) for i, d in enumerate(device)
                 if d[3] in launches]
        labels = innermost(spans, [t for _, t in keyed])
        self.span_of = [None] * len(device)
        for (i, _), label in zip(keyed, labels):
            self.span_of[i] = label
        self.unattributed = len(device) - len(keyed)
        self._spans = spans
        self._layer_at = layer_at

    def device_ms_by_span(self) -> dict:
        """Device ms a unit by innermost program span ("none": launched
        outside every program span)."""
        out: dict = defaultdict(float)
        for (s, e, _, _), span in zip(self.device, self.span_of):
            out[span or "none"] += (e - s) / 1e3
        return {k: v / self.units for k, v in
                sorted(out.items(), key=lambda kv: -kv[1])}

    def plumbing_ms_per_unit(self, layer: str):
        """Device ms a unit of the operations launched inside ``layer.*``
        spans and outside any ``kernel.*`` span: what a crossing does
        beyond its hand-written kernels."""
        us = sum(e - s for (s, e, _, _), span in zip(self.device,
                                                     self.span_of)
                 if span is not None and span.startswith(layer + "."))
        return us / 1e3 / self.units if us > 0 else None

    def top_ops(self, n: int = 20) -> list:
        """``[op, span, seconds]`` of the pairs that took most time."""
        by: dict = defaultdict(float)
        for (s, e, name, _), span in zip(self.device, self.span_of):
            by[(name[:96], span or "none")] += (e - s) / 1e6
        return [[k[0], k[1], v] for k, v in
                sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 12) -> list:
        """Idle device seconds between operations, by the innermost
        program span open when the gap began, else the layer range, else
        "outside the named layers"; largest first."""
        from perfbench import stats
        busy = stats.merged((s, e) for s, e, _, _ in self.device)
        starts = [end for (_, end), _ in zip(busy, busy[1:])]
        labels = innermost(self._spans, starts)
        by: dict = defaultdict(float)
        for ((_, end), (start, _)), label in zip(zip(busy, busy[1:]),
                                                 labels):
            if label is None and self._layer_at is not None:
                label = self._layer_at(end)
            by[label or OUTSIDE] += (start - end) / 1e6
        return sorted(([k, v] for k, v in by.items()),
                      key=lambda kv: -kv[1])[:n]


# -- running a cell ---------------------------------------------------------------


def profile_doc(run_units, units: int, ranges=None) -> tuple:
    """``(doc, wall_s)``: ``run_units(units)`` under the profiler, card
    and host, with the layer ranges and the program's profiler ranges
    on."""
    import torch
    from torch.profiler import ProfilerActivity

    from repro_torch.obs import trace
    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    if cuda:
        torch.cuda.synchronize()
    trace.enable(ranges=True)
    if ranges is not None:
        ranges.on = True
    try:
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            run_units(units)
            if cuda:
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        if ranges is not None:
            ranges.on = False
        trace.disable()
    fd, path = tempfile.mkstemp(suffix=".json", prefix="perfbench-spans-")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            doc = json.load(f)
    finally:
        os.remove(path)
    return doc, wall


def _layers(doc, wall, units, layers) -> dict:
    """The layers segment read by the drivers' layer ranges and by the
    program's spans."""
    from perfbench import tracing
    seg = tracing.Segment(doc, wall, units, set(layers))
    attr = ProgramAttribution(doc, units, seg.range_at)
    return {"units": units,
            "layer_range_device_ms_per_unit": {
                k: v / units / 1e3 for k, v in seg.layer_us.items()},
            "device_ms_by_span": attr.device_ms_by_span(),
            "plumbing_ms_per_unit": {
                layer: attr.plumbing_ms_per_unit(layer)
                for layer in ("pageio", "crossing")},
            "top_ops": attr.top_ops(),
            "idle_gaps": attr.idle_gaps(),
            "idle_gaps_by_layer_range": seg.idle_gaps(),
            "unattributed": attr.unattributed}


def run_serve(cell, seed: int, seconds: float, spans: str, device) -> dict:
    import torch

    from perfbench.drivers import serve
    from perfbench.harness import Collections
    from repro_torch.obs import trace
    wl = cell.workload
    eng, tr, _, ranges = serve.build(cell, seed, device, trace=True)
    eng.tracer = trace.SpanTracer(pid=0, capacity=1 << 22)
    process = trace.SpanTracer(tid=1, capacity=1 << 20)
    on_ticks: set = set()
    try:
        if spans == "1":
            trace.enable(process)
        tr.tick()
        tr.run_until(tr.origin + wl["warmup_s"])
        if device.type == "cuda":
            torch.cuda.synchronize()
        t0 = tr.origin + wl["warmup_s"]
        with Collections() as collections:
            while time.perf_counter() < t0 + seconds:
                on = spans == "1" or (spans == "alt" and eng.tick % 2 == 0)
                if spans == "alt":
                    if on:
                        trace.enable(process)
                    else:
                        trace.disable()
                before = eng.tick
                tr.tick()
                if on and eng.tick > before:
                    on_ticks.add(eng.tick)
        trace.disable()
        t1 = tr.ticks[-1]
        window = {i + 1 for i, t in enumerate(tr.ticks) if t0 < t <= t1}
        events = eng.tracer.events()
        out = {"window_s": t1 - t0, "ticks": len(window),
               "dropped": eng.tracer.dropped, "gc": collections.reading()}
        sets = {"all": window} if spans != "alt" else {
            "on": window & on_ticks, "off": window - on_ticks}
        if eng.tracer.dropped:
            # The ring let spans go: a sum over the window would be short.
            sets = {}
            out["lost"] = f"the tracer dropped {eng.tracer.dropped} spans"
        for key, ticks in sets.items():
            w = WindowSpans(events, ticks)
            out[key] = {
                "ticks": len(ticks),
                "host_ms_per_tick_self": w.self_ms_per_tick(),
                "dispatch_ms_per_tick": w.ms_per_tick("decode_dispatch"),
                "admit_ms_per_tick": w.ms_per_tick("tick_begin"),
                "model_host_ms_per_tick": w.ms_per_tick("model."),
                "pageio_host_ms_per_tick": w.ms_per_tick("pageio."),
                "live_page_share": w.live_page_share()}
        if sets and not tr.closed and spans == "1":
            waits = queue_waits(events, list(tr.recs.values()), t0, t1)
            if waits:
                from perfbench import stats
                out["queue_wait_ms"] = {
                    "n": len(waits),
                    "p50": stats.percentile(waits, 50) * 1e3,
                    "p90": stats.percentile(waits, 90) * 1e3,
                    "max": max(waits) * 1e3}
        t = wl["trace"]
        doc, wall = profile_doc(tr.run_ticks, t["layer_ticks"], ranges)
        out["layers"] = _layers(doc, wall, t["layer_ticks"], ranges.layers)
    finally:
        trace.disable()
        ranges.close()
    return out


def run_train(cell, seed: int, seconds: float, spans: str, device) -> dict:
    import torch

    from perfbench import tracing
    from perfbench.drivers import train
    from perfbench.harness import Collections
    from repro_torch.obs import trace
    wl = cell.workload
    ranges = tracing.Ranges(train.TARGETS)
    process = trace.SpanTracer(tid=1, capacity=1 << 22)
    try:
        prog = train.Program(cell, seed, device)
        prog.run_steps(wl["checked_steps"])
        if device.type == "cuda":
            torch.cuda.synchronize()
        if spans == "1":
            trace.enable(process)
        t0 = time.perf_counter()
        n = 0
        with Collections() as collections:
            while time.perf_counter() - t0 < seconds:
                prog.step()
                n += 1
            if device.type == "cuda":
                torch.cuda.synchronize()
        t1 = time.perf_counter()
        trace.disable()
        out = {"window_s": t1 - t0, "steps": n,
               "train_step_ms": (t1 - t0) / n * 1e3 if n else None,
               "gc": collections.reading()}
        if spans == "1" and n:
            events = process.events()
            out["dropped"] = process.dropped
            child_us: dict = defaultdict(float)
            for e in events:
                if e.get("parent") is not None:
                    child_us[e["parent"]] += e["dur"]
            by: dict = defaultdict(float)
            for e in events:
                by[e["name"]] += (e["dur"] - child_us[e["id"]]) / 1e3
            out["host_ms_per_step_self"] = {
                k: v / n for k, v in sorted(by.items(),
                                            key=lambda kv: -kv[1])}
        units = wl["trace"]["layer_steps"]
        doc, wall = profile_doc(prog.run_steps, units, ranges)
        out["layers"] = _layers(doc, wall, units, ranges.layers)
    finally:
        trace.disable()
        ranges.close()
    return out


def span_cost_us(n: int = 20000) -> dict:
    """Host µs a span costs here: off, on, on with profiler ranges (no
    profiler recording)."""
    from repro_torch.obs import trace

    def timed():
        t = time.perf_counter()
        for _ in range(n):
            with trace.span("pageio.bind"):
                pass
        return (time.perf_counter() - t) / n * 1e6

    out = {"off": timed()}
    trace.enable(trace.SpanTracer(capacity=n))
    out["on"] = timed()
    trace.enable(ranges=True)
    out["on_ranges"] = timed()
    trace.disable()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=45.0)
    ap.add_argument("--spans", choices=("1", "alt"), default="1")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    os.environ["OMP_NUM_THREADS"] = os.environ["MKL_NUM_THREADS"] = "1"
    import torch
    torch.set_num_threads(1)

    from perfbench import harness
    cell = harness.Cell(harness.load_bench(ROOT), args.workload, ROOT)
    device = torch.device("cuda", 0) if torch.cuda.is_available() \
        else torch.device("cpu")
    run = run_train if cell.workload["kind"] == "train" else run_serve
    out = {"workload": args.workload, "seed": args.seed, "spans": args.spans,
           "device": (torch.cuda.get_device_name(0) if device.type == "cuda"
                      else "cpu"),
           **run(cell, args.seed, args.seconds, args.spans, device),
           "span_cost_us": span_cost_us()}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
