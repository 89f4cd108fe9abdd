"""``perfbench/spans.py``: the program's spans read from a profiler
trace and from an engine's tracer.

A synthetic Chrome trace holds the drivers' layer ranges and the
program's spans: the existing layer attribution reads the same with the
program's spans in it as without, and the program attribution gives the
hand-computed device time by span, the plumbing, and idle gaps whose
seconds add up to the same total.  A smoke cell runs through the probe
on the CPU."""

import pytest
import torch

from perfbench import spans, tracing
from perfbench.tests import smoke


def _x(name, cat, ts, dur, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "args": args}


def _doc(program: bool) -> dict:
    """Two units.  Host: layer range ``pageio`` 0-100 holding program
    spans ``pageio.read`` 0-100 > ``pageio.bind`` 10-30 and
    ``kernel.fused_crypt_mac`` 40-50; layer range ``model`` 200-300 with
    ``model.decode`` 200-300 > ``gc`` 250-270.  Device: a kernel per
    launch."""
    events = [_x("pageio", "user_annotation", 0, 100),
              _x("model", "user_annotation", 200, 100)]
    if program:
        events += [_x("pageio.read", "user_annotation", 0, 100),
                   _x("pageio.bind", "user_annotation", 10, 20),
                   _x("kernel.fused_crypt_mac", "user_annotation", 40, 10),
                   _x("model.decode", "user_annotation", 200, 100),
                   _x("gc", "user_annotation", 250, 20, generation=2),
                   _x("tick", "user_annotation", 0, 400)]
    launches = [(1, 5), (2, 15), (3, 45), (4, 60), (5, 210), (6, 260),
                (7, 350)]
    device = [(1, 100, 10, "copy"), (2, 110, 20, "where"),
              (3, 130, 5, "fused_crypt_mac_kernel"), (4, 135, 15, "cat"),
              (5, 300, 40, "gemm"), (6, 360, 10, "add"),
              (7, 400, 30, "reduce")]
    events += [_x("cudaLaunchKernel", "cuda_runtime", ts, 1, correlation=c)
               for c, ts in launches]
    events += [_x(name, "kernel", ts, dur, correlation=c)
               for c, ts, dur, name in device]
    return {"traceEvents": events}


def test_layer_readings_ignore_the_program_spans():
    without, with_spans = (tracing.Segment(_doc(p), 1.0, 2,
                                           {"pageio", "model"})
                           for p in (False, True))
    assert dict(with_spans.layer_us) == dict(without.layer_us) == {
        "pageio": 50.0, "model": 50.0}
    assert with_spans.idle_gaps() == without.idle_gaps()
    assert with_spans.launch_count == without.launch_count == 7
    assert with_spans.busy_s() == without.busy_s()


def test_program_attribution_by_hand():
    doc = _doc(True)
    seg = tracing.Segment(doc, 1.0, 2, {"pageio", "model"})
    attr = spans.ProgramAttribution(doc, 2, seg.range_at)
    # copy (5) and cat (60) under pageio.read, where (15) under
    # pageio.bind, the kernel (45) under its span, gemm (210) under
    # model.decode, add (260) under gc, reduce (350) outside.
    assert attr.device_ms_by_span() == pytest.approx({
        "model.decode": 0.040 / 2, "pageio.read": 0.025 / 2,
        "pageio.bind": 0.020 / 2, "none": 0.030 / 2, "gc": 0.010 / 2,
        "kernel.fused_crypt_mac": 0.005 / 2})
    assert attr.plumbing_ms_per_unit("pageio") == pytest.approx(0.045 / 2)
    assert attr.plumbing_ms_per_unit("crossing") is None
    assert attr.unattributed == 0
    assert attr.top_ops(2) == [["gemm", "model.decode", 40e-6],
                               ["reduce", "none", 30e-6]]
    # Busy 100-150, 300-340, 360-370, 400-430: gaps begin at 150
    # (nothing open: layer range none -> outside), 340 and 370 (outside).
    gaps = dict(attr.idle_gaps())
    assert gaps == pytest.approx({spans.OUTSIDE: 150e-6 + 20e-6 + 30e-6})
    assert sum(gaps.values()) == pytest.approx(
        sum(v for _, v in seg.idle_gaps()))


def test_idle_gaps_take_the_innermost_program_span():
    doc = {"traceEvents": [
        _x("model", "user_annotation", 0, 100),
        _x("model.decode", "user_annotation", 0, 100),
        _x("gc", "user_annotation", 20, 30, generation=2),
        _x("pageio", "user_annotation", 100, 50),
        _x("k", "kernel", 0, 10, correlation=None),
        _x("k", "kernel", 30, 10, correlation=None),
        _x("k", "kernel", 60, 10, correlation=None),
        _x("k", "kernel", 120, 10, correlation=None),
        _x("k", "kernel", 160, 10, correlation=None)]}
    seg = tracing.Segment(doc, 1.0, 1, {"model", "pageio"})
    attr = spans.ProgramAttribution(doc, 1, seg.range_at)
    # Gaps begin at 10 (model.decode), 40 (gc), 70 (model.decode), 130
    # (no program span: the layer range pageio).
    assert dict(attr.idle_gaps()) == pytest.approx({
        "model.decode": 20e-6 + 50e-6, "gc": 20e-6, "pageio": 30e-6})
    assert attr.unattributed == 5


def _span(i, name, ts, dur, parent=None, **args):
    return {"id": i, "name": name, "ts": ts, "dur": dur, "parent": parent,
            "args": args}


def test_window_spans_by_hand():
    events = [
        _span(1, "tick", 0, 100, tick=1),
        _span(2, "decode_dispatch", 0, 80, 1, pages_crossed=32,
              pages_live=8),
        _span(3, "pageio.read", 0, 30, 2),
        _span(4, "pageio.bind", 5, 10, 3),
        _span(5, "model.decode", 30, 40, 2),
        _span(6, "request.queued", -50, 60, 1, rid=0),
        _span(7, "tick", 100, 100, tick=2),
        _span(8, "decode_dispatch", 100, 50, 7, pages_crossed=32,
              pages_live=24),
        _span(9, "pageio.read", 100, 20, 8),
    ]
    w = spans.WindowSpans(events, {1, 2})
    assert w.ms_per_tick("pageio.") == pytest.approx((30 + 20) / 1e3 / 2)
    assert w.ms_per_tick("model.") == pytest.approx(40 / 1e3 / 2)
    assert w.live_page_share() == pytest.approx(50.0)
    got = w.self_ms_per_tick()
    assert got["pageio.read"] == pytest.approx((20 + 20) / 1e3 / 2)
    assert got["decode_dispatch"] == pytest.approx((10 + 30) / 1e3 / 2)
    assert got["tick"] == pytest.approx((20 + 50) / 1e3 / 2)
    assert "request.queued" not in got
    assert spans.WindowSpans(events, {2}).live_page_share() == 75.0


def test_queue_waits_count_the_unadmitted_with_their_wait_so_far():
    from repro_torch.obs.trace import perf_counter_of
    t1 = perf_counter_of(1000.0)
    events = [_span(1, "request.queued", 0.0, 500.0, rid=0),
              _span(2, "request.queued", 800.0, 400.0, rid=2)]
    recs = [{"rid": 0, "submit": perf_counter_of(0.0), "failed": False},
            {"rid": 1, "submit": perf_counter_of(900.0), "failed": False},
            {"rid": 2, "submit": perf_counter_of(800.0), "failed": False},
            {"rid": None, "submit": perf_counter_of(10.0), "failed": True}]
    waits = spans.queue_waits(events, recs, perf_counter_of(0.0), t1)
    assert waits == pytest.approx([500e-6, 100e-6, 200e-6], abs=1e-9)


def test_a_smoke_cell_through_the_probe_on_the_cpu():
    cell = smoke.cell("smoke.chat")
    out = spans.run_serve(cell, 2_200_000_003, 4.0, "1", torch.device("cpu"))
    w = out["all"]
    assert out["dropped"] == 0 and w["ticks"] > 0
    assert 0 < w["live_page_share"] <= 100
    assert w["model_host_ms_per_tick"] > 0 and w["pageio_host_ms_per_tick"] > 0
    assert w["pageio_host_ms_per_tick"] <= w["dispatch_ms_per_tick"] + \
        w["admit_ms_per_tick"]
    assert out["queue_wait_ms"]["n"] > 0
    assert out["layers"]["plumbing_ms_per_unit"] == {"pageio": None,
                                                     "crossing": None}
