"""Port observability (``repro_torch.obs``, the engine's metrics, trace,
audit and SLO wiring) against the JAX package.

* The registry, histogram, tracer and audit-chain units of
  ``tests/test_obs.py`` on the port's copies; the declared names and
  help strings equal the reference's.
* Engine parity for all 7 schemes: two tenants, a rotation every tick
  (so eager reseals fire), a prefix cache (insert, hit, copy-on-write,
  reseal-on-share), ``audit=True`` and ``trace=True`` on both sides.  Tokens, every
  counter (the kernel-route ones aside: the reference runs without its
  kernels here) and the audit event sequence are equal; the events are
  compared field for field except ``ts``, ``prev``, ``hash`` and
  ``detail``.
* Snapshot, Prometheus text, nested phase spans, and the launcher's
  observability flags on the port's engine.
* The SLO cases of ``tests/test_slo.py`` on the port's engine.
"""

import contextlib
import gc
import json
import re
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_arch as j_get_arch
from repro.obs import metrics as j_metrics
from repro.serve.engine import SecureServingEngine as JEngine
from repro.tenancy import KeyHierarchy as JHierarchy
from repro.tenancy import TenantRegistry as JRegistry
from repro_torch.configs import get_arch
from repro_torch.convert import params_from_numpy
from repro_torch.launch import serve as launch
from repro_torch.obs import metrics as metrics_mod
from repro_torch.obs.audit import AuditLog
from repro_torch.obs.metrics import (ENGINE_COUNTERS, Histogram,
                                     MetricsRegistry, StatsView)
from repro_torch.obs.slo import SLOMonitor, merge_health
from repro_torch.obs import trace as trace_mod
from repro_torch.obs.trace import SpanTracer
from repro_torch.serve.engine import STAT_NAMES, SecureServingEngine
from repro_torch.tenancy import KeyHierarchy, TenantRegistry
from test_torch_models import numpy_params, port_test_env  # noqa: F401

SCHEMES = ["off", "sgx64", "sgx512", "mgx64", "mgx512", "seda", "seda512"]
# Counters that depend on whether a side runs its kernels (the reference
# runs its plain route here, the port its kernel wrappers).
KERNEL_ROUTE = ("fused_mixed_ticks", "fused_write_ticks")
AUDIT_SKIP = ("ts", "prev", "hash", "detail")


@pytest.fixture(scope="module")
def smoke():
    j_arch = j_get_arch("minitron-4b")
    j_cfg = j_arch.make_smoke_config()
    np_params = numpy_params(j_cfg)
    j_params = jax.tree_util.tree_map(jnp.asarray, np_params)
    arch = get_arch("minitron-4b")
    cfg = arch.make_smoke_config()
    params = params_from_numpy(cfg, np_params, device="cpu")
    return j_arch, j_cfg, j_params, arch, cfg, params


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.default_rng(0)
    return [list(map(int, rng.integers(1, 256, n))) for n in (5, 7, 9)]


def _engine(smoke, **kw):
    _, _, _, arch, cfg, params = smoke
    kw.setdefault("max_slots", 2)
    kw.setdefault("page_tokens", 4)
    kw.setdefault("pages_per_slot", 4)
    return SecureServingEngine(arch, cfg, params, device="cpu", **kw)


def audit_events(log) -> list:
    """Audit records without the fields that differ run to run."""
    return [{k: v for k, v in r.items() if k not in AUDIT_SKIP}
            for r in log.records()]


# ---------------------------------------------------------------------------
# Units (tests/test_obs.py).
# ---------------------------------------------------------------------------


class TestRegistry:
    def test_declarations_match_reference(self):
        assert metrics_mod.ENGINE_COUNTERS == j_metrics.ENGINE_COUNTERS
        assert metrics_mod.ENGINE_HISTOGRAMS == j_metrics.ENGINE_HISTOGRAMS
        assert metrics_mod.CLUSTER_COUNTERS == j_metrics.CLUSTER_COUNTERS
        assert metrics_mod.ENGINE_GAUGES == j_metrics.ENGINE_GAUGES
        assert STAT_NAMES == tuple(j_metrics.ENGINE_COUNTERS)

    def test_counters_snapshot_and_reset(self):
        reg = MetricsRegistry()
        reg.counter("a", "first").inc()
        reg.counter("a").inc(4)
        reg.gauge("g").set(7)
        reg.histogram("h").observe(2.5)
        snap = reg.snapshot(labels={"shard": "0"})
        assert snap["counters"] == {"a": 5}
        assert snap["gauges"] == {"g": 7}
        assert snap["histograms"]["h"]["count"] == 1
        assert snap["labels"] == {"shard": "0"}
        reg.reset()
        snap = reg.snapshot()
        assert snap["counters"] == {"a": 0}
        assert snap["histograms"]["h"]["count"] == 0

    def test_stats_view_dict_api(self):
        reg = MetricsRegistry()
        for name, help_ in ENGINE_COUNTERS.items():
            reg.counter(name, help_)
        stats = StatsView(reg)
        stats["admitted"] += 1
        stats["admitted"] += 2
        assert stats["admitted"] == 3
        assert dict(stats)["admitted"] == 3
        assert "admitted" in stats
        assert set(stats.keys()) == set(ENGINE_COUNTERS)
        assert len(stats) == len(ENGINE_COUNTERS)
        with pytest.raises(KeyError):
            stats.__getitem__("never_declared")

    def test_autodeclare_unknown_key(self):
        reg = MetricsRegistry()
        stats = StatsView(reg)
        stats["brand_new"] = 3
        assert reg.counters["brand_new"].value == 3
        assert stats["brand_new"] == 3

    def test_kind_conflict_rejected(self):
        reg = MetricsRegistry()
        reg.counter("x")
        with pytest.raises(ValueError):
            reg.gauge("x")
        with pytest.raises(ValueError):
            reg.histogram("x")

    def test_lazy_gauge_and_labels(self):
        reg = MetricsRegistry()
        backing = {"t0": 4, "t1": 2}
        reg.gauge("resident", fn=lambda: dict(backing), label="tenant")
        backing["t0"] = 9
        assert reg.snapshot()["gauges"]["resident"] == {"t0": 9, "t1": 2}

    def test_prometheus_text(self):
        reg = MetricsRegistry()
        reg.counter("ticks", "engine ticks").inc(3)
        reg.gauge("free", "free pages").set(11)
        reg.gauge("resident", fn=lambda: {"t0": 4}, label="tenant")
        reg.histogram("lat").observe(1.0)
        text = reg.prometheus(labels={"shard": "1"})
        assert "# TYPE repro_ticks counter" in text
        assert 'repro_ticks{shard="1"} 3' in text
        assert 'repro_free{shard="1"} 11' in text
        assert 'repro_resident{shard="1",tenant="t0"} 4' in text
        assert 'repro_lat_count{shard="1"} 1' in text

    def test_prometheus_escaping_parses_back(self):
        reg = MetricsRegistry()
        evil = 'a\\b"c\nd'
        reg.gauge("resident", 'help \\ with\nnewline',
                  fn=lambda: {evil: 7}, label="tenant")
        reg.counter("ticks", "plain").inc(2)
        text = reg.prometheus(labels={"shard": evil})
        samples, helps = {}, {}
        for line in text.splitlines():
            if line.startswith("# HELP "):
                name, help_ = line[7:].split(" ", 1)
                helps[name] = help_
                continue
            if line.startswith("#") or not line:
                continue
            name_part, value = line.rsplit(" ", 1)
            labels = {}
            if "{" in name_part:
                name, rest = name_part.split("{", 1)
                body = rest.rsplit("}", 1)[0]
                for m in re.finditer(r'(\w+)="((?:[^"\\]|\\.)*)"', body):
                    raw = m.group(2)
                    assert "\n" not in raw
                    labels[m.group(1)] = (raw.replace("\\n", "\n")
                                          .replace('\\"', '"')
                                          .replace("\\\\", "\\"))
            else:
                name = name_part
            samples[(name, tuple(sorted(labels.items())))] = float(value)
        assert samples[("repro_resident",
                        (("shard", evil), ("tenant", evil)))] == 7
        assert "\n" not in helps["repro_resident"]
        assert helps["repro_resident"].replace("\\n", "\n").replace(
            "\\\\", "\\") == 'help \\ with\nnewline'
        assert "# TYPE repro_resident gauge" in text


class TestHistogram:
    def test_percentiles_match_numpy(self):
        rng = np.random.default_rng(7)
        xs = rng.normal(size=257).tolist()
        h = Histogram("lat")
        for x in xs:
            h.observe(x)
        for q in (0, 5, 25, 50, 75, 90, 95, 99, 100):
            want = float(np.percentile(xs, q, method="linear"))
            assert h.percentile(q) == pytest.approx(want, rel=1e-12, abs=0)
        assert h.count == len(xs)
        assert h.min == min(xs) and h.max == max(xs)

    def test_sample_window_rolls_but_totals_persist(self):
        h = Histogram("lat", max_samples=4)
        for v in range(10):
            h.observe(v)
        assert h.count == 10 and h.sum == sum(range(10))
        assert h.samples == [6.0, 7.0, 8.0, 9.0]


class TestTrace:
    def test_chrome_trace_json(self, tmp_path):
        tr = SpanTracer(pid=3, tid=1)
        with tr.span("outer", tick=0):
            with tr.span("inner"):
                pass
        path = tmp_path / "trace.json"
        doc = tr.export(str(path))
        loaded = json.loads(path.read_text())
        assert loaded == doc
        events = loaded["traceEvents"]
        assert [e["name"] for e in events] == ["outer", "inner"]
        for e in events:
            assert e["ph"] == "X"
            assert e["pid"] == 3 and e["tid"] == 1
            assert e["dur"] >= 0
        outer, inner = events
        assert outer["ts"] <= inner["ts"]
        assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"] + 1e-6

    def test_ring_buffer_bounded(self):
        tr = SpanTracer(capacity=8)
        for i in range(20):
            tr.add(f"s{i}", 0, 1000)
        events = tr.events()
        assert len(events) == 8
        assert events[0]["name"] == "s12"

    def test_ring_buffer_counts_what_it_drops(self):
        tr = SpanTracer(capacity=8)
        for i in range(8):
            tr.add(f"s{i}", 0, 1000)
        assert tr.dropped == 0
        for i in range(5):
            with tr.span("late"):
                pass
        assert tr.dropped == 5 and len(tr) == 8
        tr.clear()
        assert tr.dropped == 0 and len(tr) == 0

    def test_parent_is_the_innermost_open_span(self):
        tr = SpanTracer()
        with tr.span("a"):
            with tr.span("b", k=1):
                tr.annotate(late=2)
            tr.add("c", 0, 1)
        a, b, c = (next(e for e in tr.events() if e["name"] == n)
                   for n in "abc")
        assert a["parent"] is None
        assert b["parent"] == a["id"] and c["parent"] == a["id"]
        assert b["args"] == {"k": 1, "late": 2}
        assert len({a["id"], b["id"], c["id"]}) == 3

    def test_events_survive_a_collection_while_read(self):
        """A collector pass while ``events()`` reads the ring records its
        ``gc`` span into that ring; the read still gives what was there."""
        tr = SpanTracer()
        for i in range(200):
            tr.add(f"s{i}", 0, 1000, {"k": i})
        threshold = gc.get_threshold()
        trace_mod.enable(tr)
        gc.set_threshold(1)
        try:
            events = tr.events()
        finally:
            gc.set_threshold(*threshold)
            trace_mod.disable()
        assert [e["name"] for e in events] == [f"s{i}" for i in range(200)]
        assert any(e["name"] == "gc" for e in tr.events())

    def test_spans_off_make_no_clock_or_profiler_call(self, monkeypatch):
        calls = []
        real = time.perf_counter_ns

        class Clock:
            @staticmethod
            def perf_counter_ns():
                calls.append(1)
                return real()

        monkeypatch.setattr(trace_mod, "time", Clock)
        monkeypatch.setattr(trace_mod, "_record_function", lambda name: (
            calls.append(name), contextlib.nullcontext())[1])
        assert trace_mod._active is None
        with trace_mod.span("pageio.read", x=1) as sp:
            trace_mod.record("request.queued", 0, rid=1)
        assert sp is trace_mod.span("model.decode") and calls == []
        process = trace_mod.enable(SpanTracer())
        try:
            with trace_mod.span("pageio.read"):
                pass
            assert len(process) == 1 and calls == [1, 1]
            trace_mod.enable(ranges=True)
            with trace_mod.span("model.decode"):
                pass
            assert "model.decode" in calls
        finally:
            assert trace_mod.disable() is process
        assert trace_mod._active is None and not trace_mod._ranges

    def test_gc_passes_are_spans_while_on(self):
        process = trace_mod.enable(SpanTracer())
        try:
            with trace_mod.span("model.decode"):
                gc.collect()
        finally:
            trace_mod.disable()
        events = process.events()
        (outer,) = [e for e in events if e["name"] == "model.decode"]
        passes = [e for e in events if e["name"] == "gc"]
        assert any(e["args"]["generation"] == 2 and
                   e["parent"] == outer["id"] for e in passes)
        n = len(process)
        gc.collect()
        assert len(process) == n

    def test_phase_spans_nested(self, smoke, prompts):
        eng = _engine(smoke, scheme="seda", use_kernel=True, trace=True)
        for p in prompts[:2]:
            eng.submit(prompt=p, max_new_tokens=4)
        eng.run()
        events = eng.tracer.events()
        ticks = [e for e in events if e["name"] == "tick"]
        phases = [e for e in events if e["name"] in (
            "tick_begin", "decode_dispatch", "decode_collect", "tick_end")]
        assert ticks and phases
        assert {e["name"] for e in phases} == {
            "tick_begin", "decode_dispatch", "decode_collect", "tick_end"}
        for ph in phases:
            assert any(t["ts"] - 1e-6 <= ph["ts"] and
                       ph["ts"] + ph["dur"] <= t["ts"] + t["dur"] + 1e-6
                       for t in ticks), ph["name"]
        hists = eng.snapshot()["histograms"]
        assert hists["tick_seconds"]["count"] == len(ticks)
        assert hists["phase_decode_collect_seconds"]["count"] == \
            eng.stats["decode_steps"]


class TestAudit:
    def _log(self, n=5):
        log = AuditLog()
        for i in range(n):
            log.append("rotation", tenant=f"t{i % 2}", new_epoch=i)
        return log

    def test_chain_verifies_and_round_trips(self, tmp_path):
        log = self._log()
        assert len(log) == 5
        assert log.verify_chain()
        assert log.records()[0]["prev"] == "0" * 64
        path = tmp_path / "audit.jsonl"
        log.dump(str(path))
        loaded = AuditLog.load(str(path))
        assert loaded.verify_chain()
        assert loaded.head == log.head
        assert len(loaded.events("rotation")) == 5

    def test_tamper_detected(self):
        log = self._log()
        log._records[2]["tenant"] = "t9"            # one field edited
        assert not log.verify_chain()
        log = self._log()
        del log._records[1]                         # truncation / drop
        assert not log.verify_chain()
        log = self._log()
        log._records[1], log._records[2] = \
            log._records[2], log._records[1]        # reorder
        assert not log.verify_chain()
        log = self._log()
        log._records[4]["hash"] = "f" * 64          # forged head
        assert not log.verify_chain()

    def test_reserved_fields_rejected(self):
        log = AuditLog()
        with pytest.raises(ValueError):
            log.append("rotation", seq=3)
        with pytest.raises(ValueError):
            log.append("rotation", hash="x")


# ---------------------------------------------------------------------------
# The engine against the reference.
# ---------------------------------------------------------------------------


def _tenant_run(engine_cls, registry_cls, hierarchy_cls, model, prompts,
                **kw):
    """Two tenants, a rotation every tick, the prefix cache: tenant
    a's prompt twice (miss + insert, then a hit with copy-on-write),
    tenant b's once, then a's prompt reseal-shared with b and b's
    request with it (a hit)."""
    reg = registry_cls(hierarchy_cls(2, **kw.pop("hier_kw", {})),
                       max_tenants=2)
    for name in "ab":
        reg.register(name)
    sa, sb = reg.open_session("a"), reg.open_session("b")
    eng = engine_cls(*model, registry=reg, rotate_every=1,
                     prefix_cache=True, prefix_cache_pages=8, max_slots=2,
                     page_tokens=4, pages_per_slot=4, n_pages=16,
                     defer_interval=3, audit=True, trace=True, **kw)
    shared = prompts[2][:6]             # one full page and a partial one
    rids = [eng.submit(prompt=shared, max_new_tokens=6, session=sa),
            eng.submit(prompt=prompts[1], max_new_tokens=5, session=sb)]
    eng.run()
    rids.append(eng.submit(prompt=shared + [7], max_new_tokens=4,
                           session=sa))
    eng.run()
    n_shared = eng.share_prefix(shared, from_session=sa, to_session=sb)
    rids.append(eng.submit(prompt=shared + [9], max_new_tokens=4,
                           session=sb))
    eng.run()
    return eng, [list(eng.requests[r].generated) for r in rids], n_shared


@pytest.mark.parametrize("scheme", SCHEMES)
def test_engine_counters_and_audit_match_reference(smoke, prompts, scheme):
    j_arch, j_cfg, j_params, arch, cfg, params = smoke
    j_eng, j_tokens, j_shared = _tenant_run(
        JEngine, JRegistry, JHierarchy, (j_arch, j_cfg, j_params), prompts,
        scheme=scheme, use_kernel=False)
    eng, tokens, n_shared = _tenant_run(
        SecureServingEngine, TenantRegistry, KeyHierarchy,
        (arch, cfg, params), prompts, scheme=scheme, use_kernel=True,
        device="cpu", hier_kw={"device": "cpu"})
    assert tokens == j_tokens
    assert n_shared == j_shared > 0
    for name in STAT_NAMES:
        if name not in KERNEL_ROUTE:
            assert eng.stats[name] == j_eng.stats[name], name
    assert (eng.stats["fused_write_ticks"] > 0) == (scheme == "seda")
    for name in ("audit_events", "integrity_verdicts", "rotations",
                 "reseals", "prefix_inserted_pages", "prefix_cow_pages"):
        assert eng.stats[name] > 0, name
    assert eng.stats["integrity_failures"] == 0
    assert audit_events(eng.audit) == audit_events(j_eng.audit)
    assert eng.audit.verify_chain()
    assert eng.stats["audit_events"] == len(eng.audit)
    assert eng.latency_stats() == j_eng.latency_stats()
    assert eng.n_free_pages == j_eng.n_free_pages
    j_snap, snap = j_eng.snapshot(), eng.snapshot()
    assert snap["counters"] == dict(eng.stats)
    for name in ("pool_free_pages", "pool_pages_total", "slots_active",
                 "waiting_requests", "tenant_resident_pages",
                 "prefix_cache_pages", "prefix_cache_refs"):
        assert snap["gauges"][name] == j_snap["gauges"][name], name
    for name in ("ttft_ticks", "decode_bucket"):
        assert snap["histograms"][name]["count"] == \
            j_snap["histograms"][name]["count"], name
        assert snap["histograms"][name]["sum"] == \
            j_snap["histograms"][name]["sum"], name


def test_snapshot_prometheus_and_proof_audit(smoke, prompts):
    reg = TenantRegistry(KeyHierarchy(2, device="cpu"), max_tenants=2)
    reg.register("a")
    sess = reg.open_session("a")
    eng = _engine(smoke, scheme="seda", use_kernel=True, registry=reg,
                  rotate_every=2, trace=True, audit=True)
    eng.submit(prompt=prompts[0], max_new_tokens=6, session=sess)
    eng.step()
    proof = eng.audit_proof(sess)
    eng.run()
    snap = eng.snapshot()
    assert snap["counters"]["admitted"] == 1
    assert snap["counters"]["decode_steps"] > 0
    assert snap["counters"]["rotations"] > 0
    assert snap["gauges"]["pool_free_pages"] == \
        snap["gauges"]["pool_pages_total"]          # drained engine
    assert snap["gauges"]["tenant_resident_pages"] == {"a": 0}
    assert snap["histograms"]["tick_seconds"]["count"] > 0
    assert snap["histograms"]["ttft_ticks"]["count"] == 1
    assert snap["histograms"]["ttft_seconds"]["count"] == 1
    rotations = eng.audit.events("rotation")
    assert rotations and rotations[0]["tenant"] == "a"
    (event,) = eng.audit.events("audit_proof")
    assert event["root"] == proof.root and event["tenant"] == "a"
    assert event["pages"] == len(proof.pages)
    assert eng.audit.verify_chain()
    assert snap["counters"]["audit_events"] == len(eng.audit)
    text = eng.prometheus()
    assert "# TYPE repro_admitted counter" in text
    assert 'repro_tenant_resident_pages{tenant="a"} 0' in text
    # An engine that never profiled prints the reference's declarations
    # of the three profiler gauges, and no sample.
    j_reg = j_metrics.MetricsRegistry()
    for name in ("protection_overhead_ratio",
                 "protection_overhead_flops_ratio", "roofline_utilization"):
        j_reg.gauge(name, j_metrics.ENGINE_GAUGES[name], label="bucket",
                    fn=dict)
        assert f"repro_{name}{{" not in text
    for line in j_reg.prometheus().splitlines():
        assert line in text.splitlines()
    with pytest.raises(ValueError, match="trace"):
        _engine(smoke, scheme="off").export_trace()


@pytest.fixture(scope="module")
def span_runs(smoke, prompts):
    """A two-tenant seda engine (kernel wrappers on, key rotation every
    other tick) run with the program's spans off, then on: ``{on:
    (engine, rids)}``."""
    runs = {}
    for on in (False, True):
        reg = TenantRegistry(KeyHierarchy(2, device="cpu"), max_tenants=2)
        for name in "ab":
            reg.register(name)
        sessions = [reg.open_session(name) for name in "ab"]
        eng = _engine(smoke, scheme="seda", use_kernel=True, registry=reg,
                      rotate_every=2, n_pages=16, trace=True)
        if on:
            trace_mod.enable()
        try:
            rids = [eng.submit(prompt=p, max_new_tokens=5,
                               session=sessions[i % 2])
                    for i, p in enumerate(prompts)]
            eng.run()
        finally:
            trace_mod.disable()
        runs[on] = (eng, rids)
    return runs


def test_graph_counters_declared_and_zero_on_the_cpu(span_runs):
    """The port's counters of its CUDA graphs are declared beside the
    reference's set, not in it, and stay 0 on CPU engines: their model
    steps run eagerly and capture nothing."""
    assert set(metrics_mod.GRAPH_COUNTERS) == {
        "decode_graph_replays", "prefill_graph_replays", "graph_captures"}
    assert all(metrics_mod.GRAPH_COUNTERS.values())
    assert not set(metrics_mod.GRAPH_COUNTERS) & set(STAT_NAMES)
    for eng, _ in span_runs.values():
        assert eng.stats["decode_steps"] > 0 and eng.stats["admitted"] > 0
        for name, help_ in metrics_mod.GRAPH_COUNTERS.items():
            assert eng.stats[name] == 0, name
            assert eng.metrics.counters[name].help == help_
        assert eng._graphs is None


def _chain(events, e) -> list:
    """The names of ``e``'s ancestors, innermost first."""
    by_id = {x["id"]: x for x in events}
    out = []
    while e.get("parent") is not None:
        e = by_id[e["parent"]]
        out.append(e["name"])
    return out


def test_tokens_equal_with_program_spans_on_and_off(span_runs):
    (off, off_rids), (on, on_rids) = span_runs[False], span_runs[True]
    assert [off.requests[r].generated for r in off_rids] == \
        [on.requests[r].generated for r in on_rids]
    assert dict(off.stats) == dict(on.stats)
    for a, b in zip((*off.pool.cts, off.pool.page_macs, off.pool.pool_mac),
                    (*on.pool.cts, on.pool.page_macs, on.pool.pool_mac)):
        assert np.array_equal(a.numpy(), b.numpy())
    assert {e["name"] for e in off.tracer.events()} == {
        "tick", "tick_begin", "decode_dispatch", "decode_collect",
        "tick_end"}


def test_program_spans_nest_under_the_tick_phases(span_runs):
    """Page IO and model spans sit under the tick phase that ran them
    (kernel spans wrap launches, so only on the card, in
    ``tests/test_torch_cuda.py``); each request's wait and admission
    carry its rid; the dispatch carries the pages it crossed."""
    eng, rids = span_runs[True]
    events = eng.tracer.events()
    names = {e["name"] for e in events}
    assert {"pageio.read", "pageio.write_dirty", "pageio.write",
            "pageio.write_prefill", "pageio.gather", "pageio.bind",
            "pageio.crypt", "pageio.verify", "pageio.layout",
            "pageio.scatter", "model.decode", "model.prefill",
            "model.sample", "request.queued", "request.admit"} <= names
    assert not any(n.startswith("kernel.") for n in names)
    for e in events:
        chain = _chain(events, e)
        if e["name"] in ("pageio.read", "model.decode"):
            assert chain == ["decode_dispatch", "tick"], e["name"]
        elif e["name"] == "pageio.write_prefill":
            assert chain == ["request.admit", "tick_begin", "tick"]
        elif e["name"] in ("pageio.gather", "pageio.bind", "pageio.verify",
                           "pageio.layout", "pageio.crypt",
                           "pageio.scatter"):
            assert chain[0].startswith("pageio."), (e["name"], chain)
            assert chain[-1] == "tick"
    queued = {e["args"]["rid"]: e for e in events
              if e["name"] == "request.queued"}
    assert sorted(queued) == sorted(rids)
    assert [queued[r]["args"]["tenant"] for r in rids] == ["a", "b", "a"]
    admits = [e for e in events if e["name"] == "request.admit"]
    assert sorted(e["args"]["rid"] for e in admits) == sorted(rids)
    for r in rids:
        (admit,) = [e for e in admits if e["args"]["rid"] == r]
        assert queued[r]["ts"] <= admit["ts"]
    dispatch = [e["args"] for e in events if e["name"] == "decode_dispatch"]
    assert len(dispatch) == eng.stats["decode_steps"]
    for args in dispatch:
        assert args["pages_crossed"] % eng.max_slots == 0
        assert 0 < args["pages_live"] <= args["pages_crossed"]


def test_engine_tick_without_spans_makes_no_profiler_call(
        smoke, prompts, monkeypatch):
    """Spans off: an engine without a tracer makes no clock call in the
    span helper and no record_function call; one with a tracer records
    its tick and phases, still with no record_function call."""
    calls = []
    real = time.perf_counter_ns

    class Clock:
        @staticmethod
        def perf_counter_ns():
            calls.append("clock")
            return real()

    monkeypatch.setattr(trace_mod, "time", Clock)
    monkeypatch.setattr(trace_mod, "_record_function", lambda name: (
        calls.append(name), contextlib.nullcontext())[1])
    for trace in (None, True):
        eng = _engine(smoke, scheme="seda", use_kernel=True, trace=trace)
        eng.submit(prompt=prompts[0], max_new_tokens=3)
        eng.step()
        eng.step()
        if trace is None:
            assert calls == [] and eng.tracer is None
    assert set(calls) == {"clock"}
    assert len(eng.tracer) == 10 and len(calls) == 20


def test_secure_train_step_spans_nest_the_weights_crossing():
    """A secure train step with the program's spans on (outside any
    engine: the process tracer): unprotect, forward/backward, AdamW and
    protect in that order, the crossing's stages inside their crossing;
    its new state equals the step's with the spans off."""
    import torch
    from repro_torch.core.secure_exec import SecureExecutor
    from repro_torch.core.secure_memory import SecureKeys
    from repro_torch.train import train_step as ts
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state

    def step(spans):
        params = {"w": torch.linspace(-1, 1, 96).reshape(8, 12),
                  "b": torch.zeros(12)}
        cfg = AdamWConfig()
        ex = SecureExecutor("seda", SecureKeys.derive(3, device="cpu"))
        region = ex.region_spec(params)
        state = ex.protect(params, region)

        def loss_fn(p, batch):
            loss = ((batch @ p["w"] + p["b"]) ** 2).mean()
            return loss, {}

        def train_step(s, opt, batch):
            params, ok = ex.unprotect(s, region)
            (loss, _), grads = ts.value_and_grad(loss_fn, params, batch)
            params, opt, _ = ts.adamw_update(grads, params, opt, cfg)
            return ex.protect(params, region, step=1), ok

        process = trace_mod.enable() if spans else None
        try:
            new, ok = train_step(state, init_opt_state(params, cfg),
                                 torch.ones(3, 8))
        finally:
            trace_mod.disable()
        return new, bool(ok), process

    (off, ok_off, _), (on, ok_on, process) = step(False), step(True)
    assert ok_off and ok_on
    assert all(torch.equal(a, b) for a, b in zip(off.ciphertexts,
                                                 on.ciphertexts))
    events = process.events()
    top = [e["name"] for e in sorted(events, key=lambda e: e["ts"])
           if e["parent"] is None and e["name"] != "gc"]
    assert top == ["crossing.unprotect", "train.forward_backward",
                   "optimizer.adamw", "crossing.protect"]
    for e in events:
        if e["name"] in ("crossing.bind", "crossing.to_bytes",
                         "crossing.from_bytes"):
            assert _chain(events, e)[-1] in ("crossing.protect",
                                             "crossing.unprotect")


def test_report_verdict_hooks(smoke):
    eng = _engine(smoke, scheme="seda")
    seen = []
    eng.page_io.verdict_hooks.append(lambda ok, op, ctx: seen.append(
        (ok, op, ctx)))
    eng.page_io.fault_hooks.append(lambda ok, op, ctx: ok and op != "bad")
    assert eng.page_io.report_verdict(np.bool_(True), "decode", slot=1)
    assert not eng.page_io.report_verdict(True, "bad")
    assert seen == [(True, "decode", {"slot": 1}), (False, "bad", {})]
    assert eng.stats["integrity_verdicts"] == 2
    assert eng.stats["integrity_failures"] == 1


def test_launcher_observability_files(tmp_path):
    out = {k: str(tmp_path / k) for k in ("trace.json", "metrics.json",
                                          "metrics.prom", "audit.jsonl")}
    got = launch.main([
        "--smoke", "--device", "cpu", "--batch", "2", "--prompt-len", "5",
        "--gen-len", "4", "--tenants", "2", "--rotate-every", "2",
        "--fault-tolerance", "--trace-out", out["trace.json"],
        "--metrics-json", out["metrics.json"],
        "--metrics-prom", out["metrics.prom"],
        "--audit-out", out["audit.jsonl"], "--slo-ttft-ms", "1e9",
        "--json-logs"])
    snap = json.loads(open(out["metrics.json"]).read())
    assert snap["counters"] == got["stats"]
    assert snap["counters"]["rotations"] > 0
    events = json.loads(open(out["trace.json"]).read())["traceEvents"]
    assert {"tick", "decode_dispatch", "pageio.read", "model.decode",
            "request.queued"} <= {e["name"] for e in events}
    assert trace_mod._active is None
    log = AuditLog.load(out["audit.jsonl"])
    assert log.verify_chain() and len(log) == got["stats"]["audit_events"]
    assert "# TYPE repro_rotations counter" in open(out["metrics.prom"]).read()
    with pytest.raises(SystemExit):
        launch.main(["--smoke", "--device", "cpu", "--engine", "simple",
                     "--audit-out", out["audit.jsonl"]])


# ---------------------------------------------------------------------------
# SLO (tests/test_slo.py) on the port's engine.
# ---------------------------------------------------------------------------


def _slo_engine(smoke, **kw):
    return _engine(smoke, use_kernel=True, **kw)


def _run_some(eng, prompts, n=4):
    for p in prompts:
        eng.submit(prompt=p, max_new_tokens=n)
    eng.run()


@pytest.fixture(scope="module")
def short_prompts():
    rng = np.random.default_rng(0)
    return [list(map(int, rng.integers(1, 256, n))) for n in (3, 4)]


class TestSLOBreaches:
    def test_stalled_tick_fires_counter_audit_and_health(self, smoke,
                                                         short_prompts):
        eng = _slo_engine(smoke, scheme="seda", audit=AuditLog())
        mon = SLOMonitor(stall_factor=2.0)
        mon.attach(eng)
        _run_some(eng, short_prompts)
        assert eng.stats["slo_stuck_ticks"] == 0
        assert not mon.hard_breach
        # An idle engine is never stuck, even an eternity later.
        assert mon.check_stalled(now=time.monotonic() + 1e6) is False
        assert eng.stats["slo_stuck_ticks"] == 0
        # Queued work and no tick for an eternity: stuck.
        eng.submit(prompt=short_prompts[0], max_new_tokens=2)
        mon.check_stalled(now=time.monotonic() + 1e6)
        assert eng.stats["slo_stuck_ticks"] == 1
        assert mon.hard_breach
        health = mon.health()
        assert health["status"] == "failing"
        assert health["stuck"] is True
        events = eng.audit.events("slo_breach")
        assert any(e["kind"] == "stuck_tick" for e in events)
        assert eng.audit.verify_chain()
        mon.check_stalled(now=time.monotonic() + 2e6)   # latched
        assert eng.stats["slo_stuck_ticks"] == 1
        _run_some(eng, short_prompts[:1], n=2)           # a tick clears it
        assert mon.check_stalled(now=mon._last_end + 1e-9) is False
        assert not mon.hard_breach

    def test_integrity_burst_fires_alarm(self, smoke, short_prompts):
        eng = _slo_engine(smoke, scheme="seda", audit=AuditLog())
        mon = SLOMonitor(integrity_window=16, integrity_threshold=0.5,
                         integrity_min_failures=3)
        mon.attach(eng)
        _run_some(eng, short_prompts)
        assert eng.stats["slo_integrity_alarms"] == 0
        for _ in range(4):
            for hook in eng.page_io.verdict_hooks:
                hook(False, "read", {"slot": 0})
        assert eng.stats["slo_integrity_alarms"] == 1
        assert mon.hard_breach
        health = mon.health()
        assert health["status"] == "failing"
        assert health["integrity"]["alarm"] is True
        assert health["integrity"]["failures"] >= 3
        events = eng.audit.events("slo_breach")
        assert any(e["kind"] == "integrity_rate" for e in events)
        for hook in eng.page_io.verdict_hooks:          # no double count
            hook(False, "read", {"slot": 0})
        assert eng.stats["slo_integrity_alarms"] == 1
        for _ in range(64):
            for hook in eng.page_io.verdict_hooks:
                hook(True, "read", {"slot": 0})
        assert not mon.hard_breach

    def test_ttft_breach_per_tenant(self, smoke, short_prompts):
        eng = _slo_engine(smoke, scheme="off", audit=AuditLog())
        mon = SLOMonitor(ttft_ms=1e-6)
        mon.attach(eng)
        _run_some(eng, short_prompts)
        assert eng.stats["slo_ttft_breaches"] == len(short_prompts)
        health = mon.health()
        assert health["tenants"]["default"]["breaches"] == len(short_prompts)
        assert health["status"] == "degraded"
        assert not mon.hard_breach

    def test_tick_p99_breach(self, smoke, short_prompts):
        eng = _slo_engine(smoke, scheme="off")
        mon = SLOMonitor(p99_tick_ms=1e-9, min_ticks=2)
        mon.attach(eng)
        _run_some(eng, short_prompts)
        assert eng.stats["slo_tick_p99_breaches"] == 1
        assert mon.health()["ticks"]["p99_breached"] is True


class TestSLOContract:
    def test_tokens_bit_identical_with_monitor(self, smoke, short_prompts):
        bare = _slo_engine(smoke, scheme="seda")
        rids = [bare.submit(prompt=p, max_new_tokens=4)
                for p in short_prompts]
        want = [bare.run()[r].generated for r in rids]
        eng = _slo_engine(smoke, scheme="seda", audit=AuditLog())
        SLOMonitor(ttft_ms=1e-6, p99_tick_ms=1e-9).attach(eng)
        rids = [eng.submit(prompt=p, max_new_tokens=4)
                for p in short_prompts]
        done = eng.run()
        assert [done[r].generated for r in rids] == want

    def test_attach_twice_rejected(self, smoke):
        eng = _slo_engine(smoke, scheme="off")
        SLOMonitor().attach(eng)
        with pytest.raises(ValueError):
            SLOMonitor().attach(eng)

    def test_no_monitor_no_hooks(self, smoke):
        eng = _slo_engine(smoke, scheme="off")
        assert not any(
            isinstance(getattr(h, "__self__", None), SLOMonitor)
            for h in eng.page_io.verdict_hooks)
        assert not hasattr(eng, "slo")

    def test_merge_health_worst_wins(self):
        ok = {"status": "ok", "shard": 0}
        degraded = {"status": "degraded", "shard": 1}
        failing = {"status": "failing", "shard": 2}
        assert merge_health([ok, ok])["status"] == "ok"
        assert merge_health([ok, degraded])["status"] == "degraded"
        merged = merge_health([ok, degraded, failing])
        assert merged["status"] == "failing"
        assert len(merged["shards"]) == 3
