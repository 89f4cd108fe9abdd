"""Port observability (``repro_torch.obs``, the engine's metrics, trace,
audit and SLO wiring) against the JAX package.

* The registry, histogram, tracer and audit-chain units of
  ``tests/test_obs.py`` on the port's copies; the declared names equal
  the reference's, less the three device-cost profiler gauges.
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
from repro_torch.obs.trace import SpanTracer
from repro_torch.serve.engine import STAT_NAMES, SecureServingEngine
from repro_torch.tenancy import KeyHierarchy, TenantRegistry
from test_torch_models import numpy_params

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
        profiler = {"protection_overhead_ratio",
                    "protection_overhead_flops_ratio",
                    "roofline_utilization"}
        assert metrics_mod.ENGINE_GAUGES == {
            k: v for k, v in j_metrics.ENGINE_GAUGES.items()
            if k not in profiler}
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
    assert "protection_overhead_ratio" not in text
    with pytest.raises(ValueError, match="trace"):
        _engine(smoke, scheme="off").export_trace()


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
    assert {"tick", "decode_dispatch"} <= {e["name"] for e in events}
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
