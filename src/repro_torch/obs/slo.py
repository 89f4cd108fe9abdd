"""Live SLO watchdog over the engine's tick phases and verdicts.

:class:`SLOMonitor` is the health tier of ``repro_torch.obs`` (the
port's copy of ``repro.obs.slo``): it consumes signals the engine
already produces — the wall-clock tick phases, the ttft observations,
and the host-synced MAC verdict stream — and turns them into three
kinds of alarms:

* **per-tenant ttft / p99-tick targets** — every request whose
  wall-clock time-to-first-token misses ``ttft_ms`` bumps
  ``slo_ttft_breaches`` (audited with the tenant), and an ok→breach
  transition of the rolling p99 tick latency vs ``p99_tick_ms`` bumps
  ``slo_tick_p99_breaches``;
* **integrity-failure-rate alarm** — a sliding window over the MAC
  verdict stream (``integrity_window``); when the failure rate crosses
  ``integrity_threshold`` (with at least ``integrity_min_failures``
  observed) the monitor latches ``slo_integrity_alarms`` and the
  engine is reported *failing* until the window drains;
* **stuck-tick watchdog** — :meth:`check_stalled` fires
  ``slo_stuck_ticks`` when the engine has pending work but no
  ``_tick_end`` landed within ``stall_factor`` × the rolling median
  tick duration (plus a ``min_stall_s`` floor so sub-millisecond
  median ticks don't turn scheduling jitter into pages); an idle
  engine is never stuck.

Every breach is emitted twice: as a registry counter (names declared
in :data:`repro_torch.obs.metrics.ENGINE_COUNTERS`) *and* as a hash-chained
audit event (``slo_breach`` with a ``kind`` field) when the engine has
an audit log.  Attachment is explicit (``monitor.attach(engine)``)
and wraps the tick phases per instance exactly like the span tracer
does — an engine without a monitor executes zero additional host code.
"""

from __future__ import annotations

import math
import time
from collections import deque
from typing import Optional

__all__ = ["SLOMonitor", "merge_health"]

_STATUS_RANK = {"ok": 0, "degraded": 1, "failing": 2}


def _percentile(xs, q: float) -> float:
    """np.percentile(..., method='linear') over a small window."""
    if not xs:
        return math.nan
    xs = sorted(xs)
    if len(xs) == 1:
        return xs[0]
    pos = (len(xs) - 1) * (q / 100.0)
    lo = int(math.floor(pos))
    hi = min(lo + 1, len(xs) - 1)
    frac = pos - lo
    return xs[lo] * (1.0 - frac) + xs[hi] * frac


class SLOMonitor:
    """Watchdog for one engine; see the module docstring."""

    def __init__(self, *, ttft_ms: Optional[float] = None,
                 p99_tick_ms: Optional[float] = None,
                 integrity_window: int = 256,
                 integrity_threshold: float = 0.5,
                 integrity_min_failures: int = 4,
                 stall_factor: float = 10.0,
                 min_stall_s: float = 0.0,
                 tick_window: int = 256, min_ticks: int = 8):
        self.ttft_ms = ttft_ms
        self.p99_tick_ms = p99_tick_ms
        self.integrity_window = integrity_window
        self.integrity_threshold = integrity_threshold
        self.integrity_min_failures = integrity_min_failures
        self.stall_factor = stall_factor
        self.min_stall_s = min_stall_s
        self.tick_window = tick_window
        self.min_ticks = min_ticks

        self.engine = None
        self._ticks: deque = deque(maxlen=tick_window)
        self._verdicts: deque = deque(maxlen=integrity_window)
        self._fail_count = 0
        self._tick_t0: Optional[float] = None
        self._last_end: Optional[float] = None
        self._tick_breached = False
        self._integrity_alarm = False
        self._stuck = False
        self.tenant_ttft: dict = {}          # tenant label -> deque of ms
        self.tenant_breaches: dict = {}      # tenant label -> count

    # -- attachment ---------------------------------------------------------

    def attach(self, engine) -> "SLOMonitor":
        """Wrap one engine's phases/hooks; returns self for chaining."""
        if self.engine is not None:
            raise ValueError("SLOMonitor is per-engine; attach a fresh one")
        if getattr(engine, "slo", None) is not None:
            raise ValueError("engine already has an SLOMonitor attached")
        self.engine = engine

        orig_begin = engine._tick_begin
        orig_end = engine._tick_end
        orig_ttft = engine._observe_ttft

        def tick_begin(*a, **kw):
            self._tick_t0 = time.perf_counter()
            return orig_begin(*a, **kw)

        def tick_end(*a, **kw):
            try:
                return orig_end(*a, **kw)
            finally:
                now = time.perf_counter()
                if self._tick_t0 is not None:
                    self._observe_tick(now - self._tick_t0)
                self._last_end = now
                self._stuck = False

        def observe_ttft(req):
            orig_ttft(req)
            if self.ttft_ms is not None and req.submit_time:
                ms = (time.perf_counter() - req.submit_time) * 1e3
                self._observe_ttft_ms(ms, self._tenant_label(req))

        engine._tick_begin = tick_begin
        engine._tick_end = tick_end
        engine._observe_ttft = observe_ttft
        engine.page_io.verdict_hooks.append(self._on_verdict)
        engine.slo = self
        return self

    def _tenant_label(self, req) -> str:
        idx = getattr(req, "tenant_idx", None)
        if idx is None:
            return "default"
        reg = self.engine.registry
        if reg is not None:
            try:
                return reg.by_index(idx).tenant_id
            except Exception:  # noqa: BLE001 - stale index after churn
                pass
        return str(idx)

    # -- signal ingestion ---------------------------------------------------

    def _breach(self, counter: str, kind: str, **fields) -> None:
        self.engine.stats[counter] += 1
        self.engine._audit("slo_breach", kind=kind, **fields)

    def _observe_ttft_ms(self, ms: float, tenant: str) -> None:
        dq = self.tenant_ttft.setdefault(
            tenant, deque(maxlen=self.tick_window))
        dq.append(ms)
        if ms > self.ttft_ms:
            self.tenant_breaches[tenant] = \
                self.tenant_breaches.get(tenant, 0) + 1
            self._breach("slo_ttft_breaches", "ttft", tenant=tenant,
                         ttft_ms=round(ms, 3), target_ms=self.ttft_ms)

    def _observe_tick(self, seconds: float) -> None:
        self._ticks.append(seconds)
        if self.p99_tick_ms is None or len(self._ticks) < self.min_ticks:
            return
        p99_ms = _percentile(self._ticks, 99) * 1e3
        if p99_ms > self.p99_tick_ms:
            if not self._tick_breached:
                self._tick_breached = True
                self._breach("slo_tick_p99_breaches", "tick_p99",
                             p99_ms=round(p99_ms, 3),
                             target_ms=self.p99_tick_ms)
        else:
            self._tick_breached = False

    def _on_verdict(self, ok: bool, op: str, ctx: dict) -> None:
        if len(self._verdicts) == self._verdicts.maxlen \
                and not self._verdicts[0]:
            self._fail_count -= 1
        self._verdicts.append(bool(ok))
        if not ok:
            self._fail_count += 1
        rate = self._fail_count / len(self._verdicts)
        if (self._fail_count >= self.integrity_min_failures
                and rate >= self.integrity_threshold):
            if not self._integrity_alarm:
                self._integrity_alarm = True
                self._breach("slo_integrity_alarms", "integrity_rate",
                             failure_rate=round(rate, 4),
                             window=len(self._verdicts),
                             threshold=self.integrity_threshold, op=op)
        elif rate < self.integrity_threshold:
            self._integrity_alarm = False

    # -- polling ------------------------------------------------------------

    def check_stalled(self, now: Optional[float] = None) -> bool:
        """Fire the watchdog if no tick ended within the deadline.

        ``now`` is injectable for tests; the deadline is
        ``max(stall_factor * median_tick, min_stall_s)`` past the last
        observed ``_tick_end``.  Latches *failing* until the next tick
        end; re-polling a latched stall does not re-fire the counter.
        An idle engine — no waiting requests, no occupied slots — is
        never stuck: a shard that drained early must not page while a
        sibling shard keeps the cluster loop busy.
        """
        if self._last_end is None or not self._ticks:
            return False
        eng = self.engine
        if eng is not None and not (
                eng._n_waiting()
                or any(s is not None for s in eng.slots)):
            return False
        if now is None:
            now = time.perf_counter()
        median = _percentile(self._ticks, 50)
        deadline = max(self.stall_factor * median, self.min_stall_s)
        if now - self._last_end > deadline:
            if not self._stuck:
                self._stuck = True
                self._breach("slo_stuck_ticks", "stuck_tick",
                             idle_s=round(now - self._last_end, 4),
                             deadline_s=round(deadline, 4))
            return True
        return False

    @property
    def hard_breach(self) -> bool:
        """True when the engine should be pulled out of rotation (and
        the launcher should exit non-zero): integrity alarm, stall, or
        a session lost for good to integrity recovery."""
        return (self._integrity_alarm or self._stuck
                or self._sessions_lost() > 0)

    def _sessions_lost(self) -> int:
        if self.engine is None:
            return 0
        return int(self.engine.stats.get("sessions_lost", 0))

    def _recovering(self) -> int:
        if self.engine is None or not hasattr(self.engine, "_n_recovering"):
            return 0
        return self.engine._n_recovering()

    def health(self) -> dict:
        """/healthz body: ok | degraded (soft SLO misses or sessions
        in integrity recovery) | failing."""
        recovering = self._recovering()
        soft = (sum(self.tenant_breaches.values()) > 0
                or self._tick_breached or recovering > 0)
        status = ("failing" if self.hard_breach
                  else "degraded" if soft else "ok")
        tenants = {t: {"p99_ms": round(_percentile(dq, 99), 3),
                       "breaches": self.tenant_breaches.get(t, 0)}
                   for t, dq in sorted(self.tenant_ttft.items())}
        out = {
            "status": status,
            "targets": {"ttft_ms": self.ttft_ms,
                        "p99_tick_ms": self.p99_tick_ms},
            "ticks": {"observed": len(self._ticks),
                      "p50_ms": round(_percentile(self._ticks, 50) * 1e3, 3)
                      if self._ticks else None,
                      "p99_ms": round(_percentile(self._ticks, 99) * 1e3, 3)
                      if self._ticks else None,
                      "p99_breached": self._tick_breached},
            "integrity": {"window": len(self._verdicts),
                          "failures": self._fail_count,
                          "alarm": self._integrity_alarm},
            "stuck": self._stuck,
            "tenants": tenants,
        }
        if self.engine is not None:
            out["shard"] = self.engine.shard_id
            out["recovery"] = {
                "recovering": recovering,
                "sessions_lost": self._sessions_lost(),
                "quarantined_pages":
                    len(getattr(self.engine, "quarantined", ())),
            }
        return out


def merge_health(healths: list) -> dict:
    """Cluster /healthz rollup: worst shard status wins; recovery
    state (sessions recovering/lost, quarantined pages) is summed."""
    if not healths:
        return {"status": "ok", "shards": []}
    worst = max(healths, key=lambda h: _STATUS_RANK.get(h["status"], 0))
    out = {"status": worst["status"], "shards": healths}
    recs = [h["recovery"] for h in healths if h.get("recovery")]
    if recs:
        out["recovery"] = {k: sum(r[k] for r in recs)
                          for k in ("recovering", "sessions_lost",
                                    "quarantined_pages")}
    return out
