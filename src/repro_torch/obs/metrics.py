"""Declared-metrics registry: counters, gauges, histograms.

The port's copy of ``repro.obs.metrics`` (the JAX package's module
imports no JAX, but the port imports nothing of it).  Every metric is
**declared once** with a help string; the canonical name sets below
(:data:`ENGINE_COUNTERS`, :data:`CLUSTER_COUNTERS`, ...) are the
reference's, less the three device-cost profiler gauges, whose XLA HLO
attribution is not ported.

Compatibility: :class:`StatsView` wraps a registry's counters in the
old dict API (``stats["admitted"] += 1``, ``stats.items()``,
``dict(**stats)``) so engines and tests read counters as before.
Assigning an *undeclared* key through the view declares a counter on
the fly.

Exposition: :meth:`MetricsRegistry.snapshot` returns a JSON-able dict
(gauges sampled lazily at call time, so they cost nothing on the tick
path) and :meth:`MetricsRegistry.prometheus` renders the Prometheus
text format, both with optional constant labels.
"""

from __future__ import annotations

import math
from collections.abc import MutableMapping
from typing import Callable, Optional

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "StatsView",
           "ENGINE_COUNTERS", "CLUSTER_COUNTERS", "ENGINE_GAUGES",
           "ENGINE_HISTOGRAMS", "CLUSTER_HISTOGRAMS"]


# -- canonical declarations (the single source of truth for names) ----------

ENGINE_COUNTERS = {
    "admitted": "requests admitted into a decode slot (prefill or hit)",
    "preemptions": "running slots evicted back to the waiting queue",
    "decode_steps": "batched jitted decode dispatches",
    "deferred_checks": "off-critical-path deferred pool-MAC checks",
    "rotations": "tenant key rotations observed by this engine",
    "prefill_compiles": "distinct prefill shapes compiled",
    "reseals": "eager pre-rotation reseal dispatches",
    "uniform_fast_ticks": "single-bank-row ticks on the flat crypto route",
    "fused_mixed_ticks": "mixed-row ticks kept on the fused READ kernel",
    "fused_write_ticks": "ticks resealing dirty pages via the fused WRITE "
                         "kernel",
    "decode_bucket_compiles": "(bucket, uniform) decode variants compiled",
    "decode_page_reads": "pages gathered by decode (active slots x bucket)",
    "prefix_hit_pages": "cache pages installed read-only at admission",
    "prefix_cow_pages": "shared pages copy-resealed private on first write",
    "prefix_inserted_pages": "session pages copy-resealed into the cache",
    "prefix_shared_pages": "pages explicitly resealed cross-tenant",
    "prefill_pages_skipped": "prompt pages a prefix hit exempted from "
                             "prefill",
    "integrity_verdicts": "host-synced MAC-gate verdicts observed",
    "integrity_failures": "MAC-gate / deferred-MAC verdicts that failed",
    "integrity_quarantined_pages": "physical frames permanently retired "
                                   "after a localized integrity failure",
    "sessions_recovered": "preempted sessions re-admitted via secure "
                          "recompute after an integrity fault",
    "sessions_lost": "sessions declared dead after exhausting the "
                     "integrity-recovery retry budget",
    "audit_events": "records appended to the security audit log",
    "merkle_root_updates": "amortized Merkle root recomputes (batched "
                           "dirty-path maintenance at the deferred "
                           "cadence)",
    "merkle_leaf_updates": "Merkle leaves rehashed by incremental "
                           "maintenance (dirty pages, ownership changes, "
                           "quarantine exclusions)",
    "audit_proofs": "per-tenant membership proofs issued against the "
                    "shard Merkle root",
    "slo_ttft_breaches": "requests whose wall-clock ttft missed the "
                         "per-tenant SLO target",
    "slo_tick_p99_breaches": "ok->breach transitions of the rolling p99 "
                             "tick-latency target",
    "slo_integrity_alarms": "ok->alarm transitions of the windowed "
                            "integrity-failure-rate alarm",
    "slo_stuck_ticks": "watchdog firings: no tick end within N x the "
                       "rolling median tick",
}

CLUSTER_COUNTERS = {
    "migrations": "slots moved cross-shard via secure page migration",
    "root_checks": "cluster root-MAC checks",
    "rerouted_preemptions": "preempted requests re-routed across shards",
    "shard_failovers": "shards folded out of the cluster after an "
                       "integrity failure, sessions drained to survivors",
}

ENGINE_GAUGES = {
    "pool_free_pages": "KV pool pages on the free list right now",
    "pool_pages_total": "KV pool capacity in pages",
    "slots_active": "decode slots currently running a request",
    "waiting_requests": "requests queued for admission",
    "tenant_resident_pages": "pool pages owned per tenant (label: tenant)",
    "prefix_cache_pages": "prefix-cache entries resident (pages)",
    "prefix_cache_refs": "total refcount pins across cache entries",
}

ENGINE_HISTOGRAMS = {
    "tick_seconds": "wall-clock latency of one full engine tick",
    "phase_tick_begin_seconds": "wall-clock time in _tick_begin",
    "phase_decode_dispatch_seconds": "wall-clock time in _decode_dispatch",
    "phase_decode_collect_seconds": "wall-clock time in _decode_collect",
    "phase_tick_end_seconds": "wall-clock time in _tick_end",
    "ttft_ticks": "scheduler ticks from submit to first token",
    "ttft_seconds": "wall-clock seconds from submit to first token",
    "decode_bucket": "page-count bucket distribution over decode ticks",
}

CLUSTER_HISTOGRAMS = {
    "cluster_tick_seconds": "wall-clock latency of one cluster tick",
}


class Counter:
    """Monotonic (well, resettable) integer counter."""

    __slots__ = ("name", "help", "value")

    def __init__(self, name: str, help: str = ""):  # noqa: A002
        self.name, self.help, self.value = name, help, 0

    def inc(self, n=1) -> None:
        self.value += n

    def reset(self) -> None:
        self.value = 0


class Gauge:
    """Point-in-time value, either set directly or sampled via ``fn``.

    ``fn`` may return a number, or a ``{label_value: number}`` dict for
    labeled gauges (e.g. per-tenant resident pages, label ``tenant``).
    Sampling happens only at snapshot/exposition time — a callback
    gauge costs literally nothing on the hot path.
    """

    __slots__ = ("name", "help", "label", "fn", "_value")

    def __init__(self, name: str, help: str = "", *,  # noqa: A002
                 fn: Optional[Callable] = None, label: Optional[str] = None):
        self.name, self.help, self.label, self.fn = name, help, label, fn
        self._value = 0

    def set(self, v) -> None:
        self._value = v

    def sample(self):
        return self.fn() if self.fn is not None else self._value

    def reset(self) -> None:
        self._value = 0


class Histogram:
    """Sample-keeping histogram with np.percentile-compatible quantiles.

    Keeps raw observations (bounded by ``max_samples``; oldest dropped
    first) so percentiles are exact over the retained window —
    :meth:`percentile` matches ``np.percentile(..., method="linear")``
    bit-for-bit.  ``count``/
    ``sum``/``min``/``max`` cover the whole life of the histogram even
    after the sample window rolls.
    """

    __slots__ = ("name", "help", "max_samples", "samples", "count", "sum",
                 "min", "max")

    def __init__(self, name: str, help: str = "", *,  # noqa: A002
                 max_samples: int = 65536):
        self.name, self.help = name, help
        self.max_samples = max_samples
        self.reset()

    def reset(self) -> None:
        self.samples: list = []
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, v) -> None:
        v = float(v)
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v
        self.samples.append(v)
        if len(self.samples) > self.max_samples:
            del self.samples[: len(self.samples) - self.max_samples]

    def percentile(self, q: float) -> float:
        """Linear-interpolated percentile (numpy's default method)."""
        if not self.samples:
            return math.nan
        xs = sorted(self.samples)
        if len(xs) == 1:
            return xs[0]
        pos = (len(xs) - 1) * (q / 100.0)
        lo = int(math.floor(pos))
        hi = min(lo + 1, len(xs) - 1)
        frac = pos - lo
        return xs[lo] * (1.0 - frac) + xs[hi] * frac

    def summary(self) -> dict:
        if not self.count:
            return {"count": 0, "sum": 0.0}
        return {"count": self.count, "sum": self.sum,
                "min": self.min, "max": self.max,
                "p50": self.percentile(50), "p95": self.percentile(95),
                "p99": self.percentile(99)}


class MetricsRegistry:
    """One namespace of declared counters/gauges/histograms."""

    def __init__(self):
        self.counters: dict = {}
        self.gauges: dict = {}
        self.histograms: dict = {}

    # Declarations are get-or-create so shared code paths can redeclare
    # idempotently; conflicting kinds under one name are an error.

    def counter(self, name: str, help: str = "") -> Counter:  # noqa: A002
        self._check_free(name, self.counters)
        if name not in self.counters:
            self.counters[name] = Counter(name, help)
        return self.counters[name]

    def gauge(self, name: str, help: str = "", *,  # noqa: A002
              fn: Optional[Callable] = None,
              label: Optional[str] = None) -> Gauge:
        self._check_free(name, self.gauges)
        if name not in self.gauges:
            self.gauges[name] = Gauge(name, help, fn=fn, label=label)
        return self.gauges[name]

    def histogram(self, name: str, help: str = "", *,  # noqa: A002
                  max_samples: int = 65536) -> Histogram:
        self._check_free(name, self.histograms)
        if name not in self.histograms:
            self.histograms[name] = Histogram(name, help,
                                              max_samples=max_samples)
        return self.histograms[name]

    def _check_free(self, name: str, own: dict) -> None:
        for kind in (self.counters, self.gauges, self.histograms):
            if kind is not own and name in kind:
                raise ValueError(f"metric {name!r} already declared as a "
                                 f"different kind")

    def names(self) -> set:
        return (set(self.counters) | set(self.gauges)
                | set(self.histograms))

    def reset(self) -> None:
        for m in (*self.counters.values(), *self.gauges.values(),
                  *self.histograms.values()):
            m.reset()

    # -- exposition ---------------------------------------------------------

    def snapshot(self, labels: Optional[dict] = None) -> dict:
        """JSON-able point-in-time view (gauges sampled now)."""
        out = {
            "counters": {n: c.value for n, c in sorted(self.counters.items())},
            "gauges": {n: g.sample() for n, g in sorted(self.gauges.items())},
            "histograms": {n: h.summary()
                           for n, h in sorted(self.histograms.items())},
        }
        if labels:
            out["labels"] = dict(labels)
        return out

    def prometheus(self, prefix: str = "repro",
                   labels: Optional[dict] = None) -> str:
        """Prometheus text exposition format (one block per metric).

        Label values and help strings are escaped per the text-format
        spec (label values: ``\\`` ``"`` and newline; help: ``\\`` and
        newline), so tenant ids and file paths with arbitrary bytes
        round-trip through a Prometheus parser.
        """
        base = dict(labels or {})

        def esc_label(v) -> str:
            return (str(v).replace("\\", r"\\").replace('"', r'\"')
                    .replace("\n", r"\n"))

        def esc_help(s: str) -> str:
            return str(s).replace("\\", r"\\").replace("\n", r"\n")

        def fmt_labels(extra: Optional[dict] = None) -> str:
            items = dict(base, **(extra or {}))
            if not items:
                return ""
            inner = ",".join(f'{k}="{esc_label(v)}"'
                             for k, v in sorted(items.items()))
            return "{" + inner + "}"

        lines = []
        for name, c in sorted(self.counters.items()):
            full = f"{prefix}_{name}"
            lines += [f"# HELP {full} {esc_help(c.help)}",
                      f"# TYPE {full} counter",
                      f"{full}{fmt_labels()} {c.value}"]
        for name, g in sorted(self.gauges.items()):
            full = f"{prefix}_{name}"
            lines += [f"# HELP {full} {esc_help(g.help)}",
                      f"# TYPE {full} gauge"]
            value = g.sample()
            if isinstance(value, dict):
                key = g.label or "label"
                for lv, v in sorted(value.items()):
                    lines.append(f"{full}{fmt_labels({key: lv})} {v}")
            else:
                lines.append(f"{full}{fmt_labels()} {value}")
        for name, h in sorted(self.histograms.items()):
            full = f"{prefix}_{name}"
            lines += [f"# HELP {full} {esc_help(h.help)}",
                      f"# TYPE {full} summary"]
            if h.count:
                for q in (50, 95, 99):
                    lines.append(
                        f"{full}{fmt_labels({'quantile': q / 100})} "
                        f"{h.percentile(q)}")
            lines.append(f"{full}_sum{fmt_labels()} {h.sum}")
            lines.append(f"{full}_count{fmt_labels()} {h.count}")
        return "\n".join(lines) + "\n"


class StatsView(MutableMapping):
    """The old ``engine.stats`` dict API over a registry's counters.

    ``view[k]`` reads a counter, ``view[k] = v`` sets one (declaring it
    on the fly when unknown — how cluster aggregation forwards counters
    it has never heard of), ``+=`` composes the two.  Iteration order
    follows declaration order, like the dict it replaces.
    """

    __slots__ = ("_registry",)

    def __init__(self, registry: MetricsRegistry):
        self._registry = registry

    def __getitem__(self, key: str):
        try:
            return self._registry.counters[key].value
        except KeyError:
            raise KeyError(key) from None

    def __setitem__(self, key: str, value) -> None:
        self._registry.counter(key).value = value

    def __delitem__(self, key: str) -> None:
        del self._registry.counters[key]

    def __iter__(self):
        return iter(self._registry.counters)

    def __len__(self) -> int:
        return len(self._registry.counters)

    def __repr__(self) -> str:
        return f"StatsView({dict(self)!r})"
