"""Observability layer of the port: host-side and dependency-free.

The port's own copies of ``repro.obs.metrics``, ``trace``, ``audit``,
``slo`` and ``profiler``:

* :mod:`repro_torch.obs.metrics` — a declared-metrics registry
  (counters, gauges, histograms) behind the engine's ``stats`` dict API
  (:class:`~repro_torch.obs.metrics.StatsView`);
* :mod:`repro_torch.obs.trace` — a ring-buffer span tracer for the tick
  phases, exporting Chrome trace-event JSON;
* :mod:`repro_torch.obs.audit` — an append-only SHA-256 hash-chained
  audit log of security events whose ``verify_chain()`` detects any
  edit, drop or reorder of the log itself;
* :mod:`repro_torch.obs.slo` — the per-tenant SLO watchdog (TTFT, p99
  tick latency, integrity-failure rate, stuck ticks).
* :mod:`repro_torch.obs.profiler` — the protection-vs-model device-cost
  split of one decode call (aten ops under a dispatch mode, the CUDA
  kernels' own charges), its H100 roofline, and the engine gauges that
  read it.

Off by default on the hot path: a counter costs one attribute bump,
gauges are sampled at snapshot time, and span timing runs only on an
engine built with ``trace=...``.
"""

from repro_torch.obs.audit import AuditLog
from repro_torch.obs.metrics import (CLUSTER_COUNTERS, ENGINE_COUNTERS,
                                     ENGINE_GAUGES, ENGINE_HISTOGRAMS,
                                     MetricsRegistry, StatsView)
from repro_torch.obs.slo import SLOMonitor, merge_health
from repro_torch.obs.trace import SpanTracer

__all__ = ["AuditLog", "CLUSTER_COUNTERS", "ENGINE_COUNTERS",
           "ENGINE_GAUGES", "ENGINE_HISTOGRAMS", "MetricsRegistry",
           "SLOMonitor", "SpanTracer", "StatsView", "merge_health"]
