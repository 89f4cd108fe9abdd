"""Cluster scheduler: sharded secure serving over N shard engines.

The port of ``repro.serve.cluster``.  A :class:`ClusterEngine` serves
one request stream over N shards, each a full
:class:`~repro_torch.serve.engine.SecureServingEngine` (continuous
batching, a paged MAC-protected pool, optional tenant key domains):

* **routing** — :meth:`submit` places each request on the shard whose
  prefix cache covers the most of its prompt, then the least loaded,
  with tenant affinity breaking near-ties;
* **one dispatch wave per tick** — every shard's decode is dispatched
  before any shard is collected, so on one card the host prepares the
  next shard's tick while the card runs the previous one's;
* **shard-bound integrity** — each shard's pool binds its shard id into
  the RePA fmap and the CTR counter words (a page replayed into another
  shard fails its gate), and the per-shard deferred pool MACs roll up
  into a cluster root MAC (:mod:`repro_torch.serve.sharded_pool`),
  checked every ``defer_interval`` ticks;
* **secure page migration** — when a shard starves (queued work it
  cannot admit, or page growth its free list cannot cover) and another
  has room, the starved shard's youngest slot moves: its pages are
  decrypted and verified under the source binding, hop devices as
  plaintext, and are re-encrypted and re-MACed under the destination's,
  with no eviction and no recomputed prefill;
* **cluster-wide rotation** — :meth:`rotate` goes through the shared
  registry, whose hooks reach every shard engine;
* **shard failover** — with ``fault_tolerance`` a shard whose tick
  raises without page context, or whose pool fails the root check, is
  folded out: its sessions recompute on the survivors, its pool MAC
  leaves the root.  Page-level faults stay inside the shard engine.

Shards are logical on one device by default (separate pools on the
engine's device, the card unless ``device="cpu"``); ``devices=`` places
shard ``s`` on ``devices[s]``.  :meth:`profile` rolls the shard
engines' device-cost profiles up into one.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import vn as vn_mod
from repro_torch.core.secure_memory import SecureKeys
from repro_torch.obs import audit as audit_mod
from repro_torch.obs import metrics as metrics_mod
from repro_torch.obs import trace as trace_mod
from repro_torch.serve import kv_pages as kvp
from repro_torch.serve import merkle_pool as mkp
from repro_torch.serve.engine import (IntegrityError, RunResult,
                                      SecureServingEngine, SubmitAPI,
                                      SubmitRequest, _traced,
                                      latency_percentiles)
from repro_torch.serve.faults import RecoveryPolicy
from repro_torch.serve.sharded_pool import ShardedKVPool

__all__ = ["ClusterEngine"]


class ClusterEngine(SubmitAPI):
    """N shard engines behind one ``submit()`` / ``run()`` plane.

    ::

        cluster = ClusterEngine(arch, cfg, params, shards=2,
                                scheme="seda", use_kernel=True,
                                max_slots=4, page_tokens=8,
                                pages_per_slot=10)
        rids = [cluster.submit(prompt=p, max_new_tokens=8)
                for p in prompts]
        done = cluster.run()        # RunResult, as the engine's

    ``registry=`` works as for the engine; sessions are cluster-wide.
    ``max_slots`` / ``n_pages`` are per shard.  Other keyword arguments
    (``use_kernel``, ``merkle``, ``prefix_cache``, ...) go to every
    shard engine.
    """

    def __init__(self, arch, cfg, params, *, shards: int = 2,
                 scheme: str = "seda", max_slots: int = 4,
                 page_tokens: int = 8, pages_per_slot: int = 8,
                 n_pages: Optional[int] = None,
                 keys: Optional[SecureKeys] = None,
                 registry=None, rotate_every: int = 0,
                 defer_interval: int = 16, device=None, devices=None,
                 migrate: bool = True, fault_tolerance=None,
                 trace=None, audit=None, **engine_kw):
        if shards < 1:
            raise ValueError("need at least one shard")
        if rotate_every and registry is None:
            raise ValueError("rotate_every needs a tenant registry")
        if devices is None:
            devices = [resolve_device(device)] * shards
        elif len(devices) != shards:
            raise ValueError(f"{len(devices)} devices for {shards} shards")
        else:
            devices = [resolve_device(d) for d in devices]
        self.registry = registry
        self.rotate_every = rotate_every
        self.defer_interval = defer_interval
        self.migrate = migrate
        # None is strict (an IntegrityError escapes); True or a
        # RecoveryPolicy also turns on containment in every shard.
        self.ft = None
        if fault_tolerance:
            self.ft = (RecoveryPolicy() if fault_tolerance is True
                       else fault_tolerance)
        self.failed_shards: set = set()
        # Per-migration audit hand-offs: {"rid", "from_shard", "to_shard",
        # "src_root", "proof"}, the destination's proof taken on landing.
        self.migration_proofs: list = []
        if keys is None:
            keys = SecureKeys.derive(0, device=devices[0])
        # One chained audit log for the whole cluster (the shard id is a
        # field), so cross-shard event order is itself tamper-evident.
        if isinstance(audit, audit_mod.AuditLog):
            self.audit = audit
        elif audit:
            self.audit = audit_mod.AuditLog()
        else:
            self.audit = None
        self.engines = [
            SecureServingEngine(
                arch, cfg, params, scheme=scheme, max_slots=max_slots,
                page_tokens=page_tokens, pages_per_slot=pages_per_slot,
                n_pages=n_pages, keys=keys, registry=registry,
                rotate_every=0, defer_interval=defer_interval,
                fault_tolerance=self.ft, trace=bool(trace), audit=self.audit,
                device=devices[s], shard_id=s, n_shards=shards,
                preempt_hook=self._take_preempted, **engine_kw)
            for s in range(shards)]
        self.sharded = ShardedKVPool(self.engines)
        self.tick = 0
        self.requests: dict = {}            # cluster rid -> Request
        self._next_rid = 0
        self._rotate_rr = 0
        self._orphans: deque = deque()      # preempted, awaiting re-route
        self.metrics = metrics_mod.MetricsRegistry()
        for name, help_ in metrics_mod.CLUSTER_COUNTERS.items():
            self.metrics.counter(name, help_)
        self._stats = metrics_mod.StatsView(self.metrics)
        # The cluster's tracer has its own pid (one past the last shard),
        # so its tick span does not interleave with shard 0's phases.
        self.tracer = None
        if trace:
            self.tracer = (trace if isinstance(trace, trace_mod.SpanTracer)
                           else trace_mod.SpanTracer(pid=shards))
            key = "cluster_tick_seconds"
            self._tick_hists = {key: self.metrics.histogram(
                key, metrics_mod.CLUSTER_HISTOGRAMS[key])}

    # -- observability -------------------------------------------------------

    @property
    def stats(self):
        """The cluster-level counters under the dict API."""
        return self._stats

    def _audit(self, event: str, shard: int = -1, **fields) -> None:
        """Append one cluster-level security event (shard -1 unless the
        event names one; nothing without an audit log)."""
        if self.audit is not None:
            self.audit.append(event, shard=shard, tick=self.tick, **fields)

    def snapshot(self) -> dict:
        """Cluster metrics, every shard's snapshot (``shards``, labeled
        ``shard=<id>``) and the summed counters (``rollup``)."""
        out = self.metrics.snapshot()
        out["shards"] = [e.snapshot() for e in self.engines]
        out["rollup"] = dict(self.engine_stats)
        return out

    def prometheus(self) -> str:
        """Prometheus text: the cluster's metrics, then each shard's
        block (its samples carry its ``shard=`` label)."""
        return "".join([self.metrics.prometheus()]
                       + [e.prometheus() for e in self.engines])

    def profile(self, buckets=None, uniform: bool = False,
                refresh: bool = False) -> dict:
        """Per-shard device-cost profiles + the cluster rollup.

        ``shards`` carries each engine's :meth:`SecureServingEngine.
        profile` export (each labeled with its ``shard`` id, matching
        the ``shard=`` labels on the per-shard profiler gauges), each
        run on scratch copies of that shard's own pool, so the shard
        roots and the cluster root stay as they were; ``rollup`` sums
        the attributed protection/model bytes+flops across shards and
        recomputes the combined overhead ratios.
        """
        shards = [e.profile(buckets, uniform, refresh)
                  for e in self.engines]
        rollup = {k: {"bytes": 0.0, "flops": 0.0}
                  for k in ("protection", "model", "other", "total")}
        for shard in shards:
            for prof in shard["profiles"]:
                for k in rollup:
                    rollup[k]["bytes"] += prof[k]["bytes"]
                    rollup[k]["flops"] += prof[k]["flops"]
        model = rollup["model"]
        rollup["overhead_bytes_ratio"] = (
            rollup["protection"]["bytes"] / model["bytes"]
            if model["bytes"] else 0.0)
        rollup["overhead_flops_ratio"] = (
            rollup["protection"]["flops"] / model["flops"]
            if model["flops"] else 0.0)
        return {"scheme": self.engines[0].scheme if self.engines else None,
                "shards": shards, "rollup": rollup}

    def export_trace(self, path: Optional[str] = None) -> dict:
        """One Chrome trace of the cluster's and every shard's spans
        (per-shard ``pid`` tracks show the dispatch / collect overlap)."""
        if self.tracer is None:
            raise ValueError("cluster was built without trace=...")
        extra = []
        for engine in self.engines:
            if engine.tracer is not None:
                extra += engine.tracer.events()
        return self.tracer.export(path, extra_events=extra)

    # -- submission / routing ------------------------------------------------

    def _submit(self, request: SubmitRequest) -> int:
        """Route one request to a shard; returns a cluster-wide rid."""
        tokens = [int(t) for t in request.prompt]
        tenant_index = (request.session.index
                        if request.session is not None else None)
        shard = self._route(tenant_index,
                            tokens if request.share_prefix else None)
        engine = self.engines[shard]
        local_rid = engine._submit(dataclasses.replace(request,
                                                       prompt=tokens))
        rid = self._next_rid
        self._next_rid += 1
        self.requests[rid] = engine.requests[local_rid]
        return rid

    def _load(self, engine) -> int:
        return (engine._n_waiting()
                + sum(1 for s in engine.slots if s is not None))

    def _has_tenant(self, engine, tenant_index: int) -> bool:
        if engine._tenant_waiting.get(tenant_index):
            return True
        return any(s is not None and s.tenant is not None
                   and s.tenant.index == tenant_index
                   for s in engine.slots)

    def _route(self, tenant_index: Optional[int],
               tokens: Optional[list] = None) -> int:
        """Prefix-holding shards first, then the least loaded.

        Cache pages are sealed into one shard's pool and bound to it, so
        a request whose prompt prefix is cached goes to the shard that
        covers the most tokens.  Within those, the least loaded wins,
        with tenant affinity breaking near-ties."""
        cover = [0] * len(self.engines)
        if tenant_index is not None and tokens is not None and \
                len(tokens) > 1:
            cover = [e.prefix_cache.match_tokens(tenant_index, tokens[:-1])
                     if e.prefix_cache is not None else 0
                     for e in self.engines]
        for s in self.failed_shards:      # folded-out shards take nothing
            cover[s] = -1
        top = max(cover)
        best = None
        for s, engine in enumerate(self.engines):
            if s in self.failed_shards or cover[s] < top:
                continue
            score = float(self._load(engine))
            if tenant_index is not None and \
                    self._has_tenant(engine, tenant_index):
                score -= 0.5
            if best is None or score < best[0]:
                best = (score, s)
        return best[1]

    def _take_preempted(self, req) -> bool:
        """Engine preempt hook: the cluster re-routes evicted work."""
        self._orphans.append(req)
        return True

    def _requeue_orphans(self) -> None:
        while self._orphans:
            req = self._orphans.popleft()
            shard = self._route(
                req.tenant_idx,
                req.prompt + req.generated if req.share_prefix else None)
            engine = self.engines[shard]
            if req.tenant_idx is not None:
                if not engine._tenant_active(req.tenant_idx):
                    engine._activate_vtime(req.tenant_idx)
                engine._tenant_waiting.setdefault(
                    req.tenant_idx, deque()).appendleft(req)
            else:
                engine.waiting.appendleft(req)
            self.stats["rerouted_preemptions"] += 1

    # -- the cluster tick ----------------------------------------------------

    @torch.no_grad()
    @_traced("cluster_tick", "cluster_tick_seconds")
    def step(self) -> list:
        """One cluster tick: every shard admits, then every shard's
        decode is dispatched, then every shard is collected.  Returns the
        requests that finished, across all shards.

        With ``fault_tolerance`` a shard whose phase raises without page
        context is failed over (:meth:`_failover`) while the others'
        tick goes on; a raise with page context is contained inside that
        shard and never escalates."""
        self.tick += 1
        if (self.registry is not None and self.rotate_every
                and self.tick % self.rotate_every == 0
                and self.registry.n_tenants):
            idx = self._rotate_rr % self.registry.n_tenants
            self._rotate_rr += 1
            self.rotate(self.registry.by_index(idx).tenant_id)
        finished: list = []
        if self.ft is None:
            actives = [e._tick_begin(finished) for e in self.engines]
            pendings = [e._decode_dispatch(a) if a else None
                        for e, a in zip(self.engines, actives)]
            for engine, active, pending in zip(self.engines, actives,
                                               pendings):
                if pending is not None:
                    engine._decode_collect(active, pending, finished)
            for engine in self.engines:
                engine._tick_end()
        else:
            self._step_ft(finished)
        if self.migrate and self._n_live() > 1:
            self._maybe_migrate()
        self._requeue_orphans()
        if self.defer_interval and self.tick % self.defer_interval == 0:
            self._root_check()
        return finished

    def _step_ft(self, finished: list) -> None:
        """The guarded tick phases: dispatch-all-before-collect-any holds
        across the surviving shards; a shard that raises is skipped for
        the rest of the tick and failed over at its end."""
        live = self._live_engines()
        failed_now: dict = {}

        def guard(engine, fn, *a):
            if engine.shard_id in failed_now:
                return None
            try:
                return fn(*a)
            except IntegrityError as err:
                if getattr(err, "ctx", None) is not None:
                    # Raised by the engine with fault context: page
                    # level, contained in place on that shard.
                    engine._contain_error(err)
                else:
                    failed_now[engine.shard_id] = err
                return None

        actives = [guard(e, e._tick_begin, finished) for e in live]
        pendings = [guard(e, e._decode_dispatch, a) if a else None
                    for e, a in zip(live, actives)]
        for engine, active, pending in zip(live, actives, pendings):
            if pending is not None:
                guard(engine, engine._decode_collect, active, pending,
                      finished)
        for engine in live:
            guard(engine, engine._tick_end)
        for shard, err in failed_now.items():
            self._failover(shard, err)

    def run(self, max_ticks: int = 100_000) -> RunResult:
        """Drive cluster ticks until every submitted request finished
        (or, with fault tolerance, failed for good)."""
        for _ in range(max_ticks):
            if self._busy():
                self.step()
                continue
            if self._end_checks():
                break
        else:
            raise RuntimeError("run() exceeded max_ticks")
        result = RunResult({rid: req for rid, req in self.requests.items()
                            if req.state == "finished"})
        result.latency = latency_percentiles(self.requests.values())
        return result

    def _end_checks(self) -> bool:
        """End-of-run deferred checks across the surviving shards.

        Strict mode raises on a failure; with fault tolerance a failure
        is contained (page quarantine or shard failover, either of which
        may requeue work, and then the run keeps ticking).  Returns True
        once drained."""
        for engine in self._live_engines():
            if engine.policy.deferred_model_mac:
                try:
                    engine._deferred_check()
                except IntegrityError as err:
                    if self.ft is None:
                        raise
                    engine._contain_error(err)
            if not engine.verify_every_step and not bool(engine._ok_accum):
                err = IntegrityError(
                    "accumulated page-MAC verification failed "
                    f"(shard {engine.shard_id})")
                if self.ft is None:
                    raise err
                # The accumulator cannot say which tick failed: the whole
                # shard is suspect and folds out.
                engine._ok_accum = torch.ones((), dtype=torch.bool,
                                              device=engine.device)
                self._failover(engine.shard_id, err)
        self._root_check()
        self._requeue_orphans()
        return not self._busy()

    def _busy(self) -> bool:
        if self._orphans:
            return True
        return any(e._n_waiting() or any(s is not None for s in e.slots)
                   for e in self.engines)

    def _live_engines(self) -> list:
        return [e for e in self.engines
                if e.shard_id not in self.failed_shards]

    def _n_live(self) -> int:
        return len(self.engines) - len(self.failed_shards)

    def rotate(self, tenant_id: str) -> int:
        """Cluster-wide live rotation (the registry's hooks reach every
        shard engine); returns the new epoch."""
        if self.registry is None:
            raise ValueError("rotate() needs a tenant registry")
        return self.registry.rotate(tenant_id)

    def _root_check(self) -> None:
        self.stats["root_checks"] += 1
        if self.sharded.deferred_root_check():
            return
        msg = f"cluster root MAC check failed (tick {self.tick})"
        self._audit("integrity_error", op="root_check", detail=msg)
        if self.ft is None:
            raise IntegrityError(msg)
        # Localize: at least one shard's pool MAC diverged from its
        # mirror (or its own deferred identity).  Those shards fold out;
        # their sessions recompute on the survivors.
        bad = self.sharded.failing_shards()
        if not bad:
            raise IntegrityError(msg)   # unlocalizable: do not serve on
        for shard in bad:
            self._failover(shard, IntegrityError(msg))

    def _failover(self, shard: int, err=None) -> None:
        """Fold one failed shard out of the cluster.

        Every session on it, running or queued, drains onto the
        survivors by secure recompute (re-routed by
        :meth:`_requeue_orphans`, re-prefilled from prompt + tokens at
        re-admission).  Its pages are never migrated or trusted, its free
        list is emptied and its pool MAC leaves the root.  Raises when no
        survivor would remain."""
        if shard in self.failed_shards:
            return
        if len(self.failed_shards) + 1 >= len(self.engines):
            raise IntegrityError(
                f"shard {shard} failed with no survivor left"
                + (f": {err}" if err is not None else ""))
        self.failed_shards.add(shard)
        engine = self.engines[shard]
        drained = 0
        for i, slot in enumerate(engine.slots):
            if slot is None:
                continue
            req = slot.req
            engine._preempt(i)          # the hook hands it to _orphans
            req.recovering = True
            drained += 1
        if engine.registry is None:
            while engine.waiting:
                self._orphans.append(engine.waiting.popleft())
                drained += 1
        else:
            for queue in engine._tenant_waiting.values():
                while queue:
                    self._orphans.append(queue.popleft())
                    drained += 1
        engine.free_pages = []
        self.sharded.fold_out(shard)
        self.stats["shard_failovers"] += 1
        # The record's shard is the failed one (the reference passes it
        # twice and raises TypeError once an audit log is on).
        self._audit("shard_failover", shard=shard, sessions=drained,
                    detail=str(err) if err is not None else None)

    def deferred_check(self) -> bool:
        """The cluster root MAC and every active shard's pool MAC."""
        return self.sharded.deferred_root_check()

    def audit_proof(self, session=None, *, rid: Optional[int] = None) -> list:
        """Cluster audit proofs for one session (or one request).

        One :class:`~repro_torch.serve.merkle_pool.AuditProof` per active
        shard holding the session's frames, each carrying the ordered
        active shard-root set and the cluster root it compresses to, so
        the tenant checks leaf -> shard root -> cluster root with
        ``verify_proof`` alone.  Failed-over shards are folded out."""
        pairs = self.sharded.merkle_roots()
        cluster = {"shard_roots": [(s, r.hex()) for s, r in pairs],
                   "root": mkp.compress_roots(pairs).hex()}
        proofs = []
        for shard in self.sharded._active:
            engine = self.engines[shard]
            try:
                p = engine.audit_proof(session, rid=rid)
            except KeyError:
                continue            # rid not resident on this shard
            if p.pages:
                proofs.append(dataclasses.replace(p, cluster=cluster))
        return proofs

    @property
    def engine_stats(self) -> dict:
        """Per-shard engine stats, summed, except ``rotations``: every
        shard's hook sees every registry rotation, so the max is the
        cluster-wide count."""
        agg: dict = {}
        for engine in self.engines:
            for k, v in engine.stats.items():
                agg[k] = agg.get(k, 0) + v
        if "rotations" in agg:
            agg["rotations"] = max(e.stats["rotations"]
                                   for e in self.engines)
        return agg

    # -- secure page migration ----------------------------------------------

    def _growth_pressure(self, engine) -> bool:
        """Queued work the shard cannot admit, or imminent page growth
        its free list cannot cover."""
        free = len(engine.free_pages)
        heads = []
        if engine.registry is None:
            if engine.waiting:
                heads.append(engine.waiting[0])
        else:
            heads += [q[0] for q in engine._tenant_waiting.values() if q]
        if heads and any(engine._admission_pages(r) > free for r in heads):
            return True
        need_soon = sum(
            1 for s in engine.slots if s is not None
            and (s.length + 1) // engine.page_tokens >= len(s.pages))
        return need_soon > free

    def _pick_migration(self, src: int):
        """(victim slot, destination shard) for one starved shard."""
        engine = self.engines[src]
        candidates = [i for i, s in enumerate(engine.slots) if s is not None]
        if not candidates:
            return None
        victim = max(candidates, key=lambda i: engine.slots[i].admit_seq)
        slot = engine.slots[victim]
        n = len(slot.pages)
        best = None
        for d, dst in enumerate(self.engines):
            if d == src or d in self.failed_shards or \
                    None not in dst.slots:
                continue
            # Headroom: the slot must land AND keep growing a while.
            if len(dst.free_pages) < n + 1:
                continue
            if slot.tenant is not None and \
                    dst.tenant_resident_pages(slot.tenant.index) + n > \
                    slot.tenant.page_quota:
                continue
            if best is None or len(dst.free_pages) > best[0]:
                best = (len(dst.free_pages), d)
        if best is None:
            return None
        return victim, best[1]

    def _maybe_migrate(self) -> None:
        for src in range(len(self.engines)):
            if src in self.failed_shards:
                continue
            if not self._growth_pressure(self.engines[src]):
                continue
            pick = self._pick_migration(src)
            if pick is None:
                continue
            if self.ft is None:
                self._migrate_slot(src, *pick)
                continue
            try:
                self._migrate_slot(src, *pick)
            except IntegrityError as err:
                # Migration re-verifies the source pages first; a failure
                # is a source-shard page fault, contained there (the slot
                # stays put and recovery takes over).
                self.engines[src]._contain_error(err)

    def _migrate_slot(self, src: int, slot_idx: int, dst: int) -> None:
        """Move one running slot's pages src -> dst, resealed under the
        destination shard's binding (no recompute).

        The source read syncs on its verdict before a destination page is
        popped or a byte written: both pools are written in place, so a
        failed verdict leaves both untouched."""
        es, ed = self.engines[src], self.engines[dst]
        slot = es.slots[slot_idx]
        n = len(slot.pages)
        p = es.pages_per_slot                   # padded to one lane count
        src_ids = np.full((p,), es.spec.scratch_page, np.int64)
        src_ids[:n] = slot.pages
        tenant = slot.tenant
        src_ctx = None
        if tenant is not None:
            rows = np.zeros((p,), np.int64)
            epochs = np.zeros((p,), np.int64)
            for j, e in enumerate(slot.page_epochs):
                epochs[j] = e
                if e & kvp.PREFIX_ROLE:
                    # A shared prefix page: read under the tenant's cache
                    # binding; it lands as a PRIVATE page (the cache and
                    # its refcounts are shard-local).
                    rows[j] = self.registry.cache_row(tenant.index)
                    continue
                try:
                    rows[j] = self.registry.key_row(tenant.index, e)
                except KeyError as exc:
                    raise es._integrity_fail(
                        f"migration source shard {src} slot {slot_idx} "
                        f"page {j}: {exc.args[0]}",
                        op="migration", tenant=tenant.tenant_id,
                        to_shard=dst) from exc
            src_ctx = kvp.PageKeyCtx.make(
                es._bank(), rows, np.full((p,), tenant.index, np.int64),
                epochs)
        leaf_pages, ok = es.page_io.read_raw(
            es.pool, torch.as_tensor(src_ids, device=es.device), src_ctx)
        if not es.page_io.report_verdict(ok, "migration"):
            raise es._integrity_fail(
                f"secure migration: source shard {src} page verification "
                f"failed (slot {slot_idx}, scheme={es.scheme})",
                op="migration", slot=slot_idx, to_shard=dst,
                pages=[int(q) for q in slot.pages])
        dst_pages = [ed.free_pages.pop() for _ in range(n)]
        dst_ids = np.full((p,), ed.spec.scratch_page, np.int64)
        dst_ids[:n] = dst_pages
        dst_ids = torch.as_tensor(dst_ids, device=ed.device)
        # The plaintext hop (none when both shards share a device).
        leaf_pages = [t.to(ed.device) for t in leaf_pages]
        dst_ctx, page_epochs = None, []
        if tenant is not None:
            cur = tenant.current_epoch
            dst_ctx = kvp.PageKeyCtx.make(
                ed._bank(),
                np.full((p,), self.registry.key_row(tenant.index, cur),
                        np.int64),
                np.full((p,), tenant.index, np.int64),
                np.full((p,), cur, np.int64))
            page_epochs = [cur] * n
        ed.page_io.write(ed.pool, dst_ids, leaf_pages,
                         vn_mod.kv_page_vn(ed._next_epoch()),
                         dst_ids < ed.spec.n_pages, dst_ctx)
        # Host state: the slot moves wholesale; its request stays
        # "running" and nothing is recomputed.  Its recurrent-state column
        # moves as it is, unprotected, as the reference moves it.
        dst_slot = ed.slots.index(None)
        for dst_state, src_state in zip(ed.onchip, es.onchip):
            dst_state[:, dst_slot] = src_state[:, slot_idx].to(ed.device)
        es.slots[slot_idx] = None
        es.page_table.clear(slot_idx)
        # Shared prefix pages stay with the source shard's cache (only
        # their pin is dropped); the private tail is freed.
        if slot.shared_n:
            es.prefix_cache.release(slot.shared_entries)
        es._free(slot.pages[slot.shared_n:])
        ed._admit_seq += 1
        slot.pages = dst_pages
        slot.page_epochs = page_epochs
        slot.shared_n = 0
        slot.shared_entries = []
        slot.admit_seq = ed._admit_seq
        ed.slots[dst_slot] = slot
        ed.page_table.install(dst_slot, slot)
        # The migrated session re-proves membership against the
        # destination's root at once, and the hand-off (old root -> new
        # proof) is recorded, so a tenant can audit that its transcript
        # survived the move.
        src_root = dst_root = None
        if es.merkle is not None and ed.merkle is not None:
            es._merkle_sync()
            src_root = es.merkle.root_hex()
            proof = ed.audit_proof(rid=slot.req.rid)
            dst_root = proof.root
            self.migration_proofs.append(
                {"rid": slot.req.rid, "from_shard": src, "to_shard": dst,
                 "src_root": src_root, "proof": proof.to_dict()})
        self.stats["migrations"] += 1
        self._audit("migration", from_shard=src, to_shard=dst, pages=n,
                    tenant=tenant.tenant_id if tenant is not None else None,
                    src_root=src_root, dst_root=dst_root)
