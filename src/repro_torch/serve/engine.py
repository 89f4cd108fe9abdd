"""Continuous-batching secure serving engine over the paged KV pool.

Port of the reference engine (``repro.serve.engine``):

* **admission** — FCFS: a waiting request takes a free slot when the
  pool has pages for its prompt; prefill runs per request with
  power-of-two length bucketing, and its cache pages are encrypted +
  MACed into the pool;
* **decode** — one batched step per tick over every running slot:
  gather pages -> decrypt -> verify touched pages -> attend/append ->
  re-encrypt + re-MAC only the dirty page per slot.  The step runs over
  a pow2 page-count-bucketed window picked host-side per tick; there is
  one decode function per bucket, run eagerly;
* **growth / eviction** — slots take pages as decodes lengthen; under a
  full pool the youngest running request is preempted (LIFO) and its
  KV recomputed on re-admission;
* **deferred verification** — the pool-level MAC is checked every
  ``defer_interval`` ticks and at the end of :meth:`run`.

**Multi-tenant mode.**  Built with a
:class:`repro_torch.tenancy.TenantRegistry`, the engine serves
per-tenant cryptographic domains, as the reference does:

* requests carry a :class:`~repro_torch.tenancy.SessionHandle` into
  :meth:`submit`; the registry validates it and pins the request to its
  tenant, whose page quota bounds the request;
* every KV page is encrypted and MACed under its owner's (tenant, epoch)
  bank row, with the identity in the RePA binding, so a page read under
  another tenant's keys or a stale epoch fails its gate;
* admission is weighted-fair (stride scheduling over tenant virtual
  time) and quota-gated; eviction is tenant-scoped;
* :meth:`rotate` bumps a tenant's epoch live: pages re-encrypt lazily
  on their next dirty write, and pages about to leave the retained
  window are resealed eagerly (decrypt under the dying row, re-encrypt
  under the current one), with no preemption.  ``rotate_every=K``
  rotates one tenant (round-robin) every K ticks.

A tick whose pages all resolve to one bank row runs the single-key
route (``uniform_fast_ticks``); any other tenant tick runs the
mixed-key kernels when the spec qualifies (``fused_mixed_ticks``).

**Shared-prefix cache.**  With ``prefix_cache=True`` (tenant mode) a
prompt whose leading pages an earlier same-tenant request sealed skips
their prefill: the cached pages go read-only into the slot, the rest of
the prompt is teacher-forced through the batched decode, and the first
dirty write to a shared page copies it into a private page first
(copy-on-write).  Tenants share only through :meth:`share_prefix`.

**Merkle level.**  Unless ``merkle=False`` the engine keeps an
incremental SHA-256 tree over the page MACs
(:class:`repro_torch.serve.merkle_pool.MerklePagePool`), synced at the
deferred-check cadence, and :meth:`audit_proof` gives a session an
O(log n) membership proof for its resident pages.

**Observability.**  ``stats`` is a view over a
:class:`repro_torch.obs.metrics.MetricsRegistry` (counters, lazy gauges,
histograms; :meth:`snapshot`, :meth:`prometheus`).  ``trace=True`` (or a
:class:`~repro_torch.obs.trace.SpanTracer`) records the tick and its
phases as host-clock spans (:meth:`export_trace`), and while the
program's spans are on (:func:`repro_torch.obs.trace.enable`) the page
crossings, the model, the kernels and each request's wait
(``request.queued``) inside the tick go to the same tracer;
``audit=True`` (or a shared
:class:`~repro_torch.obs.audit.AuditLog`) keeps a hash-chained log of
security events.  Every MAC-gate verdict the engine syncs goes through
``PageIO.report_verdict``, once per gate.  :meth:`profile` splits a
decode variant's device cost into protection and model
(:mod:`repro_torch.obs.profiler`) and caches it for three lazy gauges.

**Fault containment.**  An integrity failure raises
:class:`IntegrityError`, with the failing gate (``op``) and pages in
``err.ctx``.  With ``fault_tolerance`` (``True`` or a
:class:`repro_torch.serve.faults.RecoveryPolicy`) :meth:`step` contains
it instead: the failing pages are localized by re-reading every resident
page (``PageIO.read_raw``, retried), their frames are quarantined for
good (off the free list, out of the prefix cache and the Merkle tree,
their MAC rows scrubbed and the pool MAC rebuilt, all in place), and
only the affected sessions are preempted for secure recompute: their
re-admission prefills prompt + tokens so far, so the recovered stream
is the fault-free one.  A retry budget with exponential backoff bounds
the recoveries of one session (``sessions_lost``).

**Sharded mode.**  Built with ``shard_id`` / ``n_shards``, the engine
is one shard of a :class:`repro_torch.serve.cluster.ClusterEngine`: its
pool's RePA bindings and CTR counters carry the shard id, so a page
replayed into another shard fails its gate; its tick is split into
begin / dispatch / collect / end so the cluster dispatches every shard
before it collects any; ``preempt_hook(request)`` returning True hands a
preempted request to the cluster instead of the local queue; and its
pool updates, each with its pool-MAC delta, reach the cluster's
root-MAC mirrors through the pool listeners.  With ``n_shards > 1`` its
snapshot and Prometheus text carry a ``shard`` label.

**Recurrent state.**  A hybrid arch (jamba) also keeps each Mamba
layer's SSM state and conv window per slot.  That state is never paged:
it stays in device tensors beside the pool, as the reference keeps it
"on-chip" (unencrypted and unMACed in both packages; ROADMAP C).
Admission writes a slot's column from its prefill, each decode
overwrites only the active slots' columns, and prefill runs at the exact
prompt length (pad tokens would enter the recurrence).  An arch with no
paged leaf at all (mamba2) is refused with the reference's
``ValueError``, and so is ``prefix_cache`` for a hybrid one.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import time
import warnings
from collections import deque
from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import mac as mac_mod
from repro_torch.core import multilevel
from repro_torch.core import vn as vn_mod
from repro_torch.core.secure_exec import SCHEMES
from repro_torch.core.secure_memory import SecureKeys
from repro_torch.models import lm as lm_mod
from repro_torch.models.layers import tree_map
from repro_torch.models.step_graph import StepGraph
from repro_torch.obs import audit as audit_mod
from repro_torch.obs import metrics as metrics_mod
from repro_torch.obs import profiler as profiler_mod
from repro_torch.obs import trace as trace_mod
from repro_torch.serve import kv_pages as kvp
from repro_torch.serve import merkle_pool as mkp
from repro_torch.serve.faults import RecoveryPolicy
from repro_torch.serve.serve_step import greedy_sample

__all__ = ["IntegrityError", "Request", "RunResult", "SecureServingEngine",
           "SubmitAPI", "SubmitRequest", "latency_percentiles"]

# The engine's counters (``stats`` keys), as the reference declares them.
STAT_NAMES = tuple(metrics_mod.ENGINE_COUNTERS)


class IntegrityError(RuntimeError):
    """A MAC gate (page/block) or the deferred pool MAC failed."""


@dataclasses.dataclass
class Request:
    rid: int
    prompt: list
    max_new_tokens: int
    generated: list = dataclasses.field(default_factory=list)
    state: str = "waiting"          # waiting | running | finished | failed
    n_evictions: int = 0
    # Fault containment: ``recovering`` marks a session preempted by an
    # integrity failure (cleared, and counted, on re-admission);
    # ``hold_until`` delays its re-admission (backoff);
    # ``integrity_retries`` counts its recoveries against the budget.
    recovering: bool = False
    hold_until: int = 0
    integrity_retries: int = 0
    tenant_idx: Optional[int] = None
    submit_tick: int = 0
    first_tick: Optional[int] = None
    done_tick: Optional[int] = None
    share_prefix: bool = True       # may use / populate the prefix cache
    submit_time: float = 0.0        # perf_counter at submit (ttft_seconds)

    @property
    def done(self) -> bool:
        return len(self.generated) >= self.max_new_tokens


@dataclasses.dataclass
class SubmitRequest:
    """The argument object of :meth:`SecureServingEngine.submit`.

    ``share_prefix=False`` opts a request out of the shared-prefix cache
    both ways: it neither reads cached pages nor seals its prefix in.
    """

    prompt: list
    max_new_tokens: int = 16
    session: Optional[object] = None    # SessionHandle in tenant mode
    share_prefix: bool = True


class SubmitAPI:
    """The keyword-only ``submit()``: subclasses implement
    ``_submit(SubmitRequest) -> rid``.  The legacy positional form
    ``submit(prompt, max_new_tokens)`` still works, with a
    :class:`DeprecationWarning`."""

    def _submit(self, request: SubmitRequest) -> int:
        raise NotImplementedError

    def submit(self, request=None, /, *legacy, **kw) -> int:
        """Queue one request; returns its rid.

        ``submit(SubmitRequest(...))`` or
        ``submit(prompt=toks, max_new_tokens=8, session=sess)``.
        """
        if isinstance(request, SubmitRequest):
            if legacy or kw:
                raise TypeError("submit(SubmitRequest) takes no other "
                                "arguments")
            return self._submit(request)
        if request is not None:
            warnings.warn(
                "positional submit(prompt, ...) is deprecated; pass a "
                "SubmitRequest or keyword arguments",
                DeprecationWarning, stacklevel=2)
            if "prompt" in kw:
                raise TypeError("submit() got prompt twice")
            kw["prompt"] = request
            if legacy:
                if len(legacy) > 1 or "max_new_tokens" in kw:
                    raise TypeError("submit() takes at most prompt and "
                                    "max_new_tokens positionally")
                kw["max_new_tokens"] = legacy[0]
        elif legacy:
            raise TypeError("submit() got positional arguments but no "
                            "prompt")
        return self._submit(SubmitRequest(**kw))


class RunResult(dict):
    """``{rid: Request}`` plus aggregate ``latency`` percentiles."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.latency: dict = {}


def latency_percentiles(requests) -> dict:
    """p50/p95/p99 ticks-to-first-token and ticks-per-token (linear
    interpolation) over finished requests."""
    ttft, tpt = [], []
    for r in requests:
        if r.state != "finished" or r.first_tick is None:
            continue
        ttft.append(r.first_tick - r.submit_tick)
        if r.done_tick is not None and len(r.generated) > 1:
            tpt.append((r.done_tick - r.first_tick) / (len(r.generated) - 1))
    if not ttft:
        return {}
    out = {}
    for q in (50, 95, 99):
        out[f"p{q}_ttft_ticks"] = float(np.percentile(ttft, q,
                                                      method="linear"))
    for q in (50, 95, 99):
        if tpt:
            out[f"p{q}_ticks_per_token"] = float(
                np.percentile(tpt, q, method="linear"))
    return out


@dataclasses.dataclass
class _Slot:
    req: Request
    length: int                     # KV tokens resident (host mirror)
    pages: list                     # owned pool page ids, in token order
    admit_seq: int
    tenant: object = None           # tenancy.registry.Tenant | None
    # Key epoch each page was last sealed under (tenant mode).
    page_epochs: list = dataclasses.field(default_factory=list)
    # Shared prefix: the first ``shared_n`` pages are read-only cache
    # pages (epoch word PREFIX_ROLE) pinned through ``shared_entries``;
    # ``replay`` holds the prompt tokens the skipped prefill still owes
    # the KV cache (teacher-forced; the sample of the LAST replay step
    # is the first real output).
    shared_n: int = 0
    shared_entries: list = dataclasses.field(default_factory=list)
    replay: deque = dataclasses.field(default_factory=deque)


def _traced(name: str, hist_key: str):
    """Decorate a tick (or a tick phase) of an engine or cluster: with
    ``self.tracer``, its span (``args.tick`` the tick it ends in), its
    wall-clock histogram ``self._tick_hists[hist_key]``, and the
    program's spans going to that tracer while it runs; without one, one
    attribute check.  On the method rather than the instance, so a
    cluster driving its shards' phases directly records them too.  The
    spans are host time: a decode dispatch returns before the card has
    run it, and the tick syncs only on its verdict in
    ``_decode_collect``."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(self, *a, **kw):
            tracer = self.tracer
            if tracer is None:
                return fn(self, *a, **kw)
            sp = tracer.span(name)
            try:
                with trace_mod.activate(tracer), sp:
                    try:
                        return fn(self, *a, **kw)
                    finally:
                        sp.args["tick"] = self.tick
            finally:
                self._tick_hists[hist_key].observe(sp.seconds)

        return wrapper

    return deco


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _bucket_len(n: int, cap: int) -> int:
    """Round ``n`` up to the next power of two, capped at ``cap``."""
    b = 1
    while b < n:
        b <<= 1
    return min(b, cap)


def _set_column(state: torch.Tensor, slot: int, col: torch.Tensor) -> None:
    """``state[:, slot] = col`` with the reference's broadcasting: a
    column of size 1 along an axis fills it (a prompt shorter than the
    conv window), any other mismatch raises ``ValueError`` as
    ``jnp``'s ``.at[].set`` does."""
    dst = state[:, slot]
    if col.dim() != dst.dim() or any(
            a not in (1, b) for a, b in zip(col.shape, dst.shape)):
        raise ValueError(f"Incompatible shapes for broadcasting: "
                         f"{tuple(col.shape)} and requested shape "
                         f"{tuple(dst.shape)}")
    dst.copy_(col)


class SecureServingEngine(SubmitAPI):
    """Batched secure decoding with paged, MAC-protected KV residency.

    ::

        eng = SecureServingEngine(arch, cfg, params, scheme="seda",
                                  use_kernel=True, max_slots=4,
                                  page_tokens=8, pages_per_slot=4)
        rids = [eng.submit(prompt=p, max_new_tokens=8) for p in prompts]
        done = eng.run()            # RunResult: {rid: Request} + .latency

    ``params`` is a reference-layout parameter tree or an
    :class:`repro_torch.models.lm.LM`.  Runs on the card unless
    ``device="cpu"``.  Multi-tenant use::

        reg = TenantRegistry(KeyHierarchy(0), max_tenants=4)
        reg.register("alice", weight=2.0, page_quota=8)
        eng = SecureServingEngine(arch, cfg, params, registry=reg, ...)
        eng.submit(prompt=p, max_new_tokens=8,
                   session=reg.open_session("alice"))
        eng.rotate("alice")         # live key rotation

    ``prefix_cache=True`` (registry required) adds the content-addressed
    :class:`repro_torch.serve.kv_pages.PrefixCache` of at most
    ``prefix_cache_pages`` pages (default a quarter of the pool).

    Each prefill is padded to a power-of-two length unless the arch
    keeps recurrent state (``prefill_buckets``).  ``eos_id`` ends a
    request at that token; ``verify_every_step=False``
    folds the decode verdicts on the device and checks them once, at
    the end of :meth:`run`.  ``fault_tolerance``, ``trace`` and
    ``audit``: see the module docstring.
    """

    def __init__(self, arch, cfg, params, *, scheme: str = "seda",
                 max_slots: int = 4, page_tokens: int = 8,
                 pages_per_slot: int = 8, n_pages: Optional[int] = None,
                 keys: Optional[SecureKeys] = None,
                 use_kernel: bool = False, defer_interval: int = 16,
                 eos_id: Optional[int] = None,
                 verify_every_step: bool = True,
                 registry=None, rotate_every: int = 0,
                 prefix_cache: bool = False,
                 prefix_cache_pages: Optional[int] = None,
                 fault_tolerance=None, merkle: bool = True,
                 trace=None, audit=None, device=None,
                 shard_id: int = 0, n_shards: int = 1,
                 preempt_hook=None):
        if arch.kind != "lm":
            raise ValueError("the paged serving engine supports decoder-only "
                             "LMs")
        if scheme not in SCHEMES:
            raise KeyError(f"unknown scheme {scheme!r}")
        if rotate_every and registry is None:
            raise ValueError("rotate_every needs a tenant registry — there "
                             "is no key hierarchy to rotate without one")
        if prefix_cache and registry is None:
            raise ValueError("prefix_cache needs a tenant registry — cache "
                             "pages are sealed under per-tenant cache keys")
        self.device = resolve_device(device)
        self.registry = registry
        self.rotate_every = rotate_every
        self.arch, self.cfg = arch, cfg
        self.scheme = scheme
        self.max_slots = max_slots
        self.page_tokens = page_tokens
        self.pages_per_slot = pages_per_slot
        self.max_len = page_tokens * pages_per_slot
        self.n_pages = (max_slots * pages_per_slot if n_pages is None
                        else n_pages)
        keys = (keys if keys is not None
                else SecureKeys.derive(0, device=self.device))
        self.keys = keys.to(self.device)
        self.defer_interval = defer_interval
        self.eos_id = eos_id
        self.verify_every_step = verify_every_step
        self.n_shards = n_shards
        # preempt_hook(request) returning True means the cluster took the
        # preempted request (it may re-route it to another shard), so it
        # must not be requeued here.
        self._preempt_hook = preempt_hook
        # fault_tolerance=None keeps the strict discipline (an
        # IntegrityError escapes step()/run()); True or a RecoveryPolicy
        # turns on quarantine + secure-recompute recovery.
        self.ft = None
        if fault_tolerance:
            self.ft = (RecoveryPolicy() if fault_tolerance is True
                       else fault_tolerance)
        if isinstance(params, torch.nn.Module):
            params = params.tree()
        self.params = tree_map(lambda t: t.to(self.device), params)

        self._cache_tree = lm_mod.cache_specs(cfg, max_slots, self.max_len)
        flat = kvp.cache_leaves(self._cache_tree)
        paged = kvp.paged_flags(self._cache_tree)
        lengths = kvp.length_flags(self._cache_tree)
        self.paged_idx = [i for i, f in enumerate(paged) if f]
        self.len_leaves = [(i, flat[i].shape[0])
                           for i, f in enumerate(lengths) if f]
        self.onchip_idx = [i for i in range(len(flat))
                           if not paged[i] and not lengths[i]]
        self.n_leaves = len(flat)
        self.spec = kvp.build_page_spec(
            self._cache_tree, scheme=scheme, page_tokens=page_tokens,
            n_pages=self.n_pages, max_slots=max_slots, max_len=self.max_len,
            use_kernel=use_kernel, shard=shard_id, n_shards=n_shards)
        self.shard_id = self.spec.shard
        self.page_io = kvp.PageIO(self.spec, self.keys)
        self.prefix_cache = None
        if prefix_cache:
            if self.onchip_idx:
                raise ValueError(
                    "prefix_cache is unavailable for archs with recurrent "
                    "on-chip state (Mamba SSM/conv): the skipped prefill's "
                    "state cannot be reconstructed from cached KV pages")
            cap = (prefix_cache_pages if prefix_cache_pages is not None
                   else max(1, self.n_pages // 4))
            self.prefix_cache = kvp.PrefixCache(page_tokens, cap)
        cfg_s = SCHEMES[scheme]
        self.policy = (multilevel.SEDA_DEFAULT if cfg_s.verify == "layer"
                       else multilevel.SGX_LIKE if cfg_s.emulate_tree
                       else multilevel.MGX_LIKE)

        # Length bucketing is safe when every cache leaf is paged (reads
        # zero positions >= length) or a length mirror; recurrent state
        # would absorb the pad tokens, so those archs prefill at exact
        # length.
        self.prefill_buckets = not self.onchip_idx

        self._pool_listeners: list = []
        self.pool = kvp.init_pool(self.spec, self.device)
        self.onchip = [torch.zeros(flat[i].shape,
                                   dtype=kvp._torch_dtype(flat[i].dtype),
                                   device=self.device)
                       for i in self.onchip_idx]
        # Crossings write the pool in place: every write is a pool update.
        self.page_io.write_listeners.append(
            lambda pool, delta: self._notify_pool(pool, pool, delta))
        self._ok_accum = torch.ones((), dtype=torch.bool, device=self.device)
        self.waiting: deque = deque()           # single-tenant FIFO
        self._tenant_waiting: dict = {}         # tenant idx -> deque
        self._vtime: dict = {}                  # tenant idx -> virtual time
        self._rotate_rr = 0
        self.slots: list = [None] * max_slots
        self.free_pages: list = list(range(self.n_pages))
        # Frames retired for good after a localized integrity failure:
        # never on the free list, never reallocated.
        self.quarantined: set = set()
        self.requests: dict = {}
        self._next_rid = 0
        self._admit_seq = 0
        self._epoch = 0
        self.tick = 0
        self._prefill_shapes: set = set()
        self._init_obs(trace, audit)
        self.page_table = kvp.TwoLevelPageTable(max_slots, pages_per_slot)
        self._decode_fns: dict = {}
        # CUDA graphs of the model's steps on the card, captured together
        # at the first one the engine runs (_step_graph).  Off, the steps
        # run eagerly: while _detached_decode swaps clones in (the graphs
        # read the engine's own state).
        self._graphs: Optional[dict] = None
        self._graphs_off = False
        # Auditable Merkle level over the page MACs: the listener is
        # O(1); hashing waits for _tick_end's sync.
        self.merkle = None
        if merkle:
            self.merkle = mkp.MerklePagePool(
                self.n_pages, shard=self.spec.shard,
                leaf_fn=lambda pool: kvp.merkle_leaf_macs(pool, self.spec),
                owners_fn=self._page_owners,
                quarantined_fn=lambda: self.quarantined)
            self.attach_pool_listener(self.merkle.on_pool_update)
            self.merkle.on_pool_update(None, self.pool)
        if registry is not None:
            # Every engine sharing the registry reacts to a rotation,
            # whoever triggers it: the pre hook reseals pages about to
            # leave the retained window while the dying row is banked;
            # the post hook preempts anything a reseal missed.
            registry.attach_rotation_hook(self._pre_rotation, pre=True)
            registry.attach_rotation_hook(self._on_rotation)

    # -- pool updates --------------------------------------------------------

    @property
    def pool(self) -> kvp.PagedKVPool:
        return self._pool

    @pool.setter
    def pool(self, new_pool: kvp.PagedKVPool) -> None:
        old = getattr(self, "_pool", None)
        self._pool = new_pool
        self._notify_pool(old, new_pool, None if old is None
                          else old.pool_mac ^ new_pool.pool_mac)

    def _notify_pool(self, old, new, delta) -> None:
        for listener in self._pool_listeners:
            listener(old, new, delta)

    def attach_pool_listener(self, listener) -> None:
        """``listener(old_pool, new_pool, delta)`` runs on every pool
        update: a new pool assigned, or a crossing's in-place write (then
        ``old`` is ``new``), with ``delta`` the change of the pool MAC
        (``old.pool_mac ^ new.pool_mac``, or the bytes the write XORed
        in); or a repair after a fault or the first pool (then ``old``
        and ``delta`` are None: the pool MAC is to be re-adopted)."""
        self._pool_listeners.append(listener)

    # -- observability (metrics / tracing / audit) ---------------------------

    def _init_obs(self, trace, audit) -> None:
        """Wire the observability layer (:mod:`repro_torch.obs`).

        The registry is always on (its counters are ``stats``); gauges
        are sampled at :meth:`snapshot` time.  Spans and the phase
        histograms exist only with ``trace`` (see :func:`_traced`): a
        default engine makes no timing call.
        ``audit`` (``True`` or a shared :class:`AuditLog`) turns on the
        hash-chained security log.
        """
        self.metrics = metrics_mod.MetricsRegistry()
        for counters in (metrics_mod.ENGINE_COUNTERS,
                         metrics_mod.GRAPH_COUNTERS):
            for name, help_ in counters.items():
                self.metrics.counter(name, help_)
        self._stats = metrics_mod.StatsView(self.metrics)
        g = metrics_mod.ENGINE_GAUGES
        self.metrics.gauge("pool_free_pages", g["pool_free_pages"],
                           fn=lambda: len(self.free_pages))
        self.metrics.gauge("pool_pages_total", g["pool_pages_total"],
                           fn=lambda: self.n_pages)
        self.metrics.gauge("slots_active", g["slots_active"],
                           fn=lambda: sum(1 for s in self.slots
                                          if s is not None))
        self.metrics.gauge("waiting_requests", g["waiting_requests"],
                           fn=self._n_waiting)
        if self.registry is not None:
            self.metrics.gauge(
                "tenant_resident_pages", g["tenant_resident_pages"],
                label="tenant",
                fn=lambda: {
                    self.registry.by_index(i).tenant_id:
                        self.tenant_resident_pages(i)
                    for i in range(self.registry.n_tenants)})
        if self.prefix_cache is not None:
            self.metrics.gauge("prefix_cache_pages",
                               g["prefix_cache_pages"],
                               fn=lambda: self.prefix_cache.pages_used)
            self.metrics.gauge("prefix_cache_refs", g["prefix_cache_refs"],
                               fn=lambda: self.prefix_cache.total_refs)
        # Device-cost profiler gauges sample the profile() cache only: an
        # engine that never called profile() exposes empty dicts, and a
        # snapshot never runs a decode.
        self._cost_profiles: dict = {}

        def _profile_gauge(attr):
            return lambda: {
                f"{b}{'u' if u else ''}": getattr(p, attr)
                for (b, u), p in sorted(self._cost_profiles.items())}

        self.metrics.gauge(
            "protection_overhead_ratio", g["protection_overhead_ratio"],
            label="bucket", fn=_profile_gauge("overhead_bytes_ratio"))
        self.metrics.gauge(
            "protection_overhead_flops_ratio",
            g["protection_overhead_flops_ratio"],
            label="bucket", fn=_profile_gauge("overhead_flops_ratio"))
        self.metrics.gauge(
            "roofline_utilization", g["roofline_utilization"],
            label="bucket",
            fn=lambda: {
                f"{b}{'u' if u else ''}":
                    p.roofline().get("utilization", 0.0)
                for (b, u), p in sorted(self._cost_profiles.items())})
        h = metrics_mod.ENGINE_HISTOGRAMS
        self._ttft_ticks = self.metrics.histogram("ttft_ticks",
                                                  h["ttft_ticks"])
        self._ttft_seconds = self.metrics.histogram("ttft_seconds",
                                                    h["ttft_seconds"])
        self._bucket_hist = self.metrics.histogram("decode_bucket",
                                                   h["decode_bucket"])
        # isinstance first: an EMPTY shared log is falsy (len 0) but is
        # still the caller's to share.
        if isinstance(audit, audit_mod.AuditLog):
            self.audit = audit
        elif audit:
            self.audit = audit_mod.AuditLog()
        else:
            self.audit = None
        self.tracer = None
        if trace:
            self.tracer = (trace if isinstance(trace, trace_mod.SpanTracer)
                           else trace_mod.SpanTracer(pid=self.shard_id))
            self._tick_hists = {
                key: self.metrics.histogram(key, h[key])
                for key in ("phase_tick_begin_seconds",
                            "phase_decode_dispatch_seconds",
                            "phase_decode_collect_seconds",
                            "phase_tick_end_seconds", "tick_seconds")}
        # Every host-synced gate verdict lands in the counters, whichever
        # crossing produced it.
        self.page_io.verdict_hooks.append(self._on_verdict)

    def _on_verdict(self, ok: bool, op: str, ctx: dict) -> None:
        self.stats["integrity_verdicts"] += 1
        if not ok:
            self.stats["integrity_failures"] += 1

    def _observe_ttft(self, req: Request) -> None:
        self._ttft_ticks.observe(req.first_tick - req.submit_tick)
        if req.submit_time:
            self._ttft_seconds.observe(time.perf_counter() - req.submit_time)

    @property
    def stats(self):
        """The counters under the dict API (a
        :class:`repro_torch.obs.metrics.StatsView`)."""
        return self._stats

    def _audit(self, event: str, **fields) -> None:
        """Append one security event (nothing without an audit log)."""
        if self.audit is not None:
            self.audit.append(event, shard=self.shard_id,
                              scheme=self.scheme, tick=self.tick, **fields)
            self.stats["audit_events"] += 1

    def _integrity_fail(self, msg: str, **ctx) -> IntegrityError:
        """Audit and build (the caller raises) one integrity failure;
        ``ctx`` (op, tenant, slot, page/pages) rides on it as
        ``err.ctx``, so containment can quarantine the named pages
        without localizing again."""
        self._audit("integrity_error", detail=msg, **ctx)
        err = IntegrityError(msg)
        err.ctx = dict(ctx)
        return err

    def _labels(self) -> Optional[dict]:
        """The ``shard`` label of a cluster's shard, else none."""
        return ({"shard": str(self.shard_id)} if self.n_shards > 1
                else None)

    def snapshot(self) -> dict:
        """JSON-able metrics snapshot (gauges sampled now)."""
        return self.metrics.snapshot(labels=self._labels())

    def prometheus(self) -> str:
        """Prometheus text exposition of this engine's metrics."""
        return self.metrics.prometheus(labels=self._labels())

    def export_trace(self, path: Optional[str] = None) -> dict:
        """Chrome trace-event JSON of the recorded phase spans."""
        if self.tracer is None:
            raise ValueError("engine was built without trace=...")
        return self.tracer.export(path)

    # -- decode / prefill builders -----------------------------------------

    def _merge_cache_leaves(self, dense: list, lengths: torch.Tensor):
        leaves = [None] * self.n_leaves
        for j, idx in enumerate(self.paged_idx):
            leaves[idx] = dense[j]
        for idx, steps in self.len_leaves:
            # A copy, not an expanded view: a graph's static input is
            # written by copy_, which refuses a self-overlapping target.
            leaves[idx] = lengths.to(torch.int32).repeat(steps, 1)
        for j, idx in enumerate(self.onchip_idx):
            leaves[idx] = self.onchip[j]
        return kvp.cache_unflatten(self._cache_tree, leaves)

    def _decode_fn_for(self, bucket: int, uniform: bool = False):
        """The batched decode step for one pow2 page-count bucket (one
        function per (bucket, uniform) pair, counted as the reference
        counts compiles)."""
        key = (bucket, uniform)
        if key not in self._decode_fns:
            self.stats["decode_bucket_compiles"] += 1
            self._decode_fns[key] = self._build_decode_fn(uniform)
        return self._decode_fns[key]

    def _build_decode_fn(self, uniform: bool = False):
        cfg, io = self.cfg, self.page_io

        def decode_fn(page_table, lengths, active, tokens, epoch,
                      read_ctx=None, write_ctx=None, slot_ids=None):
            dense, ok = io.read(self.pool, page_table, lengths, read_ctx,
                                uniform)
            caches = self._merge_cache_leaves(dense, lengths)
            logits, new_caches = lm_mod.lm_decode(
                cfg, self.params, tokens, caches,
                graph=self._step_graph("decode", page_table.shape[1]))
            tok = greedy_sample(logits)                      # (S, 1)
            new_leaves = kvp.cache_leaves(new_caches)
            io.write_dirty(self.pool, page_table,
                           [new_leaves[i] for i in self.paged_idx], lengths,
                           active, vn_mod.kv_page_vn(epoch), write_ctx,
                           uniform)
            # Recurrent state: only the active slots' columns advance.
            for j, idx in enumerate(self.onchip_idx):
                self.onchip[j].index_copy_(
                    1, slot_ids, new_leaves[idx].index_select(1, slot_ids))
            return tok, ok

        return decode_fn

    def _step_graph(self, kind: str, key: int):
        """The CUDA graph of one model step, ``kind`` ``"decode"`` by
        page bucket or ``"prefill"`` by padded length, counting its
        replay; None where the step runs eagerly: off the card, and on
        the clones :meth:`_detached_decode` swaps in.  The first call on
        the card captures every graph the engine can pick."""
        if self.device.type != "cuda" or self._graphs_off:
            return None
        if self._graphs is None:
            self._graphs = self._capture_graphs()
        graph = self._graphs[kind].get(key)
        if graph is not None:
            self.stats[f"{kind}_graph_replays"] += 1
        return graph

    def _capture_graphs(self) -> dict:
        """One graph per shape the engine can pick: ``lm_decode`` for
        each decode bucket (the pow2 page counts up to
        ``pages_per_slot``) and, when prefills are padded, ``lm_prefill``
        for each padded length.  The static inputs are zeros, and the
        on-chip state the engine's own tensors; one side stream and one
        memory pool serve every capture."""
        cfg, params, max_len = self.cfg, self.params, self.max_len
        dev, s = self.device, self.max_slots
        pool, stream = torch.cuda.graph_pool_handle(), torch.cuda.Stream(dev)
        graphs: dict = {"decode": {}, "prefill": {}}
        for bucket in sorted({kvp.page_count_bucket(n, self.pages_per_slot)
                              for n in range(1, self.pages_per_slot + 1)}):
            dense = [torch.zeros((leaf.steps, s, bucket * self.page_tokens)
                                 + leaf.rest,
                                 dtype=kvp._torch_dtype(leaf.dtype),
                                 device=dev)
                     for leaf in self.spec.leaves]
            lengths = torch.zeros((s,), dtype=torch.int64, device=dev)
            graphs["decode"][bucket] = StepGraph(
                lambda tokens, caches: lm_mod.lm_decode(cfg, params, tokens,
                                                        caches),
                torch.zeros((s, 1), dtype=torch.int64, device=dev),
                self._merge_cache_leaves(dense, lengths), pool=pool,
                stream=stream)
        if self.prefill_buckets:
            for n in sorted({_bucket_len(n, max_len)
                             for n in range(1, max_len + 1)}):
                graphs["prefill"][n] = StepGraph(
                    lambda batch, last_pos: lm_mod.lm_prefill(
                        cfg, params, batch, max_len, last_pos),
                    {"tokens": torch.zeros((1, n), dtype=torch.int64,
                                           device=dev)},
                    torch.full((1,), n - 1, dtype=torch.int64, device=dev),
                    pool=pool, stream=stream)
        self.stats["graph_captures"] += (len(graphs["decode"])
                                         + len(graphs["prefill"]))
        return graphs

    def _prefill(self, seq: list):
        """Run (bucketed) prefill for one request's token sequence:
        (token, paged leaves, on-chip leaves).  A padded prefill on the
        card replays its length's graph."""
        lp = len(seq)
        padded, graph, last_pos = seq, None, lp - 1
        if self.prefill_buckets:
            padded = seq + [0] * (_bucket_len(lp, self.max_len) - lp)
            graph = self._step_graph("prefill", len(padded))
        if len(padded) not in self._prefill_shapes:
            self._prefill_shapes.add(len(padded))
            self.stats["prefill_compiles"] += 1
        tokens = torch.tensor([padded], dtype=torch.int64, device=self.device)
        if graph is not None:
            last_pos = torch.full((1,), last_pos, dtype=torch.int64,
                                  device=self.device)
        logits, caches = lm_mod.lm_prefill(self.cfg, self.params,
                                           {"tokens": tokens}, self.max_len,
                                           last_pos=last_pos, graph=graph)
        leaves = kvp.cache_leaves(caches)
        return (greedy_sample(logits), [leaves[i] for i in self.paged_idx],
                [leaves[i] for i in self.onchip_idx])

    # -- public API ---------------------------------------------------------

    def _submit(self, request: SubmitRequest) -> int:
        prompt = [int(t) for t in request.prompt]
        max_new_tokens = request.max_new_tokens
        session = request.session
        if not prompt or max_new_tokens < 1:
            raise ValueError("need a non-empty prompt and max_new_tokens>=1")
        total = len(prompt) + max_new_tokens
        if total > self.max_len:
            raise ValueError(f"prompt+max_new_tokens={total} exceeds "
                             f"max_len={self.max_len}")
        worst_pages = _ceil_div(total, self.page_tokens)
        if worst_pages > min(self.pages_per_slot, self.n_pages):
            raise ValueError(f"request needs up to {worst_pages} pages; pool "
                             f"has {self.n_pages} (per-slot cap "
                             f"{self.pages_per_slot})")
        tenant = None
        if self.registry is not None:
            if session is None:
                raise PermissionError("multi-tenant engine: submit() needs a "
                                      "registry session handle")
            tenant = self.registry.validate(session)
            if worst_pages > tenant.page_quota:
                raise ValueError(
                    f"request needs up to {worst_pages} pages; tenant "
                    f"{tenant.tenant_id!r} quota is {tenant.page_quota}")
        elif session is not None:
            raise ValueError("session handle given but the engine has no "
                             "tenant registry")
        rid = self._next_rid
        self._next_rid += 1
        req = Request(rid, prompt, max_new_tokens, submit_tick=self.tick,
                      share_prefix=bool(request.share_prefix),
                      submit_time=time.perf_counter())
        self.requests[rid] = req
        if tenant is not None:
            req.tenant_idx = tenant.index
            if not self._tenant_active(tenant.index):
                self._activate_vtime(tenant.index)
            self._tenant_waiting.setdefault(tenant.index,
                                            deque()).append(req)
        else:
            self.waiting.append(req)
        return rid

    def _tenant_active(self, index: int) -> bool:
        """Tenant has queued or running work (stride-scheduler sense)."""
        if self._tenant_waiting.get(index):
            return True
        return any(s is not None and s.tenant is not None
                   and s.tenant.index == index for s in self.slots)

    def _activate_vtime(self, index: int) -> None:
        """Re-anchor a tenant's virtual time as it enters the backlog:
        max(its own, the least virtual time of the active tenants, or
        the most ever reached when none is active), so a late tenant
        gets no credit for its idle time."""
        active = [v for j, v in self._vtime.items()
                  if j != index and self._tenant_active(j)]
        floor = (min(active) if active
                 else max(self._vtime.values(), default=0.0))
        self._vtime[index] = max(self._vtime.get(index, 0.0), floor)

    def rotate(self, tenant_id: str) -> int:
        """Live key rotation for one tenant (see :meth:`_pre_rotation`
        and :meth:`_on_rotation`); returns the new epoch."""
        if self.registry is None:
            raise ValueError("rotate() needs a tenant registry")
        return self.registry.rotate(tenant_id)

    def _page_owners(self) -> np.ndarray:
        """Per-frame owning tenant index (-1: free, cache or
        single-tenant), folded into the Merkle leaves so two tenants'
        frames never swap proofs.  Cross-tenant sharing reseals into the
        destination's own frames, so the map is single-valued."""
        owners = np.full(self.n_pages, -1, np.int64)
        for s in self.slots:
            if s is None or s.tenant is None:
                continue
            for p in s.pages:
                owners[p] = s.tenant.index
        return owners

    def audit_proof(self, session=None, *, rid: Optional[int] = None):
        """O(log n) membership proof for a session's resident frames.

        Returns a :class:`repro_torch.serve.merkle_pool.AuditProof`
        (leaf MACs, sibling paths, the current Merkle root), which the
        tenant checks with :func:`~repro_torch.serve.merkle_pool.
        verify_proof` and nothing else.  In tenant mode it covers every
        resident frame of the session's tenant (``rid=`` narrows it to
        one request); single-tenant, every resident frame.
        """
        if self.merkle is None:
            raise ValueError("audit_proof() needs the Merkle level "
                             "(engine built with merkle=False)")
        tenant = None
        if rid is not None:
            slot = next((s for s in self.slots
                         if s is not None and s.req.rid == rid), None)
            if slot is None:
                raise KeyError(f"request {rid} has no resident slot")
            tenant = slot.tenant
        elif self.registry is not None:
            if session is None:
                raise PermissionError("multi-tenant engine: audit_proof() "
                                      "needs a session handle")
            tenant = self.registry.validate(session)
        pages: list = []
        for s in self.slots:
            if s is None:
                continue
            if rid is not None and s.req.rid != rid:
                continue
            if tenant is not None and (s.tenant is None
                                       or s.tenant.index != tenant.index):
                continue
            pages.extend(s.pages)
        self._merkle_sync()
        proof = self.merkle.audit_proof(
            pages, tenant=None if tenant is None else tenant.index)
        self.stats["audit_proofs"] += 1
        self._audit("audit_proof",
                    tenant=None if tenant is None else tenant.tenant_id,
                    pages=len(proof.pages), root=proof.root)
        return proof

    def share_prefix(self, tokens, *, from_session, to_session) -> int:
        """Reseal one tenant's cached prefix for another; returns the
        pages shared.

        The only cross-tenant sharing path (a cache match never crosses
        tenants).  With valid sessions of both tenants, the source's
        cached chain covering ``tokens`` is decrypt-verified under the
        source cache binding and resealed page by page under the
        destination's, then indexed on the destination's own chain.
        """
        if self.prefix_cache is None:
            raise ValueError("share_prefix() needs prefix_cache=True")
        src = self.registry.validate(from_session)
        dst = self.registry.validate(to_session)
        tokens = [int(t) for t in tokens]
        pc = self.prefix_cache
        src_chain = pc.match(src.index, tokens)
        if not src_chain:
            return 0
        covered = sum(e.n_tokens for e in src_chain)
        matched_dst, missing = pc.missing(dst.index, tokens[:covered])
        if not missing:
            return 0            # already cached for dst (or partial leaf)
        src_entries = src_chain[len(matched_dst):]
        short = pc.free_capacity()
        if short < len(missing):
            self._free(pc.reclaim(len(missing) - short))
        k = min(len(missing), pc.free_capacity(), len(self.free_pages))
        if k == 0:
            return 0
        missing, src_entries = missing[:k], src_entries[:k]
        dst_pages = [self.free_pages.pop() for _ in range(k)]
        ok = self._copy_pages(
            [e.page_id for e in src_entries], dst_pages,
            src=(src.index, self.registry.cache_row(src.index),
                 kvp.PREFIX_ROLE),
            dst=(dst.index, self.registry.cache_row(dst.index),
                 kvp.PREFIX_ROLE),
            lanes=max(self.pages_per_slot, k))
        if not self.page_io.report_verdict(ok, "prefix_share"):
            self._free(dst_pages)
            raise self._integrity_fail(
                f"reseal-on-share {src.tenant_id!r} -> {dst.tenant_id!r} "
                f"failed source verification", op="prefix_share",
                tenant=src.tenant_id, to_tenant=dst.tenant_id,
                pages=[int(e.page_id) for e in src_entries])
        parent = matched_dst[-1] if matched_dst else None
        for (key, n_tok), page_id in zip(missing, dst_pages):
            parent = pc.insert(key, parent, page_id, n_tok)
        self.stats["prefix_shared_pages"] += k
        self._audit("prefix_share", tenant=src.tenant_id,
                    to_tenant=dst.tenant_id, pages=k)
        return k

    def _copy_pages(self, src_ids: list, dst_ids: list, *, src: tuple,
                    dst: tuple, lanes: int) -> bool:
        """Reseal pages ``src_ids`` into ``dst_ids`` (one
        :meth:`PageIO.copy`, padded to ``lanes`` with the scratch page);
        ``src`` / ``dst`` are the ``(tenant index, bank row, epoch
        word)`` of each side.  Returns the source verdict, synced to the
        host before any write; nothing was written when it is False."""
        bank = self._bank()

        def ids(pages):
            out = np.full((lanes,), self.spec.scratch_page, np.int64)
            out[: len(pages)] = pages
            return out

        def ctx(owner, row, epoch):
            return kvp.PageKeyCtx.make(
                bank, np.full((lanes,), row, np.int64),
                np.full((lanes,), owner, np.int64),
                np.full((lanes,), epoch, np.int64))

        _, ok = self.page_io.copy(self.pool, ids(src_ids), ids(dst_ids),
                                  vn_mod.kv_page_vn(self._next_epoch()),
                                  ctx(*src), ctx(*dst))
        return ok

    def _pre_rotation(self, tenant, new_epoch: int) -> None:
        """Eagerly reseal this engine's pages about to leave the key
        window, to the tenant's current epoch, one reseal per slot.
        Runs while the dying epoch's row is still in the bank."""
        oldest_after = new_epoch - self.registry.retain + 1
        cur = tenant.current_epoch
        for i, slot in enumerate(self.slots):
            if slot is None or slot.tenant is not tenant:
                continue
            # Cache pages (epoch word PREFIX_ROLE) live outside the
            # epoch window: their keys never rotate.
            stale = [j for j, e in enumerate(slot.page_epochs)
                     if not (e & kvp.PREFIX_ROLE) and e < oldest_after]
            if stale:
                self._reseal_slot(i, stale, cur)

    def _reseal_slot(self, slot_idx: int, page_pos: list,
                     to_epoch: int) -> None:
        """Reseal the given page positions of one slot to ``to_epoch``
        (padded to ``pages_per_slot`` entries with the scratch page)."""
        slot = self.slots[slot_idx]
        tenant = slot.tenant
        n = self.pages_per_slot
        page_ids = np.full((n,), self.spec.scratch_page, np.int64)
        old_rows = np.zeros((n,), np.int64)
        old_epochs = np.zeros((n,), np.int64)
        for k, j in enumerate(page_pos):
            page_ids[k] = slot.pages[j]
            old_epochs[k] = slot.page_epochs[j]
            old_rows[k] = self.registry.key_row(tenant.index,
                                                slot.page_epochs[j])
        owners = np.full((n,), tenant.index, np.int64)
        bank = self._bank()
        old_ctx = kvp.PageKeyCtx.make(bank, old_rows, owners, old_epochs)
        new_ctx = kvp.PageKeyCtx.make(
            bank, np.full((n,), self.registry.key_row(tenant.index, to_epoch),
                          np.int64), owners, np.full((n,), to_epoch, np.int64))
        # The reseal writes nothing unless its read verified: resealing
        # tampered bytes would launder them under fresh, valid MACs.
        _, ok = self.page_io.reseal(
            self.pool, torch.as_tensor(page_ids, device=self.device),
            vn_mod.kv_page_vn(self._next_epoch()), old_ctx, new_ctx)
        if not self.page_io.report_verdict(ok, "reseal"):
            raise self._integrity_fail(
                f"reseal of slot {slot_idx} pages {page_pos} failed "
                f"verification (tenant {tenant.tenant_id!r})",
                op="reseal", tenant=tenant.tenant_id, slot=slot_idx,
                pages=[int(slot.pages[j]) for j in page_pos])
        for j in page_pos:
            slot.page_epochs[j] = to_epoch
        self.stats["reseals"] += 1
        self._audit("reseal", tenant=tenant.tenant_id, slot=slot_idx,
                    pages=len(page_pos), to_epoch=to_epoch)

    def _on_rotation(self, tenant, new_epoch: int) -> None:
        """Post-rotation hook: preempt any slot still holding a page
        outside the retained window (the fallback a reseal should make
        unnecessary)."""
        oldest_retained = new_epoch - self.registry.retain + 1
        for i, slot in enumerate(self.slots):
            if (slot is not None and slot.tenant is tenant
                    and any(not (e & kvp.PREFIX_ROLE) and e < oldest_retained
                            for e in slot.page_epochs)):
                self._preempt(i)
        self.stats["rotations"] += 1
        self._audit("rotation", tenant=tenant.tenant_id,
                    new_epoch=new_epoch)

    def tenant_resident_pages(self, index: int) -> int:
        """Pool pages currently owned by one tenant's running slots."""
        return sum(len(s.pages) for s in self.slots
                   if s is not None and s.tenant is not None
                   and s.tenant.index == index)

    @property
    def n_free_pages(self) -> int:
        return len(self.free_pages)

    def _n_waiting(self) -> int:
        return len(self.waiting) + sum(len(q) for q in
                                       self._tenant_waiting.values())

    @torch.no_grad()
    @_traced("tick", "tick_seconds")
    def step(self) -> list:
        """One scheduler tick: admit, grow/evict, batched decode.

        Returns the requests that finished during this tick.  With fault
        tolerance an :class:`IntegrityError` raised by any phase is
        contained (:meth:`_contain_error`) instead of escaping; skipping
        the rest of a phase for one tick changes no token, since no
        slot's bookkeeping advanced for the skipped work.  Containment
        runs after the phase's verdict sync, so no decode is in flight
        while it writes the pool.
        """
        finished: list = []
        if self.ft is None:
            active_idx = self._tick_begin(finished)
            if active_idx:
                pending = self._decode_dispatch(active_idx)
                self._decode_collect(active_idx, pending, finished)
            self._tick_end()
            return finished
        try:
            active_idx = self._tick_begin(finished)
        except IntegrityError as err:
            self._contain_error(err)
            active_idx = []
        try:
            if active_idx:
                pending = self._decode_dispatch(active_idx)
                self._decode_collect(active_idx, pending, finished)
        except IntegrityError as err:
            self._contain_error(err)
        try:
            self._tick_end()
        except IntegrityError as err:
            self._contain_error(err)
        return finished

    @_traced("tick_begin", "phase_tick_begin_seconds")
    def _tick_begin(self, finished: list) -> list:
        self.tick += 1
        if (self.registry is not None and self.rotate_every
                and self.tick % self.rotate_every == 0
                and self.registry.n_tenants):
            idx = self._rotate_rr % self.registry.n_tenants
            self._rotate_rr += 1
            self.rotate(self.registry.by_index(idx).tenant_id)
        self._admit(finished)
        self._ensure_growth()
        if self.prefix_cache is not None:
            self._ensure_cow()
        return [i for i, s in enumerate(self.slots) if s is not None]

    @_traced("tick_end", "phase_tick_end_seconds")
    def _tick_end(self) -> None:
        if (self.policy.deferred_model_mac and self.defer_interval
                and self.tick % self.defer_interval == 0):
            self._deferred_check()
        # Merkle upkeep shares the deferred cadence, not the scheme gate:
        # every scheme keeps a page-MAC table.
        if (self.merkle is not None and self.defer_interval
                and self.tick % self.defer_interval == 0):
            self._merkle_sync()

    def _merkle_sync(self) -> None:
        roots, leaves = self.merkle.sync()
        self.stats["merkle_root_updates"] += roots
        self.stats["merkle_leaf_updates"] += leaves

    def run(self, max_ticks: int = 100_000) -> RunResult:
        """Drive ticks until every submitted request finished."""
        for _ in range(max_ticks):
            if self._n_waiting() or any(s is not None for s in self.slots):
                self.step()
                continue
            if self._drained():
                break
        else:
            raise RuntimeError("run() exceeded max_ticks")
        result = RunResult({rid: r for rid, r in self.requests.items()
                            if r.state == "finished"})
        result.latency = self.latency_stats()
        return result

    def _drained(self) -> bool:
        """End-of-run verification; True when nothing was requeued.

        Without fault tolerance a failed check raises.  With it, the
        failure is contained, which may requeue recovering sessions:
        :meth:`run` then keeps ticking.
        """
        if self.policy.deferred_model_mac:
            if self.ft is None:
                self._deferred_check()
            else:
                try:
                    self._deferred_check()
                except IntegrityError as err:
                    self._contain_error(err)
        if not self.verify_every_step and not self.page_io.report_verdict(
                self._ok_accum, "decode_accum"):
            err = self._integrity_fail(
                "accumulated page-MAC verification failed", op="decode_accum")
            if self.ft is None:
                raise err
            self._contain_error(err)
            self._ok_accum = torch.ones((), dtype=torch.bool,
                                        device=self.device)
        return not (self._n_waiting()
                    or any(s is not None for s in self.slots))

    def latency_stats(self) -> dict:
        """p50/p95/p99 ticks-to-first-token and ticks-per-token
        (finished requests)."""
        return latency_percentiles(self.requests.values())

    def deferred_check(self) -> bool:
        """Model-level deferred MAC over the whole pool (paper Table I)."""
        return bool(kvp.deferred_pool_check(self.pool, self.spec))

    # -- device-cost profile ------------------------------------------------

    def decode_cost_analysis(self, bucket: Optional[int] = None) -> dict:
        """Attributed cost of one batched decode call: ``{"flops": ...,
        "bytes accessed": ...}``, the keys of XLA's cost analysis that
        the reference returns.  ``bucket`` selects the page-count
        variant (default: the all-resident ``pages_per_slot`` window)."""
        p = profiler_mod.profile_decode(self, bucket)
        return {"flops": p.total["flops"], "bytes accessed": p.total["bytes"]}

    def _decode_analysis_args(self, bucket: int) -> list:
        """Shape-representative positional args of one decode variant
        (the reference's zeros and ones): every slot active at length 1
        over page 0, epoch 1; with a registry, every page and write on
        bank row 0; with on-chip state, every slot's column."""
        s, dev = self.max_slots, self.device
        args = [torch.zeros((s, bucket), dtype=torch.int64, device=dev),
                torch.ones((s,), dtype=torch.int64, device=dev),
                torch.ones((s,), dtype=torch.bool, device=dev),
                torch.zeros((s, 1), dtype=torch.int64, device=dev), 1,
                None, None, None]
        if self.registry is not None:
            bank = self._bank()
            zeros = np.zeros((s * bucket,), np.int64)
            args[5] = kvp.PageKeyCtx.make(bank, zeros, zeros, zeros)
            zeros = np.zeros((s,), np.int64)
            args[6] = kvp.PageKeyCtx.make(bank, zeros, zeros, zeros)
        if self.onchip_idx:
            args[7] = torch.arange(s, dtype=torch.int64, device=dev)
        return args

    @contextlib.contextmanager
    def _detached_decode(self):
        """Run a decode call against clones of the pool and the on-chip
        state, with the pool's write listeners detached: what the call
        writes reaches no Merkle level or cluster root, and is dropped
        on exit."""
        pool, onchip = self._pool, self.onchip
        listeners = self.page_io.write_listeners
        self._pool = kvp.PagedKVPool(*(
            tuple(t.clone() for t in f) if isinstance(f, tuple) else f.clone()
            for f in pool))
        self.onchip = [t.clone() for t in onchip]
        self.page_io.write_listeners = []
        # The graphs read the engine's own state, not these clones.
        graphs_off, self._graphs_off = self._graphs_off, True
        try:
            yield
        finally:
            self._pool, self.onchip = pool, onchip
            self.page_io.write_listeners = listeners
            self._graphs_off = graphs_off

    def profile(self, buckets=None, uniform: bool = False,
                refresh: bool = False) -> dict:
        """Attributed device-cost profile (protection vs. model) of the
        decode variants — see :mod:`repro_torch.obs.profiler`.

        Runs each requested (bucket, uniform) variant once on first use,
        on scratch copies of the engine's state, and caches the
        :class:`~repro_torch.obs.profiler.CostProfile`; the
        ``protection_overhead_ratio`` / ``roofline_utilization`` lazy
        gauges sample this cache, so snapshots never run a decode.
        """
        if buckets is None:
            buckets = [self.pages_per_slot]
        profiles = []
        for bucket in buckets:
            key = (int(bucket), bool(uniform))
            if refresh or key not in self._cost_profiles:
                self._cost_profiles[key] = profiler_mod.profile_decode(
                    self, int(bucket), bool(uniform))
            profiles.append(self._cost_profiles[key])
        return {"scheme": self.scheme, "shard": self.shard_id,
                "profiles": [p.to_dict() for p in profiles]}

    def _deferred_check(self) -> None:
        self.stats["deferred_checks"] += 1
        if not self.page_io.report_verdict(self.deferred_check(), "deferred"):
            raise self._integrity_fail(
                "deferred pool-level MAC check failed "
                f"(tick {self.tick}, scheme={self.scheme})", op="deferred")

    # -- admission ----------------------------------------------------------

    def _next_epoch(self) -> int:
        self._epoch += 1
        return self._epoch

    def _admission_pages(self, req: Request) -> int:
        # +1 so the first decode's write position is always covered.
        return min(len(req.prompt + req.generated) // self.page_tokens + 1,
                   self.pages_per_slot)

    def _held(self, req: Request) -> bool:
        """Recovery backoff: re-admission waits past ``hold_until``."""
        return req.hold_until > self.tick

    def _admit(self, finished: list) -> None:
        if self.registry is None:
            while None in self.slots:
                # FCFS over requests no recovery backoff holds back.
                req = next((r for r in self.waiting if not self._held(r)),
                           None)
                if req is None or \
                        len(self.free_pages) < self._admission_pages(req):
                    break
                self.waiting.remove(req)
                self._admit_one(req, None, finished)
            return
        # Weighted-fair (stride) admission across tenant queues: among
        # tenants whose head request fits (free pages AND page quota),
        # admit the one with the least virtual time and charge it the
        # pages it allocated, scaled by 1/weight.  A quota-capped tenant
        # queues its own work; it never evicts another tenant's.
        while None in self.slots:
            best = None
            for idx, queue in self._tenant_waiting.items():
                if not queue or self._held(queue[0]):
                    continue
                tenant = self.registry.by_index(idx)
                n_alloc = self._admission_pages(queue[0])
                if n_alloc > len(self.free_pages):
                    continue
                if self.tenant_resident_pages(idx) + n_alloc > \
                        tenant.page_quota:
                    continue
                vt = self._vtime[idx]
                if best is None or vt < best[0]:
                    best = (vt, idx, tenant, n_alloc)
            if best is None:
                break
            _, idx, tenant, n_alloc = best
            req = self._tenant_waiting[idx].popleft()
            self._vtime[idx] += n_alloc / tenant.weight
            self._admit_one(req, tenant, finished)

    def _admit_one(self, req: Request, tenant, finished: list) -> None:
        """Admit one request.  Its first wait in the queue ends here
        (``request.queued``, from ``submit()``), and the admission runs
        in a ``request.admit`` span; both carry its rid."""
        if req.submit_time and req.n_evictions == 0:
            trace_mod.record(
                "request.queued", int(req.submit_time * 1e9), rid=req.rid,
                tenant=None if tenant is None else tenant.tenant_id)
        with trace_mod.span("request.admit", rid=req.rid):
            self._admit_to_slot(req, tenant, finished)

    def _admit_to_slot(self, req: Request, tenant, finished: list) -> None:
        seq = req.prompt + req.generated
        if (self.prefix_cache is not None and tenant is not None
                and req.share_prefix and len(seq) > 1):
            # Match over seq[:-1]: at least one token is left to feed the
            # decode loop (a hit generates through decode only).
            hit = self.prefix_cache.match(tenant.index, seq[:-1])
            if hit:
                self._admit_hit(req, tenant, hit, seq)
                return
        n_alloc = self._admission_pages(req)
        slot_idx = self.slots.index(None)
        pages = [self.free_pages.pop() for _ in range(n_alloc)]
        tok, paged_leaves, onchip_leaves = self._prefill(seq)
        n_write = _ceil_div(len(seq), self.page_tokens)
        page_ids = np.full((self.pages_per_slot,), self.spec.scratch_page,
                           np.int64)
        page_ids[: len(pages)] = pages
        ctx, page_epochs = None, []
        if tenant is not None:
            epoch = tenant.current_epoch
            n = self.pages_per_slot
            ctx = kvp.PageKeyCtx.make(
                self._bank(),
                np.full((n,), self.registry.key_row(tenant.index, epoch),
                        np.int64),
                np.full((n,), tenant.index, np.int64),
                np.full((n,), epoch, np.int64))
            page_epochs = [epoch] * len(pages)
        self.page_io.write_prefill(
            self.pool, torch.as_tensor(page_ids, device=self.device),
            paged_leaves, n_write, vn_mod.kv_page_vn(self._next_epoch()), ctx)
        for j, leaf in enumerate(onchip_leaves):
            _set_column(self.onchip[j], slot_idx, leaf[:, 0])
        self._admit_seq += 1
        self.stats["admitted"] += 1
        slot = _Slot(req, length=len(seq), pages=pages,
                     admit_seq=self._admit_seq, tenant=tenant,
                     page_epochs=page_epochs)
        self.slots[slot_idx] = slot
        self.page_table.install(slot_idx, slot)
        req.state = "running"
        self._note_recovered(req)
        req.generated.append(int(tok[0, 0]))
        if req.first_tick is None:
            req.first_tick = self.tick
            self._observe_ttft(req)
        if (self.prefix_cache is not None and tenant is not None
                and req.share_prefix):
            self._prefix_insert(tenant, seq, slot)
        self._maybe_finish(slot_idx, finished)

    def _admit_hit(self, req: Request, tenant, hit: list, seq: list) -> None:
        """Admit a request whose leading pages are cached: no prefill.

        The matched chain's pages go read-only at the front of the slot
        (``shared_n``, epoch word :data:`~repro_torch.serve.kv_pages.
        PREFIX_ROLE`), the length is the tokens they cover, and the rest
        of the prompt waits on ``slot.replay``: each tick teacher-forces
        its next token through the batched decode (its KV lands in
        private pages), and the sample of the LAST replay step is the
        first output, as a full prefill's would be (causal KV at
        position p depends only on tokens 0..p).
        """
        covered = sum(e.n_tokens for e in hit)
        n_shared = len(hit)
        slot_idx = self.slots.index(None)
        self.prefix_cache.acquire(hit)
        slot = _Slot(req, length=covered, pages=[e.page_id for e in hit],
                     admit_seq=self._admit_seq + 1, tenant=tenant,
                     page_epochs=[kvp.PREFIX_ROLE] * n_shared,
                     shared_n=n_shared, shared_entries=list(hit),
                     replay=deque(seq[covered:]))
        self._admit_seq += 1
        self.stats["admitted"] += 1
        self.stats["prefix_hit_pages"] += n_shared
        self.stats["prefill_pages_skipped"] += n_shared
        self.slots[slot_idx] = slot
        self.page_table.install(slot_idx, slot)
        req.state = "running"
        self._note_recovered(req)

    def _note_recovered(self, req: Request) -> None:
        """Count a recompute-recovery re-admission."""
        if req.recovering:
            req.recovering = False
            self.stats["sessions_recovered"] += 1
            self._audit("session_recovered", rid=req.rid,
                        retries=req.integrity_retries)

    def _prefix_insert(self, tenant, seq: list, slot: _Slot) -> None:
        """Seed the cache from a freshly prefilled slot (full miss only).

        Copies the slot's leading chunk pages into free pages under the
        tenant's cache binding (session epoch word -> ``PREFIX_ROLE``);
        the slot keeps decoding on its private pages.  The copy checks
        its source before it writes, so tampered session pages are never
        laundered into valid cache MACs.
        """
        pc = self.prefix_cache
        matched, missing = pc.missing(tenant.index, seq)
        if matched or not missing:
            return              # partial hits never extend the chain here
        short = pc.free_capacity()
        if short < len(missing):
            self._free(pc.reclaim(len(missing) - short))
        k = min(len(missing), pc.free_capacity(), len(self.free_pages))
        if k == 0:
            return
        missing = missing[:k]
        dst_pages = [self.free_pages.pop() for _ in range(k)]
        epoch = tenant.current_epoch
        ok = self._copy_pages(
            slot.pages[:k], dst_pages,
            src=(tenant.index, self.registry.key_row(tenant.index, epoch),
                 epoch),
            dst=(tenant.index, self.registry.cache_row(tenant.index),
                 kvp.PREFIX_ROLE),
            lanes=self.pages_per_slot)
        if not self.page_io.report_verdict(ok, "prefix_insert"):
            self._free(dst_pages)
            raise self._integrity_fail(
                f"prefix-cache insert for tenant {tenant.tenant_id!r} "
                f"failed source verification",
                op="prefix_insert", tenant=tenant.tenant_id,
                pages=[int(p) for p in slot.pages[:k]])
        parent = None
        for (key, n_tok), page_id in zip(missing, dst_pages):
            parent = pc.insert(key, parent, page_id, n_tok)
        self.stats["prefix_inserted_pages"] += k
        self._audit("prefix_insert", tenant=tenant.tenant_id, pages=k)

    def _ensure_growth(self) -> None:
        order = sorted((i for i, s in enumerate(self.slots) if s is not None),
                       key=lambda i: self.slots[i].admit_seq)
        for i in order:
            slot = self.slots[i]
            if slot is None:                      # evicted by an older slot
                continue
            need = slot.length // self.page_tokens
            while self.slots[i] is not None and len(slot.pages) <= need:
                tenant = slot.tenant
                if tenant is not None and \
                        self.tenant_resident_pages(tenant.index) + 1 > \
                        tenant.page_quota:
                    # Over quota: the tenant preempts ITS OWN youngest.
                    self._preempt(self._pick_victim(tenant))
                    continue
                if self.free_pages:
                    slot.pages.append(self.free_pages.pop())
                    if tenant is not None:
                        slot.page_epochs.append(tenant.current_epoch)
                    continue
                self._preempt(self._pick_victim(tenant))

    def _ensure_cow(self) -> None:
        """Copy-on-write every shared page this tick's decode will dirty.

        Runs after growth, before dispatch: the dirty page is ``length //
        page_tokens``; while it is still inside the shared prefix it is
        privatized first, so decode never writes a refcounted cache
        page.  Only the LAST shared page can be partial, so at most one
        copy fires per slot over its life.
        """
        for i, slot in enumerate(self.slots):
            if slot is None or not slot.shared_n:
                continue
            if slot.length // self.page_tokens < slot.shared_n:
                self._cow_page(i)

    def _cow_page(self, idx: int) -> None:
        """Privatize one slot's deepest shared page before it is dirtied."""
        slot = self.slots[idx]
        tenant = slot.tenant
        pos = slot.shared_n - 1     # only the deepest shared page is partial
        while not self.free_pages:
            freed = self.prefix_cache.reclaim(1)
            if freed:
                self._free(freed)
                break
            self._preempt(self._pick_victim(tenant))
            if self.slots[idx] is None:
                return              # the CoW slot itself was the victim
        dst = self.free_pages.pop()
        epoch = tenant.current_epoch
        ok = self._copy_pages(
            [slot.pages[pos]], [dst],
            src=(tenant.index, self.registry.cache_row(tenant.index),
                 kvp.PREFIX_ROLE),
            dst=(tenant.index, self.registry.key_row(tenant.index, epoch),
                 epoch),
            lanes=self.pages_per_slot)
        if not self.page_io.report_verdict(ok, "cow"):
            self._free([dst])
            raise self._integrity_fail(
                f"copy-on-write of slot {idx} shared page {pos} failed "
                f"verification (tenant {tenant.tenant_id!r})",
                op="cow", tenant=tenant.tenant_id, slot=idx,
                page=int(slot.pages[pos]))
        slot.pages[pos] = dst
        slot.page_epochs[pos] = epoch
        slot.shared_n -= 1
        self.prefix_cache.release([slot.shared_entries.pop()])
        self.stats["prefix_cow_pages"] += 1
        self._audit("cow", tenant=tenant.tenant_id, slot=idx, page=int(dst))

    def _pick_victim(self, tenant=None) -> int:
        """Youngest running slot (LIFO preemption), scoped to
        ``tenant``'s own slots in multi-tenant mode."""
        candidates = [i for i, s in enumerate(self.slots) if s is not None
                      and (tenant is None or s.tenant is tenant)]
        return max(candidates, key=lambda i: self.slots[i].admit_seq)

    def _unpin_shared(self, slot: _Slot) -> None:
        """Drop a dying slot's pin on its shared prefix pages: they
        belong to the cache, and only the private tail is freed."""
        if slot.shared_n:
            self.prefix_cache.release(slot.shared_entries)
            del slot.pages[: slot.shared_n]
            del slot.page_epochs[: slot.shared_n]
            slot.shared_n = 0
            slot.shared_entries = []

    def _preempt(self, idx: int) -> None:
        slot = self.slots[idx]
        self._unpin_shared(slot)
        self._free(slot.pages)
        self.slots[idx] = None
        self.page_table.clear(idx)
        slot.req.state = "waiting"
        slot.req.n_evictions += 1
        self.stats["preemptions"] += 1
        if self._preempt_hook is not None and self._preempt_hook(slot.req):
            return          # the cluster took it (re-routes across shards)
        if slot.tenant is not None:               # preempted go to the front
            self._tenant_waiting[slot.tenant.index].appendleft(slot.req)
        else:
            self.waiting.appendleft(slot.req)

    def _release(self, idx: int) -> None:
        slot = self.slots[idx]
        self._unpin_shared(slot)
        self._free(slot.pages)
        self.slots[idx] = None
        self.page_table.clear(idx)
        slot.req.state = "finished"

    def _maybe_finish(self, idx: int, finished: list) -> None:
        req = self.slots[idx].req
        hit_eos = (self.eos_id is not None and req.generated
                   and req.generated[-1] == self.eos_id)
        if req.done or hit_eos:
            req.done_tick = self.tick
            self._release(idx)
            finished.append(req)

    # -- fault containment (quarantine + secure-recompute recovery) ---------

    def _free(self, pages) -> None:
        """Return pages to the free list, less quarantined frames."""
        self.free_pages.extend(p for p in pages
                               if int(p) not in self.quarantined)

    def _n_recovering(self) -> int:
        """Sessions preempted for recovery and not yet re-admitted (the
        SLO monitor's degraded signal)."""
        return sum(1 for r in self.requests.values() if r.recovering)

    def _commit_repair(self) -> None:
        """Announce an in-place repair: every listener re-adopts the
        pool wholesale (``old_pool=None``), since the tamper being
        repaired bypassed them and no delta can be trusted."""
        self._notify_pool(None, self.pool, None)

    def _quarantine_pages(self, pages) -> None:
        """Retire frames for good after a localized fault.

        They leave the free list forever, the prefix cache drops every
        entry holding one, their MAC and VN rows are zeroed and the
        pool MAC is rebuilt from the scrubbed page MACs, so the XOR
        identity holds again without trusting a tampered byte.  Unlike
        the reference, which commits a new pool value, the rows are
        zeroed in place, then :meth:`_commit_repair` tells the
        listeners.
        """
        fresh = sorted({int(p) for p in pages} - self.quarantined)
        if not fresh:
            return
        self.quarantined.update(fresh)
        self.free_pages = [p for p in self.free_pages
                           if p not in self.quarantined]
        if self.prefix_cache is not None:
            self.prefix_cache.evict_pages(fresh)
        pool = self.pool
        ids = torch.as_tensor(fresh, dtype=torch.int64, device=self.device)
        pool.page_macs[ids] = 0
        for bm in pool.block_macs:
            bm[ids] = 0
        pool.page_vns[ids] = 0
        pool.pool_mac.copy_(
            mac_mod.xor_aggregate(pool.page_macs[: self.spec.n_pages]))
        self._commit_repair()
        self.stats["integrity_quarantined_pages"] += len(fresh)
        self._audit("quarantine", pages=fresh)

    def _rebuild_pool_mac(self) -> None:
        """Recompute the deferred pool MAC from the stored page MACs.

        The fallback when localization finds no failing page yet a
        pool-level check failed: the pool MAC itself was hit, and the
        page MACs all just verified.  Free pages' MACs are not verified
        here, but they protect no live data and are rewritten by their
        next prefill."""
        pool = self.pool
        pool.pool_mac.copy_(
            mac_mod.xor_aggregate(pool.page_macs[: self.spec.n_pages]))
        self._commit_repair()
        self._audit("pool_mac_rebuild")

    def _probe_page(self, slot_idx: int, pos: int) -> bool:
        """Re-read one resident page through the raw verify path.

        Tried ``1 + ft.reread_retries`` times, so a transient fault does
        not condemn a healthy frame; each verdict is reported (op
        ``probe``).  One page per read, as the reference probes: on
        ``seda`` with kernels that is a single-key crossing (B1 + B2)
        per leaf, or a mixed-key one (B4 + B5) in tenant mode."""
        slot = self.slots[slot_idx]
        pid = int(slot.pages[pos])
        ids = torch.tensor([pid], dtype=torch.int64, device=self.device)
        ctx = None
        if self.registry is not None:
            tenant = slot.tenant
            epoch = slot.page_epochs[pos]
            if epoch & kvp.PREFIX_ROLE:
                row = self.registry.cache_row(tenant.index)
            else:
                try:
                    row = self.registry.key_row(tenant.index, epoch)
                except KeyError:
                    return False        # unverifiable == condemned
            ctx = kvp.PageKeyCtx.make(self._bank(), [row], [tenant.index],
                                      [epoch])
        attempts = 1 + (self.ft.reread_retries if self.ft is not None else 0)
        for _ in range(attempts):
            _, ok = self.page_io.read_raw(self.pool, ids, ctx)
            if self.page_io.report_verdict(ok, "probe", slot=slot_idx,
                                           page=pid):
                return True
        return False

    def _localize(self, slot_idxs=None) -> list:
        """Probe every resident page of the given (default: all) slots;
        ``[(slot_idx, pos, page_id), ...]`` for each page that fails
        every re-read."""
        idxs = (slot_idxs if slot_idxs is not None
                else range(self.max_slots))
        bad = []
        for i in idxs:
            slot = self.slots[i]
            if slot is None:
                continue
            for pos in range(len(slot.pages)):
                if not self._probe_page(i, pos):
                    bad.append((i, pos, int(slot.pages[pos])))
        return bad

    def _preempt_recover(self, idx: int) -> None:
        """Preempt one slot for secure-recompute recovery, or declare
        its session lost once the retry budget is spent."""
        slot = self.slots[idx]
        req = slot.req
        req.integrity_retries += 1
        if self.ft is not None and \
                req.integrity_retries > self.ft.max_retries:
            self._unpin_shared(slot)
            self._free(slot.pages)
            self.slots[idx] = None
            self.page_table.clear(idx)
            req.state = "failed"
            req.recovering = False
            self.stats["sessions_lost"] += 1
            self._audit("session_lost", rid=req.rid, slot=idx,
                        retries=req.integrity_retries)
            return
        req.recovering = True
        if self.ft is not None and self.ft.backoff_ticks:
            req.hold_until = self.tick + self.ft.backoff_ticks * (
                1 << (req.integrity_retries - 1))
        self._audit("session_recovery", rid=req.rid, slot=idx,
                    retries=req.integrity_retries)
        self._preempt(idx)

    def _contain_error(self, err: IntegrityError) -> None:
        """Quarantine and recover after a caught integrity failure.

        Pages the error names are condemned directly; otherwise every
        resident page is probed.  When nothing fails for good (a
        transient fault, or a hit on the pool MAC itself) the pool MAC
        is rebuilt instead, so the next deferred check passes without
        laundering a tampered page."""
        ctx = getattr(err, "ctx", None) or {}
        pages = [int(p) for p in ctx.get("pages", [])]
        if "page" in ctx and int(ctx["page"]) not in pages:
            pages.append(int(ctx["page"]))
        if not pages:
            pages = [b[2] for b in self._localize()]
        self._audit("fault_contained", detail=str(err),
                    op=ctx.get("op"), pages=pages)
        if pages:
            self._quarantine_pages(pages)
            for i, slot in enumerate(self.slots):
                if slot is not None and any(
                        int(p) in self.quarantined for p in slot.pages):
                    self._preempt_recover(i)
        else:
            self._rebuild_pool_mac()

    # -- decode -------------------------------------------------------------

    def _bank(self):
        """The registry's key bank on this engine's device."""
        return self.registry.bank_for(self.device)

    def _uniform_row(self, active_idx: list):
        """``(tenant, row)`` when every resident page and every dirty
        write of the tick resolves to one bank row, else None: the gate
        of the single-key route."""
        tenant, row = None, None
        for i in active_idx:
            slot = self.slots[i]
            t = slot.tenant
            if t is None:
                return None
            if any(e != t.current_epoch for e in slot.page_epochs):
                return None
            r = self.registry.key_row(t.index, t.current_epoch)
            if row is None:
                tenant, row = t, r
            elif r != row:
                return None
        return (tenant, row)

    def _tenant_decode_args(self, active_idx: list, bucket: int) -> tuple:
        """Per-slot / per-page key selections for one decode tick.

        Returns ``((key_idx (S, P), owners (S,), key_epochs (S, P),
        cur_key_idx (S,), cur_epochs (S,)), uniform)`` as host arrays, P
        the tick's bucket.  When ``uniform`` every entry holds the one
        row, so the single key also covers inactive slots' scratch
        writes.  Inactive slots and pages past a slot's list otherwise
        select row 0 (a real row: the gathers stay in range).  A
        resident page claiming an epoch outside its tenant's retained
        window raises :class:`IntegrityError` (stale-epoch replay or a
        tampered page table).
        """
        s, p = self.max_slots, bucket
        uni = self._uniform_row(active_idx)
        if uni is not None:
            tenant, row = uni
            epoch = tenant.current_epoch
            return ((np.full((s, p), row, np.int64),
                     np.full((s,), tenant.index, np.int64),
                     np.full((s, p), epoch, np.int64),
                     np.full((s,), row, np.int64),
                     np.full((s,), epoch, np.int64)), True)
        key_idx = np.zeros((s, p), np.int64)
        owners = np.zeros((s,), np.int64)
        key_epochs = np.zeros((s, p), np.int64)
        cur_key_idx = np.zeros((s,), np.int64)
        cur_epochs = np.zeros((s,), np.int64)
        for i, slot in enumerate(self.slots):
            if slot is None or slot.tenant is None:
                continue
            tenant = slot.tenant
            owners[i] = tenant.index
            cur_epochs[i] = tenant.current_epoch
            cur_key_idx[i] = self.registry.key_row(tenant.index,
                                                   tenant.current_epoch)
            for j, epoch in enumerate(slot.page_epochs[:p]):
                key_epochs[i, j] = epoch
                if epoch & kvp.PREFIX_ROLE:
                    # Shared prefix page: the tenant's epoch-independent
                    # cache row, not a session epoch's.
                    key_idx[i, j] = self.registry.cache_row(tenant.index)
                    continue
                try:
                    key_idx[i, j] = self.registry.key_row(tenant.index,
                                                          epoch)
                except KeyError as e:
                    raise self._integrity_fail(
                        f"slot {i} page {j}: {e.args[0]} (stale_epoch, "
                        f"tenant {tenant.tenant_id!r}, page "
                        f"{slot.pages[j]})",
                        op="stale_epoch", tenant=tenant.tenant_id,
                        slot=i, page=int(slot.pages[j])) from e
        return ((key_idx, owners, key_epochs, cur_key_idx, cur_epochs),
                False)

    @_traced("decode_dispatch", "phase_decode_dispatch_seconds")
    def _decode_dispatch(self, active_idx: list):
        """Launch this tick's batched decode over the bucketed window.

        The bucket is picked host-side from the live lengths.  Returns
        the ``(toks, ok)`` device tensors (no host sync).
        """
        bucket = self.page_table.bucket_for(
            (self.slots[i].length for i in active_idx), self.page_tokens)
        if self.tracer is not None:
            # The window crosses every slot's bucket, empty slots and
            # pages past a slot's length included; live pages hold a token.
            self.tracer.annotate(
                pages_crossed=self.max_slots * bucket,
                pages_live=sum(_ceil_div(self.slots[i].length,
                                         self.page_tokens)
                               for i in active_idx))
        page_table = self.page_table.window(bucket)
        lengths = np.zeros((self.max_slots,), np.int64)
        active = np.zeros((self.max_slots,), bool)
        tokens = np.zeros((self.max_slots, 1), np.int64)
        for i in active_idx:
            slot = self.slots[i]
            lengths[i] = slot.length
            active[i] = True
            # A prefix hit teacher-forces the prompt tail its skipped
            # prefill still owes the KV cache.
            tokens[i, 0] = (slot.replay[0] if slot.replay
                            else slot.req.generated[-1])
        dev = self.device
        args = [torch.as_tensor(page_table, device=dev),
                torch.as_tensor(lengths, device=dev),
                torch.as_tensor(active, device=dev),
                torch.as_tensor(tokens, device=dev), self._next_epoch()]
        uniform, kw = False, {}
        if self.onchip_idx:
            kw["slot_ids"] = torch.as_tensor(active_idx, dtype=torch.int64,
                                             device=dev)
        if self.registry is not None:
            (key_idx, owners, key_epochs, cur_key_idx, cur_epochs), \
                uniform = self._tenant_decode_args(active_idx, bucket)
            bank = self._bank()
            args += [kvp.PageKeyCtx.make(bank, key_idx.reshape(-1),
                                         np.repeat(owners, bucket),
                                         key_epochs.reshape(-1)),
                     kvp.PageKeyCtx.make(bank, cur_key_idx, owners,
                                         cur_epochs)]
        decode_fn = self._decode_fn_for(bucket, uniform)
        if uniform or self.registry is None:
            # Single-key tick: flat crypt/MAC route, fused kernels when
            # the spec qualifies.
            self.stats["uniform_fast_ticks"] += 1
        elif kvp._kernel_read_ok(self.spec) and \
                self.spec.cfg.verify != "none":
            # Mixed bank rows on the mixed-key kernels.
            self.stats["fused_mixed_ticks"] += 1
        if kvp._kernel_write_ok(self.spec) and self.spec.cfg.verify != "none":
            self.stats["fused_write_ticks"] += 1
        self.stats["decode_page_reads"] += len(active_idx) * bucket
        self._bucket_hist.observe(bucket)
        toks, ok = decode_fn(*args, **kw)
        self.stats["decode_steps"] += 1
        return toks, ok

    @_traced("decode_collect", "phase_decode_collect_seconds")
    def _decode_collect(self, active_idx: list, pending,
                        finished: list) -> None:
        """Sync on a dispatched decode and apply host bookkeeping."""
        toks, ok = pending
        if self.verify_every_step:
            if not self.page_io.report_verdict(ok, "decode"):
                self._decode_failure(active_idx)
        else:
            self._ok_accum = self._ok_accum & ok
        toks = toks.cpu().numpy()
        for i in active_idx:
            slot = self.slots[i]
            if slot is None:
                continue    # quarantined and preempted by _decode_failure:
                            # recompute recovery replays from its last
                            # good token, so nothing here may advance.
            if slot.tenant is not None:
                # The dirty page was just re-encrypted under the tenant's
                # CURRENT epoch (lazy rotation lands here).
                dirty = slot.length // self.page_tokens
                if dirty < len(slot.page_epochs):
                    slot.page_epochs[dirty] = slot.tenant.current_epoch
            slot.length += 1
            if slot.replay:
                slot.replay.popleft()
                if slot.replay:
                    continue        # mid-replay: the sample is discarded
                # The LAST replay step's sample is the first real output.
            slot.req.generated.append(int(toks[i, 0]))
            if slot.req.first_tick is None:
                slot.req.first_tick = self.tick
                self._observe_ttft(slot.req)
            self._maybe_finish(i, finished)

    def _decode_failure(self, active_idx: list) -> None:
        """The decode gate failed: localize, then contain.

        Every active slot's resident pages are probed and the ones that
        fail for good condemned.  Without fault tolerance the error
        raises, naming those pages in ``err.ctx``.  With it their frames
        are quarantined and only their slots preempted for recovery;
        every other slot's reads verified, so its token and dirty write
        stand.  An empty localization is a transient fault: the tick's
        reads now verify, so nothing is preempted.  (The tick's dirty
        pages were already written back by the decode, as the reference
        commits its decode's pool before this gate.)"""
        bad = self._localize(active_idx)
        ctx = {}
        if bad:
            slot = self.slots[bad[0][0]]
            ctx = dict(slot=bad[0][0], pages=[b[2] for b in bad])
            if slot is not None and slot.tenant is not None:
                ctx["tenant"] = slot.tenant.tenant_id
        if self.ft is None:
            raise self._integrity_fail(
                f"page MAC verification failed at tick {self.tick} "
                f"(scheme={self.scheme}, shard={self.shard_id})",
                op="decode", **ctx)
        if not bad:
            self._audit("transient_fault", op="decode")
            return
        self._audit("fault_contained", op="decode",
                    pages=[b[2] for b in bad])
        self._quarantine_pages([b[2] for b in bad])
        for idx in sorted({b[0] for b in bad}):
            if self.slots[idx] is not None:
                self._preempt_recover(idx)
