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

An integrity failure raises :class:`IntegrityError`.  The prefix cache,
fault containment, the Merkle level, observability and sharding are not
ported yet.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import multilevel
from repro_torch.core import vn as vn_mod
from repro_torch.core.secure_exec import SCHEMES
from repro_torch.core.secure_memory import SecureKeys
from repro_torch.models import lm as lm_mod
from repro_torch.models.layers import tree_map
from repro_torch.serve import kv_pages as kvp
from repro_torch.serve.serve_step import greedy_sample

__all__ = ["IntegrityError", "Request", "RunResult", "SecureServingEngine",
           "SubmitRequest", "latency_percentiles"]

STAT_NAMES = ("admitted", "decode_steps", "prefill_compiles",
              "decode_bucket_compiles", "uniform_fast_ticks",
              "fused_mixed_ticks", "fused_write_ticks", "decode_page_reads",
              "deferred_checks", "preemptions", "rotations", "reseals")


class IntegrityError(RuntimeError):
    """A MAC gate (page/block) or the deferred pool MAC failed."""


@dataclasses.dataclass
class Request:
    rid: int
    prompt: list
    max_new_tokens: int
    generated: list = dataclasses.field(default_factory=list)
    state: str = "waiting"          # waiting | running | finished
    n_evictions: int = 0
    submit_tick: int = 0
    first_tick: Optional[int] = None
    done_tick: Optional[int] = None

    @property
    def done(self) -> bool:
        return len(self.generated) >= self.max_new_tokens


@dataclasses.dataclass
class SubmitRequest:
    """The argument object of :meth:`SecureServingEngine.submit`."""

    prompt: list
    max_new_tokens: int = 16
    session: Optional[object] = None    # SessionHandle in tenant mode


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


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _bucket_len(n: int, cap: int) -> int:
    """Round ``n`` up to the next power of two, capped at ``cap``."""
    b = 1
    while b < n:
        b <<= 1
    return min(b, cap)


class SecureServingEngine:
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
    """

    def __init__(self, arch, cfg, params, *, scheme: str = "seda",
                 max_slots: int = 4, page_tokens: int = 8,
                 pages_per_slot: int = 8, n_pages: Optional[int] = None,
                 keys: Optional[SecureKeys] = None,
                 use_kernel: bool = False, defer_interval: int = 16,
                 registry=None, rotate_every: int = 0, device=None):
        if arch.kind != "lm":
            raise ValueError("the paged serving engine supports decoder-only "
                             "LMs")
        if scheme not in SCHEMES:
            raise KeyError(f"unknown scheme {scheme!r}")
        if rotate_every and registry is None:
            raise ValueError("rotate_every needs a tenant registry — there "
                             "is no key hierarchy to rotate without one")
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
        if any(not paged[i] and not lengths[i] for i in range(len(flat))):
            raise NotImplementedError("on-chip recurrent cache state is not "
                                      "ported (dense attention only)")
        self.n_leaves = len(flat)
        self.spec = kvp.build_page_spec(
            self._cache_tree, scheme=scheme, page_tokens=page_tokens,
            n_pages=self.n_pages, max_slots=max_slots, max_len=self.max_len,
            use_kernel=use_kernel)
        self.page_io = kvp.PageIO(self.spec, self.keys)
        cfg_s = SCHEMES[scheme]
        self.policy = (multilevel.SEDA_DEFAULT if cfg_s.verify == "layer"
                       else multilevel.SGX_LIKE if cfg_s.emulate_tree
                       else multilevel.MGX_LIKE)

        self.pool = kvp.init_pool(self.spec, self.device)
        self.waiting: deque = deque()           # single-tenant FIFO
        self._tenant_waiting: dict = {}         # tenant idx -> deque
        self._vtime: dict = {}                  # tenant idx -> virtual time
        self._rotate_rr = 0
        self.slots: list = [None] * max_slots
        self.free_pages: list = list(range(self.n_pages))
        self.requests: dict = {}
        self._next_rid = 0
        self._admit_seq = 0
        self._epoch = 0
        self.tick = 0
        self._prefill_shapes: set = set()
        self.stats: dict = {name: 0 for name in STAT_NAMES}
        self.page_table = kvp.TwoLevelPageTable(max_slots, pages_per_slot)
        self._decode_fns: dict = {}
        if registry is not None:
            # Every engine sharing the registry reacts to a rotation,
            # whoever triggers it: the pre hook reseals pages about to
            # leave the retained window while the dying row is banked;
            # the post hook preempts anything a reseal missed.
            registry.attach_rotation_hook(self._pre_rotation, pre=True)
            registry.attach_rotation_hook(self._on_rotation)

    # -- decode / prefill builders -----------------------------------------

    def _merge_cache_leaves(self, dense: list, lengths: torch.Tensor):
        leaves = [None] * self.n_leaves
        for j, idx in enumerate(self.paged_idx):
            leaves[idx] = dense[j]
        for idx, steps in self.len_leaves:
            leaves[idx] = lengths.to(torch.int32)[None, :].expand(
                steps, self.max_slots)
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
                      read_ctx=None, write_ctx=None):
            dense, ok = io.read(self.pool, page_table, lengths, read_ctx,
                                uniform)
            caches = self._merge_cache_leaves(dense, lengths)
            logits, new_caches = lm_mod.lm_decode(cfg, self.params, tokens,
                                                  caches)
            tok = greedy_sample(logits)                      # (S, 1)
            new_leaves = kvp.cache_leaves(new_caches)
            io.write_dirty(self.pool, page_table,
                           [new_leaves[i] for i in self.paged_idx], lengths,
                           active, vn_mod.kv_page_vn(epoch), write_ctx,
                           uniform)
            return tok, ok

        return decode_fn

    def _prefill(self, seq: list):
        """Run (bucketed) prefill for one request's token sequence."""
        lp = len(seq)
        padded = seq + [0] * (_bucket_len(lp, self.max_len) - lp)
        if len(padded) not in self._prefill_shapes:
            self._prefill_shapes.add(len(padded))
            self.stats["prefill_compiles"] += 1
        tokens = torch.tensor([padded], dtype=torch.int64, device=self.device)
        logits, caches = lm_mod.lm_prefill(self.cfg, self.params,
                                           {"tokens": tokens}, self.max_len,
                                           last_pos=lp - 1)
        leaves = kvp.cache_leaves(caches)
        return greedy_sample(logits), [leaves[i] for i in self.paged_idx]

    # -- public API ---------------------------------------------------------

    def submit(self, request: Optional[SubmitRequest] = None, /, **kw) -> int:
        """Queue one request; returns its rid.

        ``submit(SubmitRequest(...))`` or
        ``submit(prompt=toks, max_new_tokens=8)``.
        """
        if request is None:
            request = SubmitRequest(**kw)
        elif not isinstance(request, SubmitRequest) or kw:
            raise TypeError("submit() takes a SubmitRequest or keyword "
                            "arguments only")
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
        req = Request(rid, prompt, max_new_tokens, submit_tick=self.tick)
        self.requests[rid] = req
        if tenant is not None:
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

    def _pre_rotation(self, tenant, new_epoch: int) -> None:
        """Eagerly reseal this engine's pages about to leave the key
        window, to the tenant's current epoch, one reseal per slot.
        Runs while the dying epoch's row is still in the bank."""
        oldest_after = new_epoch - self.registry.retain + 1
        cur = tenant.current_epoch
        for i, slot in enumerate(self.slots):
            if slot is None or slot.tenant is not tenant:
                continue
            stale = [j for j, e in enumerate(slot.page_epochs)
                     if e < oldest_after]
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
        _, ok = self.page_io.reseal(
            self.pool, torch.as_tensor(page_ids, device=self.device),
            vn_mod.kv_page_vn(self._next_epoch()), old_ctx, new_ctx)
        if not bool(ok):
            raise IntegrityError(
                f"reseal of slot {slot_idx} pages {page_pos} failed "
                f"verification (tenant {tenant.tenant_id!r})")
        for j in page_pos:
            slot.page_epochs[j] = to_epoch
        self.stats["reseals"] += 1

    def _on_rotation(self, tenant, new_epoch: int) -> None:
        """Post-rotation hook: preempt any slot still holding a page
        outside the retained window (the fallback a reseal should make
        unnecessary)."""
        oldest_retained = new_epoch - self.registry.retain + 1
        for i, slot in enumerate(self.slots):
            if (slot is not None and slot.tenant is tenant
                    and any(e < oldest_retained for e in slot.page_epochs)):
                self._preempt(i)
        self.stats["rotations"] += 1

    def tenant_resident_pages(self, index: int) -> int:
        """Pool pages currently owned by one tenant's running slots."""
        return sum(len(s.pages) for s in self.slots
                   if s is not None and s.tenant is not None
                   and s.tenant.index == index)

    def _n_waiting(self) -> int:
        return len(self.waiting) + sum(len(q) for q in
                                       self._tenant_waiting.values())

    @torch.no_grad()
    def step(self) -> list:
        """One scheduler tick: admit, grow/evict, batched decode.

        Returns the requests that finished during this tick.
        """
        finished: list = []
        active_idx = self._tick_begin(finished)
        if active_idx:
            pending = self._decode_dispatch(active_idx)
            self._decode_collect(active_idx, pending, finished)
        self._tick_end()
        return finished

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
        return [i for i, s in enumerate(self.slots) if s is not None]

    def _tick_end(self) -> None:
        if (self.policy.deferred_model_mac and self.defer_interval
                and self.tick % self.defer_interval == 0):
            self._deferred_check()

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
        result.latency = latency_percentiles(self.requests.values())
        return result

    def _drained(self) -> bool:
        if self.policy.deferred_model_mac:
            self._deferred_check()
        return not (self._n_waiting()
                    or any(s is not None for s in self.slots))

    def deferred_check(self) -> bool:
        """Model-level deferred MAC over the whole pool (paper Table I)."""
        return bool(kvp.deferred_pool_check(self.pool, self.spec))

    def _deferred_check(self) -> None:
        self.stats["deferred_checks"] += 1
        if not self.deferred_check():
            raise IntegrityError("deferred pool-level MAC check failed "
                                 f"(tick {self.tick}, scheme={self.scheme})")

    # -- admission ----------------------------------------------------------

    def _next_epoch(self) -> int:
        self._epoch += 1
        return self._epoch

    def _admission_pages(self, req: Request) -> int:
        # +1 so the first decode's write position is always covered.
        return min(len(req.prompt + req.generated) // self.page_tokens + 1,
                   self.pages_per_slot)

    def _admit(self, finished: list) -> None:
        if self.registry is None:
            while None in self.slots and self.waiting:
                req = self.waiting[0]
                if len(self.free_pages) < self._admission_pages(req):
                    break
                self.waiting.popleft()
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
                if not queue:
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
        seq = req.prompt + req.generated
        n_alloc = self._admission_pages(req)
        slot_idx = self.slots.index(None)
        pages = [self.free_pages.pop() for _ in range(n_alloc)]
        tok, paged_leaves = self._prefill(seq)
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
        self._admit_seq += 1
        self.stats["admitted"] += 1
        slot = _Slot(req, length=len(seq), pages=pages,
                     admit_seq=self._admit_seq, tenant=tenant,
                     page_epochs=page_epochs)
        self.slots[slot_idx] = slot
        self.page_table.install(slot_idx, slot)
        req.state = "running"
        req.generated.append(int(tok[0, 0]))
        if req.first_tick is None:
            req.first_tick = self.tick
        self._maybe_finish(slot_idx, finished)

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

    def _pick_victim(self, tenant=None) -> int:
        """Youngest running slot (LIFO preemption), scoped to
        ``tenant``'s own slots in multi-tenant mode."""
        candidates = [i for i, s in enumerate(self.slots) if s is not None
                      and (tenant is None or s.tenant is tenant)]
        return max(candidates, key=lambda i: self.slots[i].admit_seq)

    def _preempt(self, idx: int) -> None:
        slot = self.slots[idx]
        self.free_pages.extend(slot.pages)
        self.slots[idx] = None
        self.page_table.clear(idx)
        slot.req.state = "waiting"
        slot.req.n_evictions += 1
        self.stats["preemptions"] += 1
        if slot.tenant is not None:               # preempted go to the front
            self._tenant_waiting[slot.tenant.index].appendleft(slot.req)
        else:
            self.waiting.appendleft(slot.req)

    def _release(self, idx: int) -> None:
        slot = self.slots[idx]
        self.free_pages.extend(slot.pages)
        self.slots[idx] = None
        self.page_table.clear(idx)
        slot.req.state = "finished"

    def _maybe_finish(self, idx: int, finished: list) -> None:
        req = self.slots[idx].req
        if req.done:
            req.done_tick = self.tick
            self._release(idx)
            finished.append(req)

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
                try:
                    key_idx[i, j] = self.registry.key_row(tenant.index,
                                                          epoch)
                except KeyError as e:
                    raise IntegrityError(
                        f"slot {i} page {j}: {e.args[0]} (stale_epoch, "
                        f"tenant {tenant.tenant_id!r}, page "
                        f"{slot.pages[j]})") from e
        return ((key_idx, owners, key_epochs, cur_key_idx, cur_epochs),
                False)

    def _decode_dispatch(self, active_idx: list):
        """Launch this tick's batched decode over the bucketed window.

        The bucket is picked host-side from the live lengths.  Returns
        the ``(toks, ok)`` device tensors (no host sync).
        """
        bucket = self.page_table.bucket_for(
            (self.slots[i].length for i in active_idx), self.page_tokens)
        page_table = self.page_table.window(bucket)
        lengths = np.zeros((self.max_slots,), np.int64)
        active = np.zeros((self.max_slots,), bool)
        tokens = np.zeros((self.max_slots, 1), np.int64)
        for i in active_idx:
            slot = self.slots[i]
            lengths[i] = slot.length
            active[i] = True
            tokens[i, 0] = slot.req.generated[-1]
        dev = self.device
        args = [torch.as_tensor(page_table, device=dev),
                torch.as_tensor(lengths, device=dev),
                torch.as_tensor(active, device=dev),
                torch.as_tensor(tokens, device=dev), self._next_epoch()]
        uniform = False
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
        toks, ok = decode_fn(*args)
        self.stats["decode_steps"] += 1
        return toks, ok

    def _decode_collect(self, active_idx: list, pending,
                        finished: list) -> None:
        """Sync on a dispatched decode and apply host bookkeeping."""
        toks, ok = pending
        if not bool(ok):
            raise IntegrityError(
                f"page MAC verification failed at tick {self.tick} "
                f"(scheme={self.scheme})")
        toks = toks.cpu().numpy()
        for i in active_idx:
            slot = self.slots[i]
            if slot.tenant is not None:
                # The dirty page was just re-encrypted under the tenant's
                # CURRENT epoch (lazy rotation lands here).
                dirty = slot.length // self.page_tokens
                if dirty < len(slot.page_epochs):
                    slot.page_epochs[dirty] = slot.tenant.current_epoch
            slot.length += 1
            slot.req.generated.append(int(toks[i, 0]))
            if slot.req.first_tick is None:
                slot.req.first_tick = self.tick
            self._maybe_finish(i, finished)
