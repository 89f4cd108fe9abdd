"""Deterministic fault injection for the port's secure serving engine.

The port of ``repro.serve.faults``: a :class:`FaultPlan` is a seeded,
replayable schedule of memory-tamper and availability faults that a
test or benchmark attaches to a live engine.  Faults fire from a
wrapper around ``_tick_begin`` — *after* admission has written the
tick's pages and *before* decode reads them back — so every state fault
models what SeDA's threat model assumes: untrusted memory changed
between a verified write and the next read.

State faults write ``engine.pool``'s tensors in place and call no pool
listener, as a physical attacker bypasses the accelerator's MAC
pipeline: the engine's Merkle mirror must *not* observe the tamper.

Fault kinds
-----------
``bitflip``
    XOR one ciphertext byte of a resident page (leaf 0).
``vn_bump``
    Increment a page's version number — a freshness/replay violation.
``page_swap``
    Swap two resident pages wholesale (ciphertext, MACs, VN).  The
    XOR pool MAC is invariant under swaps; only per-page binding to
    the physical page id catches this.
``mac_corrupt``
    Flip a byte of a stored page MAC.
``pool_mac_zap``
    Flip a byte of the deferred pool MAC itself — only the deferred
    model-level check can see this.
``transient``
    Force one decode verdict to ``False`` without touching state, via
    :attr:`PageIO.fault_hooks` — a transient read glitch that a bounded
    re-read tells apart from persistent tamper.
``shard_kill``
    Raise ``IntegrityError`` out of the target shard's tick (the
    cluster's availability fault; the port has no cluster yet, so it
    only raises).

:class:`RecoveryPolicy` (the engine's ``fault_tolerance`` knob) lives
here too, so the containment layer and the harness share one module.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core.bytesutil import MASK32, i64, u32

__all__ = ["FAULT_KINDS", "Fault", "FaultPlan", "RecoveryPolicy"]

FAULT_KINDS = ("bitflip", "vn_bump", "page_swap", "mac_corrupt",
               "pool_mac_zap", "transient", "shard_kill")


@dataclasses.dataclass
class RecoveryPolicy:
    """Knobs for quarantine-and-recompute recovery.

    ``max_retries`` bounds how often one session may be preempted for
    integrity recovery before it is declared dead (``sessions_lost``);
    re-admission of attempt *k* is held back ``backoff_ticks * 2**(k-1)``
    ticks.  ``reread_retries`` bounds the extra re-reads a failing page
    gets during localization before it is condemned as persistent
    tamper rather than a transient fault.
    """

    max_retries: int = 3
    backoff_ticks: int = 1
    reread_retries: int = 1


@dataclasses.dataclass
class Fault:
    """One scheduled fault.

    ``tick`` is the earliest engine tick (the value ``engine.tick``
    holds during that tick's decode) at which the fault fires; a state
    fault whose target slot is not yet occupied stays armed and retries
    each tick.  ``page`` overrides slot-based targeting with an absolute
    physical page id; otherwise the target is
    ``engine.slots[slot].pages[page_pos]`` resolved at fire time.
    ``page2`` names the swap partner for ``page_swap`` (default: the
    slot's next resident page).  ``bit`` selects the byte/bit position
    for ``bitflip``.
    """

    tick: int
    kind: str
    shard: int = 0
    slot: int = 0
    page_pos: int = 0
    page: Optional[int] = None
    page2: Optional[int] = None
    bit: int = 0
    fired: bool = False


class FaultPlan:
    """A deterministic, seeded schedule of faults.

    Attach with :meth:`attach`; the plan records what actually fired in
    :attr:`fired` for assertions.
    """

    def __init__(self, faults):
        faults = list(faults)
        for f in faults:
            if f.kind not in FAULT_KINDS:
                raise ValueError(f"unknown fault kind {f.kind!r}; "
                                 f"expected one of {FAULT_KINDS}")
        self.faults = faults
        self.fired: list = []

    @classmethod
    def random(cls, seed: int, *, n_faults: int = 1,
               tick_range=(2, 8), kinds=("bitflip",),
               n_shards: int = 1, n_slots: int = 1) -> "FaultPlan":
        """Seeded random plan — same seed, same schedule (the
        reference's draws, from ``np.random.default_rng``)."""
        rng = np.random.default_rng(seed)
        faults = []
        for _ in range(n_faults):
            kind = kinds[int(rng.integers(len(kinds)))]
            faults.append(Fault(
                tick=int(rng.integers(tick_range[0], tick_range[1])),
                kind=kind,
                shard=int(rng.integers(n_shards)),
                slot=int(rng.integers(n_slots)),
                bit=int(rng.integers(64))))
        return cls(faults)

    # -- attachment ---------------------------------------------------------

    def attach(self, engine) -> "FaultPlan":
        """Hook this plan into one engine's tick and verdict paths."""
        plan = self
        orig_begin = engine._tick_begin

        def tick_begin(*a, **kw):
            out = orig_begin(*a, **kw)
            plan._fire(engine)
            return out

        engine._tick_begin = tick_begin
        engine.page_io.fault_hooks.append(self._verdict_hook(engine))
        return self

    # -- firing -------------------------------------------------------------

    def _due(self, engine):
        shard = getattr(engine, "shard_id", 0)
        return [f for f in self.faults
                if not f.fired and f.shard == shard
                and engine.tick >= f.tick]

    def _fire(self, engine) -> None:
        for f in self._due(engine):
            if f.kind == "shard_kill":
                self._mark(f)
                from repro_torch.serve.engine import IntegrityError
                raise IntegrityError(
                    f"injected shard-kill fault on shard {f.shard} "
                    f"at tick {engine.tick}")
            if f.kind == "transient":
                continue        # fires from the verdict hook instead
            if self._apply_state(engine, f):
                self._mark(f)

    def _verdict_hook(self, engine):
        plan = self

        def hook(ok: bool, op: str, ctx: dict) -> bool:
            if op != "decode":
                return ok
            for f in plan._due(engine):
                if f.kind == "transient":
                    plan._mark(f)
                    return False
            return ok

        return hook

    def _mark(self, fault: Fault) -> None:
        fault.fired = True
        self.fired.append(fault)

    # -- state mutation (in place, no listener, on purpose) -----------------

    def _resolve(self, engine, fault: Fault):
        """(page, page2) physical targets, or None if not yet hittable."""
        if fault.page is not None:
            return int(fault.page), fault.page2
        if fault.slot >= len(engine.slots):
            return None
        slot = engine.slots[fault.slot]
        if slot is None or fault.page_pos >= len(slot.pages):
            return None
        pid = int(slot.pages[fault.page_pos])
        pid2 = fault.page2
        if fault.kind == "page_swap" and pid2 is None:
            nxt = fault.page_pos + 1
            if nxt >= len(slot.pages):
                return None
            pid2 = int(slot.pages[nxt])
        return pid, pid2

    def _apply_state(self, engine, fault: Fault) -> bool:
        pool = engine.pool
        if fault.kind == "pool_mac_zap":
            pool.pool_mac[0] ^= 0xFF
            return True
        target = self._resolve(engine, fault)
        if target is None:
            return False        # slot not occupied yet; stay armed
        pid, pid2 = target
        if fault.kind == "bitflip":
            ct = pool.cts[0]
            b = fault.bit % int(ct.shape[1])
            ct[pid, b] ^= 1 << (fault.bit % 8)
        elif fault.kind == "vn_bump":
            # u32 in int32 storage: the add runs in int64, masked.
            pool.page_vns[pid] = u32((i64(pool.page_vns[pid]) + 1) & MASK32)
        elif fault.kind == "mac_corrupt":
            pool.page_macs[pid, 0] ^= 0xFF
        elif fault.kind == "page_swap":
            dev = pool.page_macs.device
            idx = torch.tensor([pid, pid2], device=dev)
            rev = torch.tensor([pid2, pid], device=dev)
            # Gather both rows first, then write both.
            for t in (*pool.cts, pool.page_macs, *pool.block_macs,
                      pool.page_vns):
                t[idx] = t[rev]
        else:  # pragma: no cover - guarded by FAULT_KINDS validation
            raise ValueError(fault.kind)
        return True
