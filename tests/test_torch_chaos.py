"""Port fault containment (``repro_torch.serve.faults`` and the engine's
quarantine + secure-recompute recovery) against the JAX package.

Each containment case attaches the same seeded :class:`FaultPlan` to
the reference engine (``repro.serve.engine``, its plain route) and to
the port's (kernel wrappers, their plain versions on the CPU) and
requires the same faults fired, the same quarantined frames, the same
tokens and states, every counter equal (the kernel-route ones aside)
and the same audit event sequence (all fields but ``ts``, ``prev``,
``hash`` and ``detail``).  The port's tokens also equal its fault-free
run.  Mirrors ``TestPlan``, ``TestContainment``, ``TestSLOIntegration``
and ``TestIntegrityFailContext`` of ``tests/test_chaos.py``; shard
failover waits for the cluster engine.
"""

import ast
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_arch as j_get_arch
from repro.serve import faults as j_faults
from repro.serve.engine import IntegrityError as JIntegrityError
from repro.serve.engine import SecureServingEngine as JEngine
from repro.tenancy import KeyHierarchy as JHierarchy
from repro.tenancy import TenantRegistry as JRegistry
from repro_torch.configs import get_arch
from repro_torch.convert import params_from_numpy
from repro_torch.core.secure_exec import SCHEMES
from repro_torch.obs.slo import SLOMonitor, merge_health
from repro_torch.serve import engine as engine_mod
from repro_torch.serve import faults as faults_mod
from repro_torch.serve import kv_pages as kvp
from repro_torch.serve import merkle_pool as mkp
from repro_torch.serve.engine import (STAT_NAMES, IntegrityError,
                                      SecureServingEngine)
from repro_torch.serve.faults import (FAULT_KINDS, Fault, FaultPlan,
                                      RecoveryPolicy)
from repro_torch.tenancy import KeyHierarchy, TenantRegistry
from test_torch_models import numpy_params
from test_torch_obs import KERNEL_ROUTE, audit_events

VERIFYING = [s for s in SCHEMES if SCHEMES[s].verify != "none"]
ENGINE_KW = dict(max_slots=2, page_tokens=4, pages_per_slot=4,
                 n_pages=12)          # spare frames outlive quarantine


@pytest.fixture(scope="module")
def smoke():
    j_arch = j_get_arch("minitron-4b")
    j_cfg = j_arch.make_smoke_config()
    np_params = numpy_params(j_cfg)
    j_params = jax.tree_util.tree_map(jnp.asarray, np_params)
    arch = get_arch("minitron-4b")
    cfg = arch.make_smoke_config()
    params = params_from_numpy(cfg, np_params, device="cpu")
    return (j_arch, j_cfg, j_params), (arch, cfg, params)


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.default_rng(0)
    # Slot 0's prompt spans two pages at admission (page_tokens=4), so
    # page_swap has an in-slot partner from the first tick.
    return [list(map(int, rng.integers(1, 256, n))) for n in (6, 5)]


def _port(smoke, **kw):
    kw = {"scheme": "seda", **ENGINE_KW, **kw}
    return SecureServingEngine(*smoke[1], use_kernel=True, device="cpu",
                               **kw)


def _serve(eng, prompts, n=4, sessions=None):
    sessions = sessions or [None]
    rids = [eng.submit(prompt=p, max_new_tokens=n,
                       session=sessions[i % len(sessions)])
            for i, p in enumerate(prompts)]
    eng.run()
    return rids, [list(eng.requests[r].generated) for r in rids]


@pytest.fixture(scope="module")
def baseline(smoke, prompts):
    """The port's fault-free tokens, once per scheme."""
    cache = {}

    def get(scheme):
        if scheme not in cache:
            cache[scheme] = _serve(_port(smoke, scheme=scheme), prompts)[1]
        return cache[scheme]

    return get


def _both(smoke, prompts, faults, *, tenants=0, **kw):
    """The same plan through the reference and the port; returns
    ``(engine, plan, tokens)`` per side, reference first."""
    sides = ((JEngine, j_faults, JRegistry, JHierarchy(4), smoke[0],
              dict(use_kernel=False)),
             (SecureServingEngine, faults_mod, TenantRegistry,
              KeyHierarchy(4, device="cpu"), smoke[1],
              dict(use_kernel=True, device="cpu")))
    out = []
    for engine_cls, plan_mod, registry_cls, hierarchy, model, side_kw in \
            sides:
        ekw = {"scheme": "seda", **ENGINE_KW, **side_kw, **kw}
        sessions = None
        if tenants:
            reg = registry_cls(hierarchy, max_tenants=tenants)
            for t in range(tenants):
                reg.register(f"t{t}")
            sessions = [reg.open_session(f"t{t}") for t in range(tenants)]
            ekw.update(registry=reg, rotate_every=1)
        eng = engine_cls(*model, **ekw)
        plan = plan_mod.FaultPlan([plan_mod.Fault(**f) for f in faults])
        plan.attach(eng)
        _, tokens = _serve(eng, prompts, sessions=sessions)
        out.append((eng, plan, tokens))
    return out


def _assert_same_outcome(j, t) -> None:
    (j_eng, j_plan, j_tokens), (eng, plan, tokens) = j, t
    assert [vars(f) for f in plan.fired] == [vars(f) for f in j_plan.fired]
    assert eng.quarantined == j_eng.quarantined
    assert tokens == j_tokens
    assert [r.state for r in eng.requests.values()] == \
        [r.state for r in j_eng.requests.values()]
    assert [r.n_evictions for r in eng.requests.values()] == \
        [r.n_evictions for r in j_eng.requests.values()]
    for name in STAT_NAMES:
        if name not in KERNEL_ROUTE:
            assert eng.stats[name] == j_eng.stats[name], name
    if eng.audit is not None:
        assert audit_events(eng.audit) == audit_events(j_eng.audit)
        assert eng.audit.verify_chain()
    assert eng.free_pages == j_eng.free_pages


class TestPlan:
    def test_seeded_plans_are_reproducible(self):
        a = FaultPlan.random(7, n_faults=4, kinds=FAULT_KINDS,
                             n_shards=2, n_slots=2)
        b = FaultPlan.random(7, n_faults=4, kinds=FAULT_KINDS,
                             n_shards=2, n_slots=2)
        assert [vars(f) for f in a.faults] == [vars(f) for f in b.faults]
        ref = j_faults.FaultPlan.random(7, n_faults=4, kinds=FAULT_KINDS,
                                        n_shards=2, n_slots=2)
        assert [vars(f) for f in a.faults] == [vars(f) for f in ref.faults]
        assert FAULT_KINDS == j_faults.FAULT_KINDS

    def test_unknown_kind_rejected(self):
        with pytest.raises(ValueError):
            FaultPlan([Fault(tick=1, kind="meteor_strike")])


class TestContainment:
    @pytest.mark.parametrize("scheme", VERIFYING)
    def test_bitflip_quarantined_and_recovered(self, smoke, prompts,
                                               baseline, scheme):
        j, t = _both(smoke, prompts, [dict(tick=3, kind="bitflip", slot=0)],
                     scheme=scheme, fault_tolerance=True, audit=True)
        _assert_same_outcome(j, t)
        eng, _, tokens = t
        assert tokens == baseline(scheme)
        assert all(r.state == "finished" for r in eng.requests.values())
        assert eng.stats["integrity_quarantined_pages"] >= 1
        assert eng.stats["sessions_recovered"] >= 1
        assert eng.stats["sessions_lost"] == 0
        assert eng.stats["integrity_failures"] >= 1
        assert sum(1 for r in eng.requests.values() if r.n_evictions) == 1
        assert eng.audit.events("quarantine")
        assert eng.audit.events("session_recovered")
        assert eng.deferred_check()

    @pytest.mark.parametrize("kind", ("vn_bump", "page_swap"))
    def test_replay_and_splice_tamper_contained(self, smoke, prompts,
                                                baseline, kind):
        j, t = _both(smoke, prompts, [dict(tick=3, kind=kind, slot=0)],
                     fault_tolerance=True, audit=True)
        _assert_same_outcome(j, t)
        eng, plan, tokens = t
        assert plan.fired
        assert tokens == baseline("seda")
        assert eng.stats["integrity_quarantined_pages"] >= 1
        assert eng.stats["sessions_recovered"] >= 1
        assert eng.stats["sessions_lost"] == 0
        assert eng.deferred_check()

    @pytest.mark.parametrize("kind", ("mac_corrupt", "pool_mac_zap"))
    def test_metadata_tamper_contained(self, smoke, prompts, baseline,
                                       kind):
        """A stored-MAC tamper changes no plaintext, so the tokens stay
        fault-free; containment repairs the deferred identity."""
        j, t = _both(smoke, prompts, [dict(tick=3, kind=kind, slot=0)],
                     fault_tolerance=True, audit=True)
        _assert_same_outcome(j, t)
        eng, plan, tokens = t
        assert plan.fired
        assert tokens == baseline("seda")
        assert eng.stats["sessions_lost"] == 0
        assert (eng.audit.events("fault_contained")
                or eng.audit.events("pool_mac_rebuild"))
        assert eng.deferred_check()

    def test_transient_fault_costs_nothing(self, smoke, prompts, baseline):
        j, t = _both(smoke, prompts, [dict(tick=3, kind="transient")],
                     fault_tolerance=True, audit=True)
        _assert_same_outcome(j, t)
        eng, plan, tokens = t
        assert plan.fired
        assert tokens == baseline("seda")
        assert eng.stats["integrity_quarantined_pages"] == 0
        assert eng.stats["sessions_recovered"] == 0
        assert eng.stats["sessions_lost"] == 0
        assert eng.audit.events("transient_fault")

    def test_retry_budget_exhaustion_loses_only_victim(self, smoke, prompts,
                                                       baseline):
        j, t = _both(smoke, prompts, [dict(tick=3, kind="bitflip", slot=0)],
                     fault_tolerance=RecoveryPolicy(max_retries=0),
                     audit=True)
        _assert_same_outcome(j, t)
        eng, _, tokens = t
        assert eng.stats["sessions_lost"] == 1
        states = [r.state for r in eng.requests.values()]
        assert states.count("failed") == 1
        want = baseline("seda")
        for i, state in enumerate(states):
            if state != "failed":
                assert state == "finished" and tokens[i] == want[i]
        assert eng.audit.events("session_lost")

    def test_tenant_slots_contained(self, smoke, prompts):
        """Two tenants, a rotation every tick: the probes and the decode
        run mixed key rows, and a tenant slot's fault is contained."""
        faults = [dict(tick=2, kind="mac_corrupt", slot=0),
                  dict(tick=3, kind="bitflip", slot=1)]
        j, t = _both(smoke, prompts, faults, tenants=2,
                     fault_tolerance=True, audit=True)
        _assert_same_outcome(j, t)
        eng, plan, _ = t
        assert len(plan.fired) == 2
        assert eng.stats["integrity_quarantined_pages"] >= 2
        assert eng.stats["sessions_lost"] == 0
        assert eng.stats["rotations"] > 0
        assert eng.deferred_check()

    def test_dirty_page_tamper_is_rewritten_like_the_reference(
            self, smoke, prompts):
        """A flipped byte of the page a tick dirties: the decode writes
        that page back (re-MACed over the flipped plaintext) before the
        gate, in both packages, so its probe passes and containment sees
        a transient fault."""
        j, t = _both(smoke, prompts,
                     [dict(tick=2, kind="bitflip", slot=0, page_pos=1)],
                     fault_tolerance=True, audit=True)
        _assert_same_outcome(j, t)
        eng, plan, _ = t
        assert plan.fired
        assert eng.stats["integrity_failures"] == 1
        assert not eng.quarantined
        assert eng.audit.events("transient_fault")

    def test_folded_verdicts_contained_like_the_reference(self, smoke,
                                                           prompts):
        """``verify_every_step=False`` folds the decode verdicts on the
        device; the end of the run checks the fold (op ``decode_accum``)
        and, with every slot drained, rebuilds the pool MAC."""
        j, t = _both(smoke, prompts, [dict(tick=3, kind="bitflip", slot=0)],
                     fault_tolerance=True, audit=True,
                     verify_every_step=False)
        _assert_same_outcome(j, t)
        eng = t[0]
        (err,) = eng.audit.events("integrity_error")
        assert err["op"] == "decode_accum"
        assert eng.audit.events("pool_mac_rebuild")
        strict = _port(smoke, verify_every_step=False)
        FaultPlan([Fault(tick=3, kind="bitflip", slot=0)]).attach(strict)
        for p in prompts:
            strict.submit(prompt=p, max_new_tokens=4)
        with pytest.raises(IntegrityError, match="accumulated") as info:
            strict.run()
        assert info.value.ctx == {"op": "decode_accum"}

    def test_quarantined_frames_never_reallocated(self, smoke, prompts):
        eng = _port(smoke, fault_tolerance=True)
        FaultPlan([Fault(tick=3, kind="bitflip", slot=0)]).attach(eng)
        _serve(eng, prompts)
        bad = set(eng.quarantined)
        assert bad
        assert not bad & set(eng.free_pages)
        _serve(eng, prompts)                    # retired frames stay out
        assert eng.quarantined == bad
        assert not bad & set(eng.free_pages)
        resident = {int(p) for s in eng.slots if s is not None
                    for p in s.pages}
        assert not bad & resident
        # The Merkle level excludes them: the tree equals a rebuild.
        eng._merkle_sync()
        quar = np.zeros(eng.n_pages, bool)
        quar[sorted(bad)] = True
        assert eng.merkle.snapshot() == mkp.build_tree(
            kvp.merkle_leaf_macs(eng.pool, eng.spec), eng._page_owners(),
            quar, shard=0)
        with pytest.raises(ValueError, match="quarantined"):
            eng.merkle.audit_proof(sorted(bad))

    def test_without_fault_tolerance_same_tamper_still_raises(self, smoke,
                                                              prompts):
        ctxs = []
        for eng, plan_mod, error in (
                (JEngine(*smoke[0], scheme="seda", **ENGINE_KW), j_faults,
                 JIntegrityError),
                (_port(smoke), faults_mod, IntegrityError)):
            plan_mod.FaultPlan([plan_mod.Fault(tick=3, kind="bitflip",
                                               slot=0)]).attach(eng)
            for p in prompts:
                eng.submit(prompt=p, max_new_tokens=4)
            with pytest.raises(error) as info:
                eng.run()
            ctxs.append(info.value.ctx)
        assert ctxs[1] == ctxs[0]
        assert ctxs[1]["op"] == "decode" and ctxs[1]["pages"]


class TestSLOIntegration:
    def test_recovery_reports_degraded_then_ok(self, smoke, prompts):
        eng = _port(smoke, fault_tolerance=True)
        mon = SLOMonitor().attach(eng)
        FaultPlan([Fault(tick=2, kind="bitflip", slot=0)]).attach(eng)
        for p in prompts:
            eng.submit(prompt=p, max_new_tokens=6)
        seen_degraded = False
        for _ in range(200):
            if not (eng._n_waiting()
                    or any(s is not None for s in eng.slots)):
                break
            eng.step()
            if eng._n_recovering():
                health = mon.health()
                assert health["status"] == "degraded"
                assert health["recovery"]["recovering"] >= 1
                seen_degraded = True
        assert seen_degraded
        assert mon.health()["status"] == "ok"
        assert not mon.hard_breach

    def test_session_loss_is_hard_breach(self, smoke, prompts):
        eng = _port(smoke, fault_tolerance=RecoveryPolicy(max_retries=0))
        mon = SLOMonitor().attach(eng)
        FaultPlan([Fault(tick=3, kind="bitflip", slot=0)]).attach(eng)
        for p in prompts:
            eng.submit(prompt=p, max_new_tokens=4)
        eng.run()
        assert mon.hard_breach
        health = mon.health()
        assert health["status"] == "failing"
        assert health["recovery"]["sessions_lost"] == 1
        merged = merge_health([health])
        assert merged["status"] == "failing"
        assert merged["recovery"]["sessions_lost"] == 1


class TestIntegrityFailContext:
    """Every ``_integrity_fail`` site says which gate failed (op) and,
    unless the op is pool-global, names the tenant/slot/page context
    containment localizes from."""

    EXEMPT_OPS = {"decode_accum", "deferred"}
    CONTEXT = {"tenant", "slot", "page", "pages", "to_shard", "to_tenant"}

    def test_call_sites_carry_context(self):
        tree = ast.parse(inspect.getsource(engine_mod))
        sites = [n for n in ast.walk(tree)
                 if isinstance(n, ast.Call)
                 and isinstance(n.func, ast.Attribute)
                 and n.func.attr == "_integrity_fail" and n.keywords]
        ops = set()
        for call in sites:
            kwargs = {k.arg for k in call.keywords}
            assert "op" in kwargs or None in kwargs, ast.dump(call)
            op_kw = next((k for k in call.keywords if k.arg == "op"), None)
            op = (op_kw.value.value if op_kw is not None
                  and isinstance(op_kw.value, ast.Constant) else None)
            ops.add(op)
            if op in self.EXEMPT_OPS:
                continue
            assert kwargs & self.CONTEXT or None in kwargs, ast.dump(call)
        assert ops == {"prefix_share", "reseal", "prefix_insert", "cow",
                       "stale_epoch", "decode", "deferred", "decode_accum"}
        assert "raise IntegrityError(" not in inspect.getsource(engine_mod)


def test_rotated_dirty_page_condemned_like_the_reference(smoke):
    """Lazy rotation meets localization, in both packages: at tick 2
    tenant t1 rotates, slot 1's decode rewrites its dirty page under the
    new epoch, and a bitflip in slot 0 fails the tick.  The probe reads
    slot 1's dirty page under the epoch its host mirror still holds (the
    mirror advances only after the gate), so that healthy page is
    condemned and its session recovered too."""
    rng = np.random.default_rng(0)
    prompts = [list(map(int, rng.integers(1, 256, 5))) for _ in range(2)]
    j, t = _both(smoke, prompts, [dict(tick=2, kind="bitflip", slot=0)],
                 tenants=2, fault_tolerance=True, audit=True)
    _assert_same_outcome(j, t)
    eng = t[0]
    assert len(eng.quarantined) == 2
    assert eng.stats["preemptions"] == 2
    assert eng.stats["sessions_lost"] == 0
