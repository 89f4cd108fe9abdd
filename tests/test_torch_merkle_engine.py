"""The port engine's Merkle audit level against the JAX package.

* Equivalence: after admit / rotate / decode / copy-on-write schedules
  (all 7 schemes, prefix cache on) and a preempting single-tenant run,
  the incrementally kept tree equals a from-scratch ``build_tree`` (the
  port's and the reference's) over the pool's page MACs and owners,
  node for node.
* Proofs: the port's audit proofs verify under the reference's
  ``repro.serve.merkle_pool.verify_proof`` and the port's; each forgery
  class fails with its own error; ``audit_proof`` refuses an engine
  without the Merkle level, a tenant engine without a session, and a
  cross-tenant proof.
* The launcher's ``--audit-proof-out`` bundle verifies.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from repro.serve import merkle_pool as j_mkp
from repro_torch.configs import get_arch
from repro_torch.launch import serve as launch
from repro_torch.models import lm
from repro_torch.models.layers import init_params
from repro_torch.serve import kv_pages as kvp
from repro_torch.serve import merkle_pool as mkp
from repro_torch.serve.engine import SecureServingEngine
from repro_torch.tenancy import KeyHierarchy, TenantRegistry
from test_torch_models import port_test_env  # noqa: F401

SCHEMES = ["off", "sgx64", "sgx512", "mgx64", "mgx512", "seda", "seda512"]


@pytest.fixture(scope="module")
def smoke():
    arch = get_arch("minitron-4b")
    cfg = arch.make_smoke_config()
    return arch, cfg, init_params(lm.lm_specs(cfg), 0, device="cpu")


def _engine(smoke, **kw):
    kw.setdefault("max_slots", 2)
    kw.setdefault("page_tokens", 4)
    kw.setdefault("pages_per_slot", 4)
    kw.setdefault("n_pages", 12)
    kw.setdefault("scheme", "seda")
    kw.setdefault("defer_interval", 2)
    return SecureServingEngine(*smoke, use_kernel=True, device="cpu", **kw)


def _two_tenants(seed):
    reg = TenantRegistry(KeyHierarchy(seed, device="cpu"), max_tenants=4)
    reg.register("a")
    reg.register("b")
    return reg, reg.open_session("a"), reg.open_session("b")


def _assert_node_for_node(eng):
    """The engine's tree equals both packages' from-scratch builds over
    the live pool's MACs and the slots' owners, every node."""
    snap = eng.merkle.snapshot()
    macs = kvp.merkle_leaf_macs(eng.pool, eng.spec)
    quar = np.zeros(eng.n_pages, bool)
    for build in (mkp.build_tree, j_mkp.build_tree):
        rebuilt = build(macs, eng._page_owners(), quar, shard=0)
        assert len(snap) == len(rebuilt)
        for level, (got, want) in enumerate(zip(snap, rebuilt)):
            assert got == want, f"tree level {level} diverged from rebuild"


def _reference_proof(proof):
    """The port's proof as the reference's ``AuditProof``."""
    return j_mkp.proof_from_dict(json.loads(json.dumps(proof.to_dict())))


@pytest.mark.parametrize("scheme", SCHEMES)
def test_schedule_keeps_tree_equal_to_rebuild(smoke, scheme):
    """Random admits (prompts sharing prefixes, so hits, inserts and
    copy-on-write fire), live rotations and decode ticks."""
    reg, sa, sb = _two_tenants(11)
    eng = _engine(smoke, scheme=scheme, registry=reg, n_pages=24,
                  rotate_every=3, prefix_cache=True, prefix_cache_pages=8)
    rng = np.random.default_rng(SCHEMES.index(scheme))
    base = list(map(int, rng.integers(1, 256, 6)))
    for _ in range(10):
        op = rng.integers(0, 3)
        if op == 0 and len(eng.requests) < 6:       # admit
            tail = list(map(int, rng.integers(1, 256, rng.integers(0, 3))))
            eng.submit(prompt=base + tail, max_new_tokens=4,
                       session=(sa, sb)[int(rng.integers(2))])
        elif op == 1:                               # rotate (live)
            eng.rotate(("a", "b")[int(rng.integers(2))])
        eng.step()
        _assert_node_for_node(eng)
    eng.run()
    _assert_node_for_node(eng)
    stats = eng.stats
    assert stats["merkle_root_updates"] > 0 and stats["merkle_leaf_updates"]
    assert stats["prefix_inserted_pages"] > 0 and stats["prefix_hit_pages"]


def test_preemption_keeps_tree_equal_to_rebuild(smoke):
    # Overcommitted pool: growth preempts the youngest slot, and the
    # owner churn must reach the tree through the owner diff.
    rng = np.random.default_rng(0)
    eng = _engine(smoke, n_pages=5)
    for n in (6, 5, 7):
        eng.submit(prompt=list(map(int, rng.integers(1, 256, n))),
                   max_new_tokens=8)
    eng.run()
    assert eng.stats["preemptions"] > 0
    _assert_node_for_node(eng)


def test_every_pool_write_reaches_the_listeners(smoke):
    reg, sa, _ = _two_tenants(2)
    eng = _engine(smoke, registry=reg, prefix_cache=True)
    seen = []
    eng.attach_pool_listener(
        lambda old, new, delta: seen.append((old, new, delta)))
    eng.submit(prompt=[5, 6, 7, 8, 9], max_new_tokens=3, session=sa)
    eng.step()              # prefill write + cache insert copy + decode
    assert len(seen) == 3 and all(o is n is eng.pool for o, n, _ in seen)
    assert all(d is not None for _, _, d in seen)
    pool = eng.pool
    eng.pool = kvp.init_pool(eng.spec, "cpu")     # a new pool assigned
    old, new, delta = seen[-1]
    assert (old, new) == (pool, eng.pool)
    assert torch.equal(delta, pool.pool_mac ^ eng.pool.pool_mac)


# -- proofs and forgeries --------------------------------------------------


@pytest.fixture(scope="module")
def forged(smoke):
    """A live 2-tenant engine and a valid proof for tenant a, shared by
    every forgery case (the mutations never touch the engine)."""
    reg, sa, sb = _two_tenants(23)
    eng = _engine(smoke, registry=reg, n_pages=14)
    rng = np.random.default_rng(3)
    for session in (sa, sb):
        eng.submit(prompt=list(map(int, rng.integers(1, 256, 6))),
                   max_new_tokens=8, session=session)
    eng.step()
    eng.step()
    proof = eng.audit_proof(sa)
    assert proof.pages and proof.tenant == reg.validate(sa).index
    assert eng.stats["audit_proofs"] == 1
    return eng, sa, sb, proof


VERIFIERS = {"port": (mkp, lambda p: p),
             "reference": (j_mkp, _reference_proof)}


@pytest.mark.parametrize("who", sorted(VERIFIERS))
def test_proof_verifies(forged, who):
    eng, sa, sb, proof = forged
    m, conv = VERIFIERS[who]
    assert m.verify_proof(conv(proof), expected_root=eng.merkle.root_hex(),
                          tenant=proof.tenant)


def _replace_page(proof, **changes):
    page = dataclasses.replace(proof.pages[0], **changes)
    return dataclasses.replace(proof, pages=(page,) + proof.pages[1:])


@pytest.mark.parametrize("who", sorted(VERIFIERS))
@pytest.mark.parametrize("forgery", ["leaf_mac", "sibling", "truncated",
                                     "extended", "cross_tenant",
                                     "relabeled"])
def test_forgery_rejected(forged, who, forgery):
    eng, sa, sb, proof = forged
    m, conv = VERIFIERS[who]
    page = proof.pages[0]
    tenant_b = eng.registry.validate(sb).index
    kw = dict(expected_root=proof.root)
    if forgery == "leaf_mac":
        mac = bytearray(bytes.fromhex(page.mac))
        mac[0] ^= 0x01
        bad, err = _replace_page(proof, mac=bytes(mac).hex()), "LeafMacError"
    elif forgery == "sibling":
        other = eng.merkle.page_proof(
            next(p for p in range(eng.n_pages)
                 if p != page.page and (p >> 1) != (page.page >> 1)))
        bad = _replace_page(proof, path=(other.path[0],) + page.path[1:])
        err = "SiblingPathError"
    elif forgery == "truncated":
        bad, err = _replace_page(proof, path=page.path[:-1]), \
            "PathLengthError"
    elif forgery == "extended":
        bad, err = _replace_page(proof, path=page.path + (page.path[-1],)), \
            "PathLengthError"
    elif forgery == "cross_tenant":         # b presents a's proof as its own
        bad, err, kw = proof, "TenantMismatchError", dict(tenant=tenant_b)
    else:                     # relabeled: the owner is in every leaf hash
        bad = dataclasses.replace(
            proof, tenant=tenant_b,
            pages=tuple(dataclasses.replace(p, owner=tenant_b)
                        for p in proof.pages))
        err, kw = "LeafMacError", dict(tenant=tenant_b)
    with pytest.raises(getattr(m, err)):
        m.verify_proof(conv(bad), **kw)


def test_stale_root_and_refusals(forged, smoke):
    eng, sa, sb, proof = forged
    with pytest.raises(ValueError, match="cross-tenant"):
        eng.merkle.audit_proof([p.page for p in proof.pages],
                               tenant=eng.registry.validate(sb).index)
    with pytest.raises(PermissionError):
        eng.audit_proof()
    rid = next(s.req.rid for s in eng.slots if s is not None)
    narrow = eng.audit_proof(rid=rid)
    assert {p.page for p in narrow.pages} == set(
        next(s for s in eng.slots if s and s.req.rid == rid).pages)
    with pytest.raises(KeyError):
        eng.audit_proof(rid=999)
    old_root = proof.root
    for _ in range(4):          # decode on: MACs move, the root rotates
        eng.step()
    current = eng.merkle.root_hex()
    assert current != old_root
    assert j_mkp.verify_proof(_reference_proof(proof), tenant=proof.tenant)
    for m, conv in VERIFIERS.values():
        with pytest.raises(m.StaleRootError):
            m.verify_proof(conv(proof), expected_root=current)
    with pytest.raises(ValueError, match="merkle=False"):
        _engine(smoke, merkle=False).audit_proof()
    single = _engine(smoke)
    single.submit(prompt=[1, 2, 3, 4, 5], max_new_tokens=4)
    single.step()
    whole = single.audit_proof()
    assert whole.tenant is None
    assert [p.page for p in whole.pages] == sorted(single.slots[0].pages)
    assert j_mkp.verify_proof(_reference_proof(whole),
                              expected_root=single.merkle.root_hex())


def test_launcher_writes_a_verifiable_proof_bundle(tmp_path):
    path = tmp_path / "proofs.json"
    out = launch.main(["--smoke", "--device", "cpu", "--tenants", "2",
                       "--batch", "3", "--prompt-len", "6", "--gen-len",
                       "4", "--audit-proof-out", str(path)])
    bundle = json.loads(path.read_text())
    assert bundle == json.loads(json.dumps(out["audit_proofs"]))
    assert bundle["tick"] == 1 and bundle["verified"] == 2
    assert sorted(p["tenant"] for p in bundle["proofs"]) == [0, 1]
    for d in bundle["proofs"]:
        assert d["pages"]
        assert j_mkp.verify_proof(j_mkp.proof_from_dict(d),
                                  expected_root=d["root"],
                                  tenant=d["tenant"])
    assert len(bytes.fromhex(bundle["final"]["root"])) == j_mkp.HASH_BYTES
    assert out["stats"]["audit_proofs"] == 2
