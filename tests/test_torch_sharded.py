"""Port sharded serving (``repro_torch.serve.cluster``, ``sharded_pool``
and the shard binding of ``kv_pages``) against the JAX package.

* Shard binding at the ``PageIO`` level: a page replayed byte for byte
  from shard 0 into shard 1 fails; ``shard=0`` of any count is the
  unsharded layout; shards outside the fmap budget are refused;
  migration between shards round-trips the plaintext and rebinds the
  pages, with the destination pool's bytes equal to
  ``repro.serve.kv_pages.migrate_pages``'s.
* The root compression: ``ShardedKVPool._compress`` gives the JAX
  bytes; it binds order and count; ``fold_out`` and ``merkle_root``.
* Cluster parity with ``repro.serve.cluster.ClusterEngine`` (logical
  shards on the CPU, ``page_tokens=4``, ``pages_per_slot=4``, prompts of
  5, 7 and 9 tokens): tokens, ``stats`` and ``engine_stats`` (the
  kernel-route counters aside: the reference runs without its kernels)
  for one shard under ``off`` / ``seda`` / ``mgx64``, two shards on the
  reference's migration scenario, tenant migration under rotation, and
  shard failover.  Each JAX run is made once, in a module fixture.
* The root-MAC hazards: a pool state swapped in around the listeners
  fails ``deferred_check()`` and, one tick later, still fails, as in
  the reference; a swap with its XOR identity patched is caught by the
  mirrors alone.
* Cluster audit proofs, observability and the launcher's ``--shards``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.core.secure_memory import SecureKeys as JKeys
from repro.models.attention import KVCache as JKVCache
from repro.serve import faults as j_faults
from repro.serve import kv_pages as j_kvp
from repro.serve import merkle_pool as j_mkp
from repro.serve.cluster import ClusterEngine as JCluster
from repro.tenancy import KeyHierarchy as JHierarchy
from repro.tenancy import TenantRegistry as JRegistry
from repro_torch.configs import get_arch
from repro_torch.convert import params_from_numpy
from repro_torch.core import mac as mac_mod
from repro_torch.core.secure_memory import SecureKeys
from repro_torch.launch import serve as launch
from repro_torch.models.attention import CacheSpec
from repro_torch.models.attention import KVCache
from repro_torch.serve import faults as faults_mod
from repro_torch.serve import kv_pages as kvp
from repro_torch.serve import merkle_pool as mkp
from repro_torch.serve.cluster import ClusterEngine
from repro_torch.serve.engine import (STAT_NAMES, IntegrityError,
                                      SecureServingEngine)
from repro_torch.tenancy import KeyHierarchy, TenantRegistry
from test_torch_models import numpy_params, port_test_env  # noqa: F401
from test_torch_obs import KERNEL_ROUTE, audit_events

CLUSTER_KW = dict(shards=2, max_slots=2, page_tokens=4, pages_per_slot=4,
                  scheme="seda")
MIGRATION_KW = dict(shards=2, max_slots=2, pages_per_slot=8, n_pages=8)


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
    return [list(map(int, rng.integers(1, 256, n))) for n in (5, 7, 9)]


def _cluster(side: str, smoke, **kw):
    """A JAX (``side="jax"``, plain route) or port (CPU, kernel
    wrappers) cluster on the smoke config."""
    kw = {**CLUSTER_KW, **kw}
    if side == "jax":
        return JCluster(*smoke[0], **kw)
    return ClusterEngine(*smoke[1], device="cpu", use_kernel=True, **kw)


def _registry(side: str, seed: int, names):
    reg = (JRegistry(JHierarchy(seed), max_tenants=len(names))
           if side == "jax" else
           TenantRegistry(KeyHierarchy(seed, device="cpu"),
                          max_tenants=len(names)))
    for name in names:
        reg.register(name)
    return reg, [reg.open_session(name) for name in names]


def _serve(cl, reqs) -> list:
    """Submit ``(prompt, max_new_tokens, session)`` requests, run, and
    return each request's tokens."""
    rids = [cl.submit(prompt=p, max_new_tokens=n, session=s)
            for p, n, s in reqs]
    cl.run()
    return [list(cl.requests[r].generated) for r in rids]


# ---------------------------------------------------------------------------
# Shard binding at the PageIO level.
# ---------------------------------------------------------------------------


def _spec(scheme: str, shard: int, n_shards: int = 2):
    tree = [[KVCache(k=CacheSpec((2, 2, 16, 2, 8), "float32"),
                     v=CacheSpec((2, 2, 16, 2, 8), "float32"),
                     length=CacheSpec((2,), "int32"))]]
    return kvp.build_page_spec(tree, scheme=scheme, page_tokens=4,
                               n_pages=6, max_slots=2, max_len=16,
                               shard=shard, n_shards=n_shards)


def _j_spec(scheme: str, shard: int, n_shards: int = 2):
    leaf = jax.ShapeDtypeStruct((2, 2, 16, 2, 8), jnp.float32)
    tree = [[JKVCache(k=leaf, v=leaf,
                      length=jax.ShapeDtypeStruct((2,), jnp.int32))]]
    return j_kvp.build_page_spec(tree, scheme=scheme, page_tokens=4,
                                 n_pages=6, max_slots=2, max_len=16,
                                 shard=shard, n_shards=n_shards)


def _data(seed: int = 0) -> list:
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((2, 1, 16, 2, 8)).astype(np.float32)
            for _ in range(2)]


def _filled(spec, keys, data):
    pool = kvp.init_pool(spec, "cpu")
    kvp.write_prefill(pool, spec, keys, torch.tensor([0, 1, 2, 3]),
                      [torch.from_numpy(d) for d in data], 4, 1)
    return pool


def _pool_state(pool, n: int) -> dict:
    """Pool bytes over the real rows (numpy; u32 VNs as uint32)."""
    def conv(t):
        return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    vns = conv(pool.page_vns)[:n]
    return {"cts": [conv(c)[:n] for c in pool.cts],
            "page_macs": conv(pool.page_macs)[:n],
            "block_macs": [conv(b)[:n] for b in pool.block_macs],
            "page_vns": vns.view(np.uint32),
            "pool_mac": conv(pool.pool_mac)}


def _assert_state_equal(a: dict, b: dict) -> None:
    for key in a:
        left, right = a[key], b[key]
        pairs = zip(left, right) if isinstance(left, list) else [(left,
                                                                  right)]
        if isinstance(left, list):
            assert len(left) == len(right), key
        for x, y in pairs:
            np.testing.assert_array_equal(x, y, err_msg=key)


@pytest.mark.parametrize("scheme", ["seda", "sgx64", "mgx512"])
def test_byte_identical_replay_across_shards_fails(scheme):
    keys = SecureKeys.derive(1234, device="cpu")
    spec0, spec1 = _spec(scheme, 0), _spec(scheme, 1)
    pool0 = _filled(spec0, keys, _data())
    pool1 = kvp.init_pool(spec1, "cpu")
    ids = torch.tensor([0, 1, 2, 3])
    # Everything the untrusted side could capture moves verbatim.
    for c0, c1 in zip(pool0.cts, pool1.cts):
        c1[ids] = c0[ids]
    for b0, b1 in zip(pool0.block_macs, pool1.block_macs):
        b1[ids] = b0[ids]
    pool1.page_macs[ids] = pool0.page_macs[ids]
    pool1.page_vns[ids] = pool0.page_vns[ids]
    _, ok_own = kvp.read_pages_raw(pool0, spec0, keys, ids)
    _, ok_replay = kvp.read_pages_raw(pool1, spec1, keys, ids)
    assert bool(ok_own) and not bool(ok_replay)


def test_shard0_bit_identical_to_unsharded():
    keys = SecureKeys.derive(1234, device="cpu")
    plain = _spec("seda", 0, n_shards=1)
    sharded = plain._replace(n_shards=4)          # shard 0 of 4
    a = _pool_state(_filled(plain, keys, _data()), 6)
    b = _pool_state(_filled(sharded, keys, _data()), 6)
    _assert_state_equal(a, b)


def test_spec_rejects_out_of_budget_shards():
    with pytest.raises(ValueError):
        _spec("seda", 0, n_shards=kvp.MAX_SHARDS + 1)
    with pytest.raises(ValueError):
        _spec("seda", 2, n_shards=2)
    assert kvp.MAX_SHARDS == j_kvp.MAX_SHARDS


@pytest.mark.parametrize("scheme", ["off", "seda", "mgx64"])
def test_migrate_roundtrips_and_rebinds_like_the_reference(scheme):
    data = _data(3)
    src, dst = [0, 1, 2, 3], [2, 3, 4, 5]
    j_keys = JKeys.derive(1234)
    j_spec0, j_spec1 = _j_spec(scheme, 0), _j_spec(scheme, 1)
    j_pool0 = j_kvp.write_prefill(
        j_kvp.init_pool(j_spec0), j_spec0, j_keys, jnp.asarray(src),
        [jnp.asarray(d) for d in data], 4, jnp.uint32(1))
    j_pool1, j_ok = j_kvp.migrate_pages(
        j_pool0, j_spec0, j_kvp.init_pool(j_spec1), j_spec1, j_keys,
        jnp.asarray(src), jnp.asarray(dst), jnp.uint32(9))
    keys = SecureKeys.derive(1234, device="cpu")
    spec0, spec1 = _spec(scheme, 0), _spec(scheme, 1)
    pool0 = _filled(spec0, keys, data)
    want, ok = kvp.read_pages_raw(pool0, spec0, keys, torch.tensor(src))
    assert bool(ok)
    pool1, ok_mig = kvp.migrate_pages(pool0, spec0,
                                      kvp.init_pool(spec1, "cpu"), spec1,
                                      keys, src, dst, 9)
    assert ok_mig is True and bool(j_ok)
    _assert_state_equal(_pool_state(pool1, 6), _pool_state(j_pool1, 6))
    got, ok_dst = kvp.read_pages_raw(pool1, spec1, keys, torch.tensor(dst))
    assert bool(ok_dst)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    if scheme != "off":
        # The migrated pages are bound to shard 1: read under shard 0's
        # binding they fail.
        _, ok_wrong = kvp.read_pages_raw(pool1, spec0, keys,
                                         torch.tensor(dst))
        assert not bool(ok_wrong)


def test_failed_migration_source_writes_nothing():
    keys = SecureKeys.derive(1234, device="cpu")
    spec0, spec1 = _spec("seda", 0), _spec("seda", 1)
    pool0 = _filled(spec0, keys, _data())
    pool0.cts[0][1, 5] ^= 0x40                   # tamper one source page
    io = kvp.PageIO(spec1, keys)
    seen = []
    io.write_listeners.append(lambda pool, delta: seen.append(delta))
    pool1 = kvp.init_pool(spec1, "cpu")
    before = _pool_state(pool1, 7)
    out, ok = io.migrate(pool0, spec0, pool1, [0, 1], [2, 3], 9)
    assert ok is False and out is pool1 and seen == []
    _assert_state_equal(_pool_state(pool1, 7), before)


def test_every_write_hands_its_pool_mac_delta_to_the_write_listeners():
    keys = SecureKeys.derive(1234, device="cpu")
    spec = _spec("seda", 1)
    io = kvp.PageIO(spec, keys)
    pool = kvp.init_pool(spec, "cpu")
    mirror = pool.pool_mac.clone()
    deltas = []

    def fold(written, delta):
        assert written is pool
        deltas.append(delta)
        mirror.bitwise_xor_(delta)

    io.write_listeners.append(fold)
    io.write_prefill(pool, torch.tensor([0, 1, 2, 3]),
                     [torch.from_numpy(d) for d in _data()], 4, 1)
    io.reseal(pool, torch.tensor([1, 2]), 2)
    io.copy(pool, [0], [5], 3)
    assert len(deltas) == 3
    assert torch.equal(mirror, pool.pool_mac)
    assert bool(kvp.deferred_pool_check(pool, spec))


# ---------------------------------------------------------------------------
# Cluster parity with the reference (each JAX run made once).
# ---------------------------------------------------------------------------


def _snap(cl) -> dict:
    """The counters a run leaves: the cluster's, the summed shard
    counters, each shard's, and the failed shards."""
    return {"stats": dict(cl.stats), "failed": set(cl.failed_shards),
            "engine_stats": dict(cl.engine_stats),
            "shards": [dict(e.stats) for e in cl.engines]}


def _assert_same_counters(j: dict, t: dict) -> None:
    """Equal counters (the kernel-route ones aside)."""
    assert t["stats"] == j["stats"]
    assert t["failed"] == j["failed"]
    for name in STAT_NAMES:
        if name not in KERNEL_ROUTE:
            assert t["engine_stats"][name] == j["engine_stats"][name], name
            for js, ts in zip(j["shards"], t["shards"]):
                assert ts[name] == js[name], name


def _engine_tokens(smoke, reqs, **kw) -> list:
    """The port's single engine (3 slots) on the same requests."""
    kw = {"scheme": "seda", "max_slots": 3, "page_tokens": 4,
          "pages_per_slot": 4, **kw}
    eng = SecureServingEngine(*smoke[1], use_kernel=True, device="cpu", **kw)
    rids = [eng.submit(prompt=p, max_new_tokens=n) for p, n, _ in reqs]
    eng.run()
    return [list(eng.requests[r].generated) for r in rids]


@pytest.fixture(scope="module", params=["off", "seda", "mgx64"])
def one_shard(request, smoke, prompts):
    """One shard (3 slots) under each scheme, in both packages; the
    port's single engine beside them."""
    scheme = request.param
    reqs = [(p, 4, None) for p in prompts]
    runs = {}
    for side in ("jax", "torch"):
        cl = _cluster(side, smoke, shards=1, max_slots=3, scheme=scheme)
        runs[side] = dict(cl=cl, tokens=_serve(cl, reqs), snap=_snap(cl))
    return runs, _engine_tokens(smoke, reqs, scheme=scheme)


def test_one_shard_equals_reference_and_engine(one_shard):
    runs, engine_tokens = one_shard
    assert runs["torch"]["tokens"] == runs["jax"]["tokens"] == engine_tokens
    _assert_same_counters(runs["jax"]["snap"], runs["torch"]["snap"])
    assert runs["torch"]["cl"].deferred_check()


def _tamper(side: str, eng, kind: str, victim: int) -> None:
    """Swap a new pool value into one shard around its listeners (the
    same call again undoes it).  ``pool_mac``: one byte of the pool MAC
    flipped.  ``consistent``: page ``victim``'s MAC row changed and the
    pool MAC patched to match, so the pool's own XOR identity holds."""
    macs = np.asarray(eng.pool.page_macs).copy()
    pool_mac = np.asarray(eng.pool.pool_mac).copy()
    if kind == "pool_mac":
        pool_mac[0] ^= 0xFF
    else:
        macs[victim] ^= 0x5A
        pool_mac ^= 0x5A
    conv = jnp.asarray if side == "jax" else torch.from_numpy
    eng._pool = eng.pool._replace(page_macs=conv(macs),
                                  pool_mac=conv(pool_mac))


# (kind, max_new_tokens): the reference's whole-pool-MAC swap test (6
# tokens), and the listener-bypassing swap with its XOR identity patched.
SWAPS = (("pool_mac", 6), ("consistent", 4))


def _swap_chain(side: str, cl, prompts) -> list:
    """Each swap on shard 0 of the drained cluster: ``deferred_check()``
    one tick after admission, after the swap, and after one more tick (a
    listened write after the swap); then the swap is undone and the
    cluster drains (its end-of-run root check must pass)."""
    out = []
    for kind, n in SWAPS:
        for p in prompts:
            cl.submit(prompt=p, max_new_tokens=n)
        cl.step()
        eng = cl.engines[0]
        victim = eng.free_pages[0]
        verdicts = [bool(cl.deferred_check())]
        _tamper(side, eng, kind, victim)
        verdicts.append(bool(cl.deferred_check()))
        cl.step()
        verdicts.append(bool(cl.deferred_check()))
        _tamper(side, eng, kind, victim)
        cl.run()
        out.append(verdicts)
    return out


@pytest.fixture(scope="module")
def two_shards(smoke, prompts):
    """Two seda shards, audit and trace on, in both packages, on the
    reference's migration scenario: two long decodes route to shard 0, a
    short one to shard 1, and when it drains shard 0's page pressure
    migrates its youngest slot.  Then the swap chain on the same
    cluster.  The port's single engine beside them."""
    reqs = [(prompts[0], 20, None), (prompts[1], 2, None),
            (prompts[2], 20, None)]
    runs = {}
    for side in ("jax", "torch"):
        cl = _cluster(side, smoke, audit=True, trace=True, **MIGRATION_KW)
        tokens = _serve(cl, reqs)
        runs[side] = dict(cl=cl, tokens=tokens, snap=_snap(cl),
                          ok=bool(cl.deferred_check()),
                          swaps=_swap_chain(side, cl, prompts))
    return runs, _engine_tokens(smoke, reqs, pages_per_slot=8, n_pages=24)


def test_two_shards_equal_reference(two_shards):
    runs, engine_tokens = two_shards
    j, t = runs["jax"], runs["torch"]
    assert t["tokens"] == j["tokens"]
    assert t["tokens"] == engine_tokens   # placement never changes tokens
    _assert_same_counters(j["snap"], t["snap"])
    assert all(s["decode_steps"] > 0 for s in t["snap"]["shards"])
    assert t["ok"] and j["ok"]


def test_cluster_rolls_up_the_graph_counters(two_shards):
    """The engines' CUDA-graph counters (the port's own) reach the
    cluster's rollup as every engine counter does: 0 on CPU shards, whose
    model steps run eagerly."""
    from repro_torch.obs.metrics import GRAPH_COUNTERS
    snap = two_shards[0]["torch"]["snap"]
    for name in GRAPH_COUNTERS:
        assert [s[name] for s in snap["shards"]] == [0, 0], name
        assert snap["engine_stats"][name] == 0, name
    assert snap["engine_stats"]["decode_steps"] > 0


def test_migration_under_load_zero_recompute(two_shards):
    snap = two_shards[0]["torch"]["snap"]
    assert snap["stats"]["migrations"] > 0
    assert snap["engine_stats"]["preemptions"] == 0
    assert snap["engine_stats"]["admitted"] == 3  # no recomputed prefill


def test_migration_proofs_verify(two_shards):
    runs = two_shards[0]
    jc, tc = runs["jax"]["cl"], runs["torch"]["cl"]
    assert len(tc.migration_proofs) == len(jc.migration_proofs) > 0
    for entry, j_entry in zip(tc.migration_proofs, jc.migration_proofs):
        assert {k: entry[k] for k in ("rid", "from_shard", "to_shard")} == \
            {k: j_entry[k] for k in ("rid", "from_shard", "to_shard")}
        proof = mkp.proof_from_dict(entry["proof"])
        assert proof.shard == entry["to_shard"]
        assert mkp.verify_proof(proof)
        assert j_mkp.verify_proof(j_mkp.proof_from_dict(entry["proof"]))
        assert entry["src_root"] != proof.root
        assert len(proof.pages) == len(j_entry["proof"]["pages"])


def test_cluster_audit_chain_equals_reference(two_shards):
    """One chained log for the cluster: the shards' events and the
    cluster's own (shard -1), in the reference's order and fields (the
    Merkle roots aside: page MACs differ between the packages)."""
    runs = two_shards[0]
    jc, tc = runs["jax"]["cl"], runs["torch"]["cl"]

    def events(log):
        return [{k: v for k, v in e.items()
                 if k not in ("src_root", "dst_root", "root")}
                for e in audit_events(log)]

    assert events(tc.audit) == events(jc.audit)
    migrations = tc.audit.events("migration")
    assert len(migrations) == tc.stats["migrations"] > 0
    assert all(e["shard"] == -1 for e in migrations)
    assert tc.audit.verify_chain()


def test_listener_bypassing_swap_still_caught(two_shards):
    """A pool swapped in around the listeners with its XOR identity
    patched: the mirror catches it, and one tick (a listened write)
    later still does, where a mirror that copied the pool MAC at each
    write would have absorbed it.  The reference's verdicts."""
    runs = two_shards[0]
    got, want = runs["torch"]["swaps"][1], runs["jax"]["swaps"][1]
    assert got == want == [True, False, False]


def test_root_mac_catches_untracked_pool_swap(two_shards):
    """A whole-pool-MAC substitution around the listeners fails the
    root, and still fails one tick later: the reference's verdicts."""
    runs = two_shards[0]
    got, want = runs["torch"]["swaps"][0], runs["jax"]["swaps"][0]
    assert got == want == [True, False, False]


# ---------------------------------------------------------------------------
# The root compression.
# ---------------------------------------------------------------------------


def test_compress_bytes_equal_the_reference(two_shards):
    runs = two_shards[0]
    jc, tc = runs["jax"]["cl"], runs["torch"]["cl"]
    rng = np.random.default_rng(5)
    for n in (1, 2, 3):
        macs = [rng.integers(0, 256, mac_mod.MAC_BYTES, dtype=np.uint8)
                for _ in range(n)]
        want = np.asarray(jc.sharded._compress(
            [jnp.asarray(m) for m in macs]))
        got = tc.sharded._compress([torch.from_numpy(m) for m in macs])
        np.testing.assert_array_equal(got, want)
    # The pool MACs differ between the packages (K/V floats do), so the
    # port's root is held against its own pools: mirrors equal actuals.
    np.testing.assert_array_equal(
        tc.sharded.root_mac.numpy(),
        tc.sharded._compress([e.pool.pool_mac for e in tc.engines]))


def test_root_binds_order_and_shard_count(two_shards):
    sh = two_shards[0]["torch"]["cl"].sharded
    macs = [torch.arange(8, dtype=torch.uint8),
            torch.arange(8, 16, dtype=torch.uint8)]
    assert not np.array_equal(sh._compress(macs), sh._compress(macs[::-1]))
    grown = macs + [torch.zeros(8, dtype=torch.uint8)]
    assert not np.array_equal(sh._compress(macs), sh._compress(grown))


def test_merkle_root_equals_reference_compress_roots(two_shards):
    tc = two_shards[0]["torch"]["cl"]
    pairs = tc.sharded.merkle_roots()
    assert [s for s, _ in pairs] == [0, 1]
    assert tc.sharded.merkle_root == j_mkp.compress_roots(pairs)


def test_fold_out_removes_a_shard(smoke, prompts):
    cl = _cluster("torch", smoke)
    for p in prompts:
        cl.submit(prompt=p, max_new_tokens=4)
    cl.step()
    root, merkle_root = cl.sharded.root_mac, cl.sharded.merkle_root
    cl.sharded.fold_out(1)
    assert not torch.equal(cl.sharded.root_mac, root)
    assert cl.sharded.merkle_root != merkle_root
    assert [s for s, _ in cl.sharded.merkle_roots()] == [0]
    assert cl.sharded.deferred_root_check()


# ---------------------------------------------------------------------------
# Tenants: migration and rotation across the shards.
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tenants(smoke, prompts):
    """Tenants a and b, a rotation every tick, 4 pages a slot and 6 a
    shard: tenant a's younger slot migrates to shard 1, and the
    rotations reseal pages on both shards.  Both packages."""
    runs = {}
    for side in ("jax", "torch"):
        reg, (sa, sb) = _registry(side, 5, "ab")
        cl = _cluster(side, smoke, registry=reg, rotate_every=1, n_pages=6)
        tokens = _serve(cl, [(prompts[0], 11, sa), (prompts[1], 2, sb),
                             (prompts[2], 7, sa)])
        runs[side] = dict(cl=cl, tokens=tokens, snap=_snap(cl))
    return runs


def test_tenant_migration_reseals_to_destination(tenants):
    j, t = tenants["jax"], tenants["torch"]
    assert t["tokens"] == j["tokens"]
    assert [len(x) for x in t["tokens"]] == [11, 2, 7]
    _assert_same_counters(j["snap"], t["snap"])
    assert t["snap"]["stats"]["migrations"] > 0
    assert t["snap"]["engine_stats"]["preemptions"] == 0
    assert t["cl"].deferred_check()


def test_rotation_fans_out_to_every_shard(tenants):
    shards = tenants["torch"]["snap"]["shards"]
    reseals = [s["reseals"] for s in shards]
    assert reseals == [s["reseals"] for s in tenants["jax"]["snap"]["shards"]]
    assert all(n > 0 for n in reseals)
    # Every shard's hook saw every registry rotation.
    rotations = {s["rotations"] for s in shards}
    assert rotations == {tenants["torch"]["snap"]["engine_stats"][
        "rotations"]} and rotations != {0}


def test_failed_migration_leaves_both_pools_untouched(smoke, prompts):
    cl = _cluster("torch", smoke, **MIGRATION_KW)
    for p, n in ((prompts[0], 20), (prompts[1], 2), (prompts[2], 20)):
        cl.submit(prompt=p, max_new_tokens=n)
    cl.step()
    src = next(s for s, e in enumerate(cl.engines)
               if sum(sl is not None for sl in e.slots) == 2)
    es, ed = cl.engines[src], cl.engines[1 - src]
    slot = es.slots[0]
    es.pool.cts[0][slot.pages[0], 3] ^= 0x01
    before = [_pool_state(e.pool, e.n_pages) for e in (es, ed)]
    free = [list(e.free_pages) for e in (es, ed)]
    with pytest.raises(IntegrityError, match="migration") as info:
        cl._migrate_slot(src, 0, 1 - src)
    assert info.value.ctx["op"] == "migration"
    for e, state, fl in zip((es, ed), before, free):
        _assert_state_equal(_pool_state(e.pool, e.n_pages), state)
        assert e.free_pages == fl
    assert es.slots[0] is slot and cl.stats["migrations"] == 0


# ---------------------------------------------------------------------------
# Shard failover.
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def failover(smoke):
    """``shard_kill`` on shard 1 at tick 3 under fault tolerance, in
    both packages (``off``: failover does not depend on the scheme, and
    the chip smoke runs it under ``seda``); the port's fault-free tokens
    beside them."""
    rng = np.random.default_rng(1)
    reqs = [(list(map(int, rng.integers(1, 256, n))), 4, None)
            for n in (6, 5, 4)]
    runs = {}
    for side, plan_mod in (("jax", j_faults), ("torch", faults_mod)):
        cl = _cluster(side, smoke, scheme="off", fault_tolerance=True)
        plan = plan_mod.FaultPlan([plan_mod.Fault(tick=3, kind="shard_kill",
                                                  shard=1)])
        plan.attach_cluster(cl)
        runs[side] = dict(cl=cl, tokens=_serve(cl, reqs), snap=_snap(cl),
                          fired=[vars(f) for f in plan.fired])
    return runs, _serve(_cluster("torch", smoke, scheme="off"), reqs)


def test_shard_kill_fails_over_like_the_reference(failover):
    runs, want = failover
    j, t = runs["jax"], runs["torch"]
    tc = t["cl"]
    assert t["tokens"] == j["tokens"] == want
    assert t["fired"] == j["fired"] and len(t["fired"]) == 1
    _assert_same_counters(j["snap"], t["snap"])
    assert all(r.state == "finished" for r in tc.requests.values())
    assert tc.stats["shard_failovers"] == 1 and tc.failed_shards == {1}
    assert tc.engine_stats["sessions_lost"] == 0
    assert tc.engine_stats["sessions_recovered"] >= 1
    # The dead shard is folded out of both roots.
    assert tc.sharded._active == [0]
    assert [s for s, _ in tc.sharded.merkle_roots()] == [0]
    assert tc.deferred_check()


def test_failover_is_audited(smoke, prompts):
    cl = _cluster("torch", smoke, scheme="off", fault_tolerance=True,
                  audit=True)
    faults_mod.FaultPlan([faults_mod.Fault(tick=2, kind="shard_kill",
                                           shard=0)]).attach_cluster(cl)
    _serve(cl, [(p, 4, None) for p in prompts])
    (event,) = cl.audit.events("shard_failover")
    assert event["shard"] == 0 and event["sessions"] >= 1
    assert cl.audit.verify_chain() and cl.failed_shards == {0}


def test_no_survivor_is_fatal(smoke, prompts):
    cl = _cluster("torch", smoke, scheme="off", fault_tolerance=True)
    faults_mod.FaultPlan([faults_mod.Fault(tick=2, kind="shard_kill",
                                           shard=s) for s in (0, 1)]
                         ).attach_cluster(cl)
    for p in prompts:
        cl.submit(prompt=p, max_new_tokens=4)
    with pytest.raises(IntegrityError, match="no survivor"):
        cl.run()


# ---------------------------------------------------------------------------
# Integrity: replay through the cluster, the mirror alone.
# ---------------------------------------------------------------------------


def test_cross_shard_replay_through_cluster_raises(smoke, prompts):
    cl = _cluster("torch", smoke, max_slots=1)
    cl.submit(prompt=prompts[0], max_new_tokens=8)
    cl.submit(prompt=prompts[1], max_new_tokens=6)
    cl.step()
    e0, e1 = cl.engines
    pid0, pid1 = e0.slots[0].pages[0], e1.slots[0].pages[0]
    # Shard 0's page (ct, MAC, VN) copied verbatim into shard 1's pool.
    for c0, c1 in zip(e0.pool.cts, e1.pool.cts):
        c1[pid1] = c0[pid0]
    e1.pool.page_macs[pid1] = e0.pool.page_macs[pid0]
    e1.pool.page_vns[pid1] = e0.pool.page_vns[pid0]
    with pytest.raises(IntegrityError):
        cl.run()


def test_mirror_alone_localizes_and_repair_readopts(smoke, prompts):
    """Without the Merkle level the mirror alone catches the consistent
    swap, before and after the next write, and localizes the shard; a
    repair commit (old pool None) re-adopts the pool MAC wholesale."""
    cl = _cluster("torch", smoke, merkle=False)
    for p in prompts:
        cl.submit(prompt=p, max_new_tokens=4)
    cl.step()
    eng = cl.engines[1]
    _tamper("torch", eng, "consistent", eng.free_pages[0])
    assert bool(kvp.deferred_pool_check(eng.pool, eng.spec))
    assert not cl.deferred_check() and cl.sharded.failing_shards() == [1]
    cl.step()
    assert not cl.deferred_check() and cl.sharded.failing_shards() == [1]
    eng._commit_repair()
    assert cl.sharded.failing_shards() == [] and cl.deferred_check()


def _prefix_cluster(smoke, prefix_cache: bool):
    reg, (sess,) = _registry("torch", 0, ["alice"])
    return _cluster("torch", smoke, n_pages=16, registry=reg,
                    prefix_cache=prefix_cache), sess


def test_routing_prefers_the_prefix_holder(smoke, prompts):
    """Cache pages are shard-local: follow-up requests with a cached
    prompt route to the shard that seeded it and hit there, with the
    tokens of a cluster without the cache."""
    base, s0 = _prefix_cluster(smoke, False)
    want = _serve(base, [(prompts[2], 4, s0)] * 4)
    cl, sess = _prefix_cluster(smoke, True)
    got = _serve(cl, [(prompts[2], 4, sess)])
    got += _serve(cl, [(prompts[2], 4, sess)] * 3)
    assert got == want
    seeded = [e.stats["prefix_inserted_pages"] for e in cl.engines]
    hits = [e.stats["prefix_hit_pages"] for e in cl.engines]
    assert sum(1 for n in seeded if n) == 1
    assert hits[seeded.index(max(seeded))] > 0
    assert cl.engine_stats["prefix_hit_pages"] == sum(hits)


def test_cluster_submit_surface_and_stat_sums(smoke):
    from repro_torch.serve.engine import SubmitRequest
    cl = _cluster("torch", smoke, scheme="off")
    prompt = [9, 8, 7, 6, 5]
    with pytest.warns(DeprecationWarning):
        r0 = cl.submit(prompt, 4)
    r1 = cl.submit(SubmitRequest(prompt=prompt, max_new_tokens=4))
    done = cl.run()
    assert done[r0].generated == done[r1].generated
    for i, eng in enumerate(cl.engines):
        eng.stats["brand_new_counter"] = i + 1
    assert cl.engine_stats["brand_new_counter"] == 3


# ---------------------------------------------------------------------------
# Cluster audit proofs.
# ---------------------------------------------------------------------------


def test_cluster_proof_chains_to_cluster_root(smoke):
    reg, (sa, sb) = _registry("torch", 41, "ab")
    cl = _cluster("torch", smoke, registry=reg, n_pages=8)
    rng = np.random.default_rng(13)
    for session in (sa, sb, sa):
        cl.submit(prompt=list(map(int, rng.integers(1, 256, 5))),
                  max_new_tokens=6, session=session)
    cl.step()
    cl.step()
    proofs = cl.audit_proof(sa)
    assert proofs
    cluster_root = cl.sharded.merkle_root.hex()
    for p in proofs:
        assert p.cluster["root"] == cluster_root
        assert mkp.verify_proof(p, tenant=p.tenant)
        assert j_mkp.verify_proof(j_mkp.proof_from_dict(p.to_dict()),
                                  tenant=p.tenant)
    # A forged shard-root set breaks the cluster binding.
    p = proofs[0]
    forged = [(s, ("0" * 64 if s != p.shard else r))
              for s, r in p.cluster["shard_roots"]]
    bad = dataclasses.replace(p, cluster={"shard_roots": forged,
                                          "root": p.cluster["root"]})
    with pytest.raises(mkp.ClusterRootError):
        mkp.verify_proof(bad)


# ---------------------------------------------------------------------------
# Observability and the launcher.
# ---------------------------------------------------------------------------


def test_cluster_counters_in_snapshot_equal_reference(two_shards):
    runs = two_shards[0]
    jc, tc = runs["jax"]["cl"], runs["torch"]["cl"]
    snap, j_snap = tc.snapshot(), jc.snapshot()
    assert snap["counters"] == j_snap["counters"] == dict(tc.stats)
    assert snap["rollup"] == tc.engine_stats
    assert [s["labels"] for s in snap["shards"]] == \
        [{"shard": "0"}, {"shard": "1"}]
    assert snap["histograms"]["cluster_tick_seconds"]["count"] == tc.tick
    for shard, j_shard in zip(snap["shards"], j_snap["shards"]):
        for name in ("pool_free_pages", "pool_pages_total", "slots_active"):
            assert shard["gauges"][name] == j_shard["gauges"][name]


def test_prometheus_and_trace_carry_the_shards(two_shards):
    tc = two_shards[0]["torch"]["cl"]
    text = tc.prometheus()
    assert "# TYPE repro_migrations counter" in text
    assert 'repro_decode_steps{shard="0"}' in text
    assert 'repro_decode_steps{shard="1"}' in text
    events = tc.export_trace()["traceEvents"]
    assert {e["pid"] for e in events} == {0, 1, 2}
    assert any(e["name"] == "cluster_tick" and e["pid"] == 2
               for e in events)


def test_launcher_shards(tmp_path):
    path = tmp_path / "proofs.json"
    out = launch.main(["--smoke", "--device", "cpu", "--engine", "paged",
                       "--scheme", "seda", "--shards", "2", "--tenants", "2",
                       "--rotate-every", "4", "--audit-proof-out",
                       str(path), "--quiet"])
    assert out["deferred_mac_ok"]
    assert out["tokens"].shape == (4, 16)
    assert out["stats"]["rotations"] > 0 and "migrations" in out["stats"]
    import json
    bundle = json.loads(path.read_text())
    assert bundle["verified"] == len(bundle["proofs"]) >= 2
    for d in bundle["proofs"]:
        assert d["cluster"] is not None
        mkp.verify_proof(mkp.proof_from_dict(d), expected_root=d["root"],
                         tenant=d["tenant"])
    final = bundle["final"]
    pairs = [(s, bytes.fromhex(r)) for s, r in final["shard_roots"]]
    assert [s for s, _ in pairs] == [0, 1]
    assert mkp.compress_roots(pairs).hex() == final["cluster_root"]


def test_launcher_refuses_shards_without_paged():
    with pytest.raises(SystemExit, match="--shards needs --engine paged"):
        launch.main(["--smoke", "--device", "cpu", "--engine", "simple",
                     "--shards", "2"])
