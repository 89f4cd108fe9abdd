"""The port's secure shared-prefix cache against the JAX package.

* ``PrefixCache`` (host only): seeded op streams give the same matches,
  refcounts, reclaim order and errors in both packages, plus the
  reference's unit cases.
* ``PageIO.copy`` under mixed ctxs (session -> cache binding and back)
  leaves pool bytes equal to the reference's on identical plaintext, for
  all 7 schemes; a copy from a tampered source writes nothing; the free
  functions are bit-identical to the facade.
* The engine: hit / miss / copy-on-write tokens equal the reference's
  no-cache tokens for all 7 schemes, and its counters the reference's
  cache-on ``seda`` engine's; tenant isolation (no cross-tenant match, a
  replayed cache page fails its gate, reseal-on-share, sessions
  checked), the cache surviving rotation, and the ``submit()`` surface.

The JAX engines run once each, in module-scoped fixtures.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.core.vn import kv_page_vn as j_kv_page_vn
from repro.models import lm as j_lm
from repro.serve import kv_pages as j_kvp
from repro.serve.engine import SecureServingEngine as JEngine
from repro.tenancy import KeyHierarchy as JHierarchy
from repro.tenancy import TenantRegistry as JRegistry
from repro_torch.configs import get_arch
from repro_torch.convert import params_from_numpy
from repro_torch.core.vn import kv_page_vn
from repro_torch.models import lm
from repro_torch.models.attention import CacheSpec, KVCache
from repro_torch.serve import kv_pages as kvp
from repro_torch.serve.engine import (STAT_NAMES, IntegrityError,
                                      SecureServingEngine, SubmitRequest)
from repro_torch.tenancy import KeyHierarchy, TenantRegistry
from test_torch_models import numpy_params, port_test_env  # noqa: F401
from test_torch_serving import _assert_same, _pool_state, _t

SCHEMES = ["off", "sgx64", "sgx512", "mgx64", "mgx512", "seda", "seda512"]


@pytest.fixture(scope="module")
def smoke():
    j_arch = j_get_arch("minitron-4b")
    j_cfg = j_arch.make_smoke_config()
    np_params = numpy_params(j_cfg)
    j_params = jax.tree_util.tree_map(jnp.asarray, np_params)
    arch = get_arch("minitron-4b")
    cfg = arch.make_smoke_config()
    params = params_from_numpy(cfg, np_params, device="cpu")
    return j_arch, j_cfg, j_params, arch, cfg, params


# ---------------------------------------------------------------------------
# PrefixCache (host only).
# ---------------------------------------------------------------------------


def _cache_ops(seed: int, n: int = 60) -> list:
    """A seeded op stream over a few prompts sharing prefixes."""
    rng = np.random.default_rng(seed)
    bases = [list(map(int, rng.integers(1, 50, 11))) for _ in range(3)]
    ops = []
    for _ in range(n):
        kind = ("seed", "seed", "match", "acquire", "release", "reclaim",
                "flush", "evict", "dup")[int(rng.integers(9))]
        toks = bases[int(rng.integers(3))][: int(rng.integers(1, 12))]
        ops.append((kind, int(rng.integers(2)), toks,
                    int(rng.integers(0, 4))))
    return ops


def _drive_cache(cls, ops) -> list:
    """Apply ``ops`` to a fresh ``cls(4, 6)``; record every answer."""
    pc = cls(page_tokens=4, capacity_pages=6)
    held, log, next_page = [], [], 0

    def view(entries):
        return [(e.page_id, e.n_tokens, e.refs) for e in entries]

    for kind, tenant, toks, n in ops:
        try:
            if kind == "seed":
                matched, missing = pc.missing(tenant, toks)
                parent = matched[-1] if matched else None
                short = pc.free_capacity()
                freed = pc.reclaim(len(missing) - short) if short < len(
                    missing) else []
                for key, n_tok in missing:
                    parent = pc.insert(key, parent, next_page, n_tok)
                    next_page += 1
                out = (view(matched), len(missing), freed)
            elif kind == "match":
                out = (view(pc.match(tenant, toks)),
                       pc.match_tokens(tenant, toks))
            elif kind == "acquire":
                chain = pc.match(tenant, toks)
                pc.acquire(chain)
                held.append(chain)
                out = view(chain)
            elif kind == "release":
                out = view(held[n % len(held)]) if held else None
                if held:
                    pc.release(held[n % len(held)])
            elif kind == "reclaim":
                out = pc.reclaim(n)
            elif kind == "flush":
                out = pc.flush(tenant if n % 2 else None)
            elif kind == "evict":
                out = pc.evict_pages([n, n + 3])
            else:                                   # re-insert a cached key
                chain = pc.match(tenant, toks)
                out = view(chain)
                if chain:
                    pc.insert(chain[-1].key, chain[-1].parent, 99, 4)
        except (RuntimeError, ValueError) as e:
            out = type(e).__name__
        entries = sorted((e.key[0], e.page_id, e.n_tokens, e.refs,
                          e.last_use) for e in pc._entries.values())
        log.append((kind, out, entries, pc.pages_used, pc.total_refs))
    return log


@pytest.mark.parametrize("seed", range(6))
def test_prefix_cache_op_streams_match_reference(seed):
    ops = _cache_ops(seed)
    want = _drive_cache(j_kvp.PrefixCache, ops)
    got = _drive_cache(kvp.PrefixCache, ops)
    assert got == want
    kinds = {k for k, out, *_ in want if out not in ("ValueError",
                                                    "RuntimeError")}
    assert {"seed", "match", "reclaim"} <= kinds


def _seed_chain(pc, tenant, tokens, first_page=0):
    matched, missing = pc.missing(tenant, tokens)
    assert matched == []
    parent = None
    for i, (key, n) in enumerate(missing):
        parent = pc.insert(key, parent, first_page + i, n)
    return missing


def test_prefix_cache_chain_partial_leaf_and_tenants():
    pc = kvp.PrefixCache(page_tokens=4, capacity_pages=8)
    toks = list(range(10, 19))                       # 4 + 4 + 1-partial
    _seed_chain(pc, 0, toks)
    assert [e.n_tokens for e in pc.match(0, toks)] == [4, 4, 1]
    assert [e.n_tokens for e in pc.match(0, toks[:8])] == [4, 4]
    assert [e.n_tokens for e in pc.match(0, toks[:6])] == [4]
    assert pc.match(0, [99] + toks[1:]) == []
    assert pc.match_tokens(0, toks) == 9
    assert pc.match(1, toks) == []                   # tenants never share
    matched, missing = pc.missing(1, toks)
    assert matched == [] and len(missing) == 3
    pc2 = kvp.PrefixCache(page_tokens=4, capacity_pages=8)
    _seed_chain(pc2, 0, list(range(7)))              # 4 + 3-partial
    assert [e.n_tokens for e in pc2.match(0, list(range(9)))] == [4, 3]


def test_prefix_cache_refcounts_reclaim_and_insert_errors():
    pc = kvp.PrefixCache(page_tokens=4, capacity_pages=4)
    _seed_chain(pc, 0, list(range(8)), first_page=0)        # pages 0, 1
    _seed_chain(pc, 1, list(range(50, 54)), first_page=5)   # page 5
    chain = pc.match(0, list(range(8)))
    pc.acquire(chain)
    assert [e.refs for e in chain] == [1, 1]
    assert pc.reclaim(3) == [5]                      # pinned chain stays
    pc.release(chain)
    with pytest.raises(RuntimeError):
        pc.release(chain)                            # refcount underflow
    assert pc.reclaim(3) == [1, 0]                   # leaf-first
    missing = _seed_chain(pc, 0, list(range(7)))     # full + partial leaf
    with pytest.raises(ValueError):
        pc.insert(missing[0][0], None, 9, 4)         # duplicate chunk
    partial = pc.match(0, list(range(7)))[-1]
    with pytest.raises(ValueError):
        pc.insert((0, b"y"), partial, 9, 4)          # extend partial leaf
    assert pc.missing(0, list(range(9)))[1] == []
    pc.insert((0, b"x"), None, 8, 4)
    pc.insert((0, b"z"), None, 9, 4)
    with pytest.raises(ValueError, match="capacity"):
        pc.insert((0, b"w"), None, 10, 4)
    assert sorted(pc.flush(tenant_index=1)) == []
    assert pc.evict_pages([0]) == 2                  # page 0 + its leaf


# ---------------------------------------------------------------------------
# PageIO.copy, the wrappers.
# ---------------------------------------------------------------------------

MAX_SLOTS, PAGE_TOKENS, N_PAGES, MAX_LEN = 4, 4, 10, 8


def _registries():
    out = []
    for reg in (JRegistry(JHierarchy(41), max_tenants=2),
                TenantRegistry(KeyHierarchy(41, device="cpu"),
                               max_tenants=2)):
        reg.register("t0")
        reg.register("t1")
        reg.rotate("t1")
        out.append(reg)
    return out


def _ctx_pair(j_reg, reg, owners, epochs):
    """The same ctx in both packages; ``PREFIX_ROLE`` selects the cache
    row, any other epoch its session row."""
    rows = np.array([reg.cache_row(o) if e & kvp.PREFIX_ROLE
                     else reg.key_row(o, e) for o, e in zip(owners, epochs)])
    owners, epochs = np.asarray(owners), np.asarray(epochs)
    return (j_kvp.PageKeyCtx.make(j_reg.bank, rows.astype(np.int32),
                                  owners.astype(np.uint32),
                                  epochs.astype(np.uint32)),
            kvp.PageKeyCtx.make(reg.bank, rows, owners, epochs))


@pytest.mark.parametrize("scheme", SCHEMES)
def test_copy_rebinds_pages_like_the_reference(smoke, scheme):
    """Session pages of two tenants are copied into cache-bound pages
    (lanes padded with the scratch page), and one cache page back into a
    session page (copy-on-write): pool bytes equal the reference's, with
    and without the kernels' route."""
    _, j_cfg, _, _, cfg, _ = smoke
    j_reg, reg = _registries()
    role = kvp.PREFIX_ROLE
    rng = np.random.default_rng(SCHEMES.index(scheme) + 70)
    kw = dict(scheme=scheme, page_tokens=PAGE_TOKENS, n_pages=N_PAGES,
              max_slots=MAX_SLOTS, max_len=MAX_LEN)
    j_spec = j_kvp.build_page_spec(j_lm.cache_specs(j_cfg, MAX_SLOTS,
                                                    MAX_LEN),
                                   use_kernel=False, **kw)
    tree = lm.cache_specs(cfg, MAX_SLOTS, MAX_LEN)
    specs = [kvp.build_page_spec(tree, use_kernel=uk, **kw)
             for uk in (True, False)]
    scratch = specs[0].scratch_page
    leaf_shape = tree[0][0].k.shape
    pages = [rng.standard_normal((4, leaf_shape[0], PAGE_TOKENS)
                                 + leaf_shape[3:]).astype(np.float32)
             for _ in specs[0].leaves]
    ids = np.array([0, 1, 2, 3])
    src = np.array([0, 1, 2, 3, scratch])
    dst = np.array([4, 5, 6, 7, scratch])
    owners = [0, 0, 1, 1, 0]
    sessions = _ctx_pair(j_reg, reg, owners[:4], [0, 0, 1, 1])
    src_sessions = _ctx_pair(j_reg, reg, owners, [0, 0, 1, 1, 0])
    caches = _ctx_pair(j_reg, reg, owners, [role] * 5)
    cow_src = _ctx_pair(j_reg, reg, [1, 1], [role, role])
    cow_dst = _ctx_pair(j_reg, reg, [1, 1], [1, 1])
    j_io = j_kvp.PageIO(j_spec, None)
    j_pool = j_io.write(j_kvp.init_pool(j_spec), jnp.asarray(ids, jnp.int32),
                        list(map(jnp.asarray, pages)),
                        j_kv_page_vn(np.uint32(1)),
                        jnp.ones(4, bool), sessions[0])
    j_pool, j_ok = j_io.copy(j_pool, jnp.asarray(src, jnp.int32),
                             jnp.asarray(dst, jnp.int32),
                             j_kv_page_vn(np.uint32(2)), src_sessions[0],
                             caches[0])
    j_pool, j_cow_ok = j_io.copy(j_pool, jnp.asarray([6, scratch], jnp.int32),
                                 jnp.asarray([8, scratch], jnp.int32),
                                 j_kv_page_vn(np.uint32(3)), cow_src[0],
                                 cow_dst[0])
    assert bool(j_ok) and bool(j_cow_ok)
    for spec in specs:
        io = kvp.PageIO(spec, None)
        pool = kvp.init_pool(spec, device="cpu")
        io.write(pool, _t(ids).long(), [_t(p) for p in pages], kv_page_vn(1),
                 torch.ones(4, dtype=torch.bool), sessions[1])
        _, ok = io.copy(pool, src, dst, kv_page_vn(2), src_sessions[1],
                        caches[1])
        _, cow_ok = io.copy(pool, np.array([6, scratch]),
                            np.array([8, scratch]), kv_page_vn(3),
                            cow_src[1], cow_dst[1])
        assert bool(ok) and bool(cow_ok)
        _assert_same(_pool_state(j_pool, N_PAGES, False),
                     _pool_state(pool, N_PAGES, True))
        assert bool(kvp.deferred_pool_check(pool, spec))
        got, ok = io.read_raw(pool, _t(dst[:4]).long(), caches[1].take(4))
        assert bool(ok)
        for a, b in zip(pages, got):
            assert (a == b.numpy()).all()
        if spec.cfg.verify == "none":
            continue
        # The copies fail read under the session binding they left.
        assert not bool(io.read_raw(pool, _t(dst[:4]).long(),
                                    sessions[1])[1])
        # A copy from a tampered source fails and writes nothing.
        pool.cts[0][5, 3] ^= 1
        snapshot = [t.clone() for t in (*pool.cts, pool.page_macs,
                                        pool.page_vns, pool.pool_mac,
                                        *pool.block_macs)]
        _, bad = io.copy(pool, np.array([4, 5]), np.array([9, 9]),
                         kv_page_vn(4), caches[1].take(2),
                         cow_dst[1])
        assert not bool(bad)
        after = (*pool.cts, pool.page_macs, pool.page_vns, pool.pool_mac,
                 *pool.block_macs)
        assert all(torch.equal(a, b) for a, b in zip(snapshot, after))


def _wrapper_spec(scheme):
    tree = [[KVCache(k=CacheSpec((2, 2, 16, 2, 8), "float32"),
                     v=CacheSpec((2, 2, 16, 2, 8), "float32"),
                     length=CacheSpec((2,), "int32"))]]
    return kvp.build_page_spec(tree, scheme=scheme, page_tokens=4,
                               n_pages=6, max_slots=2, max_len=16)


@pytest.mark.parametrize("scheme", ["seda", "mgx64"])
def test_wrappers_bit_identical_to_facade(scheme):
    from repro_torch.core.secure_memory import SecureKeys
    keys = SecureKeys.derive(1234, device="cpu")
    spec = _wrapper_spec(scheme)
    rng = np.random.default_rng(0)
    data = [torch.from_numpy(rng.standard_normal((2, 1, 16, 2, 8)).astype(
        np.float32)) for _ in spec.leaves]
    io = kvp.PageIO(spec, keys)
    ids = torch.tensor([0, 1, 2, 3])
    pool_fn = kvp.write_prefill(kvp.init_pool(spec, "cpu"), spec, keys, ids,
                                data, 4, 1)
    pool_io = io.write_prefill(kvp.init_pool(spec, "cpu"), ids, data, 4, 1)

    def same(a, b):
        for x, y in zip(a, b):
            if isinstance(x, tuple):
                same(x, y)
            else:
                assert torch.equal(x, y)

    same(pool_fn, pool_io)
    table = torch.tensor([[0, 1, 2, 3], [-1, -1, -1, -1]])
    lengths = torch.tensor([16, 0])
    dense_fn, ok_fn = kvp.read_pages(pool_fn, spec, keys, table, lengths)
    dense_io, ok_io = io.read(pool_io, table, lengths)
    assert bool(ok_fn) and bool(ok_io)
    same(dense_fn, dense_io)
    raw_fn, _ = kvp.read_pages_raw(pool_fn, spec, keys, ids)
    raw_io, _ = io.read_raw(pool_io, ids)
    same(raw_fn, raw_io)
    _, ok1 = kvp.reseal_pages(pool_fn, spec, keys, ids, 2)
    _, ok2 = io.reseal(pool_io, ids, 2)
    assert bool(ok1) and bool(ok2)
    same(pool_fn, pool_io)
    dense = [d.expand(2, 2, 16, 2, 8).contiguous() for d in data]
    kvp.write_dirty(pool_fn, spec, keys, table, dense, torch.tensor([5, 0]),
                    torch.tensor([True, False]), 3)
    io.write_dirty(pool_io, table, dense, torch.tensor([5, 0]),
                   torch.tensor([True, False]), 3)
    same(pool_fn, pool_io)
    kvp.write_pages(pool_fn, spec, keys, ids[:2], [r[:2] for r in raw_fn],
                    4, torch.tensor([True, True]))
    io.write(pool_io, ids[:2], [r[:2] for r in raw_io], 4,
             torch.tensor([True, True]))
    same(pool_fn, pool_io)
    dst = [4, 5, spec.scratch_page, spec.scratch_page]
    mig_fn, ok3 = kvp.migrate_pages(pool_fn, spec, kvp.init_pool(spec, "cpu"),
                                    spec, keys, ids, dst, 5)
    mig_io, ok4 = io.migrate(pool_io, spec, kvp.init_pool(spec, "cpu"), ids,
                             dst, 5)
    assert bool(ok3) and bool(ok4)
    same(mig_fn, mig_io)
    moved, ok = io.read_raw(mig_io, torch.tensor([4, 5]))
    assert bool(ok)
    same([r[:2] for r in raw_io], moved)


def test_copy_checks_page_ids_and_listeners():
    from repro_torch.core.secure_memory import SecureKeys
    keys = SecureKeys.derive(1234, device="cpu")
    spec = _wrapper_spec("seda")
    io = kvp.PageIO(spec, keys)
    pool = kvp.init_pool(spec, "cpu")
    seen = []
    io.write_listeners.append(lambda pool, delta: seen.append(pool))
    for bad in ([0, spec.scratch_page + 1], [-1, 0]):
        with pytest.raises(IndexError, match="outside the pool"):
            io.copy(pool, [0, 1], bad, 1)
    with pytest.raises(ValueError, match="destinations"):
        io.copy(pool, [0, 1], [2], 1)
    assert seen == []                    # nothing was written
    data = [torch.zeros((2, 1, 16, 2, 8)) for _ in spec.leaves]
    io.write_prefill(pool, torch.tensor([0, 1]), data, 2, 1)
    io.copy(pool, [0, 1], [2, 3], 2)
    io.reseal(pool, torch.tensor([2]), 3)
    assert seen == [pool, pool, pool]    # every crossing that wrote


# ---------------------------------------------------------------------------
# The prefix-cache engine.
# ---------------------------------------------------------------------------

ENGINE_KW = dict(max_slots=2, page_tokens=4, pages_per_slot=4, n_pages=16)


def _prompts():
    rng = np.random.default_rng(3)
    p7 = list(map(int, rng.integers(1, 256, 7)))
    p8 = p7 + [int(rng.integers(1, 256))]
    p9 = list(map(int, rng.integers(1, 256, 9)))
    # p7 seeds the chain (one full + one partial page); the second p7
    # hits; p8 extends the partial leaf (hit + copy-on-write); p9 misses.
    return [p7, p7, p8, p9]


def _engine(model, engine_cls, reg_cls, hier_cls, *, tenants=("alice",),
            scheme="seda", prefix_cache=True, device_kw=None, **kw):
    device_kw = device_kw or {}
    reg = reg_cls(hier_cls(0, **device_kw), max_tenants=4)
    for t in tenants:
        reg.register(t)
    eng = engine_cls(*model, scheme=scheme, registry=reg,
                     prefix_cache=prefix_cache, **ENGINE_KW, **device_kw,
                     **kw)
    return eng, reg


def _port(smoke, **kw):
    return _engine(smoke[3:], SecureServingEngine, TenantRegistry,
                   KeyHierarchy, use_kernel=True,
                   device_kw={"device": "cpu"}, **kw)


def _hitmiss(eng, reg):
    sess = reg.open_session("alice")
    rids = [eng.submit(prompt=p, max_new_tokens=4, session=sess)
            for p in _prompts()]
    done = eng.run()
    return [done[r].generated for r in rids]


@pytest.fixture(scope="module")
def jax_runs(smoke):
    """The reference's no-cache tokens (``off``) and its cache-on
    ``seda`` engine (kernels on)."""
    model = smoke[:3]
    base, reg = _engine(model, JEngine, JRegistry, JHierarchy,
                        scheme="off", prefix_cache=False)
    baseline = _hitmiss(base, reg)
    eng, reg = _engine(model, JEngine, JRegistry, JHierarchy,
                       use_kernel=True)
    tokens = _hitmiss(eng, reg)
    return baseline, tokens, {name: eng.stats[name] for name in STAT_NAMES}


@pytest.mark.parametrize("scheme", SCHEMES)
def test_hit_miss_cow_tokens_match_reference(smoke, jax_runs, scheme):
    baseline, j_tokens, j_stats = jax_runs
    eng, reg = _port(smoke, scheme=scheme)
    got = _hitmiss(eng, reg)
    assert got == baseline == j_tokens, scheme
    for name in ("prefix_hit_pages", "prefill_pages_skipped",
                 "prefix_cow_pages", "prefix_inserted_pages"):
        assert eng.stats[name] > 0, name
    if scheme == "seda":
        assert {name: eng.stats[name] for name in STAT_NAMES} == j_stats
    assert eng.deferred_check()
    assert eng.prefix_cache.total_refs == 0          # every pin released


def test_cache_survives_rotation(smoke, jax_runs):
    baseline = jax_runs[0]
    eng, reg = _port(smoke)
    sess = reg.open_session("alice")
    p7 = _prompts()[0]
    r0 = eng.submit(prompt=p7, max_new_tokens=4, session=sess)
    eng.run()
    eng.rotate("alice")
    eng.rotate("alice")          # old session epochs leave the window
    hits0 = eng.stats["prefix_hit_pages"]
    r1 = eng.submit(prompt=p7, max_new_tokens=4, session=sess)
    done = eng.run()
    assert eng.stats["prefix_hit_pages"] > hits0
    assert done[r1].generated == baseline[0]
    assert eng.requests[r0].generated == baseline[0]


def test_no_cross_tenant_match_and_replay_rejected(smoke):
    """Tenants never match each other's chains, and a byte-identical
    cache page forged into another tenant's slot fails its MAC gate."""
    eng, reg = _port(smoke, tenants=("alice", "bob"))
    sa, sb = reg.open_session("alice"), reg.open_session("bob")
    p7 = _prompts()[0]
    eng.submit(prompt=p7, max_new_tokens=4, session=sa)
    eng.run()
    bob = reg.tenants["bob"].index
    assert eng.prefix_cache.match(bob, p7) == []
    entry = next(iter(eng.prefix_cache._entries.values()))
    eng.submit(prompt=p7, max_new_tokens=6, session=sb)
    eng.step()                   # admit bob's slot (a prefill: no match)
    slot = next(s for s in eng.slots if s is not None)
    assert slot.tenant.tenant_id == "bob"
    slot.pages[0] = entry.page_id         # replay alice's cache page
    slot.page_epochs[0] = kvp.PREFIX_ROLE
    with pytest.raises(IntegrityError):
        for _ in range(8):
            eng.step()


def test_tampered_cache_page_fails_the_next_hit(smoke):
    eng, reg = _port(smoke)
    sess = reg.open_session("alice")
    p7, _, p8, _ = _prompts()
    eng.submit(prompt=p7, max_new_tokens=4, session=sess)
    eng.run()
    chain = eng.prefix_cache.match(reg.tenants["alice"].index, p7)
    eng.pool.cts[0][chain[0].page_id, 5] ^= 0x40
    eng.submit(prompt=p8, max_new_tokens=4, session=sess)
    with pytest.raises(IntegrityError):
        eng.run()


def test_reseal_on_share_crosses_tenants(smoke, jax_runs):
    baseline = jax_runs[0]
    eng, reg = _port(smoke, tenants=("alice", "bob"))
    sa, sb = reg.open_session("alice"), reg.open_session("bob")
    p7 = _prompts()[0]
    eng.submit(prompt=p7, max_new_tokens=4, session=sa)
    eng.run()
    shared = eng.share_prefix(p7, from_session=sa, to_session=sb)
    assert shared > 0
    assert eng.stats["prefix_shared_pages"] == shared
    assert eng.share_prefix(p7, from_session=sa, to_session=sb) == 0
    hits0 = eng.stats["prefix_hit_pages"]
    rb = eng.submit(prompt=p7, max_new_tokens=4, session=sb)
    done = eng.run()
    assert eng.stats["prefix_hit_pages"] > hits0
    assert done[rb].generated == baseline[0]
    # A tampered source page fails the share and frees what it took.
    eng2, reg2 = _port(smoke, tenants=("alice", "bob"))
    sa2, sb2 = reg2.open_session("alice"), reg2.open_session("bob")
    eng2.submit(prompt=p7, max_new_tokens=4, session=sa2)
    eng2.run()
    chain = eng2.prefix_cache.match(reg2.tenants["alice"].index, p7)
    eng2.pool.cts[1][chain[0].page_id, 0] ^= 1
    free0 = sorted(eng2.free_pages)
    with pytest.raises(IntegrityError, match="share"):
        eng2.share_prefix(p7, from_session=sa2, to_session=sb2)
    assert sorted(eng2.free_pages) == free0
    assert eng2.prefix_cache.match(reg2.tenants["bob"].index, p7) == []


def test_share_needs_valid_sessions_and_a_cache(smoke):
    eng, reg = _port(smoke, tenants=("alice", "bob"))
    sa, sb = reg.open_session("alice"), reg.open_session("bob")
    reg.revoke(sb)
    with pytest.raises(PermissionError):
        eng.share_prefix(_prompts()[0], from_session=sa, to_session=sb)
    plain, reg = _port(smoke, prefix_cache=False)
    with pytest.raises(ValueError, match="prefix_cache"):
        plain.share_prefix([1, 2], from_session=reg.open_session("alice"),
                           to_session=reg.open_session("alice"))
    _, _, _, arch, cfg, params = smoke
    with pytest.raises(ValueError, match="registry"):
        SecureServingEngine(arch, cfg, params, prefix_cache=True,
                            device="cpu", **ENGINE_KW)


def test_share_prefix_opt_out(smoke):
    eng, reg = _port(smoke)
    sess = reg.open_session("alice")
    prompt = list(range(1, 10))
    eng.submit(prompt=prompt, max_new_tokens=4, session=sess,
               share_prefix=False)
    eng.run()
    assert eng.prefix_cache.pages_used == 0          # never seeded
    eng.submit(prompt=prompt, max_new_tokens=4, session=sess)
    eng.run()
    assert eng.prefix_cache.pages_used > 0
    hits = eng.stats["prefix_hit_pages"]
    eng.submit(SubmitRequest(prompt=prompt, max_new_tokens=4, session=sess,
                             share_prefix=False))
    eng.run()
    assert eng.stats["prefix_hit_pages"] == hits     # never read


def test_submit_forms_match_and_validate(smoke):
    _, _, _, arch, cfg, params = smoke
    eng = SecureServingEngine(arch, cfg, params, scheme="off", max_slots=2,
                              page_tokens=4, pages_per_slot=4, device="cpu")
    prompt = [5, 6, 7, 8, 9]
    with pytest.warns(DeprecationWarning):
        r0 = eng.submit(prompt, 4)
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        r1 = eng.submit(prompt=prompt, max_new_tokens=4)
        r2 = eng.submit(SubmitRequest(prompt=prompt, max_new_tokens=4))
    done = eng.run()
    assert done[r0].generated == done[r1].generated == done[r2].generated
    sr = SubmitRequest(prompt=[1, 2], max_new_tokens=2)
    with pytest.raises(TypeError):
        eng.submit(sr, 4)
    with pytest.raises(TypeError):
        eng.submit(sr, max_new_tokens=4)
    with pytest.raises(TypeError), pytest.warns(DeprecationWarning):
        eng.submit([1, 2], prompt=[3, 4])
    with pytest.raises(TypeError), pytest.warns(DeprecationWarning):
        eng.submit([1, 2], 4, max_new_tokens=4)
    with pytest.raises(TypeError, match="no\\s+prompt"):
        eng.submit(None, 4)
