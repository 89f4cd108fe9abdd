"""Port tenancy (``repro_torch.tenancy``, the mixed ctx path of
``repro_torch.serve``) against the JAX package.

* KDF and key bank bytes, the retained-epoch and cache-row windows.
* PageIO under a mixed ctx for all 7 schemes: pool bytes after a mixed
  write, a dirty write, a reseal, and the read, ``read_raw`` and verdicts,
  on identical plaintext; cross-tenant and stale-epoch reads fail.
* The multi-tenant engine: tokens and counters equal to the JAX engine
  for ``seda`` (kernels on both sides; plain versions here) and
  ``mgx64`` with a rotation every tick, so reseals and preemptions fire;
  weighted-fair admission order under a quota.
* The port's launcher: argument errors and a small run.

The JAX engines run once each, in module-scoped fixtures.
"""

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
from repro.tenancy import keys as j_keys
from repro_torch.configs import get_arch
from repro_torch.convert import params_from_numpy
from repro_torch.core.vn import kv_page_vn
from repro_torch.launch import serve as launch
from repro_torch.models import lm
from repro_torch.serve import kv_pages as kvp
from repro_torch.serve.engine import IntegrityError, SecureServingEngine
from repro_torch.tenancy import KeyHierarchy, TenantRegistry
from repro_torch.tenancy import keys as keys_mod
from test_torch_models import numpy_params
from test_torch_serving import _assert_same, _pool_state, _t

SCHEMES = ["off", "sgx64", "sgx512", "mgx64", "mgx512", "seda", "seda512"]
STATS = ("admitted", "decode_steps", "prefill_compiles",
         "decode_bucket_compiles", "uniform_fast_ticks", "fused_mixed_ticks",
         "fused_write_ticks", "decode_page_reads", "deferred_checks",
         "preemptions", "rotations", "reseals")


def _np(t) -> np.ndarray:
    a = t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    return a.view(np.uint32) if a.dtype == np.int32 else a


def _registries(n: int, seed: int, weights=None, quota=None, rotate=()):
    """The same registry in both packages: ``n`` tenants, then the
    rotations in ``rotate`` (tenant ids)."""
    out = []
    for reg in (JRegistry(JHierarchy(seed), max_tenants=max(n, 2)),
                TenantRegistry(KeyHierarchy(seed, device="cpu"),
                               max_tenants=max(n, 2))):
        for i in range(n):
            reg.register(f"t{i}", weight=(weights or [1.0] * n)[i],
                         page_quota=quota)
        for tid in rotate:
            reg.rotate(tid)
        out.append(reg)
    return out


# ---------------------------------------------------------------------------
# Keys and the registry.
# ---------------------------------------------------------------------------


def test_kdf_and_bank_bytes_match():
    j_reg, reg = _registries(3, 17, weights=[1.0, 2.0, 0.5],
                             rotate=["t0", "t2", "t0"])
    for a, b in zip(j_reg.bank, reg.bank):
        assert (np.asarray(a) == _np(b)).all()
    for i in range(3):
        jt, t = j_reg.by_index(i), reg.by_index(i)
        assert jt.current_epoch == t.current_epoch
        for name in ("master", "enc_key", "mac_key", "vn_key"):
            assert (getattr(jt.keyset, name) == getattr(t.keyset, name)).all()
        e = t.current_epoch
        for a, b in zip(jt.keyset.epoch_keys(e), t.keyset.epoch_keys(e)):
            assert (np.asarray(a) == _np(b)).all()
        assert jt.keyset.epoch_salt(e) == t.keyset.epoch_salt(e)
        for a, b in zip(jt.keyset.cache_keys(), t.keyset.cache_keys()):
            assert (np.asarray(a) == _np(b)).all()
        assert jt.keyset.cache_salt() == t.keyset.cache_salt()
    for msg in (b"", b"x" * 15, b"y" * 16, b"z" * 33):
        key = np.arange(16, dtype=np.uint8)
        assert (j_keys.prf(key, msg) == keys_mod.prf(key, msg)).all()
    seed = np.arange(16, dtype=np.uint8) * 7
    assert (j_keys._expand_lanes(seed, 21)
            == keys_mod._expand_lanes(seed, 21)).all()
    assert KeyHierarchy(b"\x01" * 16, device="cpu")._root.tolist() == [1] * 16


def test_key_row_and_cache_row_windows():
    j_reg, reg = _registries(2, 5, rotate=["t1", "t1", "t1"])
    for index in range(2):
        for epoch in range(-1, 6):
            try:
                want = j_reg.key_row(index, epoch)
            except KeyError:
                with pytest.raises(KeyError, match="retained window"):
                    reg.key_row(index, epoch)
                continue
            assert reg.key_row(index, epoch) == want
        assert reg.cache_row(index) == j_reg.cache_row(index)
    with pytest.raises(KeyError):
        reg.cache_row(2)
    # The dropped epoch's material is destroyed in both.
    for r in (j_reg, reg):
        with pytest.raises(KeyError, match="dropped"):
            r.by_index(1).keyset.epoch_keys(1)


def test_sessions_registration_and_bank_replicas():
    reg = TenantRegistry(KeyHierarchy(2, device="cpu"), max_tenants=2)
    assert reg.device.type == "cpu"
    a = reg.register("a")
    with pytest.raises(ValueError, match="already"):
        reg.register("a")
    with pytest.raises(ValueError, match="positive"):
        reg.register("b", weight=0)
    reg.register("b", page_quota=3)
    with pytest.raises(ValueError, match="full"):
        reg.register("c")
    with pytest.raises(ValueError, match="retain"):
        TenantRegistry(KeyHierarchy(2, device="cpu"), retain=1)
    sess = reg.open_session("a")
    assert reg.validate(sess) is a
    with pytest.raises(PermissionError):
        reg.validate(sess._replace(index=1))
    reg.revoke(sess)
    with pytest.raises(PermissionError):
        reg.validate(sess)
    # The bank on the registry's device is the bank itself; a rotation
    # rewrites its row in place, so a held reference sees the new keys.
    bank = reg.bank_for("cpu")
    assert bank is reg.bank
    before = bank.round_keys[reg.key_row(0, 0)].clone()
    reg.rotate("a")
    assert torch.equal(bank.round_keys[reg.key_row(0, 1)],
                       reg.keys_for(0, 1).round_keys)
    assert not torch.equal(bank.round_keys[reg.key_row(0, 1)], before)


# ---------------------------------------------------------------------------
# PageIO under a mixed ctx.
# ---------------------------------------------------------------------------

MAX_SLOTS, PAGE_TOKENS, N_PAGES, MAX_LEN = 4, 4, 6, 8


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


def _ctxs(j_reg, reg, owners, epochs):
    """The same ctx in both packages for (owner, epoch) per page."""
    rows = np.array([reg.key_row(o, e) for o, e in zip(owners, epochs)])
    owners, epochs = np.asarray(owners), np.asarray(epochs)
    return (j_kvp.PageKeyCtx.make(j_reg.bank, rows.astype(np.int32),
                                  owners.astype(np.uint32),
                                  epochs.astype(np.uint32)),
            kvp.PageKeyCtx.make(reg.bank, rows, owners, epochs))


@pytest.mark.parametrize("scheme", SCHEMES)
def test_page_io_mixed_ctx_matches(smoke, scheme):
    """Slot i owns page ids[i]; tenants 0, 0, 1, 1 at epochs 0, 1, 0, 1.
    Every crossing is four pages wide, so the reference's eager
    primitives compile once per scheme."""
    _, j_cfg, _, _, cfg, _ = smoke
    j_reg, reg = _registries(2, 31, rotate=["t0", "t1"])
    rng = np.random.default_rng(SCHEMES.index(scheme) + 50)
    kw = dict(scheme=scheme, page_tokens=PAGE_TOKENS, n_pages=N_PAGES,
              max_slots=MAX_SLOTS, max_len=MAX_LEN)
    j_spec = j_kvp.build_page_spec(j_lm.cache_specs(j_cfg, MAX_SLOTS,
                                                    MAX_LEN),
                                   use_kernel=False, **kw)
    tree = lm.cache_specs(cfg, MAX_SLOTS, MAX_LEN)
    specs = [kvp.build_page_spec(tree, use_kernel=uk, **kw)
             for uk in (True, False)]
    j_io = j_kvp.PageIO(j_spec, None)
    ios = [kvp.PageIO(spec, None) for spec in specs]
    j_pool = j_kvp.init_pool(j_spec)
    pools = [kvp.init_pool(spec, device="cpu") for spec in specs]
    leaf_shape = tree[0][0].k.shape             # (steps, S, L, kv, hd)
    ids = np.array([3, 2, 1, 0], np.int32)
    owners = [0, 0, 1, 1]
    j_mixed, mixed = _ctxs(j_reg, reg, owners, [0, 1, 0, 1])
    j_cur, cur = _ctxs(j_reg, reg, owners, [1, 1, 1, 1])
    pages = [rng.standard_normal((4, leaf_shape[0], PAGE_TOKENS)
                                 + leaf_shape[3:]).astype(np.float32)
             for _ in specs[0].leaves]
    real = np.ones(4, bool)
    table = ids[:, None]
    active = np.array([True, False, True, False])
    lengths = np.array([2, 0, 3, 0], np.int32)
    read_len = np.array([3, 4, 4, 1], np.int32)
    dense = [rng.standard_normal(leaf_shape).astype(np.float32)
             for _ in specs[0].leaves]
    # Mixed write; raw read; reseal everything to epoch 1; a dirty write
    # under the current epoch; the decode read.
    j_pool = j_io.write(j_pool, jnp.asarray(ids),
                        list(map(jnp.asarray, pages)),
                        j_kv_page_vn(np.uint32(1)), jnp.asarray(real),
                        j_mixed)
    j_raw, j_raw_ok = j_io.read_raw(j_pool, jnp.asarray(ids), j_mixed)
    j_pool, j_rs_ok = j_io.reseal(j_pool, jnp.asarray(ids),
                                  j_kv_page_vn(np.uint32(2)), j_mixed, j_cur)
    j_pool = j_io.write_dirty(j_pool, jnp.asarray(table),
                              list(map(jnp.asarray, dense)),
                              jnp.asarray(lengths), jnp.asarray(active),
                              j_kv_page_vn(np.uint32(3)), j_cur)
    j_dense, j_ok = j_io.read(j_pool, jnp.asarray(table),
                              jnp.asarray(read_len), j_cur)
    assert bool(j_ok) and bool(j_raw_ok) and bool(j_rs_ok)
    for io, pool in zip(ios, pools):
        t_ids = _t(ids).long()
        io.write(pool, t_ids, [_t(p) for p in pages], kv_page_vn(1),
                 _t(real), mixed)
        raw, raw_ok = io.read_raw(pool, t_ids, mixed)
        _, rs_ok = io.reseal(pool, t_ids, kv_page_vn(2), mixed, cur)
        io.write_dirty(pool, _t(table), [_t(d) for d in dense], _t(lengths),
                       _t(active), kv_page_vn(3), cur)
        got_dense, ok = io.read(pool, _t(table), _t(read_len), cur)
        assert bool(ok) and bool(raw_ok) and bool(rs_ok)
        for a, b in zip(j_raw, raw):
            assert (np.asarray(a) == b.numpy()).all()
        for a, b in zip(j_dense, got_dense):
            assert (np.asarray(a) == b.numpy()).all()
        _assert_same(_pool_state(j_pool, N_PAGES, False),
                     _pool_state(pool, N_PAGES, True))
        assert bool(kvp.deferred_pool_check(pool, io.spec))
        if io.spec.cfg.verify == "none":
            continue
        # The resealed pages fail under their old epochs, and every page
        # fails read as the other tenant's.
        assert not bool(io.read_raw(pool, t_ids, mixed)[1])
        _, swapped = _ctxs(j_reg, reg, [1, 1, 0, 0], [1, 1, 1, 1])
        assert not bool(io.read_raw(pool, t_ids, swapped)[1])
        # A reseal of tampered bytes fails and writes nothing.
        pool.cts[0][0, 7] ^= 1
        snapshot = [c.clone() for c in pool.cts]
        _, bad = io.reseal(pool, t_ids, kv_page_vn(4), cur, cur)
        assert not bool(bad)
        assert all(torch.equal(a, b) for a, b in zip(snapshot, pool.cts))


@pytest.mark.parametrize("engine", ["cbc", "naive"])
def test_mixed_ctx_aes_mac_engines_match(smoke, monkeypatch, engine):
    """A custom scheme whose MAC engine is ``cbc`` or ``naive`` (no entry
    of SCHEMES has one), under a mixed ctx: the pool's MAC bytes and the
    verdicts equal the reference's, which computes them page by page."""
    from repro.core import secure_exec as j_exec
    from repro_torch.core import secure_exec as t_exec
    _, j_cfg, _, _, cfg, _ = smoke
    name = f"mgx64-{engine}"
    for mod in (j_exec, t_exec):
        monkeypatch.setitem(mod.SCHEMES, name, mod.SchemeConfig(
            name, 64, "block", engine, False, False, False))
    j_reg, reg = _registries(2, 37, rotate=["t1"])
    kw = dict(scheme=name, page_tokens=PAGE_TOKENS, n_pages=N_PAGES,
              max_slots=MAX_SLOTS, max_len=MAX_LEN, use_kernel=False)
    j_spec = j_kvp.build_page_spec(j_lm.cache_specs(j_cfg, MAX_SLOTS,
                                                    MAX_LEN), **kw)
    tree = lm.cache_specs(cfg, MAX_SLOTS, MAX_LEN)
    spec = kvp.build_page_spec(tree, **kw)
    j_io, io = j_kvp.PageIO(j_spec, None), kvp.PageIO(spec, None)
    j_pool, pool = j_kvp.init_pool(j_spec), kvp.init_pool(spec, "cpu")
    leaf_shape = tree[0][0].k.shape
    rng = np.random.default_rng(41)
    pages = [rng.standard_normal((4, leaf_shape[0], PAGE_TOKENS)
                                 + leaf_shape[3:]).astype(np.float32)
             for _ in spec.leaves]
    ids, real = np.array([3, 2, 1, 0], np.int32), np.ones(4, bool)
    j_mixed, mixed = _ctxs(j_reg, reg, [0, 0, 1, 1], [0, 0, 0, 1])
    j_pool = j_io.write(j_pool, jnp.asarray(ids),
                        list(map(jnp.asarray, pages)),
                        j_kv_page_vn(np.uint32(1)), jnp.asarray(real),
                        j_mixed)
    io.write(pool, _t(ids).long(), [_t(p) for p in pages], kv_page_vn(1),
             _t(real), mixed)
    _assert_same(_pool_state(j_pool, N_PAGES, False),
                 _pool_state(pool, N_PAGES, True))
    raw, ok = io.read_raw(pool, _t(ids).long(), mixed)
    assert bool(ok) and bool(j_io.read_raw(j_pool, jnp.asarray(ids),
                                           j_mixed)[1])
    for a, b in zip(pages, raw):
        assert (a == b.numpy()).all()
    _, swapped = _ctxs(j_reg, reg, [1, 1, 0, 0], [1, 1, 0, 0])
    assert not bool(io.read_raw(pool, _t(ids).long(), swapped)[1])


def test_ctx_make_refuses_rows_outside_the_bank():
    _, reg = _registries(1, 3)
    with pytest.raises(IndexError):
        kvp.PageKeyCtx.make(reg.bank, np.array([0, 6]), np.zeros(2),
                            np.zeros(2))


# ---------------------------------------------------------------------------
# The multi-tenant engine.
# ---------------------------------------------------------------------------

ENGINE_KW = dict(max_slots=3, page_tokens=4, pages_per_slot=4, n_pages=7,
                 defer_interval=2)


def _prompts():
    rng = np.random.default_rng(0)
    return [list(map(int, rng.integers(1, 256, n))) for n in (5, 7, 9, 6)]


def _serve(engine_cls, reg_cls, hier_cls, model, scheme, use_kernel,
           **dev):
    reg = reg_cls(hier_cls(3, **dev), max_tenants=3)
    for i, w in enumerate((1.0, 2.0, 1.0)):
        reg.register(f"t{i}", weight=w)
    sessions = [reg.open_session(f"t{i}") for i in range(3)]
    extra = dict(merkle=False) if not dev else dev
    eng = engine_cls(*model, scheme=scheme, use_kernel=use_kernel,
                     registry=reg, rotate_every=1, **ENGINE_KW, **extra)
    rids = [eng.submit(prompt=p, max_new_tokens=7,
                       session=sessions[i % 3])
            for i, p in enumerate(_prompts())]
    done = eng.run()
    return ([done[r].generated for r in rids],
            {name: eng.stats[name] for name in STATS}, done.latency,
            eng.deferred_check())


@pytest.fixture(scope="module")
def jax_runs(smoke):
    j_arch, j_cfg, j_params = smoke[:3]
    return {(scheme, uk): _serve(JEngine, JRegistry, JHierarchy,
                                 (j_arch, j_cfg, j_params), scheme, uk)
            for scheme, uk in (("seda", True), ("mgx64", False))}


@pytest.mark.parametrize("scheme,use_kernel", [("seda", True),
                                               ("mgx64", False)])
def test_engine_tokens_and_counters_match_reference(smoke, jax_runs, scheme,
                                                    use_kernel):
    _, _, _, arch, cfg, params = smoke
    got = _serve(SecureServingEngine, TenantRegistry, KeyHierarchy,
                 (arch, cfg, params), scheme, use_kernel, device="cpu")
    want = jax_runs[(scheme, use_kernel)]
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert got[2] == want[2]
    assert got[3] is want[3] is True
    stats = got[1]
    assert stats["reseals"] > 0 and stats["preemptions"] > 0
    assert stats["rotations"] > 0
    if scheme == "seda":
        assert stats["fused_mixed_ticks"] > 0 and stats["fused_write_ticks"]


def _admission_order(engine_cls, reg_cls, hier_cls, model, **dev):
    """Rids in the order the engine admits them: tenant t1 has weight 3,
    each tenant a quota of 4 pages."""
    reg = reg_cls(hier_cls(8, **dev), max_tenants=2)
    reg.register("t0", weight=1.0, page_quota=4)
    reg.register("t1", weight=3.0, page_quota=4)
    sessions = [reg.open_session("t0"), reg.open_session("t1")]
    extra = dict(merkle=False) if not dev else dev
    eng = engine_cls(*model, scheme="off", registry=reg, max_slots=2,
                     page_tokens=4, pages_per_slot=4, n_pages=8, **extra)
    order = []
    admit_one = eng._admit_one

    def record(req, tenant, finished):
        order.append(req.rid)
        return admit_one(req, tenant, finished)

    eng._admit_one = record
    prompts = _prompts()
    for i in range(8):
        eng.submit(prompt=prompts[i % 4][:4], max_new_tokens=3,
                   session=sessions[i % 2])
    done = eng.run()
    return order, [done[r].generated for r in sorted(done)]


def test_weighted_fair_admission_order_matches_reference(smoke):
    j_arch, j_cfg, j_params, arch, cfg, params = smoke
    want = _admission_order(JEngine, JRegistry, JHierarchy,
                            (j_arch, j_cfg, j_params))
    got = _admission_order(SecureServingEngine, TenantRegistry, KeyHierarchy,
                           (arch, cfg, params), device="cpu")
    assert got == want
    assert sorted(got[0]) != got[0]          # not FCFS: weights reorder it


def _tenant_engine(smoke, n_tenants=2, **kw):
    _, _, _, arch, cfg, params = smoke
    reg = TenantRegistry(KeyHierarchy(9, device="cpu"), max_tenants=2)
    for i in range(n_tenants):
        reg.register(f"t{i}")
    sessions = [reg.open_session(f"t{i}") for i in range(n_tenants)]
    eng = SecureServingEngine(arch, cfg, params, scheme="seda",
                              use_kernel=True, registry=reg, max_slots=2,
                              page_tokens=4, pages_per_slot=4, device="cpu",
                              **kw)
    return eng, sessions


def test_engine_cross_tenant_and_stale_epoch_reads_raise(smoke):
    prompts = _prompts()
    eng, sess = _tenant_engine(smoke)
    r0 = eng.submit(prompt=prompts[0], max_new_tokens=6, session=sess[0])
    eng.submit(prompt=prompts[1], max_new_tokens=6, session=sess[1])
    eng.step()
    s0 = next(s for s in eng.slots if s and s.req.rid == r0)
    s1 = next(s for s in eng.slots if s and s.req.rid != r0)
    s1.pages, s1.page_epochs = list(s0.pages), list(s0.page_epochs)
    with pytest.raises(IntegrityError):
        eng.step()
    eng, sess = _tenant_engine(smoke, n_tenants=1)
    eng.submit(prompt=prompts[0], max_new_tokens=6, session=sess[0])
    eng.step()
    eng.slots[0].page_epochs[0] = 7          # an epoch that never existed
    with pytest.raises(IntegrityError, match="stale_epoch"):
        eng.step()
    # Replaying a page's pre-rotation ciphertext fails its gate.
    eng, sess = _tenant_engine(smoke, n_tenants=1)
    eng.submit(prompt=[3, 1, 4, 1, 5], max_new_tokens=8, session=sess[0])
    eng.step()
    slot = eng.slots[0]
    dirty = slot.pages[slot.length // eng.page_tokens]
    old = [c[dirty].clone() for c in eng.pool.cts]
    eng.rotate("t0")
    eng.step()                               # re-encrypted under epoch 1
    for c, row in zip(eng.pool.cts, old):
        c[dirty] = row
    with pytest.raises(IntegrityError):
        eng.step()


def test_engine_tenant_surface(smoke):
    _, _, _, arch, cfg, params = smoke
    with pytest.raises(ValueError, match="registry"):
        SecureServingEngine(arch, cfg, params, rotate_every=2, device="cpu")
    eng, sess = _tenant_engine(smoke)
    with pytest.raises(PermissionError):
        eng.submit(prompt=[1, 2], max_new_tokens=2)
    eng.registry.revoke(sess[0])
    with pytest.raises(PermissionError):
        eng.submit(prompt=[1, 2], max_new_tokens=2, session=sess[0])
    eng.submit(prompt=[1, 2, 3], max_new_tokens=4, session=sess[1])
    eng.step()
    assert eng.tenant_resident_pages(1) == 1
    assert eng.tenant_resident_pages(0) == 0


# ---------------------------------------------------------------------------
# The launcher.
# ---------------------------------------------------------------------------


def test_launcher_argument_errors():
    with pytest.raises(SystemExit, match="--tenants"):
        launch.main(["--smoke", "--device", "cpu", "--rotate-every", "2"])
    # --ckpt-dir is accepted (tests/test_torch_checkpoint.py serves one);
    # the simple loop takes no tenants and no paged-engine flags, and
    # sharding and the device-cost profile are not ported.
    for flag in (["--engine", "simple", "--tenants", "2"],
                 ["--engine", "simple", "--fault-tolerance"],
                 ["--shards", "2"], ["--profile-json", "p.json"]):
        with pytest.raises(SystemExit):
            launch.main(["--smoke", "--device", "cpu", *flag])
    with pytest.raises(ValueError, match="pool"):
        launch.main(["--smoke", "--device", "cpu", "--n-pages", "1"])


def test_launcher_multi_tenant_run():
    out = launch.main(["--smoke", "--device", "cpu", "--engine", "paged",
                       "--tenants", "2", "--rotate-every", "2", "--batch",
                       "3", "--prompt-len", "6", "--gen-len", "5"])
    assert out["tokens"].shape == (3, 5)
    stats = out["stats"]
    assert stats["rotations"] > 0 and stats["fused_mixed_ticks"] > 0
    assert out["deferred_mac_ok"] is True
    assert set(out) >= {"tokens", "tok_per_s", "stats", "latency"}
