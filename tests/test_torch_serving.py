"""Port paged pool and engine (``repro_torch.serve``) against the JAX ones.

* Page IO: one seeded sequence of ``write_prefill``, ``write_dirty`` and
  ``read`` on identical plaintext leaves; the pool state (``cts``,
  ``page_macs``, ``block_macs``, ``page_vns`` over real rows, and
  ``pool_mac``), the dense read-back and the ``ok`` verdict are equal
  for all 7 schemes.  A flipped byte and a replayed older page fail.
* Engine: identical greedy tokens and counters against
  ``repro.serve.engine.SecureServingEngine(..., merkle=False)`` for
  ``off``, ``seda`` (port with ``use_kernel=True``, reference with the
  bit-identical core route) and ``mgx64``.
* The dense loop (``serve_step``, the launcher's ``--engine simple``):
  the paged ``off`` engine's tokens, and the reference's loop.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.core.secure_memory import SecureKeys as JKeys
from repro.core.vn import kv_page_vn as j_kv_page_vn
from repro.models import lm as j_lm
from repro.serve import kv_pages as j_kvp
from repro.serve.engine import SecureServingEngine as JEngine
from repro_torch.configs import get_arch
from repro_torch.convert import params_from_numpy
from repro_torch.core.secure_memory import SecureKeys
from repro_torch.core.vn import kv_page_vn
from repro_torch.models import lm
from repro_torch.serve import kv_pages as kvp
from repro_torch.serve.engine import (IntegrityError, SecureServingEngine,
                                      SubmitRequest)
from test_torch_models import numpy_params, port_test_env  # noqa: F401

SCHEMES = ["off", "sgx64", "sgx512", "mgx64", "mgx512", "seda", "seda512"]
MAX_SLOTS, PAGE_TOKENS, PAGES_PER_SLOT, N_PAGES = 2, 4, 2, 4
MAX_LEN = PAGE_TOKENS * PAGES_PER_SLOT


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


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _pool_state(pool, n_pages, torch_side: bool) -> dict:
    conv = ((lambda t: t.numpy()) if torch_side else np.asarray)
    vns = conv(pool.page_vns)[:n_pages]
    return {"cts": [conv(c)[:n_pages] for c in pool.cts],
            "page_macs": conv(pool.page_macs)[:n_pages],
            "block_macs": [conv(b)[:n_pages] for b in pool.block_macs],
            "page_vns": vns.view(np.uint32) if torch_side else vns,
            "pool_mac": conv(pool.pool_mac)}


def _assert_same(a: dict, b: dict) -> None:
    for key in a:
        left, right = a[key], b[key]
        if isinstance(left, list):
            assert len(left) == len(right), key
            for x, y in zip(left, right):
                assert (x == y).all(), key
        else:
            assert (left == right).all(), key


def _page_io_sequence(scheme, cfg, j_cfg):
    """Run one op sequence through both packages; return both sides."""
    rng = np.random.default_rng(SCHEMES.index(scheme))
    j_tree = j_lm.cache_specs(j_cfg, MAX_SLOTS, MAX_LEN)
    tree = lm.cache_specs(cfg, MAX_SLOTS, MAX_LEN)
    kw = dict(scheme=scheme, page_tokens=PAGE_TOKENS, n_pages=N_PAGES,
              max_slots=MAX_SLOTS, max_len=MAX_LEN)
    j_spec = j_kvp.build_page_spec(j_tree, use_kernel=False, **kw)
    spec = kvp.build_page_spec(tree, use_kernel=True, **kw)
    assert [tuple(l) for l in spec.leaves] == [tuple(l) for l in j_spec.leaves]
    j_io = j_kvp.PageIO(j_spec, JKeys.derive(5))
    io = kvp.PageIO(spec, SecureKeys.derive(5, device="cpu"))
    leaf_shape = tree[0][0].k.shape                 # (steps, S, L, kv, hd)
    j_pool, pool = j_kvp.init_pool(j_spec), kvp.init_pool(spec, device="cpu")

    def prefill(j_pool, ids, n_write, epoch):
        leaves = [rng.standard_normal((leaf_shape[0], 1) + leaf_shape[2:])
                  .astype(np.float32) for _ in spec.leaves]
        ids = np.array(ids, np.int32)
        j_pool = j_io.write_prefill(j_pool, jnp.asarray(ids),
                                    [jnp.asarray(x) for x in leaves], n_write,
                                    j_kv_page_vn(np.uint32(epoch)))
        io.write_prefill(pool, _t(ids), [_t(x) for x in leaves], n_write,
                         kv_page_vn(epoch))
        return j_pool

    # Every crossing is two pages wide (prefills, the dirty write, and a
    # one-page read window per slot), so the reference compiles each of
    # its primitives once per scheme.
    j_pool = prefill(j_pool, [3, 2], 2, 1)
    older = [c[3].clone() for c in pool.cts], pool.page_vns[3].clone()
    j_pool = prefill(j_pool, [1, 0], 2, 2)
    table = np.array([[3, 2], [1, -1]], np.int32)
    dense = [rng.standard_normal(leaf_shape).astype(np.float32)
             for _ in spec.leaves]
    lengths = np.array([2, 3], np.int32)
    active = np.array([True, True])
    j_pool = j_io.write_dirty(j_pool, jnp.asarray(table),
                              [jnp.asarray(x) for x in dense],
                              jnp.asarray(lengths), jnp.asarray(active),
                              j_kv_page_vn(np.uint32(3)))
    io.write_dirty(pool, _t(table), [_t(x) for x in dense], _t(lengths),
                   _t(active), kv_page_vn(3))
    window, read_len = np.array([[3], [-1]], np.int32), np.array([3, 0],
                                                                  np.int32)
    j_dense, j_ok = j_io.read(j_pool, jnp.asarray(window),
                              jnp.asarray(read_len))
    t_dense, t_ok = io.read(pool, _t(window), _t(read_len))
    return (j_spec, j_pool, j_dense, j_ok), (spec, io, pool, t_dense, t_ok,
                                             older, window, read_len)


@pytest.mark.parametrize("scheme", SCHEMES)
def test_page_io_pool_state_matches(smoke, scheme):
    _, j_cfg, _, _, cfg, _ = smoke
    (j_spec, j_pool, j_dense, j_ok), (spec, io, pool, dense, ok, older,
                                      table, read_len) = _page_io_sequence(
        scheme, cfg, j_cfg)
    _assert_same(_pool_state(j_pool, N_PAGES, False),
                 _pool_state(pool, N_PAGES, True))
    assert bool(ok) == bool(j_ok) is True
    for a, b in zip(j_dense, dense):
        assert (np.asarray(a) == b.numpy()).all()
    assert bool(kvp.deferred_pool_check(pool, spec)) == bool(
        j_kvp.deferred_pool_check(j_pool, j_spec)) is True
    if spec.cfg.verify == "none":
        return
    # A flipped ciphertext byte of a touched page fails the gate.
    pool.cts[0][3, 5] ^= 1
    assert not bool(io.read(pool, _t(table), _t(read_len))[1])
    pool.cts[0][3, 5] ^= 1
    assert bool(io.read(pool, _t(table), _t(read_len))[1])
    # Replaying page 3's older ciphertext (and its VN) fails too.
    cts, vn = older
    for li, ct in enumerate(cts):
        pool.cts[li][3] = ct
    pool.page_vns[3] = vn
    assert not bool(io.read(pool, _t(table), _t(read_len))[1])


def test_page_bytes_round_trip(smoke):
    _, _, _, _, cfg, _ = smoke
    spec = kvp.build_page_spec(lm.cache_specs(cfg, 2, 8), scheme="seda",
                               page_tokens=4, n_pages=4, max_slots=2,
                               max_len=8)
    leaf = spec.leaves[0]
    toks = torch.randn((3, leaf.steps, 4) + leaf.rest)
    buf = kvp._dense_to_pages(spec, leaf, toks)
    assert buf.shape == (3, leaf.page_bytes)
    assert torch.equal(kvp._bytes_to_tokens(spec, leaf, buf), toks)


def test_cache_unflatten_keeps_no_reference_cycle():
    """A rebuilt cache tree holds its leaves and nothing else does: with
    the collector off, a leaf is freed once the caller drops it and the
    tree (the engine rebuilds one over each tick's decrypted window)."""
    import gc
    import weakref
    t0 = torch.zeros(2)
    gc.disable()
    try:
        t, u = torch.ones(2), torch.ones(3)
        alive = weakref.ref(t)
        tree = kvp.cache_unflatten({"a": (t0, t0)}, [t, u])
        assert tree["a"][0] is t and tree["a"][1] is u
        del tree, t
        assert alive() is None
    finally:
        gc.enable()


def test_page_table_and_buckets_match():
    for n, cap in [(1, 8), (3, 8), (5, 4), (9, 16)]:
        assert kvp.page_count_bucket(n, cap) == j_kvp.page_count_bucket(n, cap)

    class Entry:
        def __init__(self, pages):
            self.pages = pages

    j_tab, tab = j_kvp.TwoLevelPageTable(3, 8), kvp.TwoLevelPageTable(3, 8)
    for t in (j_tab, tab):
        t.install(0, Entry([5, 6, 7]))
        t.install(2, Entry([1]))
    assert tab.bucket_for([9, 2], 4) == j_tab.bucket_for([9, 2], 4)
    assert (tab.window(4) == j_tab.window(4)).all()


def _prompts():
    rng = np.random.default_rng(0)
    return [list(map(int, rng.integers(1, 256, n))) for n in (5, 6)]


ENGINE_KW = dict(max_slots=2, page_tokens=4, pages_per_slot=4,
                 defer_interval=2)


@pytest.mark.parametrize("scheme", ["off", "seda", "mgx64"])
def test_engine_tokens_match_reference(smoke, scheme):
    j_arch, j_cfg, j_params, arch, cfg, params = smoke
    j_eng = JEngine(j_arch, j_cfg, j_params, scheme=scheme, merkle=False,
                    use_kernel=False, **ENGINE_KW)
    eng = SecureServingEngine(arch, cfg, params, scheme=scheme,
                              use_kernel=True, device="cpu", **ENGINE_KW)
    j_rids = [j_eng.submit(prompt=p, max_new_tokens=4) for p in _prompts()]
    rids = [eng.submit(prompt=p, max_new_tokens=4) for p in _prompts()]
    j_done, done = j_eng.run(), eng.run()
    assert [done[r].generated for r in rids] == [
        j_done[r].generated for r in j_rids]
    assert done.latency == j_done.latency
    for name in ("admitted", "decode_steps", "prefill_compiles",
                 "decode_bucket_compiles", "uniform_fast_ticks",
                 "decode_page_reads", "deferred_checks"):
        assert eng.stats[name] == j_eng.stats[name], name
    assert (eng.stats["fused_write_ticks"] > 0) == (scheme == "seda")


def test_engine_eos_matches_reference(smoke):
    """``eos_id`` ends a request at that token, as in the reference."""
    j_arch, j_cfg, j_params, arch, cfg, params = smoke
    free = JEngine(j_arch, j_cfg, j_params, scheme="off", merkle=False,
                   **ENGINE_KW)
    rids = [free.submit(prompt=p, max_new_tokens=4) for p in _prompts()]
    eos = free.run()[rids[0]].generated[1]
    j_eng = JEngine(j_arch, j_cfg, j_params, scheme="off", merkle=False,
                    eos_id=eos, **ENGINE_KW)
    eng = SecureServingEngine(arch, cfg, params, scheme="off", eos_id=eos,
                              device="cpu", **ENGINE_KW)
    got = []
    for e in (j_eng, eng):
        rids = [e.submit(prompt=p, max_new_tokens=4) for p in _prompts()]
        done = e.run()
        got.append([(done[r].generated, done[r].done_tick) for r in rids])
    assert got[1] == got[0]
    assert got[1][0][0][-1] == eos and len(got[1][0][0]) <= 2


def _eng(smoke, **kw):
    _, _, _, arch, cfg, params = smoke
    merged = dict(ENGINE_KW, device="cpu", **kw)
    return SecureServingEngine(arch, cfg, params, **merged)


def test_engine_tamper_raises(smoke):
    eng = _eng(smoke, scheme="seda", use_kernel=True)
    eng.submit(SubmitRequest(prompt=[3, 1, 4, 1, 5, 9], max_new_tokens=6))
    eng.step()
    eng.step()
    page = eng.slots[0].pages[0]
    eng.pool.cts[0][page, 0] ^= 0x80
    with pytest.raises(IntegrityError):
        eng.step()


def test_engine_deferred_check_catches_metadata_tamper(smoke):
    eng = _eng(smoke, scheme="seda")
    eng.submit(prompt=[2, 7, 1, 8], max_new_tokens=3)
    free = eng.free_pages[0]
    eng.pool.page_macs[free, 0] ^= 1        # a page no decode reads
    with pytest.raises(IntegrityError, match="deferred"):
        eng.run()


def test_engine_eviction_keeps_tokens(smoke):
    prompts = _prompts()
    roomy = _eng(smoke, scheme="seda", use_kernel=True)
    tight = _eng(smoke, scheme="seda", use_kernel=True, n_pages=4)
    want = [roomy.submit(prompt=p, max_new_tokens=8) for p in prompts]
    got = [tight.submit(prompt=p, max_new_tokens=8) for p in prompts]
    a, b = roomy.run(), tight.run()
    assert tight.stats["preemptions"] > 0
    assert [b[r].generated for r in got] == [a[r].generated for r in want]


def test_engine_submit_surface_and_device(smoke):
    eng = _eng(smoke, scheme="off")
    with pytest.raises(TypeError):
        eng.submit(SubmitRequest(prompt=[1, 2, 3]), 4)
    with pytest.warns(DeprecationWarning):     # the legacy positional form
        eng.submit([1, 2, 3], 4)
    with pytest.raises(ValueError):
        eng.submit(prompt=[1] * 20, max_new_tokens=1)
    with pytest.raises(ValueError, match="registry"):
        eng.submit(prompt=[1], max_new_tokens=1, session=object())
    if not torch.cuda.is_available():
        _, _, _, arch, cfg, params = smoke
        with pytest.raises(RuntimeError, match="cpu"):
            SecureServingEngine(arch, cfg, params, scheme="off")


def test_simple_engine_matches_paged_off_and_reference_loop(smoke,
                                                            monkeypatch):
    """``--engine simple`` gives the paged ``off`` engine's tokens on the
    same prompts, and its serve steps the reference's dense loop."""
    from repro.serve import serve_step as j_step
    from repro_torch.launch import serve as launch
    from repro_torch.serve import serve_step
    argv = ["--smoke", "--device", "cpu", "--batch", "3", "--prompt-len",
            "6", "--gen-len", "5"]
    simple = launch.main(argv + ["--engine", "simple"])
    paged = launch.main(argv + ["--engine", "paged", "--scheme", "off"])
    assert simple["tokens"].shape == (3, 5)
    assert (simple["tokens"] == paged["tokens"]).all()
    j_arch, j_cfg, j_params, arch, cfg, params = smoke
    prompts = np.random.default_rng(3).integers(1, cfg.vocab, (2, 5))
    j_prefill = jax.jit(j_step.make_prefill_step(j_arch, j_cfg, 9))
    j_decode = jax.jit(j_step.make_decode_step(j_arch, j_cfg))
    prefill = serve_step.make_prefill_step(arch, cfg, 9)
    decode = serve_step.make_decode_step(arch, cfg)
    j_logits, j_caches = j_prefill(j_params, {"tokens": jnp.asarray(
        prompts, jnp.int32)})
    with torch.no_grad():
        logits, caches = prefill(params, {"tokens": _t(prompts)})
    j_tok, tok = j_step.greedy_sample(j_logits), serve_step.greedy_sample(
        logits)
    for _ in range(4):
        assert (np.asarray(j_tok) == tok.numpy()).all()
        j_logits, j_caches = j_decode(j_params, j_tok, j_caches)
        with torch.no_grad():
            logits, caches = decode(params, tok, caches)
        j_tok = j_step.greedy_sample(j_logits)
        tok = serve_step.greedy_sample(logits)
    assert (np.asarray(j_tok) == tok.numpy()).all()
    # An encoder-decoder arch gets the decoder's steps, as in the
    # reference (held against it in tests/test_torch_train.py).
    from repro_torch.models import encdec
    monkeypatch.setattr(encdec, "decoder_prefill", lambda *a: "prefill")
    monkeypatch.setattr(encdec, "decoder_decode", lambda *a: "decode")
    ed_arch = dataclasses.replace(arch, kind="encdec")
    assert serve_step.make_prefill_step(ed_arch, cfg, 9)(params, {}) == (
        "prefill")
    assert serve_step.make_decode_step(ed_arch, cfg)(params, tok,
                                                     caches) == "decode"
