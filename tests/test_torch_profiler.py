"""The port's device-cost profiler (``repro_torch.obs.profiler``) and the
last public names of the reference, against the JAX package.

* ``classify_source``: the reference's ``TestClassifySource`` cases on
  the port's paths, and one line of each protection helper the port
  adds (``_crossing``, ``_counter_words``, ``_page_keys``).
* ``CostProfile``: the reference's arithmetic (ratios, coverage,
  ``to_dict`` keys) on equal input dicts; each package's roofline with
  its own peaks (the reference's TPU v5e's, the port's H100's).
* The reference's profiler bounds, met by the port on its own: for
  every scheme and decode buckets 1 and 2 on the minitron-4b smoke
  config, coverage >= 0.95 of bytes and flops, ``off`` < 0.01 and every
  other scheme > 0.01 on both overhead ratios.  The reference's own
  ``profile_decode`` is not called: it fails on this host.
* The engine's three gauges read the profile cache only; the 2-shard
  rollup sums its shards; ``--profile-json`` writes JSON.
* ``profile()`` between ticks changes nothing a run without it shows:
  tokens, pool bytes, on-chip state, the Merkle root, the cluster root,
  the audit chain and the stats (``decode_bucket_compiles`` aside, which
  moves as the reference's does).
* The public names the reference exports, bytes equal to it (floats of
  ``layer_norm`` within 1e-6).
"""

import inspect
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.configs import get_arch as j_get_arch
from repro.core import aes as j_aes
from repro.core import baes as j_baes
from repro.core import ctr as j_ctr
from repro.kernels import common as j_common
from repro.launch import roofline as j_roofline
from repro.models import layers as j_layers
from repro.models import lm as j_lm
from repro.obs import profiler as j_prof
from repro.serve import kv_pages as j_kvp
from repro.serve import sharded_pool as j_sharded
from repro.tenancy import KeyHierarchy as JHierarchy
from repro.tenancy import TenantRegistry as JRegistry
from repro_torch.configs import get_arch
from repro_torch.core import aes, baes, ctr
from repro_torch.core.layout import tree_flatten
from repro_torch.core.secure_exec import SCHEMES
from repro_torch.core.secure_memory import SecureKeys
from repro_torch.kernels import common
from repro_torch.launch import serve as launch
from repro_torch.models import layers, lm
from repro_torch.obs import profiler
from repro_torch.obs.profiler import CostProfile, classify_source
from repro_torch.serve import kv_pages as kvp
from repro_torch.serve.cluster import ClusterEngine
from repro_torch.serve.engine import SecureServingEngine
from repro_torch.tenancy import KeyHierarchy, TenantRegistry
from test_torch_models import port_test_env  # noqa: F401

AUDIT_SKIP = ("ts", "prev", "hash")


@pytest.fixture(scope="module")
def smoke():
    arch = get_arch("minitron-4b")
    cfg = arch.make_smoke_config()
    return arch, cfg, layers.init_params(lm.lm_specs(cfg), 0, device="cpu")


def _engine(smoke, **kw):
    arch, cfg, params = smoke
    kw.setdefault("max_slots", 1)
    kw.setdefault("page_tokens", 4)
    kw.setdefault("pages_per_slot", 2)
    return SecureServingEngine(arch, cfg, params, device="cpu", **kw)


def _np(t) -> np.ndarray:
    a = t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    return a.view(np.uint32) if a.dtype == np.int32 else a


def _u8(rng, shape) -> np.ndarray:
    return rng.integers(0, 256, shape, dtype=np.uint8)


# ---------------------------------------------------------------------------
# Classification and CostProfile arithmetic.
# ---------------------------------------------------------------------------


class TestClassifySource:
    def test_kernel_and_core_files_are_protection(self):
        assert classify_source(
            "/x/repro_torch/kernels/aes_ctr/kernel.py", 10) == "protection"
        assert classify_source("/x/repro_torch/core/mac.py", 1) \
            == "protection"
        assert classify_source("/x/repro_torch/core/aes.py", 99) \
            == "protection"

    def test_model_files_are_model(self):
        assert classify_source("/x/repro_torch/models/layers.py", 5) \
            == "model"
        assert classify_source("/x/repro_torch/serve/engine.py", 5) \
            == "model"

    @pytest.mark.parametrize("fn", ["_crypt", "_crossing", "_counter_words",
                                    "_page_keys"])
    def test_kv_pages_split_by_function_ranges(self, fn):
        line = inspect.getsourcelines(getattr(kvp, fn))[1] + 1
        assert classify_source(kvp.__file__, line) == "protection"
        # Module line 1 (docstring) and the IO surface are paging glue.
        assert classify_source(kvp.__file__, 1) == "model"
        read = inspect.getsourcelines(kvp.PageIO.read)[1] + 1
        assert classify_source(kvp.__file__, read) == "model"


COSTS = dict(
    protection={"bytes": 3.0e6, "flops": 2.0e5, "ops": 40},
    model={"bytes": 8.0e9, "flops": 6.0e10, "ops": 900},
    other={"bytes": 1.0e3, "flops": 0.0, "ops": 2},
    total={"bytes": 8.003001e9, "flops": 6.00002e10, "ops": 942},
    by_file={"core/aes.py": {"bytes": 3.0e6, "flops": 2.0e5, "ops": 40},
             "models/lm.py": {"bytes": 8.0e9, "flops": 6.0e10, "ops": 900}})


@pytest.mark.parametrize("p50", [None, 0.0125])
def test_cost_profile_arithmetic_matches_reference(p50):
    kw = dict(scheme="seda", bucket=2, uniform=False, **COSTS,
              tick_seconds_p50=p50)
    want = j_prof.CostProfile(**kw).to_dict()
    got = CostProfile(**kw).to_dict()
    assert set(got) == set(want)
    want_roof, got_roof = want.pop("roofline"), got.pop("roofline")
    assert got == want
    assert set(got_roof) == set(want_roof)
    for roof, hbm, peak in ((want_roof, j_roofline.HBM_BW,
                             j_roofline.PEAK_FLOPS),
                            (got_roof, 3.35e12, 989e12)):
        assert roof["compute_s"] == COSTS["total"]["flops"] / peak
        assert roof["memory_s"] == COSTS["total"]["bytes"] / hbm
        assert roof["roofline_s"] == max(roof["compute_s"], roof["memory_s"])
        assert roof["bound"] == ("compute" if roof["compute_s"]
                                 >= roof["memory_s"] else "memory")
        if p50:
            assert roof["utilization"] == roof["roofline_s"] / p50
    assert (profiler.HBM_BW, profiler.PEAK_FLOPS) == (3.35e12, 989e12)


def test_attribute_call_counts_ops_by_convention():
    a = torch.ones((4, 8))
    b = torch.ones((8, 3))
    idx = torch.tensor([0, 2])

    def fn():
        c = a @ b                         # 2*4*3*8 flops, 128+96+48 B
        d = c.view(12)                    # a view: free
        e = d[idx]                        # gather: 2*8 + 16 B
        return (e * 2).sum()              # 2 flops, then 2 (reduction)

    out, attr = profiler.attribute_call(fn)
    assert float(out) == 32.0
    # No frame of the package: every op lands in "other".
    assert attr["other"]["flops"] == 2 * 4 * 3 * 8 + 2 + 2
    assert attr["other"]["bytes"] == (128 + 96 + 48) + (2 * 8 + 16) \
        + (8 + 8) + (8 + 4)
    assert attr["protection"]["ops"] == attr["model"]["ops"] == 0


# ---------------------------------------------------------------------------
# The reference's profiler bounds, on the port's engine.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scheme", sorted(SCHEMES))
def test_coverage_all_schemes_and_buckets(smoke, scheme):
    eng = _engine(smoke, scheme=scheme, use_kernel=(scheme != "off"))
    for bucket in (1, 2):
        p = profiler.profile_decode(eng, bucket=bucket)
        assert isinstance(p, CostProfile)
        cov = p.coverage
        assert cov["bytes"] >= 0.95, (scheme, bucket, cov)
        assert cov["flops"] >= 0.95, (scheme, bucket, cov)
        if scheme == "off":
            assert p.overhead_bytes_ratio < 0.01
            assert p.overhead_flops_ratio < 0.01
        else:
            assert p.overhead_bytes_ratio > 0.01
            assert p.overhead_flops_ratio > 0.01
    assert eng.stats["decode_bucket_compiles"] == 2
    cost = eng.decode_cost_analysis(2)
    assert cost == {"flops": p.total["flops"], "bytes accessed":
                    p.total["bytes"]}
    assert eng.stats["decode_bucket_compiles"] == 2


def test_profile_export_gauges_and_roofline(smoke, monkeypatch):
    eng = _engine(smoke, scheme="seda", use_kernel=True, trace=True)
    gauges = eng.metrics.snapshot()["gauges"]
    for name in ("protection_overhead_ratio",
                 "protection_overhead_flops_ratio", "roofline_utilization"):
        assert gauges[name] == {}                # never profiled
    roof = profiler.profile_decode(eng, bucket=2).roofline()
    assert roof["roofline_s"] == max(roof["compute_s"], roof["memory_s"])
    assert "utilization" not in roof             # no measured tick yet
    eng.submit(prompt=[3, 4, 5], max_new_tokens=3)
    eng.run()
    out = eng.profile()
    assert out["scheme"] == "seda" and out["shard"] == 0
    assert len(out["profiles"]) == 1
    prof = out["profiles"][0]
    json.dumps(out)                              # JSON-serializable
    for key in ("protection", "model", "other", "total", "coverage",
                "overhead_bytes_ratio", "roofline", "xla_cost", "by_file"):
        assert key in prof
    assert prof["xla_cost"] == {}
    p50 = eng.metrics.histograms["tick_seconds"].percentile(50)
    assert prof["roofline"]["utilization"] == pytest.approx(
        prof["roofline"]["roofline_s"] / p50)
    # The gauges read the cache: a snapshot runs no decode.
    monkeypatch.setattr(profiler, "profile_decode", None)
    gauges = eng.metrics.snapshot()["gauges"]
    assert gauges["protection_overhead_ratio"] == {
        "2": pytest.approx(prof["overhead_bytes_ratio"])}
    assert gauges["protection_overhead_flops_ratio"] == {
        "2": pytest.approx(prof["overhead_flops_ratio"])}
    assert gauges["roofline_utilization"] == {
        "2": pytest.approx(prof["roofline"]["utilization"])}
    assert 'repro_protection_overhead_ratio{bucket="2"}' in eng.prometheus()
    assert eng.profile() == out                  # cached


def test_cluster_rollup(smoke):
    cluster = ClusterEngine(*smoke, shards=2, max_slots=1, page_tokens=4,
                            pages_per_slot=2, scheme="seda", use_kernel=True,
                            device="cpu")
    out = cluster.profile()
    assert out["scheme"] == "seda"
    assert [s["shard"] for s in out["shards"]] == [0, 1]
    roll = out["rollup"]
    for k in ("protection", "model", "other", "total"):
        for m in ("bytes", "flops"):
            assert roll[k][m] == pytest.approx(sum(
                s["profiles"][0][k][m] for s in out["shards"]))
    assert roll["overhead_bytes_ratio"] == pytest.approx(
        roll["protection"]["bytes"] / roll["model"]["bytes"])
    assert roll["overhead_bytes_ratio"] > 0.01
    json.dumps(out)


@pytest.mark.parametrize("shards", [[], ["--shards", "2"]])
def test_launcher_profile_json(tmp_path, shards):
    path = tmp_path / "profile.json"
    launch.main(["--smoke", "--device", "cpu", "--batch", "2",
                 "--prompt-len", "4", "--gen-len", "3", "--quiet",
                 "--profile-json", str(path), *shards])
    doc = json.loads(path.read_text())
    assert doc["scheme"] == "seda"
    profiles = ([p for s in doc["shards"] for p in s["profiles"]] if shards
                else doc["profiles"])
    assert profiles and all(p["overhead_bytes_ratio"] > 0.01
                            for p in profiles)
    if shards:
        assert doc["rollup"]["overhead_bytes_ratio"] > 0.01


# ---------------------------------------------------------------------------
# A profile changes nothing a run without it shows.
# ---------------------------------------------------------------------------


def _pool_bytes(eng) -> list:
    pool = eng.pool
    return [t.clone() for t in (*pool.cts, pool.page_macs, *pool.block_macs,
                                pool.page_vns, pool.pool_mac)]


def _same(a: list, b: list) -> bool:
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def _events(log) -> list:
    return [{k: v for k, v in r.items() if k not in AUDIT_SKIP}
            for r in log.records()]


def _stats(eng) -> dict:
    return {k: v for k, v in eng.stats.items()
            if k != "decode_bucket_compiles"}


def _profile_everything(eng) -> None:
    """Every variant an engine may profile, and the cost analysis."""
    eng.profile([1, 2, eng.pages_per_slot])
    eng.profile(uniform=True, refresh=True)
    eng.decode_cost_analysis()


def _twins(make, prompts, ticks: int = 2) -> tuple:
    """Two engines built alike, the same requests, ``ticks`` steps each."""
    pair = []
    for _ in range(2):
        eng, submit = make()
        rids = [submit(eng, i, p) for i, p in enumerate(prompts)]
        for _ in range(ticks):
            eng.step()
        pair.append((eng, rids))
    return pair


def _single_engine(smoke, arch_name=None):
    def make():
        reg = None
        if arch_name is None:
            reg = TenantRegistry(KeyHierarchy(4, device="cpu"),
                                 max_tenants=2)
            for t in ("a", "b"):
                reg.register(t)
            arch, cfg, params = smoke
        else:
            arch = get_arch(arch_name)
            cfg = arch.make_smoke_config()
            params = layers.init_params(lm.lm_specs(cfg), 0, device="cpu")
        eng = SecureServingEngine(
            arch, cfg, params, scheme="seda", use_kernel=True, max_slots=2,
            page_tokens=4, pages_per_slot=4, registry=reg,
            rotate_every=2 if reg else 0, audit=True, device="cpu")
        sessions = ([reg.open_session(t) for t in ("a", "b")] if reg
                    else [None])

        def submit(eng, i, prompt):
            return eng.submit(prompt=prompt, max_new_tokens=6,
                              session=sessions[i % len(sessions)])
        return eng, submit
    return make


@pytest.mark.parametrize("arch_name", [None, "jamba-v0.1-52b"])
def test_profile_between_ticks_changes_nothing(smoke, arch_name):
    """Tenants, rotations and audit on minitron; jamba's on-chip
    recurrent state beside its pages."""
    prompts = [[5, 9, 3, 7, 1], [2, 8, 6]]
    (eng, rids), (twin, twin_rids) = _twins(
        _single_engine(smoke, arch_name), prompts)
    pool, onchip = _pool_bytes(eng), [t.clone() for t in eng.onchip]
    events, stats = _events(eng.audit), _stats(eng)
    _profile_everything(eng)
    assert _same(_pool_bytes(eng), pool)
    assert _same(eng.onchip, onchip)
    assert bool(arch_name) == bool(onchip)
    assert _events(eng.audit) == events and _stats(eng) == stats
    assert eng.stats["decode_bucket_compiles"] == len(eng._decode_fns)
    done, twin_done = eng.run(), twin.run()
    assert [done[r].generated for r in rids] == \
        [twin_done[r].generated for r in twin_rids]
    assert _same(_pool_bytes(eng), _pool_bytes(twin))
    assert _same(eng.onchip, twin.onchip)
    assert eng.merkle.root() == twin.merkle.root()
    assert eng.audit.verify_chain()
    assert _events(eng.audit) == _events(twin.audit)
    assert _stats(eng) == _stats(twin)


def test_detached_decode_puts_back_the_graph_switch(smoke):
    """A profile's detached decode turns the engine's CUDA graphs off
    while it runs and puts back the switch it found: a nested detach
    leaves its caller's decodes eager."""
    eng, _ = _single_engine(smoke)()
    assert not eng._graphs_off
    with eng._detached_decode():
        assert eng._graphs_off
        with eng._detached_decode():
            assert eng._graphs_off
        assert eng._graphs_off
    assert not eng._graphs_off


def test_cluster_profile_between_ticks_changes_nothing(smoke):
    def make():
        cl = ClusterEngine(*smoke, shards=2, max_slots=1, page_tokens=4,
                           pages_per_slot=4, scheme="seda", use_kernel=True,
                           device="cpu")
        return cl, lambda cl, i, p: cl.submit(prompt=p, max_new_tokens=5)

    prompts = [[5, 9, 3, 7, 1], [2, 8, 6]]
    (cl, rids), (twin, twin_rids) = _twins(make, prompts)
    root, pools = cl.sharded.root_mac, [_pool_bytes(e) for e in cl.engines]
    cl.profile([1, 2, 4])
    assert torch.equal(cl.sharded.root_mac, root)
    assert all(_same(_pool_bytes(e), p) for e, p in zip(cl.engines, pools))
    assert cl.deferred_check()
    done, twin_done = cl.run(), twin.run()
    assert [done[r].generated for r in rids] == \
        [twin_done[r].generated for r in twin_rids]
    assert torch.equal(cl.sharded.root_mac, twin.sharded.root_mac)
    assert cl.sharded.merkle_root == twin.sharded.merkle_root
    assert [_stats(e) for e in cl.engines] == \
        [_stats(e) for e in twin.engines]


# ---------------------------------------------------------------------------
# The last public names, against the reference.
# ---------------------------------------------------------------------------


def test_aes_names_match():
    rng = np.random.default_rng(1)
    blocks, key = _u8(rng, (37, 16)), _u8(rng, (16,))
    rk = j_aes.key_expansion_np(key)
    want = np.asarray(j_aes.aes128_encrypt(jnp.asarray(blocks),
                                           jnp.asarray(rk)))
    got = aes.aes128_encrypt(torch.from_numpy(blocks), torch.from_numpy(rk))
    assert (_np(got) == want).all()
    state, round_key = _u8(rng, (5, 16)), _u8(rng, (16,))
    assert (_np(aes.add_round_key(torch.from_numpy(state),
                                  torch.from_numpy(round_key)))
            == np.asarray(j_aes.add_round_key(jnp.asarray(state),
                                              jnp.asarray(round_key)))).all()


@pytest.mark.parametrize("block_bytes", [64, 512])
def test_baes_names_match(block_bytes):
    rng = np.random.default_rng(block_bytes)
    n = 3
    pt = _u8(rng, (n * block_bytes,))
    words = rng.integers(0, 2 ** 32, (n, 4), dtype=np.uint32)
    key = _u8(rng, (16,))
    rk = j_aes.key_expansion_np(key)
    t_rk, t_words = torch.from_numpy(rk), torch.from_numpy(
        words.astype(np.int64))
    want = np.asarray(j_baes.baes_decrypt(
        jnp.asarray(pt), jnp.asarray(rk), jnp.asarray(words),
        block_bytes=block_bytes, key=jnp.asarray(key)))
    got = baes.baes_decrypt(torch.from_numpy(pt), t_rk, t_words,
                            block_bytes=block_bytes,
                            key=torch.from_numpy(key))
    assert (_np(got) == want).all()
    want = np.asarray(j_baes.shared_otp_encrypt(
        jnp.asarray(pt), jnp.asarray(rk), jnp.asarray(words),
        block_bytes=block_bytes))
    got = baes.shared_otp_encrypt(torch.from_numpy(pt), t_rk, t_words,
                                  block_bytes=block_bytes)
    assert (_np(got) == want).all()


def test_ctr_names_match():
    for addr in (0, 0x1234_5678_9ABC_DEF0, 2 ** 64 - 1):
        got = [int(w) for w in ctr.split_addr(addr)]
        assert got == [int(w) for w in j_ctr.split_addr(addr)]
    arr = np.array([0, 7, 2 ** 32 - 1], np.uint32)
    for g, w in zip(ctr.split_addr(torch.from_numpy(arr.astype(np.int64))),
                    j_ctr.split_addr(arr)):
        assert (_np(g) == np.asarray(w)).all()
    rng = np.random.default_rng(2)
    hi, lo = (rng.integers(0, 2 ** 32, (3, 2), dtype=np.uint32)
              for _ in range(2))
    want = np.asarray(j_ctr.pack_counter_words(hi, lo, 5, 2 ** 32 - 1))
    got = ctr.pack_counter_words(torch.from_numpy(hi.astype(np.int64)),
                                 torch.from_numpy(lo.astype(np.int64)), 5,
                                 2 ** 32 - 1)
    assert got.shape == want.shape and (_np(got) == want).all()
    # The packed words key the same keystream in both packages.
    rk = j_aes.key_expansion_np(np.arange(16, dtype=np.uint8))
    assert (_np(ctr.ctr_keystream(torch.from_numpy(rk), got))
            == np.asarray(j_ctr.ctr_keystream(jnp.asarray(rk),
                                              jnp.asarray(want)))).all()


def test_layer_and_config_names_match():
    rng = np.random.default_rng(3)
    x, scale, bias = (rng.standard_normal(s).astype(np.float32)
                      for s in ((2, 5, 24), (24,), (24,)))
    want = np.asarray(j_layers.layer_norm(*map(jnp.asarray, (x, scale,
                                                             bias))))
    got = layers.layer_norm(*map(torch.from_numpy, (x, scale, bias)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    cfg = get_arch("minitron-4b").make_smoke_config()
    j_cfg = j_get_arch("minitron-4b").make_smoke_config()
    got = tree_flatten(layers.shape_structs(lm.lm_specs(cfg)))[0]
    want = jax.tree_util.tree_leaves(j_layers.shape_structs(
        j_lm.lm_specs(j_cfg)))
    assert [(tuple(g.shape), str(g.dtype).split(".")[-1]) for g in got] == \
        [(tuple(w.shape), str(w.dtype)) for w in want]
    struct = lm.lm_specs(cfg)["embed"].struct()
    j_struct = j_lm.lm_specs(j_cfg)["embed"].struct()
    assert isinstance(struct, layers.ShapeDtype)
    assert (struct.shape, str(struct.dtype)) == \
        (j_struct.shape, f"torch.{j_struct.dtype}")
    for name in J_ARCHS:
        j_c, c = j_get_arch(name).make_config(), get_arch(name).make_config()
        if hasattr(j_c, "resolved_head_dim"):
            assert c.resolved_head_dim == j_c.resolved_head_dim, name
    for a in range(-5, 40):
        for b in (1, 3, 8, 128):
            assert common.cdiv(a, b) == j_common.cdiv(a, b)


def test_serving_names_match(smoke):
    cl = ClusterEngine(*smoke, shards=2, max_slots=1, page_tokens=4,
                       pages_per_slot=4, scheme="seda", device="cpu")
    cl.submit(prompt=[1, 2, 3, 4, 5, 6], max_new_tokens=6)
    cl.step()
    pool = cl.sharded
    ref = j_sharded.ShardedKVPool
    assert pool.n_shards == ref.n_shards.fget(pool) == 2
    assert all(a is b is e.pool for a, b, e in zip(
        pool.pools, ref.pools.fget(pool), cl.engines))
    assert pool.specs == ref.specs.fget(pool)
    assert [pool.free_pages(s) for s in (0, 1)] == \
        [ref.free_pages(pool, s) for s in (0, 1)]
    assert pool.occupancy() == ref.occupancy(pool)
    assert sum(pool.occupancy()) > 0
    j_reg, reg = (R(H(11, **kw), max_tenants=2) for R, H, kw in (
        (JRegistry, JHierarchy, {}),
        (TenantRegistry, KeyHierarchy, {"device": "cpu"})))
    for r in (j_reg, reg):
        r.register("a")
        r.register("b")
    for i in (0, 1):
        for a, b in zip(j_reg.cache_keys_for(i), reg.cache_keys_for(i)):
            assert (np.asarray(a) == _np(b)).all()
    assert isinstance(reg.cache_keys_for(0), SecureKeys)
    _, cfg, _ = smoke
    j_cfg = j_get_arch("minitron-4b").make_smoke_config()
    kw = dict(scheme="seda", page_tokens=4, n_pages=6, max_slots=3,
              max_len=16)
    j_spec = j_kvp.build_page_spec(j_lm.cache_specs(j_cfg, 3, 16), **kw)
    spec = kvp.build_page_spec(lm.cache_specs(cfg, 3, 16), **kw)
    assert spec.blocks_per_read == j_spec.blocks_per_read
