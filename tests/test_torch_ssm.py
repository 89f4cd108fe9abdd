"""The Mamba-2 mixer and the engine's recurrent state against the JAX package.

mamba2-780m (attention-free, served by the dense loop) and jamba-v0.1-52b
(Mamba + attention 1:7, MoE every 2nd layer, served by the paged secure
engine with its SSM and conv state beside the pool).  Inputs are seeded
numpy arrays given to both packages; float32, at the reference's smoke
configs.

* Modules (atol = rtol = 1e-5): ``ssd_chunked`` with L not a multiple
  of the chunk and with 2 groups, and ``ssd_reference``;
  ``_causal_conv``, ``mamba2_forward`` with its final state and
  ``mamba2_decode``; ``block_prefill``'s cache for prompts of 5, 2 and 1
  tokens (the short ones keep the reference's window of their own rows).
* The LM: configs field for field, ``layout`` and ``segments`` (jamba's
  periodic segment at 32, 16 and 8 layers), prefill and decode logits
  (atol = rtol = 1e-4, as ``tests/test_torch_models.py``), jamba's page
  layout and recurrent-state leaves at full width.
* The engine, jamba: tokens, counters and latencies equal to the
  reference engine's under ``seda``, with a pool small enough to preempt
  and under 2 tenants rotating every tick (each reference run once).
  ``off``, a contained bitflip on an attention page and a 2-shard
  cluster that migrates a slot mid-decode give the port's seda tokens.
* The refusals of the reference: ``prefix_cache`` with recurrent state,
  the paged engine for mamba2, a 2-token jamba prompt.
* The dense loop (mamba2) and the launcher.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.models import blocks as j_blocks
from repro.models import lm as j_lm
from repro.models import mamba2 as j_m2
from repro.serve import kv_pages as j_kvp
from repro.serve import serve_step as j_serve_step
from repro.serve.engine import SecureServingEngine as JEngine
from repro.tenancy import KeyHierarchy as JHierarchy
from repro.tenancy import TenantRegistry as JRegistry
from repro_torch.configs import get_arch
from repro_torch.convert import params_from_numpy
from repro_torch.models import blocks, lm, mamba2
from repro_torch.serve import kv_pages as kvp
from repro_torch.serve.cluster import ClusterEngine
from repro_torch.serve.engine import SecureServingEngine
from repro_torch.serve.faults import Fault, FaultPlan
from repro_torch.serve.serve_step import (greedy_sample, make_decode_step,
                                          make_prefill_step)
from repro_torch.tenancy import KeyHierarchy, TenantRegistry
from test_torch_models import numpy_params, port_test_env  # noqa: F401

ARCHS = ["mamba2-780m", "jamba-v0.1-52b"]
TOL = dict(atol=1e-5, rtol=1e-5)
LM_TOL = dict(atol=1e-4, rtol=1e-4)
STATS = ("admitted", "decode_steps", "prefill_compiles",
         "decode_bucket_compiles", "uniform_fast_ticks", "decode_page_reads",
         "deferred_checks", "preemptions", "rotations", "reseals")
# The reference's refusals, word for word.
NO_PAGED_LEAVES = ("cache tree has no paged (KV/latent) leaves — the paged "
                   "engine needs at least one attention or MLA layer")
NO_PREFIX_CACHE = ("prefix_cache is unavailable for archs with recurrent "
                   "on-chip state")

torch.backends.cuda.matmul.allow_tf32 = False


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _close(want, got, tol=TOL):
    np.testing.assert_allclose(np.asarray(want), got.float().numpy(), **tol)


def _models(name: str, seed: int = 0):
    """(JAX arch, cfg, params), (port arch, cfg, params) on one set of
    seeded numpy weights of the smoke config."""
    j_arch, arch = j_get_arch(name), get_arch(name)
    j_cfg, cfg = j_arch.make_smoke_config(), arch.make_smoke_config()
    np_params = numpy_params(j_cfg, seed=seed)
    return ((j_arch, j_cfg, jax.tree_util.tree_map(jnp.asarray, np_params)),
            (arch, cfg, params_from_numpy(cfg, np_params, device="cpu")))


# ---------------------------------------------------------------------------
# Modules.
# ---------------------------------------------------------------------------


def _ssd_inputs(groups: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    b, l, h, p, n = 2, 13, 4, 8, 16

    def normal(*shape):
        return (rng.standard_normal(shape) * 0.5).astype(np.float32)

    dt = np.log1p(np.exp(rng.standard_normal((b, l, h)))).astype(np.float32)
    return (normal(b, l, h, p), normal(b, l, groups, n),
            normal(b, l, groups, n), dt, (-dt * 0.3).astype(np.float32))


@pytest.mark.parametrize("groups", [1, 2])
def test_ssd_chunked_and_reference_match(groups):
    """L = 13 over chunks of 4 (padded to 16); 4 heads over ``groups``."""
    args = _ssd_inputs(groups)
    j_args = [jnp.asarray(a) for a in args]
    t_args = [_t(a) for a in args]
    j_y, j_s = jax.jit(functools.partial(j_m2.ssd_chunked, chunk=4))(*j_args)
    y, s = mamba2.ssd_chunked(*t_args, chunk=4)
    _close(j_y, y)
    _close(j_s, s)
    j_ry, j_rs = j_m2.ssd_reference(*j_args)
    ry, rs = mamba2.ssd_reference(*t_args)
    _close(j_ry, ry)
    _close(j_rs, rs)
    # The chunked scan equals the sequential recurrence (the reference's
    # own oracle test holds them to atol 1e-4).
    np.testing.assert_allclose(y.numpy(), ry.numpy(), atol=1e-4)
    np.testing.assert_allclose(s.numpy(), rs.numpy(), atol=1e-4)


@pytest.fixture(scope="module")
def mixer():
    """A 2-group Mamba-2 mixer (8 heads of 8, state 8) and its weights."""
    kw = dict(d_model=16, d_inner=64, head_dim=8, d_state=8, n_groups=2,
              d_conv=4)
    j_cfg, cfg = j_m2.Mamba2Config(**kw), mamba2.Mamba2Config(**kw)
    assert (cfg.n_heads, cfg.conv_dim, cfg.proj_dim) == (
        j_cfg.n_heads, j_cfg.conv_dim, j_cfg.proj_dim)
    specs = j_m2.mamba2_specs(j_cfg, "float32")
    assert {k: (s.shape, s.dtype, s.init) for k, s in specs.items()} == {
        k: (s.shape, s.dtype, s.init)
        for k, s in mamba2.mamba2_specs(cfg, "float32").items()}
    rng = np.random.default_rng(2)
    tree = {k: (rng.standard_normal(s.shape)
                / np.sqrt(np.prod(s.shape[:-1]) or 1)).astype(np.float32)
            for k, s in specs.items()}
    return (j_cfg, {k: jnp.asarray(v) for k, v in tree.items()}), (
        cfg, {k: _t(v) for k, v in tree.items()})


def test_causal_conv_forward_and_decode_match(mixer):
    (j_cfg, j_p), (cfg, p) = mixer
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 11, cfg.d_model)).astype(np.float32)
    xbc = rng.standard_normal((2, 11, cfg.conv_dim)).astype(np.float32)
    _close(j_m2._causal_conv(jnp.asarray(xbc), j_p["conv_w"], j_p["conv_b"]),
           mamba2._causal_conv(_t(xbc), p["conv_w"], p["conv_b"]))
    j_out, j_state = jax.jit(functools.partial(
        j_m2.mamba2_forward, j_cfg, chunk=4, return_state=True))(
        j_p, jnp.asarray(x))
    out, state = mamba2.mamba2_forward(cfg, p, _t(x), chunk=4,
                                       return_state=True)
    _close(j_out, out)
    _close(j_state, state)
    ssm = rng.standard_normal((2, cfg.n_heads, cfg.head_dim,
                               cfg.d_state)).astype(np.float32)
    conv = rng.standard_normal((2, 3, cfg.conv_dim)).astype(np.float32)
    j_out, j_new = jax.jit(functools.partial(j_m2.mamba2_decode, j_cfg))(
        j_p, jnp.asarray(x[:, :1]), j_m2.Mamba2State(
            jnp.asarray(ssm), jnp.asarray(conv), jnp.int32(4)))
    out, new = mamba2.mamba2_decode(cfg, p, _t(x[:, :1]), mamba2.Mamba2State(
        _t(ssm), _t(conv), torch.tensor(4, dtype=torch.int32)))
    _close(j_out, out)
    _close(j_new.ssm, new.ssm)
    _close(j_new.conv, new.conv)
    assert int(new.length) == int(j_new.length) == 5


@pytest.mark.parametrize("prompt_len", [5, 2, 1])
def test_block_prefill_cache_matches(prompt_len):
    """A jamba (mamba, dense) block's cache; prompts shorter than
    d_conv - 1 keep only their own rows, as the reference keeps them."""
    (_, j_cfg, j_params), (_, cfg, params) = _models("jamba-v0.1-52b")
    kind = blocks.LayerKind("mamba", "dense")
    assert lm.layout(cfg)[0] == kind
    j_p = jax.tree_util.tree_map(lambda a: a[0], j_params["segments"][0][0])
    p = jax.tree_util.tree_map(lambda a: a[0], params["segments"][0][0])
    rng = np.random.default_rng(prompt_len)
    x = rng.standard_normal((1, prompt_len, cfg.d_model)).astype(np.float32)
    pos = np.arange(prompt_len, dtype=np.int32)[None]
    j_x, j_cache, _ = j_blocks.block_prefill(
        j_cfg, j_blocks.LayerKind(*kind), j_p, jnp.asarray(x),
        jnp.asarray(pos), jnp.zeros(()), 16)
    out, cache = blocks.block_prefill(cfg, kind, p, _t(x), _t(pos), 16)
    _close(j_x, out)
    assert cache.conv.shape == j_cache.conv.shape == (
        1, min(prompt_len, 3), cfg.mamba.conv_dim)
    for j_leaf, leaf in zip(j_cache, cache):
        _close(j_leaf, leaf)


# ---------------------------------------------------------------------------
# The LM and its cache layout.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ARCHS)
def test_configs_match_the_reference(name):
    j_arch, arch = j_get_arch(name), get_arch(name)
    assert (arch.family, arch.kind, arch.source) == (
        j_arch.family, j_arch.kind, j_arch.source)
    for make in ("make_config", "make_smoke_config"):
        cfg, j_cfg = getattr(arch, make)(), getattr(j_arch, make)()
        for f in dataclasses.fields(cfg):
            want, got = getattr(j_cfg, f.name), getattr(cfg, f.name)
            if want is None or got is None:
                assert got is want is None, f.name
            elif isinstance(want, tuple):      # Mamba2Config / MoEConfig
                assert type(got).__name__ == type(want).__name__
                assert got._asdict() == {k: getattr(want, k)
                                         for k in got._fields}, f.name
                assert set(want._fields) - set(got._fields) <= {"dispatch"}
            else:
                assert got == want, f.name


@pytest.mark.parametrize("n_layers", [32, 16, 8])
def test_jamba_layout_and_segments_match(n_layers):
    cfg = dataclasses.replace(get_arch("jamba-v0.1-52b").make_config(),
                              n_layers=n_layers)
    j_cfg = dataclasses.replace(j_get_arch("jamba-v0.1-52b").make_config(),
                                n_layers=n_layers)
    assert lm.layout(cfg) == [tuple(k) for k in j_lm.layout(j_cfg)]
    segs = lm.segments(cfg)
    assert segs == [(tuple(tuple(k) for k in kinds), steps)
                    for kinds, steps in j_lm.segments(j_cfg)]
    assert segs == [(tuple(lm.layout(cfg)[:8]), n_layers // 8)]
    specs = lm.lm_specs(cfg)["segments"][0]
    assert specs[3]["attn"]["wq"].shape == (n_layers // 8, 4096, 32, 128)
    assert specs[0]["mamba"]["in_proj"].shape == (n_layers // 8, 4096,
                                                  2 * 8192 + 2 * 16 + 64)
    assert "norm_ffn" in specs[0] and "moe" in specs[1]


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    return _models(request.param)


def test_lm_prefill_decode_logits_and_tokens(model):
    (_, j_cfg, j_params), (_, cfg, params) = model
    assert jax.tree_util.tree_structure(jax.tree_util.tree_map(
        lambda t: 0, params)) == jax.tree_util.tree_structure(
        jax.tree_util.tree_map(lambda t: 0, j_params))
    tokens = np.random.default_rng(7).integers(0, cfg.vocab, (2, 11))
    j_logits, j_caches = jax.jit(functools.partial(
        j_lm.lm_prefill, j_cfg, max_len=32))(
        j_params, {"tokens": jnp.asarray(tokens, jnp.int32)})
    logits, caches = lm.lm_prefill(cfg, params, {"tokens": _t(tokens)}, 32)
    _close(j_logits, logits, LM_TOL)
    j_leaves = jax.tree_util.tree_leaves(j_caches)
    assert len(j_leaves) == len(kvp.cache_leaves(caches))
    for j_leaf, leaf in zip(j_leaves, kvp.cache_leaves(caches)):
        _close(j_leaf, leaf, LM_TOL)
    tok = greedy_sample(logits)
    j_decode = jax.jit(functools.partial(j_lm.lm_decode, j_cfg))
    for _ in range(2):
        assert (tok.numpy() == np.asarray(
            jnp.argmax(j_logits[:, -1], -1))[:, None]).all()
        j_logits, j_caches = j_decode(j_params, jnp.asarray(tok.numpy()),
                                      j_caches)
        logits, caches = lm.lm_decode(cfg, params, tok.long(), caches)
        _close(j_logits, logits, LM_TOL)
        tok = greedy_sample(logits)


def test_jamba_page_spec_and_recurrent_leaves_at_full_width():
    """The chip phase's pool at 16 of 32 layers: 2 paged leaves (k, v)
    numbered as the reference numbers them, and 14 recurrent ones (ssm
    and conv of the period's 7 Mamba kinds, 2 layers each)."""
    cfg = dataclasses.replace(get_arch("jamba-v0.1-52b").make_config(),
                              n_layers=16)
    j_cfg = dataclasses.replace(j_get_arch("jamba-v0.1-52b").make_config(),
                                n_layers=16)
    tree, j_tree = lm.cache_specs(cfg, 8, 80), j_lm.cache_specs(j_cfg, 8, 80)
    kw = dict(scheme="seda", page_tokens=8, n_pages=80, max_slots=8,
              max_len=80)
    spec = kvp.build_page_spec(tree, **kw)
    j_spec = j_kvp.build_page_spec(j_tree, **kw)
    assert [a._replace(dtype=str(a.dtype)) for a in spec.leaves] == [
        b._replace(dtype=str(np.dtype(b.dtype))) for b in j_spec.leaves]
    assert [(l.base_layer, l.lp_bytes) for l in spec.leaves] == [
        (0, 16384), (2, 16384)]              # 8 tokens x 2 KB, 2 layers
    flags = (kvp.paged_flags(tree), kvp.length_flags(tree))
    assert flags == (j_kvp.paged_flags(j_tree), j_kvp.length_flags(j_tree))
    onchip = [i for i, (p, n) in enumerate(zip(*flags)) if not p and not n]
    assert len(onchip) == 14
    leaves = kvp.cache_leaves(tree)
    for leaf, j_leaf in zip(leaves, jax.tree_util.tree_leaves(j_tree)):
        assert leaf.shape == j_leaf.shape
        assert leaf.dtype == np.dtype(j_leaf.dtype).name
    assert {leaves[i].shape for i in onchip} == {(2, 8, 64, 128, 16),
                                                 (2, 8, 3, 8192 + 32)}


# ---------------------------------------------------------------------------
# The engine against the reference engine (jamba).
# ---------------------------------------------------------------------------

ENGINE_KW = dict(max_slots=2, page_tokens=4, pages_per_slot=4,
                 defer_interval=2)
# Per case: extra engine kwargs, tenants.
CASES = {"seda": ({}, 0), "seda_preempt": (dict(n_pages=5), 0),
         "seda_tenants": ({}, 2)}


def _prompts(lengths=(5, 7, 6)) -> list:
    rng = np.random.default_rng(8)
    return [list(map(int, rng.integers(1, 256, n))) for n in lengths]


@pytest.fixture(scope="module")
def jamba():
    return _models("jamba-v0.1-52b", seed=1)


def _serve(engine_cls, model, case, j_side: bool, scheme="seda", **kw):
    extra, tenants = CASES[case]
    kw = dict(ENGINE_KW, **extra, **kw)
    kw.update(dict(merkle=False) if j_side else dict(device="cpu"))
    sessions = [None]
    if tenants:
        reg = (JRegistry(JHierarchy(3), max_tenants=tenants) if j_side else
               TenantRegistry(KeyHierarchy(3, device="cpu"),
                              max_tenants=tenants))
        for i in range(tenants):
            reg.register(f"t{i}")
        sessions = [reg.open_session(f"t{i}") for i in range(tenants)]
        kw.update(registry=reg, rotate_every=1)
    eng = engine_cls(*model, scheme=scheme, use_kernel=not j_side, **kw)
    rids = [eng.submit(prompt=p, max_new_tokens=6,
                       session=sessions[i % len(sessions)])
            for i, p in enumerate(_prompts())]
    done = eng.run()
    return eng, ([done[r].generated for r in rids],
                 {name: eng.stats[name] for name in STATS}, done.latency)


@pytest.fixture(scope="module")
def port_seda(jamba):
    return _serve(SecureServingEngine, jamba[1], "seda", False)


@pytest.mark.parametrize("case", list(CASES))
def test_engine_matches_reference(jamba, port_seda, case):
    j_eng, want = _serve(JEngine, jamba[0], case, True)
    eng, got = (port_seda if case == "seda" else
                _serve(SecureServingEngine, jamba[1], case, False))
    assert got == want
    assert eng.deferred_check() is True and bool(j_eng.deferred_check())
    assert not eng.prefill_buckets and not j_eng.prefill_buckets
    stats = eng.stats
    assert stats["fused_write_ticks"] > 0
    if case == "seda_preempt":
        assert stats["preemptions"] > 0
    if case == "seda_tenants":
        assert stats["rotations"] > 0 and stats["fused_mixed_ticks"] > 0


def _contained(model):
    eng = SecureServingEngine(*model, scheme="seda", use_kernel=True,
                              device="cpu", fault_tolerance=True,
                              **ENGINE_KW)
    FaultPlan([Fault(tick=3, kind="bitflip", slot=0)]).attach(eng)
    rids = [eng.submit(prompt=p, max_new_tokens=6) for p in _prompts()]
    eng.run()
    assert eng.quarantined and eng.stats["preemptions"] > 0
    return [list(eng.requests[r].generated) for r in rids]


def _migrated(model):
    """The reference's migration scenario: two long decodes route to
    shard 0, a short one to shard 1, and when it drains, shard 0's page
    pressure migrates its youngest slot with its recurrent state."""
    reqs = [(p, n) for p, n in zip(_prompts(), (20, 2, 20))]
    cl = ClusterEngine(*model, scheme="seda", use_kernel=True, device="cpu",
                       shards=2, max_slots=2, page_tokens=4,
                       pages_per_slot=8, n_pages=8)
    rids = [cl.submit(prompt=p, max_new_tokens=n) for p, n in reqs]
    cl.run()
    assert cl.stats["migrations"] > 0
    assert cl.engine_stats["preemptions"] == 0
    assert cl.engine_stats["admitted"] == 3        # nothing recomputed
    eng = SecureServingEngine(*model, scheme="seda", use_kernel=True,
                              device="cpu", max_slots=3, page_tokens=4,
                              pages_per_slot=8)
    want = [eng.submit(prompt=p, max_new_tokens=n) for p, n in reqs]
    eng.run()
    assert [list(eng.requests[r].generated) for r in want] == [
        list(cl.requests[r].generated) for r in rids]
    return [list(cl.requests[r].generated)[:6] for r in rids]


@pytest.mark.parametrize("path", ["off", "contained", "migrated"])
def test_port_paths_give_the_seda_tokens(jamba, port_seda, path):
    """``off``, a contained bitflip on an attention page (the victim
    re-admitted through a prefill of prompt + tokens so far) and a
    migration mid-decode keep the tokens the reference gives."""
    want = port_seda[1][0]
    if path == "off":
        got = _serve(SecureServingEngine, jamba[1], "seda", False,
                     scheme="off")[1][0]
    elif path == "contained":
        got = _contained(jamba[1])
    else:
        got = _migrated(jamba[1])
        want = [w[:len(g)] for w, g in zip(want, got)]
    assert got == want


def test_reference_refusals(jamba):
    (j_arch, j_cfg, j_params), (arch, cfg, params) = jamba
    reg = TenantRegistry(KeyHierarchy(0, device="cpu"), max_tenants=1)
    with pytest.raises(ValueError, match=NO_PREFIX_CACHE):
        SecureServingEngine(arch, cfg, params, registry=reg,
                            prefix_cache=True, device="cpu", **ENGINE_KW)
    with pytest.raises(ValueError, match=NO_PREFIX_CACHE):
        JEngine(j_arch, j_cfg, j_params, registry=JRegistry(JHierarchy(0)),
                prefix_cache=True, **ENGINE_KW)
    (j_m, j_mcfg, j_mp), (m, mcfg, mp) = _models("mamba2-780m")
    with pytest.raises(ValueError) as j_err:
        JEngine(j_m, j_mcfg, j_mp, **ENGINE_KW)
    with pytest.raises(ValueError) as err:
        SecureServingEngine(m, mcfg, mp, device="cpu", **ENGINE_KW)
    assert str(err.value) == str(j_err.value) == NO_PAGED_LEAVES


@pytest.mark.parametrize("prompt", [[5, 9], [5]], ids=["2_tokens", "1_token"])
def test_short_prompts_as_in_the_reference(jamba, prompt):
    """Prompts shorter than the conv window (ROADMAP C): 2 tokens leave a
    2-row window that the 3-row state cannot take, and both packages
    raise at admission; 1 token's one row fills the window, as the
    reference's broadcast does, and the run gives its tokens."""
    sides = []
    for engine_cls, model, kw in ((JEngine, jamba[0], dict(merkle=False)),
                                  (SecureServingEngine, jamba[1],
                                   dict(device="cpu"))):
        eng = engine_cls(*model, scheme="seda", **ENGINE_KW, **kw)
        rid = eng.submit(prompt=prompt, max_new_tokens=3)
        try:
            sides.append(eng.run()[rid].generated)
        except ValueError as e:
            sides.append(str(e))
    assert sides[1] == sides[0]
    if len(prompt) == 2:
        assert sides[0] == ("Incompatible shapes for broadcasting: "
                            "(1, 2, 80) and requested shape (1, 3, 80)")
    else:
        assert len(sides[0]) == 3


# ---------------------------------------------------------------------------
# The dense loop (mamba2) and the launcher.
# ---------------------------------------------------------------------------


def test_mamba2_dense_loop_matches_reference():
    """``make_prefill_step`` / ``make_decode_step`` give the JAX loop's
    tokens, and a loop that re-runs the prefill over prompt + generated
    at every step gives them too (the recurrence equals the scan)."""
    (j_arch, j_cfg, j_params), (arch, cfg, params) = _models("mamba2-780m")
    prompts = np.random.default_rng(4).integers(1, cfg.vocab, (2, 6))
    j_prefill = jax.jit(j_serve_step.make_prefill_step(j_arch, j_cfg, 12))
    j_decode = jax.jit(j_serve_step.make_decode_step(j_arch, j_cfg))
    j_logits, j_caches = j_prefill(j_params, {"tokens": jnp.asarray(
        prompts, jnp.int32)})
    prefill = make_prefill_step(arch, cfg, 12)
    decode = make_decode_step(arch, cfg)
    logits, caches = prefill(params, {"tokens": _t(prompts)})
    j_out, out = [], []
    for _ in range(5):
        j_tok = j_serve_step.greedy_sample(j_logits)
        tok = greedy_sample(logits)
        j_out.append(np.asarray(j_tok))
        out.append(tok.numpy())
        j_logits, j_caches = j_decode(j_params, j_tok, j_caches)
        logits, caches = decode(params, tok.long(), caches)
    tokens = np.concatenate(out, axis=1)
    assert (tokens == np.concatenate(j_out, axis=1)).all()
    seq = _t(prompts)
    for i in range(tokens.shape[1]):
        logits, _ = lm.lm_prefill(cfg, params, {"tokens": seq}, 12)
        assert (greedy_sample(logits).numpy()[:, 0] == tokens[:, i]).all()
        seq = torch.cat([seq, _t(tokens[:, i: i + 1])], dim=1)


def test_launcher_serves_both_archs():
    from repro_torch.launch import serve as launch
    common = ["--smoke", "--device", "cpu", "--batch", "2",
              "--prompt-len", "6", "--gen-len", "3", "--quiet"]
    simple = launch.main(["--arch", "mamba2-780m", "--engine", "simple"]
                         + common)
    assert simple["tokens"].shape == (2, 3)
    with pytest.raises(ValueError, match="no paged"):
        launch.main(["--arch", "mamba2-780m", "--engine", "paged"] + common)
    jamba = ["--arch", "jamba-v0.1-52b"] + common
    assert launch.main(jamba + ["--engine", "simple"])["tokens"].shape == (
        2, 3)
    out = launch.main(jamba + ["--engine", "paged", "--scheme", "seda",
                               "--tenants", "2", "--shards", "2"])
    assert out["tokens"].shape == (2, 3) and out["deferred_mac_ok"] is True
