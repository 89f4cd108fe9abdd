"""The attention-family LMs of the port against the JAX package.

minitron-8b (dense), granite-34b (GELU MLP, MQA), olmoe-1b-7b (MoE) and
deepseek-v3-671b (MLA + shared-expert MoE, dense prefix, untied head).
Inputs are seeded numpy arrays given to both packages; float32, at the
reference's smoke configs.

* Configs equal the reference's field for field (also pixtral's and
  seamless's, which train in ``tests/test_torch_train.py``).
* Modules (atol = rtol = 1e-5): ``dense_ffn`` without a gate (GELU,
  tanh form), ``moe_ffn`` where an expert overflows its capacity (a
  drop asserted), with a shared expert, and on tied router
  probabilities (expert choices exactly equal); ``_project_kv_latent``,
  ``mla_attention`` and ``mla_decode`` with per-slot lengths.
* The LM: prefill and decode logits (atol = rtol = 1e-4, as
  ``tests/test_torch_models.py``) and greedy tokens, weights carried by
  ``params_from_numpy``; the page layout of each cache.
* The engine: tokens and every shared counter equal to
  ``repro.serve.engine.SecureServingEngine`` under ``seda`` and ``off``,
  on prompts whose lengths are not powers of two; olmoe also with a pool
  small enough to preempt, deepseek also under 2 rotating tenants.
* The launcher: ``--arch olmoe-1b-7b --smoke`` through both engines;
  seamless exits with the reference's message and pixtral because the
  engines serve no images, and mamba2's paged engine raises the
  reference's ``ValueError``.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.configs import OPT_DTYPE_OVERRIDES as J_OPT_DTYPE_OVERRIDES
from repro.configs import get_arch as j_get_arch
from repro.models import lm as j_lm
from repro.models import mla as j_mla
from repro.models import moe as j_moe
from repro.serve import kv_pages as j_kvp
from repro.serve.engine import SecureServingEngine as JEngine
from repro.tenancy import KeyHierarchy as JHierarchy
from repro.tenancy import TenantRegistry as JRegistry
from repro_torch.configs import ARCHS as PORT_ARCHS
from repro_torch.configs import OPT_DTYPE_OVERRIDES, get_arch
from repro_torch.convert import params_from_numpy
from repro_torch.models import blocks, lm, mla, moe
from repro_torch.serve import kv_pages as kvp
from repro_torch.serve.engine import SecureServingEngine
from repro_torch.serve.serve_step import greedy_sample
from repro_torch.tenancy import KeyHierarchy, TenantRegistry
from test_torch_models import numpy_params, port_test_env  # noqa: F401

ARCHS = ["minitron-8b", "granite-34b", "olmoe-1b-7b", "deepseek-v3-671b"]
TOL = dict(atol=1e-5, rtol=1e-5)
LM_TOL = dict(atol=1e-4, rtol=1e-4)
# The counters both engines keep whatever the crypto route (the
# reference runs its bit-identical core route, without the kernels).
STATS = ("admitted", "decode_steps", "prefill_compiles",
         "decode_bucket_compiles", "uniform_fast_ticks", "decode_page_reads",
         "deferred_checks", "preemptions", "rotations", "reseals")

torch.backends.cuda.matmul.allow_tf32 = False


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _close(want, got, tol=TOL):
    np.testing.assert_allclose(np.asarray(want), got.float().numpy(), **tol)


def _np_tree(specs, seed: int):
    """Seeded fan-in-scaled normals for a JAX spec tree."""
    rng = np.random.default_rng(seed)

    def leaf(s):
        if s.init == "ones":
            return np.ones(s.shape, np.float32)
        return (rng.standard_normal(s.shape)
                / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)

    return jax.tree_util.tree_map(
        leaf, specs, is_leaf=lambda x: type(x).__name__ == "ParamSpec")


def _both(tree):
    return (jax.tree_util.tree_map(jnp.asarray, tree),
            jax.tree_util.tree_map(_t, tree))


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    j_arch = j_get_arch(request.param)
    j_cfg = j_arch.make_smoke_config()
    arch = get_arch(request.param)
    cfg = arch.make_smoke_config()
    np_params = numpy_params(j_cfg)
    j_params = jax.tree_util.tree_map(jnp.asarray, np_params)
    return j_arch, j_cfg, j_params, arch, cfg, params_from_numpy(
        cfg, np_params, device="cpu")


# ---------------------------------------------------------------------------
# Configs.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ARCHS + ["pixtral-12b",
                                          "seamless-m4t-large-v2"])
def test_configs_match_the_reference(name):
    j_arch, arch = j_get_arch(name), get_arch(name)
    assert (arch.family, arch.kind, arch.source) == (
        j_arch.family, j_arch.kind, j_arch.source)
    for make in ("make_config", "make_smoke_config"):
        cfg, j_cfg = getattr(arch, make)(), getattr(j_arch, make)()
        for f in dataclasses.fields(cfg):
            want = getattr(j_cfg, f.name)
            got = getattr(cfg, f.name)
            if want is None or got is None:
                assert got is want is None, f.name
            elif isinstance(want, tuple):      # MoEConfig / MLAConfig
                assert type(got).__name__ == type(want).__name__
                assert got._asdict() == {k: getattr(want, k)
                                         for k in got._fields}, f.name
                # The mesh's sharding choice, which one device lacks.
                assert set(want._fields) - set(got._fields) <= {"dispatch"}
            else:
                assert got == want, f.name
        if arch.kind == "encdec":
            continue
        assert lm.segments(cfg) == [
            (tuple(tuple(k) for k in kinds), steps)
            for kinds, steps in j_lm.segments(j_cfg)]


def test_deepseek_cut_to_four_layers_keeps_the_dense_prefix():
    cfg = dataclasses.replace(get_arch("deepseek-v3-671b").make_config(),
                              n_layers=4)
    assert lm.segments(cfg) == [((blocks.LayerKind("mla", "dense"),), 3),
                                ((blocks.LayerKind("mla", "moe"),), 1)]
    specs = lm.lm_specs(cfg)
    assert specs["lm_head"].shape == (7168, 129280)
    assert specs["segments"][1][0]["moe"]["shared"]["w_gate"].shape == (
        1, 7168, 2048)


def test_mamba_blocks_and_unported_archs_raise():
    """A mamba block builds; every arch of the reference is ported (the
    vision and encoder-decoder ones since the training slice), with the
    reference's optimizer-state overrides, and only an unknown name is
    refused."""
    cfg = get_arch("mamba2-780m").make_smoke_config()
    specs = blocks.block_specs(cfg, blocks.LayerKind("mamba", "none"))
    assert set(specs) == {"norm_mixer", "mamba"}
    assert specs["mamba"]["in_proj"].shape == (32, cfg.mamba.proj_dim)
    assert set(PORT_ARCHS) == set(J_ARCHS)
    assert (get_arch("pixtral-12b").kind,
            get_arch("seamless-m4t-large-v2").kind) == ("lm", "encdec")
    assert OPT_DTYPE_OVERRIDES == J_OPT_DTYPE_OVERRIDES
    with pytest.raises(KeyError, match="unknown arch"):
        get_arch("gpt-5")


# ---------------------------------------------------------------------------
# Modules.
# ---------------------------------------------------------------------------


def test_dense_ffn_gelu_matches():
    specs = j_moe.ffn_specs(32, 48, "float32", gated=False)
    assert set(specs) == set(moe.ffn_specs(32, 48, "float32", gated=False))
    j_p, p = _both(_np_tree(specs, 0))
    x = np.random.default_rng(1).standard_normal((3, 5, 32)).astype(
        np.float32) * 3
    _close(jax.jit(j_moe.dense_ffn)(j_p, jnp.asarray(x)),
           moe.dense_ffn(p, _t(x)))


def _moe_case(n_shared: int, seed: int = 0):
    cfg_kw = dict(n_experts=4, top_k=2, d_model=16, d_ff=8,
                  n_shared=n_shared, shared_d_ff=8 if n_shared else 0,
                  capacity_factor=1.0)
    j_cfg, cfg = j_moe.MoEConfig(**cfg_kw), moe.MoEConfig(**cfg_kw)
    tree = _np_tree(j_moe.moe_specs(j_cfg, "float32"), seed)
    # Bias the router to expert 0 so it overflows its capacity.
    tree["router"][:, 0] += 0.5
    x = np.random.default_rng(seed + 1).standard_normal((12, 16)).astype(
        np.float32) + 0.5
    return j_cfg, cfg, tree, x


@pytest.mark.parametrize("n_shared", [0, 1])
def test_moe_ffn_with_dropped_slots_matches(n_shared):
    j_cfg, cfg, tree, x = _moe_case(n_shared)
    j_p, p = _both(tree)
    capacity = max(1, int(12 * 2 / 4 * 1.0))
    probs = torch.softmax(_t(x) @ p["router"], dim=-1)
    _, idx = moe.top_k(probs, 2)
    assert torch.bincount(idx.reshape(-1), minlength=4).max() > capacity
    j_y, j_aux = jax.jit(functools.partial(j_moe.moe_ffn, j_cfg))(
        j_p, jnp.asarray(x))
    y, aux = moe.moe_ffn(cfg, p, _t(x))
    _close(j_y, y)
    _close(j_aux, aux)
    if n_shared:
        assert set(p["shared"]) == {"w_up", "w_down", "w_gate"}


def test_moe_ffn_tied_router_probabilities_pick_the_same_experts():
    j_cfg, cfg, tree, x = _moe_case(1, seed=3)
    # Columns 1 = 2 and 3 = 0 make every row's probabilities tie in pairs;
    # rows 0-3 are zero, so all four experts tie there.
    tree["router"][:, 2] = tree["router"][:, 1]
    tree["router"][:, 3] = tree["router"][:, 0]
    x[:4] = 0.0
    j_p, p = _both(tree)
    probs = jax.nn.softmax(jnp.asarray(x) @ j_p["router"], axis=-1)
    j_gates, j_idx = jax.lax.top_k(probs, 2)
    gates, idx = moe.top_k(_t(probs), 2)
    assert (np.asarray(j_idx) == idx.numpy()).all()
    assert (idx[:4] == torch.tensor([0, 1])).all()
    _close(j_gates, gates)
    j_y, _ = jax.jit(functools.partial(j_moe.moe_ffn, j_cfg))(
        j_p, jnp.asarray(x))
    y, _ = moe.moe_ffn(cfg, p, _t(x))
    _close(j_y, y)


@pytest.fixture(scope="module")
def mla_case():
    j_cfg = get_arch("deepseek-v3-671b").make_smoke_config().mla
    jm = j_mla.MLAConfig(*j_cfg)
    j_p, p = _both(_np_tree(j_mla.mla_specs(jm, "float32"), 4))
    return jm, j_cfg, j_p, p


def test_mla_latent_and_attention_match(mla_case):
    jm, cfg, j_p, p = mla_case
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 11, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(11, dtype=np.int32), (2, 11)).copy()
    j_c, j_k = jax.jit(functools.partial(j_mla._project_kv_latent, jm))(
        j_p, jnp.asarray(x), jnp.asarray(pos))
    c, k = mla._project_kv_latent(cfg, p, _t(x), _t(pos))
    _close(j_c, c)
    _close(j_k, k)
    want = jax.jit(functools.partial(j_mla.mla_attention, jm, q_block=4,
                                     kv_block=8))(j_p, jnp.asarray(x),
                                                  jnp.asarray(pos))
    got = mla.mla_attention(cfg, p, _t(x), _t(pos), q_block=4, kv_block=8)
    _close(want, got)


def test_mla_decode_with_per_slot_lengths(mla_case):
    jm, cfg, j_p, p = mla_case
    rng = np.random.default_rng(6)
    c_kv = rng.standard_normal((3, 16, cfg.kv_lora_rank)).astype(np.float32)
    k_pe = rng.standard_normal((3, 16, cfg.qk_rope_dim)).astype(np.float32)
    lengths = np.array([0, 5, 15], np.int32)
    x = rng.standard_normal((3, 1, cfg.d_model)).astype(np.float32)
    j_out, j_new = jax.jit(functools.partial(j_mla.mla_decode, jm))(
        j_p, jnp.asarray(x), j_mla.MLACache(
            jnp.asarray(c_kv), jnp.asarray(k_pe), jnp.asarray(lengths)))
    out, new = mla.mla_decode(cfg, p, _t(x), mla.MLACache(
        _t(c_kv), _t(k_pe), _t(lengths)))
    _close(j_out, out)
    _close(j_new.c_kv, new.c_kv)
    _close(j_new.k_pe, new.k_pe)
    assert (np.asarray(j_new.length) == new.length.numpy()).all()


# ---------------------------------------------------------------------------
# The LM and its page layout.
# ---------------------------------------------------------------------------


def test_lm_prefill_decode_logits_and_tokens(model):
    _, j_cfg, j_params, _, cfg, params = model
    assert jax.tree_util.tree_structure(jax.tree_util.tree_map(
        lambda t: 0, params)) == jax.tree_util.tree_structure(
        jax.tree_util.tree_map(lambda t: 0, j_params))
    tokens = np.random.default_rng(7).integers(0, cfg.vocab, (2, 11))
    j_logits, j_caches = jax.jit(functools.partial(
        j_lm.lm_prefill, j_cfg, max_len=32, last_pos=7))(
        j_params, {"tokens": jnp.asarray(tokens, jnp.int32)})
    logits, caches = lm.lm_prefill(cfg, params, {"tokens": _t(tokens)}, 32,
                                   last_pos=7)
    _close(j_logits, logits, LM_TOL)
    for j_leaf, leaf in zip(jax.tree_util.tree_leaves(j_caches),
                            kvp.cache_leaves(caches)):
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
    module = lm.LM(cfg, params)
    assert sum(t.numel() for t in module.parameters()) == sum(
        a.size for a in jax.tree_util.tree_leaves(j_params))
    a, _ = module.prefill(_t(tokens), 16)
    b, _ = lm.lm_prefill(cfg, params, {"tokens": _t(tokens)}, 16)
    assert torch.equal(a, b)


@pytest.mark.parametrize("name", ARCHS)
def test_page_spec_matches_at_full_width(name):
    """The page layout (MQA, MLA latent and MHA leaves) of the published
    config, at the chip phase's pool, equals the reference's."""
    cfg = get_arch(name).make_config()
    j_cfg = j_get_arch(name).make_config()
    if name == "deepseek-v3-671b":
        cfg = dataclasses.replace(cfg, n_layers=4)
        j_cfg = dataclasses.replace(j_cfg, n_layers=4)
    kw = dict(scheme="seda", page_tokens=8, n_pages=80, max_slots=8,
              max_len=80)
    spec = kvp.build_page_spec(lm.cache_specs(cfg, 8, 80), **kw)
    j_spec = j_kvp.build_page_spec(j_lm.cache_specs(j_cfg, 8, 80), **kw)
    assert len(spec.leaves) == len(j_spec.leaves)
    for a, b in zip(spec.leaves, j_spec.leaves):
        assert a._replace(dtype=str(a.dtype)) == b._replace(
            dtype=str(np.dtype(b.dtype)))
        assert a.lp_bytes % 64 == 0
    if name == "deepseek-v3-671b":      # c_kv 8 KB, k_pe 1 KB a layer
        assert [(l.rest, l.lp_bytes) for l in spec.leaves] == [
            ((512,), 8192), ((64,), 1024), ((512,), 8192), ((64,), 1024)]
    if name == "granite-34b":           # one KV head: 2 KB a layer
        assert {l.lp_bytes for l in spec.leaves} == {2048}


# ---------------------------------------------------------------------------
# The engine against the reference engine.
# ---------------------------------------------------------------------------

ENGINE_KW = dict(max_slots=2, page_tokens=4, pages_per_slot=4,
                 defer_interval=2)
# Per case: scheme, extra engine kwargs, tenants.
CASES = {
    "seda": ("seda", {}, 0),
    "off": ("off", {}, 0),
    "seda_preempt": ("seda", dict(n_pages=5), 0),
    "seda_tenants": ("seda", {}, 2),
}
ENGINE_RUNS = [(a, c) for a in ARCHS for c in ("seda", "off")] + [
    ("olmoe-1b-7b", "seda_preempt"), ("deepseek-v3-671b", "seda_tenants")]


def _prompts(vocab: int):
    rng = np.random.default_rng(8)
    return [list(map(int, rng.integers(1, vocab, n))) for n in (5, 7, 6)]


def _serve(engine_cls, model, case, j_side: bool):
    scheme, extra, tenants = CASES[case]
    kw = dict(ENGINE_KW, **extra)
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
            for i, p in enumerate(_prompts(model[1].vocab))]
    done = eng.run()
    return ([done[r].generated for r in rids],
            {name: eng.stats[name] for name in STATS}, done.latency,
            eng.deferred_check(), dict(eng.stats))


@pytest.mark.parametrize("name,case", ENGINE_RUNS)
def test_engine_tokens_and_counters_match_reference(name, case):
    j_arch, arch = j_get_arch(name), get_arch(name)
    j_cfg, cfg = j_arch.make_smoke_config(), arch.make_smoke_config()
    np_params = numpy_params(j_cfg, seed=1)
    j_params = jax.tree_util.tree_map(jnp.asarray, np_params)
    params = params_from_numpy(cfg, np_params, device="cpu")
    want = _serve(JEngine, (j_arch, j_cfg, j_params), case, True)
    got = _serve(SecureServingEngine, (arch, cfg, params), case, False)
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert got[2] == want[2]
    assert got[3] is True and bool(want[3])
    stats = got[4]
    if case == "seda_preempt":
        assert stats["preemptions"] > 0
    if case == "seda_tenants":
        assert stats["rotations"] > 0 and stats["fused_mixed_ticks"] > 0
    if case.startswith("seda"):
        assert stats["fused_write_ticks"] > 0


# ---------------------------------------------------------------------------
# The launcher.
# ---------------------------------------------------------------------------


def test_launcher_serves_olmoe_through_both_engines():
    from repro_torch.launch import serve as launch
    argv = ["--arch", "olmoe-1b-7b", "--smoke", "--device", "cpu",
            "--batch", "3", "--prompt-len", "6", "--gen-len", "4", "--quiet"]
    paged = launch.main(argv + ["--engine", "paged", "--scheme", "seda"])
    simple = launch.main(argv + ["--engine", "simple"])
    assert paged["tokens"].shape == simple["tokens"].shape == (3, 4)
    assert paged["deferred_mac_ok"] is True
    assert paged["stats"]["fused_write_ticks"] > 0
    for name, why in (("seamless-m4t-large-v2",
                       "use the decoder demo in examples/ for enc-dec"),
                      ("pixtral-12b", "serve no images")):
        with pytest.raises(SystemExit, match=why):
            launch.main(["--arch", name, "--smoke", "--device", "cpu"])
    # mamba2 has no KV cache to page: the reference's ValueError.
    with pytest.raises(ValueError, match=r"no paged \(KV/latent\) leaves "
                       "— the paged engine needs at least one attention "
                       "or MLA layer"):
        launch.main(["--arch", "mamba2-780m", "--smoke", "--device", "cpu",
                     "--engine", "paged"])
