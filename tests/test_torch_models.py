"""Port LM (``repro_torch.models``) against the JAX model.

Seeded numpy weights in the reference layout go to both packages (into
the port through :func:`repro_torch.convert.params_from_numpy`), so both
compute the same function.  Float32 with TF32 off: only the order of summation
differs, so logits agree within atol = rtol = 1e-4 and greedy tokens are
identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.models import attention as j_attn
from repro.models import lm as j_lm
from repro.models.layers import init_params as j_init_params
from repro_torch.configs import get_arch
from repro_torch.convert import params_from_numpy
from repro_torch.models import attention, lm
from repro_torch.models.layers import init_params
from repro_torch.serve.serve_step import greedy_sample

TOL = dict(atol=1e-4, rtol=1e-4)
ARCHS = ["minitron-4b", "smollm-135m"]

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def numpy_params(j_cfg, seed: int = 0):
    """Seeded numpy weights in the reference layout (fan-in scaled
    normals, ones for norms): one set of inputs for both packages."""
    rng = np.random.default_rng(seed)

    def leaf(s):
        if s.init == "ones":
            return np.ones(s.shape, np.float32)
        scale = 0.02 if s.init == "embed" else 1 / np.sqrt(
            np.prod(s.shape[:-1]))
        return (rng.standard_normal(s.shape) * scale).astype(np.float32)

    return jax.tree_util.tree_map(
        leaf, j_lm.lm_specs(j_cfg),
        is_leaf=lambda x: type(x).__name__ == "ParamSpec")


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    j_cfg = j_get_arch(request.param).make_smoke_config()
    cfg = get_arch(request.param).make_smoke_config()
    np_params = numpy_params(j_cfg)
    j_params = jax.tree_util.tree_map(jnp.asarray, np_params)
    params = params_from_numpy(cfg, np_params, device="cpu")
    return j_cfg, j_params, cfg, params


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), b.float().numpy(), **TOL)


def test_smoke_configs_match_the_reference():
    for name in ARCHS:
        j_cfg = j_get_arch(name).make_smoke_config()
        cfg = get_arch(name).make_smoke_config()
        for field in ("n_layers", "d_model", "n_heads", "n_kv", "head_dim",
                      "d_ff", "vocab", "dtype", "q_block", "kv_block",
                      "tie_embeddings", "gated_ffn"):
            assert getattr(cfg, field) == getattr(j_cfg, field), field
        full, j_full = get_arch(name).make_config(), j_get_arch(name).make_config()
        assert (full.n_layers, full.d_model, full.vocab, full.dtype) == (
            j_full.n_layers, j_full.d_model, j_full.vocab, j_full.dtype)


def test_prefill_then_decode_logits_and_tokens(model):
    j_cfg, j_params, cfg, params = model
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, j_cfg.vocab, (2, 11)).astype(np.int32)
    j_logits, j_caches = j_lm.lm_prefill(j_cfg, j_params,
                                         {"tokens": jnp.asarray(tokens)}, 32,
                                         last_pos=7)
    logits, caches = lm.lm_prefill(cfg, params,
                                   {"tokens": torch.from_numpy(tokens).long()},
                                   32, last_pos=7)
    _close(j_logits, logits)
    _close(j_caches[0][0].k, caches[0][0].k)
    _close(j_caches[0][0].v, caches[0][0].v)
    tok = greedy_sample(logits)
    assert (tok.numpy() == np.asarray(jnp.argmax(j_logits[:, -1], -1))[:, None]
            ).all()
    for _ in range(1):
        j_logits, j_caches = j_lm.lm_decode(j_cfg, j_params,
                                            jnp.asarray(tok.numpy()), j_caches)
        logits, caches = lm.lm_decode(cfg, params, tok.long(), caches)
        _close(j_logits, logits)
        nxt = greedy_sample(logits)
        assert (nxt.numpy() == np.asarray(
            jnp.argmax(j_logits[:, -1], -1))[:, None]).all()
        tok = nxt


def test_decode_with_per_slot_lengths(model):
    j_cfg, j_params, cfg, params = model
    rng = np.random.default_rng(1)
    specs = lm.cache_specs(cfg, 3, 16)
    k_shape = specs[0][0].k.shape
    k = rng.standard_normal(k_shape).astype(np.float32)
    v = rng.standard_normal(k_shape).astype(np.float32)
    lengths = np.broadcast_to(np.array([0, 5, 15], np.int32),
                              (k_shape[0], 3)).copy()
    tokens = rng.integers(0, j_cfg.vocab, (3, 1)).astype(np.int32)
    j_cache = [[j_attn.KVCache(jnp.asarray(k), jnp.asarray(v),
                               jnp.asarray(lengths))]]
    cache = [[attention.KVCache(torch.from_numpy(k), torch.from_numpy(v),
                                torch.from_numpy(lengths))]]
    j_logits, j_new = j_lm.lm_decode(j_cfg, j_params, jnp.asarray(tokens),
                                     j_cache)
    logits, new = lm.lm_decode(cfg, params, torch.from_numpy(tokens).long(),
                               cache)
    _close(j_logits, logits)
    _close(j_new[0][0].k, new[0][0].k)
    assert (np.asarray(j_new[0][0].length) == new[0][0].length.numpy()).all()


def test_chunked_attention_over_many_blocks():
    rng = np.random.default_rng(2)
    q = rng.standard_normal((2, 37, 6, 8)).astype(np.float32)
    k = rng.standard_normal((2, 37, 2, 8)).astype(np.float32)
    v = rng.standard_normal((2, 37, 2, 8)).astype(np.float32)
    want = j_attn._chunked_causal_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), q_block=8,
        kv_block=16)
    got = attention._chunked_causal_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        q_block=8, kv_block=16)
    _close(want, got)


def test_lm_module_holds_the_tree(model):
    _, _, cfg, params = model
    module = lm.LM(cfg, params)
    tree = module.tree()
    assert sum(p.numel() for p in module.parameters()) == sum(
        t.numel() for t in jax.tree_util.tree_leaves(params))
    tokens = torch.arange(6)[None] % cfg.vocab
    a, _ = module.prefill(tokens, 8)
    b, _ = lm.lm_prefill(cfg, tree, {"tokens": tokens}, 8)
    assert torch.equal(a, b)


def test_init_params_is_seeded_and_shaped():
    cfg = get_arch("smollm-135m").make_smoke_config()
    specs = lm.lm_specs(cfg)
    a = init_params(specs, torch.Generator().manual_seed(3), device="cpu")
    b = init_params(specs, 3, device="cpu")
    assert torch.equal(a["embed"], b["embed"])
    assert a["segments"][0][0]["attn"]["wq"].shape == (2, 48, 3, 16)
    assert a["final_norm"].dtype == torch.float32
    j_specs = j_lm.lm_specs(j_get_arch("smollm-135m").make_smoke_config())
    j_params = jax.eval_shape(
        lambda: j_init_params(j_specs, jax.random.PRNGKey(0)))
    assert jax.tree_util.tree_structure(
        jax.tree_util.tree_map(lambda x: 0, a)) == jax.tree_util.tree_structure(
        jax.tree_util.tree_map(lambda x: 0, j_params))
    bad = numpy_params(j_get_arch("smollm-135m").make_smoke_config())
    bad["embed"] = bad["embed"][:, :7]
    with pytest.raises(ValueError, match="embed"):
        params_from_numpy(cfg, bad, device="cpu")
