"""Training and the encoder-decoder of the port against the JAX package.

Seeded numpy inputs go to both packages; float32, at the reference's
smoke configs.

* The data pipeline: ``make_batch`` bytes-equal for ``lm``, ``vlm`` and
  ``encdec``; ``SyntheticLM`` resumes, and refuses a foreign seed.
* AdamW: ``adamw_update`` on the same grads, params and state
  (rtol 1e-6), with float32 and bfloat16 moments; gradient compression:
  the same int8 values, residuals within 1e-6.  The reference's own
  optimizer and compression tests, ported.
* The LM and encoder-decoder training forward: loss (rtol 1e-5) and
  every leaf's gradient (within 1e-4 of the leaf's largest) for the
  smollm, pixtral (image prefix), seamless, deepseek (MLA, MoE aux loss)
  and jamba (Mamba-2 + attention + MoE) smoke configs, one JAX
  ``value_and_grad`` each; ``remat="full"`` gives the gradients of
  ``remat="none"``.
* seamless serving: ``decoder_prefill`` / ``decoder_decode`` logits
  (atol = rtol = 1e-4) and greedy tokens through ``serve_step``.
* The secure step is transparent under all 7 schemes: the state it
  produces, unprotected, is the ``off`` step's params bit for bit.
* The launcher: each smoke config trains; a flipped ciphertext byte
  aborts with ``INTEGRITY FAILURE``, also when it lands after the last
  step a checkpoint reads (the reference writes a checkpoint of the
  tampered state that loads as verified, ROADMAP §C1); an untampered
  run's checkpoints hold its protected params; the port and the
  reference resume from copies of one reference-written checkpoint and
  give the same first and last losses (rtol 1e-4).
"""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.data import pipeline as j_pipe
from repro.launch import train as j_train
from repro.models import encdec as j_ed
from repro.models import lm as j_lm
from repro.serve import serve_step as j_serve_step
from repro.train import grad_comp as j_gc
from repro.train import optimizer as j_opt
from repro.train.train_step import make_loss_fn as j_make_loss_fn
from repro_torch.checkpoint.secure_ckpt import latest_step, load_checkpoint
from repro_torch.configs import get_arch
from repro_torch.convert import params_from_numpy
from repro_torch.core.layout import tree_flatten
from repro_torch.core.secure_exec import SCHEMES, SecureExecutor
from repro_torch.core.secure_memory import SecureKeys
from repro_torch.data import pipeline as pipe
from repro_torch.launch import train
from repro_torch.models import encdec, lm
from repro_torch.models.layers import init_params
from repro_torch.serve import serve_step
from repro_torch.train import grad_comp as gc
from repro_torch.train import optimizer as opt
from repro_torch.train.train_step import (make_loss_fn,
                                          make_secure_train_step,
                                          make_train_step, value_and_grad)
from test_torch_models import port_test_env  # noqa: F401

TRAIN_ARCHS = ["smollm-135m", "pixtral-12b", "seamless-m4t-large-v2",
               "deepseek-v3-671b", "jamba-v0.1-52b"]
SEAMLESS = "seamless-m4t-large-v2"
LM_TOL = dict(atol=1e-4, rtol=1e-4)

torch.backends.cuda.matmul.allow_tf32 = False


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _specs(j_arch, j_cfg):
    return (j_ed.encdec_specs(j_cfg) if j_arch.kind == "encdec"
            else j_lm.lm_specs(j_cfg))


def _np_params(j_specs, seed: int = 0):
    """Seeded numpy weights in the reference layout (fan-in scaled
    normals, 0.02 for the embedding, ones for norms)."""
    rng = np.random.default_rng(seed)

    def leaf(s):
        if s.init == "ones":
            return np.ones(s.shape, np.float32)
        scale = 0.02 if s.init == "embed" else 1 / np.sqrt(
            np.prod(s.shape[:-1]))
        return (rng.standard_normal(s.shape) * scale).astype(np.float32)

    return jax.tree_util.tree_map(
        leaf, j_specs, is_leaf=lambda x: type(x).__name__ == "ParamSpec")


def _data_cfg(cfg, kind: str, seq_len: int = 16, batch: int = 2, seed=0):
    return dict(vocab=cfg.vocab, seq_len=seq_len, global_batch=batch,
                seed=seed, kind=kind,
                n_image_patches=getattr(cfg, "n_image_patches", 0),
                d_vision=getattr(cfg, "d_vision", 0), d_model=cfg.d_model,
                src_len=max(8, seq_len // 2))


def _kind(arch, cfg) -> str:
    if arch.kind == "encdec":
        return "encdec"
    return "vlm" if cfg.n_image_patches else "lm"


def _batches(arch, cfg, step: int = 0, **kw) -> tuple:
    """The reference's batch and the port's for the same step."""
    fields = _data_cfg(cfg, _kind(arch, cfg), **kw)
    return (j_pipe.make_batch(j_pipe.DataConfig(**fields), step),
            pipe.make_batch(pipe.DataConfig(**fields), step, device="cpu"))


# ---------------------------------------------------------------------------
# The data pipeline.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["lm", "vlm", "encdec"])
def test_make_batch_is_bytes_equal(kind):
    fields = dict(vocab=101, seq_len=24, global_batch=3, seed=7, kind=kind,
                  n_image_patches=4, d_vision=8, d_model=16, src_len=6)
    for step in (0, 5):
        want = j_pipe.make_batch(j_pipe.DataConfig(**fields), step)
        got = pipe.make_batch(pipe.DataConfig(**fields), step, device="cpu")
        assert set(got) == set(want)
        for key, arr in want.items():
            arr = np.asarray(arr)
            assert got[key].numpy().dtype == arr.dtype, key
            assert got[key].numpy().tobytes() == arr.tobytes(), key


def test_synthetic_lm_resumes_and_refuses_a_foreign_seed():
    cfg = pipe.DataConfig(vocab=101, seq_len=32, global_batch=4, seed=7)
    it = pipe.SyntheticLM(cfg, device="cpu")
    for _ in range(5):
        next(it)
    again = pipe.SyntheticLM(cfg, device="cpu")
    again.load_state_dict(it.state_dict())
    assert torch.equal(next(again)["tokens"],
                       pipe.make_batch(cfg, 5, device="cpu")["tokens"])
    b = pipe.make_batch(cfg, 3, device="cpu")
    assert torch.equal(b["tokens"][:, 1:], b["labels"][:, :-1])
    with pytest.raises(ValueError, match="seed mismatch"):
        pipe.SyntheticLM(cfg, device="cpu").load_state_dict(
            {"step": 3, "seed": 8})


# ---------------------------------------------------------------------------
# AdamW and gradient compression.
# ---------------------------------------------------------------------------


def _opt_inputs(rng) -> tuple:
    """(params, grads, mu, nu) numpy trees: a matrix, a vector and a
    stacked leaf in a list; nu >= 0."""
    def tree():
        return {"w": rng.standard_normal((6, 5)).astype(np.float32),
                "b": rng.standard_normal(5).astype(np.float32),
                "stack": [rng.standard_normal((2, 3, 4)).astype(np.float32)]}

    params, grads, mu = tree(), tree(), tree()
    return params, grads, mu, jax.tree_util.tree_map(np.abs, tree())


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_adamw_update_matches(state_dtype):
    rng = np.random.default_rng(0)
    params, grads, mu, nu = _opt_inputs(rng)
    grads = jax.tree_util.tree_map(lambda g: g * 3, grads)  # clipped
    j_cfg = j_opt.AdamWConfig(lr=1e-2, warmup_steps=10,
                              state_dtype=state_dtype)
    cfg = opt.AdamWConfig(lr=1e-2, warmup_steps=10, state_dtype=state_dtype)
    # Moments as stored in state_dtype, the same values for both.
    mu, nu = (jax.tree_util.tree_map(lambda a: np.asarray(jnp.asarray(
        a, state_dtype).astype(jnp.float32)), t) for t in (mu, nu))
    j_state = j_opt.OptState(
        *(jax.tree_util.tree_map(lambda a: jnp.asarray(a, state_dtype), t)
          for t in (mu, nu)), jnp.asarray(4, jnp.int32))
    state = opt.OptState(
        *(jax.tree_util.tree_map(
            lambda a: _t(a).to(getattr(torch, state_dtype)), t)
          for t in (mu, nu)), torch.tensor(4, dtype=torch.int32))
    j_p, j_s, j_m = j_opt.adamw_update(
        jax.tree_util.tree_map(jnp.asarray, grads),
        jax.tree_util.tree_map(jnp.asarray, params), j_state, j_cfg)
    p, s, m = opt.adamw_update(jax.tree_util.tree_map(_t, grads),
                               jax.tree_util.tree_map(_t, params), state, cfg)
    assert int(s.count) == int(j_s.count) == 5
    np.testing.assert_allclose(float(m["grad_norm"]),
                               float(j_m["grad_norm"]), rtol=1e-6)
    np.testing.assert_allclose(float(m["lr"]), float(j_m["lr"]), rtol=1e-6)
    for want, got in ((j_p, p), (j_s.mu, s.mu), (j_s.nu, s.nu)):
        for a, b in zip(jax.tree_util.tree_leaves(want), tree_flatten(got)[0],
                        strict=True):
            assert b.dtype == getattr(torch, str(a.dtype))
            np.testing.assert_allclose(b.float().numpy(),
                                       np.asarray(a.astype(jnp.float32)),
                                       rtol=1e-6, atol=1e-7)


def test_adamw_moves_toward_minimum_and_reports_preclip_norm():
    cfg = opt.AdamWConfig(lr=0.1, warmup_steps=1, weight_decay=0.0)
    params = {"w": torch.tensor([4.0, -3.0])}
    state = opt.init_opt_state(params, cfg)
    for _ in range(50):
        params, state, _ = opt.adamw_update({"w": 2 * params["w"]}, params,
                                            state, cfg)
    assert float(params["w"].abs().max()) < 1.0
    assert int(state.count) == 50 and state.count.dtype == torch.int32
    _, _, m = opt.adamw_update({"w": torch.full((4,), 1e6)},
                               {"w": torch.ones(4)},
                               opt.init_opt_state({"w": torch.ones(4)}, cfg),
                               cfg)
    assert float(m["grad_norm"]) > 1e5
    bf = opt.AdamWConfig(state_dtype="bfloat16")
    p = {"w": torch.ones(4, dtype=torch.bfloat16)}
    p2, s2, _ = opt.adamw_update({"w": torch.ones(4, dtype=torch.bfloat16)},
                                 p, opt.init_opt_state(p, bf), bf)
    assert s2.nu["w"].dtype == p2["w"].dtype == torch.bfloat16
    specs = opt.opt_state_specs(lm.lm_specs(
        get_arch("smollm-135m").make_smoke_config()), bf)
    assert specs.mu["embed"].dtype == "bfloat16"
    assert specs.count.shape == ()


def test_compress_grads_matches():
    rng = np.random.default_rng(1)
    grads = {"a": rng.standard_normal((7, 5)).astype(np.float32),
             "b": (rng.standard_normal((33,)) * 1e-3).astype(np.float32)}
    err = {k: (rng.standard_normal(v.shape) * 1e-4).astype(np.float32)
           for k, v in grads.items()}
    j_deq, j_state = j_gc.compress_grads(
        jax.tree_util.tree_map(jnp.asarray, grads),
        j_gc.CompressionState(jax.tree_util.tree_map(jnp.asarray, err)))
    deq, state = gc.compress_grads(
        jax.tree_util.tree_map(_t, grads),
        gc.CompressionState(jax.tree_util.tree_map(_t, err)))
    for k in grads:
        gf = grads[k] + err[k]
        scale = max(np.abs(gf).max(), 1e-12) / 127.0
        q, q_scale, _ = gc._quantize(_t(grads[k]), _t(err[k]))
        assert q.dtype == torch.int8
        np.testing.assert_array_equal(
            q.numpy(), np.round(np.asarray(j_deq[k]) / scale).astype(np.int8))
        np.testing.assert_allclose(float(q_scale), scale, rtol=1e-6)
        np.testing.assert_allclose(deq[k].numpy(), np.asarray(j_deq[k]),
                                   rtol=1e-6, atol=1e-9)
        np.testing.assert_allclose(state.error[k].numpy(),
                                   np.asarray(j_state.error[k]), atol=1e-6)


def test_error_feedback_and_compressed_step_train():
    g_true = torch.from_numpy(
        np.random.default_rng(0).standard_normal(64).astype(np.float32)
        * 1e-3)
    state = gc.init_compression({"w": g_true})
    applied = torch.zeros_like(g_true)
    for _ in range(20):
        deq, state = gc.compress_grads({"w": g_true}, state)
        applied = applied + deq["w"]
    one_step = float(g_true.abs().max()) / 127
    assert float((applied - 20 * g_true).abs().max()) <= 2 * one_step

    cfg = opt.AdamWConfig(lr=0.05, warmup_steps=1, weight_decay=0.0)

    def loss_fn(params, batch):
        return ((batch["x"] @ params["w"] - batch["y"]) ** 2).mean(), {}

    step = gc.make_compressed_train_step(
        loss_fn, lambda g, p, s: opt.adamw_update(g, p, s, cfg))
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((32, 8)).astype(np.float32))
    batch = {"x": x, "y": x @ torch.from_numpy(
        rng.standard_normal(8).astype(np.float32))}
    params = {"w": torch.zeros(8)}
    state, comp = opt.init_opt_state(params, cfg), gc.init_compression(params)
    first = None
    for _ in range(60):
        params, state, comp, m = step(params, state, comp, batch)
        first = float(m["loss"]) if first is None else first
    assert float(m["loss"]) < first * 0.2


# ---------------------------------------------------------------------------
# The training forward, loss and gradients.
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=TRAIN_ARCHS)
def trained(request):
    """One JAX ``value_and_grad`` of the reference loss per arch, on the
    numpy weights and batch the port gets too."""
    j_arch = j_get_arch(request.param)
    j_cfg = j_arch.make_smoke_config()
    arch = get_arch(request.param)
    cfg = arch.make_smoke_config()
    np_params = _np_params(_specs(j_arch, j_cfg))
    j_batch, batch = _batches(arch, cfg)
    (j_loss, _), j_grads = jax.jit(jax.value_and_grad(
        j_make_loss_fn(j_arch, j_cfg), has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, np_params), j_batch)
    return (arch, cfg, params_from_numpy(cfg, np_params, device="cpu"),
            batch, float(j_loss), j_grads)


def test_loss_and_grads_match_the_reference(trained):
    arch, cfg, params, batch, j_loss, j_grads = trained
    (loss, metrics), grads = value_and_grad(make_loss_fn(arch, cfg), params,
                                            batch)
    np.testing.assert_allclose(float(loss), j_loss, rtol=1e-5)
    if arch.kind == "lm" and cfg.ffn == "moe":
        assert float(metrics["aux"]) > 0
    paths = [p for p, _ in jax.tree_util.tree_flatten_with_path(j_grads)[0]]
    j_leaves = jax.tree_util.tree_leaves(j_grads)
    leaves = tree_flatten(grads)[0]
    assert len(leaves) == len(j_leaves)
    for path, want, got in zip(paths, j_leaves, leaves):
        want = np.asarray(want)
        assert got.shape == want.shape, path
        scale = max(float(np.abs(want).max()), 1e-30)
        assert float(np.abs(got.numpy() - want).max()) <= 1e-4 * scale, (
            jax.tree_util.keystr(path))


def test_remat_full_gives_the_grads_of_none(trained):
    import dataclasses
    arch, cfg, params, batch, _, _ = trained
    out = {}
    for remat in ("full", "none"):
        c = dataclasses.replace(cfg, remat=remat)
        out[remat] = value_and_grad(make_loss_fn(arch, c), params, batch)
    assert torch.equal(out["full"][0][0], out["none"][0][0])
    for a, b in zip(tree_flatten(out["full"][1])[0],
                    tree_flatten(out["none"][1])[0]):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# seamless serving.
# ---------------------------------------------------------------------------


def test_seamless_prefill_and_decode_match_the_reference():
    j_arch = j_get_arch(SEAMLESS)
    j_cfg = j_arch.make_smoke_config()
    arch = get_arch(SEAMLESS)
    cfg = arch.make_smoke_config()
    np_params = _np_params(_specs(j_arch, j_cfg), seed=3)
    j_params = jax.tree_util.tree_map(jnp.asarray, np_params)
    params = params_from_numpy(cfg, np_params, device="cpu")
    rng = np.random.default_rng(4)
    src = rng.standard_normal((2, 12, cfg.d_model)).astype(np.float32)
    tgt = rng.integers(0, cfg.vocab, (2, 5)).astype(np.int32)
    max_len = 9
    j_logits, j_caches = jax.jit(j_serve_step.make_prefill_step(
        j_arch, j_cfg, max_len))(j_params, {"src_embeds": jnp.asarray(src),
                                            "tgt_tokens": jnp.asarray(tgt)})
    with torch.no_grad():
        logits, caches = serve_step.make_prefill_step(arch, cfg, max_len)(
            params, {"src_embeds": _t(src), "tgt_tokens": _t(tgt)})
    spec = encdec.decoder_cache_specs(cfg, 2, max_len, 12)
    assert caches["self"].k.shape == spec["self"].k.shape
    assert caches["self"].length.shape == spec["self"].length.shape
    assert caches["cross_k"].shape == spec["cross_k"].shape
    for want, got in ((j_caches["self"].k, caches["self"].k),
                      (j_caches["cross_k"], caches["cross_k"]),
                      (j_caches["cross_v"], caches["cross_v"])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **LM_TOL)
    j_decode = jax.jit(j_serve_step.make_decode_step(j_arch, j_cfg))
    decode = serve_step.make_decode_step(arch, cfg)
    for _ in range(4):
        np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits),
                                   **LM_TOL)
        j_tok = j_serve_step.greedy_sample(j_logits)
        tok = serve_step.greedy_sample(logits)
        assert (tok.numpy() == np.asarray(j_tok)).all()
        j_logits, j_caches = j_decode(j_params, j_tok, j_caches)
        with torch.no_grad():
            logits, caches = decode(params, tok, caches)
    np.testing.assert_array_equal(caches["self"].length.numpy(),
                                  np.asarray(j_caches["self"].length))
    np.testing.assert_allclose(caches["self"].v.numpy(),
                               np.asarray(j_caches["self"].v), **LM_TOL)


# ---------------------------------------------------------------------------
# The secure step.
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def smollm_step():
    """smollm's smoke params, batch and the ``off`` step's result."""
    arch = get_arch("smollm-135m")
    cfg = arch.make_smoke_config()
    params = init_params(lm.lm_specs(cfg), 0, device="cpu")
    batch = pipe.make_batch(pipe.DataConfig(**_data_cfg(cfg, "lm")), 0,
                            device="cpu")
    ocfg = opt.AdamWConfig()
    want, _, metrics = make_train_step(arch, cfg, ocfg)(
        params, opt.init_opt_state(params, ocfg), batch)
    return arch, cfg, params, batch, ocfg, want, float(metrics["loss"])


@pytest.mark.parametrize("scheme", sorted(SCHEMES))
def test_secure_step_is_transparent(smollm_step, scheme):
    arch, cfg, params, batch, ocfg, want, want_loss = smollm_step
    ex = SecureExecutor(scheme, keys=SecureKeys.derive(0, device="cpu"))
    region = ex.region_spec(params)
    step = make_secure_train_step(arch, cfg, ocfg, ex, region)
    state, _, metrics = step(ex.protect(params, region, step=0),
                             opt.init_opt_state(params, ocfg), batch, 0)
    assert bool(metrics["integrity_ok"])
    assert float(metrics["loss"]) == want_loss
    got, ok = ex.unprotect(state, region)
    assert bool(ok)
    for a, b in zip(tree_flatten(got)[0], tree_flatten(want)[0],
                    strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b)


# ---------------------------------------------------------------------------
# The launcher.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", TRAIN_ARCHS)
def test_launcher_trains_each_smoke_config(name):
    out = train.main(["--arch", name, "--smoke", "--device", "cpu",
                      "--steps", "2", "--global-batch", "2", "--seq-len",
                      "16", "--log-every", "100"])
    assert out["steps"] == 2
    assert np.isfinite(out["first_loss"]) and np.isfinite(out["last_loss"])


def test_launcher_aborts_on_a_flipped_ciphertext_byte(monkeypatch):
    protect = SecureExecutor.protect
    calls = []

    def flipping(self, tree, spec, *, step=0):
        state = protect(self, tree, spec, step=step)
        calls.append(step)
        if len(calls) == 2:                 # the state step 1 reads
            state.ciphertexts[3][7] ^= 0x10
        return state

    monkeypatch.setattr(SecureExecutor, "protect", flipping)
    with pytest.raises(RuntimeError, match="INTEGRITY FAILURE at step 1"):
        train.main(["--arch", "smollm-135m", "--smoke", "--device", "cpu",
                    "--scheme", "seda", "--steps", "3", "--global-batch",
                    "2", "--seq-len", "16", "--log-every", "100"])
    assert calls == [0, 1, 2]        # step 1 ran, then the loop aborted


SMOLLM_RUN = ["--arch", "smollm-135m", "--smoke", "--device", "cpu",
              "--scheme", "seda", "--steps", "2", "--global-batch", "2",
              "--seq-len", "16", "--log-every", "100"]


def _recording_protect(monkeypatch, flip_call=None) -> list:
    """Patch ``SecureExecutor.protect`` to keep every state it returns,
    flipping ciphertext 0's byte 0 in the ``flip_call``-th (1-based)."""
    protect = SecureExecutor.protect
    states = []

    def recording(self, tree, spec, *, step=0):
        state = protect(self, tree, spec, step=step)
        states.append((self, spec, state))
        if len(states) == flip_call:
            state.ciphertexts[0][0] ^= 0x01
        return state

    monkeypatch.setattr(SecureExecutor, "protect", recording)
    return states


@pytest.mark.parametrize("ckpt_every,flip_call,step", [
    ("100", 3, 2),      # after the last step: the final save
    ("1", 2, 1),        # after step 0: the save of step 1
])
def test_launcher_refuses_to_checkpoint_a_tampered_state(
        monkeypatch, tmp_path, ckpt_every, flip_call, step):
    states = _recording_protect(monkeypatch, flip_call)
    with pytest.raises(RuntimeError,
                       match=f"INTEGRITY FAILURE at step {step}:"):
        train.main(SMOLLM_RUN + ["--ckpt-dir", str(tmp_path),
                                 "--ckpt-every", ckpt_every])
    assert len(states) == flip_call      # no step read the tampered state
    assert latest_step(str(tmp_path)) is None
    assert not any(tmp_path.iterdir())


def test_launcher_checkpoints_an_untampered_run(monkeypatch, tmp_path):
    want = train.main(SMOLLM_RUN)
    states = _recording_protect(monkeypatch)
    got = train.main(SMOLLM_RUN + ["--ckpt-dir", str(tmp_path),
                                   "--ckpt-every", "1"])
    assert got == want
    assert latest_step(str(tmp_path)) == 2
    _, _, specs = train.build("smollm-135m", True)
    keys = SecureKeys.derive(0, device="cpu")
    for step in (1, 2):
        executor, spec, state = states[step]
        params, ok = executor.unprotect(state, spec)
        assert bool(ok)
        loaded, manifest = load_checkpoint(
            str(tmp_path / f"step_{step:08d}"), specs, keys, device="cpu")
        assert manifest["step"] == step
        for a, b in zip(tree_flatten(loaded)[0], tree_flatten(params)[0]):
            assert torch.equal(a, b)


def test_launcher_resumes_a_reference_checkpoint_as_the_reference(tmp_path):
    """The slice as a whole: both launchers resume seamless from copies
    of one reference-written checkpoint under seda."""
    common = ["--arch", SEAMLESS, "--smoke", "--global-batch", "2",
              "--seq-len", "16", "--log-every", "100"]
    j_train.main(common + ["--steps", "0", "--ckpt-dir",
                           str(tmp_path / "d")])
    for name in ("ref", "port"):
        shutil.copytree(tmp_path / "d", tmp_path / name)
    args = common + ["--scheme", "seda", "--steps", "3"]
    want = j_train.main(args + ["--ckpt-dir", str(tmp_path / "ref")])
    got = train.main(args + ["--ckpt-dir", str(tmp_path / "port"),
                             "--device", "cpu"])
    assert got["steps"] == want["steps"] == 3
    for key in ("first_loss", "last_loss"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4)
