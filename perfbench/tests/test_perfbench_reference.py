"""The plain references against the port at smoke sizes, in float32 on
the CPU: the same weights and inputs give the same logits, loss and
gradients; the float8 control does not."""

import json

import pytest
import torch

from perfbench import harness, traffic, weights
from perfbench.reference import encdec as ref_encdec
from perfbench.reference import lm as ref_lm
from perfbench.tests.smoke import DATA

CPU = torch.device("cpu")
DENSE = harness.load_family("dense_lm")
ENCDEC = harness.load_family("encdec")


def smoke_config(name, **kw):
    c = json.loads((DATA / name).read_text())
    c.update(torch_dtype="float32", **kw)
    return c


def test_lm_reference_matches_the_port():
    from repro_torch.models import lm
    c = smoke_config("minitron-4b-smoke.json")
    w = weights.make(DENSE.shapes(c), 5, CPU)
    _, pcfg = DENSE.program_config(c)
    tokens = torch.randint(1, c["vocab_size"], (23,),
                           generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        logits, _ = lm.lm_prefill(pcfg, DENSE.program_tree(w),
                                  {"tokens": tokens[None]}, 32)
    want = ref_lm.logits(c, w, tokens, torch.tensor([22]))
    torch.testing.assert_close(logits[0], want, rtol=1e-4, atol=1e-4)
    # Every position against a decode loop of the port is covered by the
    # cell runs; the control rounds its matmuls and drifts.
    ctrl = ref_lm.logits(c, w, tokens, torch.tensor([22]), "fp8")
    assert (ctrl - want).abs().max() > 1e-3


def test_encdec_reference_matches_the_port():
    from repro_torch.models import encdec
    from repro_torch.train.train_step import make_loss_fn, value_and_grad
    c = smoke_config("seamless-smoke.json", remat="none")
    w = weights.make(ENCDEC.shapes(c), 6, CPU)
    arch, pcfg = ENCDEC.program_config(c)
    spec = {"batch": 3, "src_frames": 7, "tgt_tokens": 5}
    batch = traffic.train_batch(spec, c, 6, 0, CPU)
    (loss, _), grads = value_and_grad(make_loss_fn(arch, pcfg),
                                      ENCDEC.program_tree(w), batch)
    assert encdec.encdec_loss(pcfg, ENCDEC.program_tree(w),
                              batch)[0].item() == pytest.approx(loss.item())
    leaves = {k: v.clone().requires_grad_() for k, v in w.items()}
    with torch.enable_grad():
        want = ref_encdec.nll_sum(c, leaves, batch, "float32") \
            / batch["labels"].numel()
        want_g = torch.autograd.grad(want, list(leaves.values()))
    assert loss.item() == pytest.approx(want.item(), rel=1e-5)
    got = ENCDEC.from_program_tree(grads)
    for (k, _), g in zip(leaves.items(), want_g):
        torch.testing.assert_close(got[k], g, rtol=1e-4, atol=1e-6)


def test_reference_training_steps_follow_the_port():
    """Three AdamW steps of the reference against the port's optimizer
    on the port's gradients, float32 smoke weights."""
    from repro_torch.train.optimizer import (AdamWConfig, adamw_update,
                                             init_opt_state)
    from repro_torch.train.train_step import make_loss_fn, value_and_grad
    c = smoke_config("seamless-smoke.json", remat="none")
    c["optimizer"] = dict(c["optimizer"], lr=1e-2, warmup_steps=1)
    arch, pcfg = ENCDEC.program_config(c)
    spec = {"batch": 4, "src_frames": 6, "tgt_tokens": 5}
    batches = [traffic.train_batch(spec, c, 8, i, CPU) for i in range(3)]
    o = AdamWConfig(**{k: v for k, v in c["optimizer"].items()
                       if k != "kind"})
    params = ENCDEC.program_tree(weights.make(ENCDEC.shapes(c), 8, CPU))
    state = init_opt_state(params, o)
    losses = []
    for b in batches:
        (loss, _), g = value_and_grad(make_loss_fn(arch, pcfg), params, b)
        params, state, _ = adamw_update(g, params, state, o)
        losses.append(loss.item())
    stored = weights.make(ENCDEC.shapes(c), 8, CPU)
    start = {k: v.clone() for k, v in stored.items()}
    out = ref_encdec.train_steps(c, stored, batches, rows=3)
    assert out["losses"] == pytest.approx(losses, rel=1e-5)
    # Elements whose gradient is near Adam's eps take round-off-sized
    # steps either way, so the leaves are compared as the cell compares
    # them: by the norm of their change.
    got = ENCDEC.from_program_tree(params)
    for k, v in stored.items():
        assert float((got[k] - start[k]).norm()) == pytest.approx(
            out["change_norms"][k], rel=1e-3)
        assert float((v - start[k]).norm()) == pytest.approx(
            out["change_norms"][k], rel=1e-6)
