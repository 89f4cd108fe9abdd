"""Train-step factories for every arch kind, with an optional SeDA boundary.

``make_train_step(arch, cfg, opt_cfg)`` returns

    step(params, opt_state, batch) -> (params, opt_state, metrics)

Gradients come from autograd over the plain torch model (the reference
takes ``jax.value_and_grad``); the AdamW update runs under
``torch.no_grad()``.  With ``make_secure_train_step`` the step runs
inside the :class:`~repro_torch.core.secure_exec.SecureExecutor`
boundary: params are decrypted and verified on entry and re-protected on
exit; gradients never pass through the crypto.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core.layout import tree_flatten, tree_unflatten
from repro_torch.models import encdec as ed
from repro_torch.models import lm as lm_mod
from repro_torch.obs import trace as trace_mod
from repro_torch.train.optimizer import AdamWConfig, adamw_update

__all__ = ["make_loss_fn", "make_train_step", "make_secure_train_step",
           "value_and_grad"]


def make_loss_fn(arch, cfg) -> Callable:
    if arch.kind == "encdec":
        return lambda params, batch: ed.encdec_loss(cfg, params, batch)
    return lambda params, batch: lm_mod.lm_loss(cfg, params, batch)


def value_and_grad(loss_fn: Callable, params, batch) -> tuple:
    """``((loss, metrics), grads)`` of ``loss_fn(params, batch) -> (loss,
    metrics)``: each leaf's gradient by autograd (zeros where the loss
    does not reach it, as ``jax.grad``), everything returned detached."""
    with trace_mod.span("train.forward_backward"):
        leaves, treedef = tree_flatten(params)
        leaves = [p.detach().requires_grad_() for p in leaves]
        with torch.enable_grad():
            loss, metrics = loss_fn(tree_unflatten(treedef, leaves), batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for g, p in zip(grads, leaves)]
        metrics = {k: v.detach() for k, v in metrics.items()}
        return (loss.detach(), metrics), tree_unflatten(treedef, grads)


def make_train_step(arch, cfg, opt_cfg: AdamWConfig) -> Callable:
    loss_fn = make_loss_fn(arch, cfg)

    def train_step(params, opt_state, batch):
        (loss, metrics), grads = value_and_grad(loss_fn, params, batch)
        params, opt_state, opt_metrics = adamw_update(grads, params,
                                                      opt_state, opt_cfg)
        metrics.update(opt_metrics)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step


def make_secure_train_step(arch, cfg, opt_cfg: AdamWConfig, executor,
                           region_spec) -> Callable:
    """Params live protected in untrusted memory:

        step(secure_state, opt_state, batch, step_idx)
            -> (secure_state', opt_state', metrics)

    ``metrics["integrity_ok"]`` (a bool tensor) is the entry check; the
    host loop must abort on False (tamper evident).  The optimizer state
    stays outside the boundary, as in the reference.
    """
    inner = make_train_step(arch, cfg, opt_cfg)

    def secure_step(secure_state, opt_state, batch, step_idx):
        params, ok = executor.unprotect(secure_state, region_spec)
        params, opt_state, metrics = inner(params, opt_state, batch)
        new_state = executor.protect(params, region_spec, step=step_idx + 1)
        metrics["integrity_ok"] = ok
        return new_state, opt_state, metrics

    return secure_step
