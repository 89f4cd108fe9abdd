"""Gradient compression with error feedback.

Before a data-parallel all-reduce, gradients are quantized to int8 with
a per-tensor scale; the quantization residual is carried into the next
step (error feedback, Karimireddy et al., 2019), which keeps SGD/Adam
convergence intact.  The reference's arithmetic
(``repro.train.grad_comp``): ``torch.round`` rounds half to even, as
``jnp.round`` does.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.core.layout import tree_flatten, tree_unflatten
from repro_torch.models.layers import tree_map
from repro_torch.train.train_step import value_and_grad

__all__ = ["CompressionState", "init_compression", "compress_grads",
           "make_compressed_train_step"]


class CompressionState(NamedTuple):
    error: Any  # residual tree (float32)


def init_compression(params: Any) -> CompressionState:
    return CompressionState(error=tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
        params))


def _quantize(g: torch.Tensor, err: torch.Tensor) -> tuple:
    """``(int8 values, scale, residual)`` of one leaf plus its carried
    error: what crosses the wire, and what stays behind."""
    gf = g.float() + err
    scale = torch.clamp(gf.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    return q, scale, gf - q.float() * scale


def _quantize_leaf(g: torch.Tensor, err: torch.Tensor) -> tuple:
    """``(dequantized grad in g's dtype, new residual)``."""
    q, scale, residual = _quantize(g, err)
    return (q.float() * scale).to(g.dtype), residual


@torch.no_grad()
def compress_grads(grads: Any, state: CompressionState) -> tuple:
    """Returns ``(dequantized grads, new state)``."""
    flat_g, treedef = tree_flatten(grads)
    flat_e = tree_flatten(state.error)[0]
    out = [_quantize_leaf(g, e) for g, e in zip(flat_g, flat_e, strict=True)]
    return (tree_unflatten(treedef, [o[0] for o in out]),
            CompressionState(tree_unflatten(treedef, [o[1] for o in out])))


def make_compressed_train_step(loss_fn: Callable,
                               opt_update: Callable) -> Callable:
    """``step(params, opt_state, comp_state, batch)`` with int8 gradient
    sync: ``loss_fn(params, batch) -> (loss, metrics)`` differentiated
    by autograd, ``opt_update(grads, params, opt_state)``."""
    def step(params, opt_state, comp_state, batch):
        (loss, metrics), grads = value_and_grad(loss_fn, params, batch)
        grads, comp_state = compress_grads(grads, comp_state)
        params, opt_state, opt_metrics = opt_update(grads, params, opt_state)
        metrics = dict(metrics)
        metrics.update(opt_metrics)
        metrics["loss"] = loss
        return params, opt_state, comp_state, metrics

    return step
