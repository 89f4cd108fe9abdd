"""Parameter specs, initialization and the shared numerics.

Parameter trees keep the reference package's layout (nested dicts and
lists of tensors, per-segment stacked leaves), so weights carry across
by name (:mod:`repro_torch.convert`).  :func:`init_params` draws from an
explicit ``torch.Generator``; its numbers differ from ``jax.random``.
"""

from __future__ import annotations

import functools
import math
from typing import Any, NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.core.layout import tree_flatten, tree_unflatten

__all__ = ["ParamSpec", "ShapeDtype", "spec", "init_params", "tree_map",
           "shape_structs", "rms_norm", "layer_norm", "rope", "dense",
           "masked_nll", "unstack", "maybe_remat", "DTYPES"]

DEFAULT_DTYPE = "bfloat16"
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class ShapeDtype(NamedTuple):
    """A leaf's shape and dtype, allocating nothing (torch has no
    ``jax.ShapeDtypeStruct``)."""
    shape: tuple
    dtype: torch.dtype


class ParamSpec(NamedTuple):
    shape: tuple
    dtype: str
    init: str = "fan_in"   # fan_in | zeros | ones | embed

    def struct(self) -> ShapeDtype:
        return ShapeDtype(self.shape, DTYPES[self.dtype])


def spec(shape, dtype=DEFAULT_DTYPE, init="fan_in") -> ParamSpec:
    return ParamSpec(tuple(int(s) for s in shape), dtype, init)


def tree_map(fn, tree: Any) -> Any:
    """Map over the leaves of nested dicts / lists / tuples."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, ParamSpec):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def shape_structs(specs: Any) -> Any:
    """Spec tree -> :class:`ShapeDtype` tree (no allocation)."""
    return tree_map(lambda s: s.struct(), specs)


def _init_leaf(s: ParamSpec, gen: torch.Generator, device) -> torch.Tensor:
    dtype = DTYPES[s.dtype]
    if s.init == "zeros":
        return torch.zeros(s.shape, dtype=dtype, device=device)
    if s.init == "ones":
        return torch.ones(s.shape, dtype=dtype, device=device)
    # embed: GPT-style 0.02; fan_in: 1/sqrt(prod(shape[:-1])), as the
    # reference computes it (stacked leaves include the layer axis).
    scale = (0.02 if s.init == "embed"
             else 1.0 / math.sqrt(max(1, math.prod(s.shape[:-1]))))
    w = torch.randn(s.shape, generator=gen, dtype=torch.float32,
                    device=device)
    return (w.mul_(scale)).to(dtype)


def init_params(specs: Any, generator: torch.Generator | int = 0, *,
                device=None) -> Any:
    """Materialize a parameter tree from a spec tree.

    ``generator`` is a ``torch.Generator`` on ``device`` or an int seed
    for one.  Runs on the card unless ``device="cpu"``.
    """
    device = resolve_device(device)
    gen = generator
    if not isinstance(gen, torch.Generator):
        gen = torch.Generator(device=device).manual_seed(int(generator))
    return tree_map(lambda s: _init_leaf(s, gen, device), specs)


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(dim=-1, keepdim=True)
    return ((xf - mean) * torch.rsqrt(var + eps) * scale.float()
            + bias.float()).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, *,
         base: float = 10000.0) -> torch.Tensor:
    """Rotary embedding on (..., seq, heads, head_dim)."""
    half = x.shape[-1] // 2
    freqs = torch.exp(-math.log(base)
                      * torch.arange(half, dtype=torch.float32,
                                     device=x.device) / half)
    angles = positions[..., :, None].float() * freqs
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def dense(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., d) @ w (d, f), accumulated in float32, in x's dtype."""
    return torch.matmul(x, w)


def masked_nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross entropy in float32 over the positions whose
    label is >= 0 (``-1`` marks padding)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    mask = (labels >= 0).float()
    gold = torch.gather(logits, -1,
                        torch.clamp(labels, min=0).long()[..., None])[..., 0]
    return ((logz - gold) * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def unstack(tree: Any, steps: int) -> list:
    """A tree of (steps, ...) stacked leaves -> ``steps`` per-layer trees
    of views; one ``unbind`` a leaf, so the backward pass stacks the
    layers' gradients once."""
    leaves, treedef = tree_flatten(tree)
    per_leaf = [leaf.unbind(0) for leaf in leaves]
    return [tree_unflatten(treedef, [u[i] for u in per_leaf])
            for i in range(steps)]


def maybe_remat(remat: str, fn):
    """``fn`` recomputed in the backward pass when ``remat == "full"``
    and autograd is recording (serving runs it as it is)."""
    if remat == "full" and torch.is_grad_enabled():
        return functools.partial(checkpoint, fn, use_reentrant=False)
    return fn
