"""Mixture-of-Experts FFN (top-k routing, sort-based dispatch).

Plain torch (the reference computes it in plain ``jnp``, outside any
Pallas kernel).  Token-slots are sorted by expert id, ranked within
their expert segment and scattered into an (E, C, d) buffer that feeds
one batched GEMM per projection; slots ranked beyond the capacity C are
dropped.  Every shape is static (no boolean-mask indexing), so a decode
step makes no host sync.  The reference's ``MoEConfig.dispatch`` (how a
mesh shards the buffer) has no counterpart on one device.

Also the dense FFN: SwiGLU, or the plain GELU MLP when there is no
``w_gate`` (granite).  Supports a DeepSeek-style shared expert.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense, spec

__all__ = ["MoEConfig", "moe_specs", "moe_ffn", "dense_ffn", "ffn_specs",
           "top_k"]


class MoEConfig(NamedTuple):
    n_experts: int
    top_k: int
    d_model: int
    d_ff: int               # per-expert hidden dim
    n_shared: int = 0       # shared-expert count (DeepSeek-V3: 1)
    shared_d_ff: int = 0
    capacity_factor: float = 1.25


def ffn_specs(d_model: int, d_ff: int, dtype: str, gated: bool = True):
    """Dense (Swi)GLU FFN specs: ``w_gate`` only when gated."""
    s = {"w_up": spec((d_model, d_ff), dtype),
         "w_down": spec((d_ff, d_model), dtype)}
    if gated:
        s["w_gate"] = spec((d_model, d_ff), dtype)
    return s


def dense_ffn(params, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU FFN, or GELU (tanh approximation, as ``jax.nn.gelu``)
    without ``w_gate``: x (..., d) -> (..., d)."""
    up = dense(x, params["w_up"])
    if "w_gate" in params:
        up = F.silu(dense(x, params["w_gate"])) * up
    else:
        up = F.gelu(up, approximate="tanh")
    return dense(up, params["w_down"])


def moe_specs(cfg: MoEConfig, dtype: str) -> dict:
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    s = {"router": spec((d, e), "float32"),
         "w_gate": spec((e, d, f), dtype),
         "w_up": spec((e, d, f), dtype),
         "w_down": spec((e, f, d), dtype)}
    if cfg.n_shared:
        shared_ff = cfg.shared_d_ff or cfg.d_ff
        s["shared"] = ffn_specs(d, shared_ff * cfg.n_shared, dtype)
    return s


def top_k(probs: torch.Tensor, k: int) -> tuple:
    """``jax.lax.top_k``: the k largest along the last axis, descending,
    ties broken toward the lower index (``torch.topk`` promises no order
    for ties; a stable descending sort does)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(cfg: MoEConfig, params, x: torch.Tensor) -> tuple:
    """Router: (probs (T, E), gates (T, k) renormalised, idx (T, k))."""
    router_logits = dense(x.float(), params["router"])
    probs = torch.softmax(router_logits, dim=-1)
    gates, idx = top_k(probs, cfg.top_k)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return probs, gates, idx


def _dispatch(x: torch.Tensor, idx: torch.Tensor, e: int,
              capacity: int) -> tuple:
    """Sort the (T*k) token-slots by expert (stably), rank each within
    its expert and scatter the kept ones into an (E, C, d) buffer.
    Returns (buf, dest, keep, order)."""
    d = x.shape[1]
    n = idx.numel()
    slot_expert = idx.reshape(-1)
    slot_token = torch.arange(n, device=x.device) // idx.shape[-1]
    order = torch.argsort(slot_expert, stable=True)
    sorted_e = slot_expert[order]
    sorted_tok = slot_token[order]
    seg_start = torch.searchsorted(sorted_e, sorted_e, side="left")
    rank = torch.arange(n, device=x.device) - seg_start
    keep = (rank < capacity)[:, None]                        # drops
    dest = sorted_e * capacity + torch.clamp(rank, max=capacity - 1)
    gathered = x[sorted_tok] * keep.to(x.dtype)
    buf = torch.zeros((e * capacity, d), dtype=x.dtype, device=x.device)
    buf.index_add_(0, dest, torch.where(keep, gathered,
                                        torch.zeros_like(gathered)))
    return buf.reshape(e, capacity, d), dest, keep, order


def _experts(params, buf: torch.Tensor) -> torch.Tensor:
    """SwiGLU of every expert over its buffer rows: batched GEMMs."""
    up = torch.bmm(buf, params["w_up"])
    gate = torch.bmm(buf, params["w_gate"])
    return torch.bmm(F.silu(gate) * up, params["w_down"])


def _combine(out: torch.Tensor, dest, keep, order,
             gates: torch.Tensor) -> torch.Tensor:
    """Gather each kept slot's expert output, un-sort, weight by the
    gates and sum over k: (E, C, d) -> (T, d)."""
    t, k = gates.shape
    slot_out = out.reshape(-1, out.shape[-1])[dest]
    slot_out = torch.where(keep, slot_out, torch.zeros_like(slot_out))
    unsorted = torch.empty_like(slot_out).index_copy_(0, order, slot_out)
    return (unsorted.reshape(t, k, -1)
            * gates[..., None].to(out.dtype)).sum(dim=1)


def moe_ffn(cfg: MoEConfig, params, x: torch.Tensor) -> tuple:
    """x: (T, d) -> (y (T, d), aux_loss ()), the load-balance loss."""
    t = x.shape[0]
    e, k = cfg.n_experts, cfg.top_k
    capacity = max(1, int(t * k / e * cfg.capacity_factor))
    probs, gates, idx = _route(cfg, params, x)
    # Load-balance auxiliary loss (Switch-style).
    ce = torch.zeros(e, dtype=torch.float32, device=x.device).index_add_(
        0, idx.reshape(-1), torch.ones(t * k, device=x.device)) / (t * k)
    aux = e * torch.sum(probs.mean(dim=0) * ce)
    buf, dest, keep, order = _dispatch(x, idx, e, capacity)
    y = _combine(_experts(params, buf), dest, keep, order, gates)
    if cfg.n_shared:
        y = y + dense_ffn(params["shared"], x)
    return y, aux
