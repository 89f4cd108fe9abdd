"""GQA attention: chunked causal prefill + cached single-token decode.

Plain torch (the reference has no Pallas attention kernel).  Layouts
follow the reference: q (B, L, H, D), caches (B, L_max, n_kv, D),
``wq`` (d_model, H, D), ``wo`` (H, D, d_model).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.models.layers import rope, spec

__all__ = ["attention_specs", "attention", "decode_attention", "KVCache",
           "init_kv_cache_specs", "decode_lengths", "scatter_new_token",
           "CacheSpec"]

NEG_INF = -1e30


class CacheSpec(NamedTuple):
    """Shape + dtype of one cache leaf (the ShapeDtypeStruct counterpart)."""

    shape: tuple
    dtype: str


class KVCache(NamedTuple):
    k: torch.Tensor       # (B, L_max, n_kv, head_dim)
    v: torch.Tensor       # (B, L_max, n_kv, head_dim)
    length: torch.Tensor  # () or (B,) int32: tokens currently cached


def attention_specs(d_model: int, n_heads: int, n_kv: int, head_dim: int,
                    dtype: str) -> dict:
    return {
        "wq": spec((d_model, n_heads, head_dim), dtype),
        "wk": spec((d_model, n_kv, head_dim), dtype),
        "wv": spec((d_model, n_kv, head_dim), dtype),
        "wo": spec((n_heads, head_dim, d_model), dtype),
    }


def init_kv_cache_specs(batch: int, max_len: int, n_kv: int, head_dim: int,
                        dtype: str) -> KVCache:
    return KVCache(CacheSpec((batch, max_len, n_kv, head_dim), dtype),
                   CacheSpec((batch, max_len, n_kv, head_dim), dtype),
                   CacheSpec((), "int32"))


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum('bld,dhk->blhk') as one matmul."""
    d, h, k = w.shape
    return torch.matmul(x, w.reshape(d, h * k)).reshape(x.shape[:-1] + (h, k))


def _qkv(params, x, positions):
    q = rope(_proj(x, params["wq"]), positions)
    k = rope(_proj(x, params["wk"]), positions)
    v = _proj(x, params["wv"])
    return q, k, v


def _out(ctx: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """einsum('blhk,hkd->bld') as one matmul."""
    h, k, d = wo.shape
    return torch.matmul(ctx.reshape(ctx.shape[:-2] + (h * k,)),
                        wo.reshape(h * k, d))


def _chunked_causal_attention(q, k, v, *, q_block: int, kv_block: int):
    """Online-softmax blockwise causal attention (Lq == Lk).

    q: (B, L, H, D); k/v: (B, L, Hkv, D) with H % Hkv == 0.  The loops
    over q and kv blocks replace the reference's two ``lax.scan``s.
    """
    b, lq, h, d = q.shape
    _, lk, hkv, _ = k.shape
    groups = h // hkv
    scale = 1.0 / math.sqrt(d)
    q_block = min(q_block, lq)
    kv_block = min(kv_block, lk)
    nq, nk = -(-lq // q_block), -(-lk // kv_block)
    pad_q, pad_k = nq * q_block - lq, nk * kv_block - lk
    q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, pad_q))
    k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad_k))
    v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad_k))
    qb = q.reshape(b, nq, q_block, h, d).permute(1, 0, 3, 2, 4)
    kb = k.reshape(b, nk, kv_block, hkv, d).permute(1, 0, 3, 2, 4)
    vb = v.reshape(b, nk, kv_block, hkv, d).permute(1, 0, 3, 2, 4)
    rows = torch.arange(q_block, device=q.device)[:, None]
    cols = torch.arange(kv_block, device=q.device)[None, :]
    outs = []
    for iq in range(nq):
        qg = (qb[iq].float() * scale).reshape(b, hkv, groups, q_block, d)
        m = torch.full((b, hkv, groups, q_block), NEG_INF,
                       dtype=torch.float32, device=q.device)
        s = torch.zeros_like(m)
        o = torch.zeros((b, hkv, groups, q_block, d), dtype=torch.float32,
                        device=q.device)
        for ik in range(nk):
            logits = torch.einsum("bhgqd,bhkd->bhgqk", qg, kb[ik].float())
            keep = ((ik * kv_block + cols) <= (iq * q_block + rows)).float()
            logits = logits + (1.0 - keep) * NEG_INF
            new_m = torch.maximum(m, logits.amax(dim=-1))
            alpha = torch.exp(m - new_m)
            p = torch.exp(logits - new_m[..., None]) * keep
            s = s * alpha + p.sum(dim=-1)
            o = o * alpha[..., None] + torch.einsum(
                "bhgqk,bhkd->bhgqd", p, vb[ik].float())
            m = new_m
        out = o / torch.clamp(s[..., None], min=1e-30)
        outs.append(out.reshape(b, h, q_block, d))
    out = torch.stack(outs).permute(1, 0, 3, 2, 4).reshape(
        b, nq * q_block, h, d)
    return out[:, :lq].to(q.dtype)


def attention(params, x, positions, *, q_block: int = 512,
              kv_block: int = 512, return_kv: bool = False):
    """Causal self-attention for prefill.  x: (B, L, d)."""
    q, k, v = _qkv(params, x, positions)
    ctx = _chunked_causal_attention(q, k, v, q_block=q_block,
                                    kv_block=kv_block)
    out = _out(ctx, params["wo"])
    if return_kv:
        return out, (k, v)
    return out


def decode_lengths(length: torch.Tensor, batch: int):
    """(per_seq, lengths (B,) int32) from a scalar or (B,) cache length."""
    per_seq = length.dim() == 1
    lengths = length if per_seq else length.reshape(1).expand(batch)
    return per_seq, lengths.to(torch.int32)


def scatter_new_token(cache_arr, new, length, lengths, per_seq: bool):
    """Write a (B, 1, ...) new-token slice at each sequence's position."""
    if per_seq:
        l_max = cache_arr.shape[1]
        hit = (torch.arange(l_max, device=cache_arr.device)[None, :]
               == lengths[:, None])
        hit = hit.reshape(hit.shape + (1,) * (cache_arr.dim() - 2))
        return torch.where(hit, new.to(cache_arr.dtype), cache_arr)
    out = cache_arr.clone()
    pos = int(length)
    out[:, pos: pos + 1] = new.to(cache_arr.dtype)
    return out


def decode_attention(params, x, cache: KVCache):
    """Single-token decode.  x: (B, 1, d); returns (out, new_cache)."""
    b, one, _ = x.shape
    assert one == 1
    per_seq, lengths = decode_lengths(cache.length, b)
    q, k_new, v_new = _qkv(params, x, lengths[:, None])
    l_max = cache.k.shape[1]
    k = scatter_new_token(cache.k, k_new, cache.length, lengths, per_seq)
    v = scatter_new_token(cache.v, v_new, cache.length, lengths, per_seq)
    h, hkv = q.shape[2], k.shape[2]
    groups = h // hkv
    scale = 1.0 / math.sqrt(q.shape[-1])
    qg = (q.float() * scale).reshape(b, 1, hkv, groups, -1)
    logits = torch.einsum("bqhgd,blhd->bhgql", qg, k.float())
    mask = (torch.arange(l_max, device=x.device)[None, None, None, None, :]
            <= lengths[:, None, None, None, None])
    logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    p = torch.softmax(logits, dim=-1)
    ctx = torch.einsum("bhgql,blhd->bqhgd", p, v.float())
    ctx = ctx.reshape(b, 1, h, -1).to(x.dtype)
    out = _out(ctx, params["wo"])
    return out, KVCache(k, v, cache.length + 1)
