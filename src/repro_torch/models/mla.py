"""Multi-head Latent Attention (DeepSeek-V2/V3).

Queries and keys/values are low-rank compressed; only the compressed
KV latent ``c_kv`` (kv_lora_rank) plus the shared RoPE key ``k_pe``
(rope dim) are cached for decode: the tensors SeDA protects when the
cache crosses the untrusted boundary.  Plain torch, as the reference's
plain ``jnp``; decode expands the latent over the whole window (the
naive form, not the absorbed one), as the reference does.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models import attention as attn_mod
from repro_torch.models.attention import CacheSpec
from repro_torch.models.layers import dense, rms_norm, rope, spec

__all__ = ["MLAConfig", "mla_specs", "mla_attention", "mla_decode",
           "MLACache", "init_mla_cache_specs"]

NEG_INF = -1e30


class MLAConfig(NamedTuple):
    d_model: int
    n_heads: int
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128


class MLACache(NamedTuple):
    c_kv: torch.Tensor    # (B, L_max, kv_lora_rank)
    k_pe: torch.Tensor    # (B, L_max, qk_rope_dim)
    length: torch.Tensor  # () or (B,) int32


def init_mla_cache_specs(cfg: MLAConfig, batch: int, max_len: int,
                         dtype: str) -> MLACache:
    return MLACache(CacheSpec((batch, max_len, cfg.kv_lora_rank), dtype),
                    CacheSpec((batch, max_len, cfg.qk_rope_dim), dtype),
                    CacheSpec((), "int32"))


def mla_specs(cfg: MLAConfig, dtype: str) -> dict:
    h, dn, dr, dv = (cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim,
                     cfg.v_head_dim)
    return {
        "wq_a": spec((cfg.d_model, cfg.q_lora_rank), dtype),
        "q_norm": spec((cfg.q_lora_rank,), "float32", init="ones"),
        "wq_b": spec((cfg.q_lora_rank, h, dn + dr), dtype),
        "wkv_a": spec((cfg.d_model, cfg.kv_lora_rank + dr), dtype),
        "kv_norm": spec((cfg.kv_lora_rank,), "float32", init="ones"),
        "wkv_b": spec((cfg.kv_lora_rank, h, dn + dv), dtype),
        "wo": spec((h, dv, cfg.d_model), dtype),
    }


def _project_q(cfg: MLAConfig, params, x, positions):
    cq = rms_norm(dense(x, params["wq_a"]), params["q_norm"])
    q = attn_mod._proj(cq, params["wq_b"])
    q_nope, q_pe = q[..., : cfg.qk_nope_dim], q[..., cfg.qk_nope_dim:]
    return torch.cat([q_nope, rope(q_pe, positions)], dim=-1)


def _project_kv_latent(cfg: MLAConfig, params, x, positions):
    kv = dense(x, params["wkv_a"])                     # (B, L, rank + dr)
    c_kv = rms_norm(kv[..., : cfg.kv_lora_rank], params["kv_norm"])
    k_pe = rope(kv[..., None, cfg.kv_lora_rank:], positions)[..., 0, :]
    return c_kv, k_pe


def _expand_kv(cfg: MLAConfig, params, c_kv, k_pe):
    kv = attn_mod._proj(c_kv, params["wkv_b"])         # (B, L, H, dn + dv)
    k_nope = kv[..., : cfg.qk_nope_dim]
    v = kv[..., cfg.qk_nope_dim:]
    k_pe_b = k_pe[:, :, None, :].expand(
        k_pe.shape[:2] + (cfg.n_heads, cfg.qk_rope_dim))
    return torch.cat([k_nope, k_pe_b], dim=-1), v


def mla_attention(cfg: MLAConfig, params, x, positions, *,
                  q_block: int = 512, kv_block: int = 512):
    """Causal MLA for prefill.  x: (B, L, d)."""
    q = _project_q(cfg, params, x, positions)
    c_kv, k_pe = _project_kv_latent(cfg, params, x, positions)
    k, v = _expand_kv(cfg, params, c_kv, k_pe)
    # Pad V to the QK head dim so the blockwise attention sees equal dims.
    v_pad = F.pad(v, (0, q.shape[-1] - v.shape[-1]))
    ctx = attn_mod._chunked_causal_attention(q, k, v_pad, q_block=q_block,
                                             kv_block=kv_block)
    return attn_mod._out(ctx[..., : cfg.v_head_dim], params["wo"])


def mla_decode(cfg: MLAConfig, params, x, cache: MLACache):
    """Single-token decode with the compressed cache.  x: (B, 1, d).

    ``cache.length`` may be a scalar or (B,) for continuous batching.
    """
    b = x.shape[0]
    per_seq, lengths = attn_mod.decode_lengths(cache.length, b)
    positions = lengths[:, None]                              # (B, 1)
    q = _project_q(cfg, params, x, positions)                 # (B,1,H,dq)
    c_new, kpe_new = _project_kv_latent(cfg, params, x, positions)
    l_max = cache.c_kv.shape[1]
    c_kv = attn_mod.scatter_new_token(cache.c_kv, c_new, cache.length,
                                      lengths, per_seq)
    k_pe = attn_mod.scatter_new_token(cache.k_pe, kpe_new, cache.length,
                                      lengths, per_seq)
    k, v = _expand_kv(cfg, params, c_kv, k_pe)                # (B,L,H,*)
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bqhk,blhk->bhql", q.float() * scale, k.float())
    mask = (torch.arange(l_max, device=x.device)[None, None, None, :]
            <= lengths[:, None, None, None])
    logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    p = torch.softmax(logits, dim=-1)
    ctx = torch.einsum("bhql,blhd->bqhd", p, v.float()).to(x.dtype)
    out = attn_mod._out(ctx, params["wo"])
    return out, MLACache(c_kv, k_pe, cache.length + 1)
