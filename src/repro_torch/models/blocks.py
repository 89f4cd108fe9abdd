"""Pre-norm residual blocks: ``LayerKind("attn", "dense")`` only.

Other mixers (MLA, Mamba) and MoE FFNs are not ported yet and raise.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models import attention as attn_mod
from repro_torch.models.layers import dense, rms_norm, spec

__all__ = ["LayerKind", "block_specs", "block_prefill", "block_decode",
           "block_cache_specs", "dense_ffn"]


class LayerKind(NamedTuple):
    mixer: str
    ffn: str


def _check(kind: LayerKind) -> None:
    if kind != LayerKind("attn", "dense"):
        raise NotImplementedError(f"block kind {kind} is not ported yet "
                                  "(attn + dense only)")


def block_specs(cfg, kind: LayerKind) -> dict:
    _check(kind)
    if not cfg.gated_ffn:
        raise NotImplementedError("the GELU MLP is not ported (SwiGLU only)")
    ffn = {"w_up": spec((cfg.d_model, cfg.d_ff), cfg.dtype),
           "w_down": spec((cfg.d_ff, cfg.d_model), cfg.dtype),
           "w_gate": spec((cfg.d_model, cfg.d_ff), cfg.dtype)}
    return {
        "norm_mixer": spec((cfg.d_model,), "float32", init="ones"),
        "attn": attn_mod.attention_specs(cfg.d_model, cfg.n_heads, cfg.n_kv,
                                         cfg.head_dim, cfg.dtype),
        "norm_ffn": spec((cfg.d_model,), "float32", init="ones"),
        "ffn": ffn,
    }


def dense_ffn(params, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU FFN: (..., d) -> (..., d)."""
    up = F.silu(dense(x, params["w_gate"])) * dense(x, params["w_up"])
    return dense(up, params["w_down"])


def _apply_ffn(params, x):
    return x + dense_ffn(params["ffn"], rms_norm(x, params["norm_ffn"]))


def block_cache_specs(cfg, kind: LayerKind, batch: int, max_len: int):
    _check(kind)
    return attn_mod.init_kv_cache_specs(batch, max_len, cfg.n_kv,
                                        cfg.head_dim, cfg.dtype)


def _pad_to(x: torch.Tensor, max_len: int) -> torch.Tensor:
    """Pad (B, L, ...) along axis 1 up to max_len with zeros."""
    out = x.new_zeros((x.shape[0], max_len) + tuple(x.shape[2:]))
    out[:, : x.shape[1]] = x
    return out


def block_prefill(cfg, kind: LayerKind, params, x, positions, max_len: int):
    """Forward + this block's decode cache (padded to max_len)."""
    _check(kind)
    h = rms_norm(x, params["norm_mixer"])
    out, (k, v) = attn_mod.attention(params["attn"], h, positions,
                                     q_block=cfg.q_block,
                                     kv_block=cfg.kv_block, return_kv=True)
    x = x + out
    cache = attn_mod.KVCache(_pad_to(k, max_len), _pad_to(v, max_len),
                             torch.tensor(x.shape[1], dtype=torch.int32,
                                          device=x.device))
    return _apply_ffn(params, x), cache


def block_decode(cfg, kind: LayerKind, params, x, cache):
    _check(kind)
    h = rms_norm(x, params["norm_mixer"])
    out, cache = attn_mod.decode_attention(params["attn"], h, cache)
    return _apply_ffn(params, x + out), cache
