"""Pre-norm residual blocks: (mixer, ffn) pairs.

mixer: 'attn' (GQA/MQA + RoPE) | 'mla' (DeepSeek latent) | 'mamba' (SSD)
ffn:   'dense' (SwiGLU or GELU MLP) | 'moe' (top-k routed) | 'none'
       (pure-mamba blocks)
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.models import attention as attn_mod
from repro_torch.models import mamba2 as mamba_mod
from repro_torch.models import mla as mla_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models.layers import dense, rms_norm, spec

__all__ = ["LayerKind", "block_specs", "block_forward", "block_prefill",
           "block_decode", "block_cache_specs"]

MIXERS = ("attn", "mla", "mamba")
FFNS = ("dense", "moe", "none")


class LayerKind(NamedTuple):
    mixer: str
    ffn: str


def _check(kind: LayerKind) -> None:
    if kind.mixer not in MIXERS or kind.ffn not in FFNS:
        raise ValueError(f"unknown block kind {kind}")


def block_specs(cfg, kind: LayerKind) -> dict:
    _check(kind)
    s: dict = {"norm_mixer": spec((cfg.d_model,), "float32", init="ones")}
    if kind.mixer == "attn":
        s["attn"] = attn_mod.attention_specs(cfg.d_model, cfg.n_heads,
                                             cfg.n_kv, cfg.head_dim,
                                             cfg.dtype)
    elif kind.mixer == "mla":
        s["mla"] = mla_mod.mla_specs(cfg.mla, cfg.dtype)
    else:
        s["mamba"] = mamba_mod.mamba2_specs(cfg.mamba, cfg.dtype)
    if kind.ffn != "none":
        s["norm_ffn"] = spec((cfg.d_model,), "float32", init="ones")
    if kind.ffn == "dense":
        s["ffn"] = moe_mod.ffn_specs(cfg.d_model, cfg.d_ff, cfg.dtype,
                                     gated=cfg.gated_ffn)
    elif kind.ffn == "moe":
        s["moe"] = moe_mod.moe_specs(cfg.moe, cfg.dtype)
    return s


def _apply_ffn(cfg, kind: LayerKind, params, x, aux):
    """``(x + ffn(norm(x)), aux + the MoE load-balance loss)``."""
    if kind.ffn == "none":
        return x, aux
    h = rms_norm(x, params["norm_ffn"])
    if kind.ffn == "dense":
        return x + moe_mod.dense_ffn(params["ffn"], h), aux
    b, l, d = h.shape
    y, moe_aux = moe_mod.moe_ffn(cfg.moe, params["moe"], h.reshape(b * l, d))
    return x + y.reshape(b, l, d), aux + moe_aux


def block_forward(cfg, kind: LayerKind, params, x, positions, aux):
    """Training forward: ``(x, aux)`` -> ``(x', aux')``.  Writes nothing
    in place, so autograd differentiates it."""
    _check(kind)
    h = rms_norm(x, params["norm_mixer"])
    if kind.mixer == "attn":
        out = attn_mod.attention(params["attn"], h, positions,
                                 q_block=cfg.q_block, kv_block=cfg.kv_block)
    elif kind.mixer == "mla":
        out = mla_mod.mla_attention(cfg.mla, params["mla"], h, positions,
                                    q_block=cfg.q_block,
                                    kv_block=cfg.kv_block)
    else:
        out = mamba_mod.mamba2_forward(cfg.mamba, params["mamba"], h,
                                       chunk=cfg.ssd_chunk)
    return _apply_ffn(cfg, kind, params, x + out, aux)


def block_cache_specs(cfg, kind: LayerKind, batch: int, max_len: int):
    _check(kind)
    if kind.mixer == "attn":
        return attn_mod.init_kv_cache_specs(batch, max_len, cfg.n_kv,
                                            cfg.head_dim, cfg.dtype)
    if kind.mixer == "mla":
        return mla_mod.init_mla_cache_specs(cfg.mla, batch, max_len,
                                            cfg.dtype)
    return mamba_mod.init_mamba2_state_specs(cfg.mamba, batch, cfg.dtype)


def _pad_to(x: torch.Tensor, max_len: int) -> torch.Tensor:
    """Pad (B, L, ...) along axis 1 up to max_len with zeros."""
    out = x.new_zeros((x.shape[0], max_len) + tuple(x.shape[2:]))
    out[:, : x.shape[1]] = x
    return out


def block_prefill(cfg, kind: LayerKind, params, x, positions, max_len: int):
    """Forward + this block's decode cache (padded to max_len)."""
    _check(kind)
    h = rms_norm(x, params["norm_mixer"])
    # Filled on the device: a copy from the host would sync the stream
    # (and could not be captured in a CUDA graph).
    length = torch.full((), x.shape[1], dtype=torch.int32, device=x.device)
    if kind.mixer == "attn":
        out, (k, v) = attn_mod.attention(params["attn"], h, positions,
                                         q_block=cfg.q_block,
                                         kv_block=cfg.kv_block,
                                         return_kv=True)
        cache = attn_mod.KVCache(_pad_to(k, max_len), _pad_to(v, max_len),
                                 length)
    elif kind.mixer == "mla":
        out = mla_mod.mla_attention(cfg.mla, params["mla"], h, positions,
                                    q_block=cfg.q_block,
                                    kv_block=cfg.kv_block)
        c_kv, k_pe = mla_mod._project_kv_latent(cfg.mla, params["mla"], h,
                                                positions)
        cache = mla_mod.MLACache(_pad_to(c_kv, max_len),
                                 _pad_to(k_pe, max_len), length)
    else:
        p = params["mamba"]
        out, state = mamba_mod.mamba2_forward(cfg.mamba, p, h,
                                              chunk=cfg.ssd_chunk,
                                              return_state=True)
        # The conv window is the last (d_conv - 1) conv inputs, taken as
        # the reference takes it: a prompt shorter than d_conv - 1 keeps
        # only its own rows (not zero-padded; ROADMAP C).  Only those rows
        # of the xbc columns are projected.
        di, gn = cfg.mamba.d_inner, cfg.mamba.n_groups * cfg.mamba.d_state
        window = dense(h[:, -(cfg.mamba.d_conv - 1):],
                       p["in_proj"][:, di: 2 * di + 2 * gn])
        cache = mamba_mod.Mamba2State(state, window.contiguous(), length)
    return _apply_ffn(cfg, kind, params, x + out, 0.0)[0], cache


def block_decode(cfg, kind: LayerKind, params, x, cache):
    _check(kind)
    h = rms_norm(x, params["norm_mixer"])
    if kind.mixer == "attn":
        out, cache = attn_mod.decode_attention(params["attn"], h, cache)
    elif kind.mixer == "mla":
        out, cache = mla_mod.mla_decode(cfg.mla, params["mla"], h, cache)
    else:
        out, cache = mamba_mod.mamba2_decode(cfg.mamba, params["mamba"], h,
                                             cache)
    return _apply_ffn(cfg, kind, params, x + out, 0.0)[0], cache
