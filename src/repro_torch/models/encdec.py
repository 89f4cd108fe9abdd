"""Encoder-decoder transformer backbone (seamless-m4t-large-v2).

The audio frontend is a stub, as in the reference
(``repro.models.encdec``): the batch carries precomputed frame
embeddings (B, S_src, d_model).  A bidirectional encoder stack and a
causal decoder stack with cross-attention, parameters stacked per stack::

    {"embed": (vocab, d), "enc_final_norm": (d,), "dec_final_norm": (d,),
     "encoder": {"norm_attn": (L, d), "attn": {"wq": (L, d, H, D), ...},
                 "norm_ffn": (L, d), "ffn": {"w_up": (L, d, F), ...}},
     "decoder": {... the encoder's leaves, "norm_cross": (L, d),
                 "cross": {"wq": ..., "wk": ..., "wv": ..., "wo": ...}}}

Copied from the reference as they are (ROADMAP C): cross-attention
queries take RoPE at their decoder positions and cross keys at their
source positions; decode's cross-attention query sits at ``cache.length
- 1`` of the updated self cache; ``remat`` acts in training only.
Serving caches are ``{"self": KVCache(k (L, B, max_len, n_kv, D), v,
length (L,)), "cross_k": (L, B, S, n_kv, D), "cross_v": ...}``.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models.attention import CacheSpec
from repro_torch.models.layers import (DTYPES, ParamSpec, masked_nll,
                                       maybe_remat, rms_norm, rope, spec,
                                       tree_map, unstack)

__all__ = ["EncDecConfig", "encdec_specs", "encdec_forward", "encdec_loss",
           "encode", "decoder_prefill", "decoder_decode",
           "decoder_cache_specs"]


@dataclasses.dataclass(frozen=True)
class EncDecConfig:
    name: str
    enc_layers: int
    dec_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: int = 0
    dtype: str = "bfloat16"
    q_block: int = 512
    kv_block: int = 1024
    remat: str = "full"

    def __post_init__(self):
        if not self.head_dim:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)


def _stack(specs: Any, steps: int) -> Any:
    return tree_map(lambda s: ParamSpec((steps,) + s.shape, s.dtype, s.init),
                    specs)


def _enc_layer_specs(cfg: EncDecConfig) -> dict:
    return {
        "norm_attn": spec((cfg.d_model,), "float32", init="ones"),
        "attn": attn_mod.attention_specs(cfg.d_model, cfg.n_heads, cfg.n_kv,
                                         cfg.head_dim, cfg.dtype),
        "norm_ffn": spec((cfg.d_model,), "float32", init="ones"),
        "ffn": moe_mod.ffn_specs(cfg.d_model, cfg.d_ff, cfg.dtype),
    }


def _dec_layer_specs(cfg: EncDecConfig) -> dict:
    s = _enc_layer_specs(cfg)
    s["norm_cross"] = spec((cfg.d_model,), "float32", init="ones")
    s["cross"] = attn_mod.attention_specs(cfg.d_model, cfg.n_heads, cfg.n_kv,
                                          cfg.head_dim, cfg.dtype)
    return s


def encdec_specs(cfg: EncDecConfig) -> dict:
    return {
        "embed": spec((cfg.vocab, cfg.d_model), cfg.dtype, init="embed"),
        "enc_final_norm": spec((cfg.d_model,), "float32", init="ones"),
        "dec_final_norm": spec((cfg.d_model,), "float32", init="ones"),
        "encoder": _stack(_enc_layer_specs(cfg), cfg.enc_layers),
        "decoder": _stack(_dec_layer_specs(cfg), cfg.dec_layers),
    }


def _positions(b: int, n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int32, device=device)[None].expand(b, n)


def _full_attention(q, k, v) -> torch.Tensor:
    """Unmasked softmax attention in float32 with GQA broadcast:
    q (B, Lq, H, D), k/v (B, Lk, Hkv, D) -> (B, Lq, H, D) in q's dtype."""
    b, lq, h, d = q.shape
    hkv = k.shape[2]
    qg = (q.float() * (1.0 / math.sqrt(d))).reshape(b, lq, hkv, h // hkv, d)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float())
    p = torch.softmax(logits, dim=-1)
    ctx = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return ctx.reshape(b, lq, h, d).to(q.dtype)


def _bidir_attention(params, x, positions) -> torch.Tensor:
    """Non-causal self-attention (all pairs) for the encoder."""
    q, k, v = attn_mod._qkv(params, x, positions)
    return attn_mod._out(_full_attention(q, k, v), params["wo"])


def _cross_attention(params, x, enc_kv, positions_q) -> torch.Tensor:
    """Decoder -> encoder attention over precomputed ``enc_kv = (k, v)``."""
    k, v = enc_kv
    q = rope(attn_mod._proj(x, params["wq"]), positions_q)
    return attn_mod._out(_full_attention(q, k, v), params["wo"])


def _cross_kv(params, enc_out, positions_src) -> tuple:
    k = attn_mod._proj(enc_out, params["wk"])
    v = attn_mod._proj(enc_out, params["wv"])
    return rope(k, positions_src), v


def _enc_layer(positions, layer, x) -> torch.Tensor:
    x = x + _bidir_attention(layer["attn"], rms_norm(x, layer["norm_attn"]),
                             positions)
    return x + moe_mod.dense_ffn(layer["ffn"],
                                 rms_norm(x, layer["norm_ffn"]))


def encode(cfg: EncDecConfig, params, src_embeds) -> torch.Tensor:
    """src_embeds: (B, S, d_model) frame embeddings (frontend stub)."""
    b, s, _ = src_embeds.shape
    positions = _positions(b, s, src_embeds.device)
    x = src_embeds.to(DTYPES[cfg.dtype])
    for layer in unstack(params["encoder"], cfg.enc_layers):
        x = maybe_remat(cfg.remat,
                        functools.partial(_enc_layer, positions, layer))(x)
    return rms_norm(x, params["enc_final_norm"])


def _dec_layer(cfg, positions, enc_out, positions_src, layer, x):
    h = rms_norm(x, layer["norm_attn"])
    x = x + attn_mod.attention(layer["attn"], h, positions,
                               q_block=cfg.q_block, kv_block=cfg.kv_block)
    enc_kv = _cross_kv(layer["cross"], enc_out, positions_src)
    x = x + _cross_attention(layer["cross"], rms_norm(x, layer["norm_cross"]),
                             enc_kv, positions)
    return x + moe_mod.dense_ffn(layer["ffn"],
                                 rms_norm(x, layer["norm_ffn"]))


def encdec_forward(cfg: EncDecConfig, params, batch) -> torch.Tensor:
    """batch: ``src_embeds`` (B, S, d), ``tgt_tokens`` (B, T) -> logits
    (B, T, V)."""
    enc_out = encode(cfg, params, batch["src_embeds"])
    b, s = enc_out.shape[:2]
    positions_src = _positions(b, s, enc_out.device)
    tgt = batch["tgt_tokens"]
    x = params["embed"][tgt]
    positions = _positions(b, tgt.shape[1], x.device)
    for layer in unstack(params["decoder"], cfg.dec_layers):
        body = functools.partial(_dec_layer, cfg, positions, enc_out,
                                 positions_src, layer)
        x = maybe_remat(cfg.remat, body)(x)
    x = rms_norm(x, params["dec_final_norm"])
    return torch.matmul(x, params["embed"].t())


def encdec_loss(cfg: EncDecConfig, params, batch) -> tuple:
    loss = masked_nll(encdec_forward(cfg, params, batch), batch["labels"])
    return loss, {"nll": loss}


# ---------------------------------------------------------------------------
# Serving: decoder self-attention KV cache + cached cross K/V.
# ---------------------------------------------------------------------------


def decoder_cache_specs(cfg: EncDecConfig, batch: int, max_len: int,
                        src_len: int) -> dict:
    stacked = (cfg.dec_layers, batch)
    kv = CacheSpec(stacked + (max_len, cfg.n_kv, cfg.head_dim), cfg.dtype)
    cross = CacheSpec(stacked + (src_len, cfg.n_kv, cfg.head_dim), cfg.dtype)
    return {"self": attn_mod.KVCache(kv, kv,
                                     CacheSpec((cfg.dec_layers,), "int32")),
            "cross_k": cross, "cross_v": cross}


def decoder_prefill(cfg: EncDecConfig, params, batch, max_len: int) -> tuple:
    """Encode ``src_embeds``, run the decoder over ``tgt_tokens`` and
    build its caches: ``(last logits (B, 1, V), caches)``."""
    enc_out = encode(cfg, params, batch["src_embeds"])
    b, s = enc_out.shape[:2]
    positions_src = _positions(b, s, enc_out.device)
    tgt = batch["tgt_tokens"]
    t = tgt.shape[1]
    x = params["embed"][tgt]
    positions = _positions(b, t, x.device)
    dtype = DTYPES[cfg.dtype]
    ks, vs, cks, cvs = [], [], [], []
    for layer in unstack(params["decoder"], cfg.dec_layers):
        h = rms_norm(x, layer["norm_attn"])
        out, (k, v) = attn_mod.attention(layer["attn"], h, positions,
                                         q_block=cfg.q_block,
                                         kv_block=cfg.kv_block,
                                         return_kv=True)
        x = x + out
        pad = (0, 0, 0, 0, 0, max_len - t)
        ks.append(F.pad(k.to(dtype), pad))
        vs.append(F.pad(v.to(dtype), pad))
        ck, cv = _cross_kv(layer["cross"], enc_out, positions_src)
        x = x + _cross_attention(layer["cross"],
                                 rms_norm(x, layer["norm_cross"]), (ck, cv),
                                 positions)
        x = x + moe_mod.dense_ffn(layer["ffn"],
                                  rms_norm(x, layer["norm_ffn"]))
        cks.append(ck.to(dtype))
        cvs.append(cv.to(dtype))
    x = rms_norm(x, params["dec_final_norm"])
    logits = torch.matmul(x[:, -1:], params["embed"].t())
    length = torch.full((cfg.dec_layers,), t, dtype=torch.int32,
                        device=x.device)
    return logits, {"self": attn_mod.KVCache(torch.stack(ks), torch.stack(vs),
                                             length),
                    "cross_k": torch.stack(cks), "cross_v": torch.stack(cvs)}


def decoder_decode(cfg: EncDecConfig, params, tokens, caches) -> tuple:
    """One decode step: tokens (B, 1) -> (logits (B, 1, V), new caches)."""
    x = params["embed"][tokens]
    b = x.shape[0]
    old = caches["self"]
    ks, vs, lengths = [], [], []
    for i, layer in enumerate(unstack(params["decoder"], cfg.dec_layers)):
        h = rms_norm(x, layer["norm_attn"])
        out, cache = attn_mod.decode_attention(
            layer["attn"], h, attn_mod.KVCache(old.k[i], old.v[i],
                                               old.length[i]))
        x = x + out
        pos = (cache.length - 1).to(torch.int32).reshape(1, 1).expand(b, 1)
        x = x + _cross_attention(layer["cross"],
                                 rms_norm(x, layer["norm_cross"]),
                                 (caches["cross_k"][i], caches["cross_v"][i]),
                                 pos)
        x = x + moe_mod.dense_ffn(layer["ffn"],
                                  rms_norm(x, layer["norm_ffn"]))
        ks.append(cache.k)
        vs.append(cache.v)
        lengths.append(cache.length)
    x = rms_norm(x, params["dec_final_norm"])
    logits = torch.matmul(x, params["embed"].t())
    return logits, {"self": attn_mod.KVCache(torch.stack(ks), torch.stack(vs),
                                             torch.stack(lengths)),
                    "cross_k": caches["cross_k"],
                    "cross_v": caches["cross_v"]}
