"""Plain reference of the decoder LM the port serves (minitron-4b).

Float32 throughout, TF32 off, no cache, no batching, no kernels: one
causal forward pass over one token sequence, a layer at a time, each
layer's weights cast to float32 as it is reached, so that only one
layer's float32 copy lives at once.

The block is the one the configuration file states (``departures``
there lists where it leaves the published Nemotron block):

    x = embed[tokens]
    per layer:  h = rmsnorm(x) * norm_mixer
                q, k = rope(h @ wq), rope(h @ wk); v = h @ wv   (GQA)
                x = x + softmax(q k^T / sqrt(head_dim), causal) v @ wo
                h = rmsnorm(x) * norm_ffn
                x = x + (silu(h @ w_gate) * (h @ w_up)) @ w_down
    logits = (rmsnorm(x) * final_norm) @ lm_head       (embed^T if tied)

RoPE rotates the two halves of each head (base ``rope_theta``) at
positions 0, 1, ...; rmsnorm divides by sqrt(mean(x^2) + eps).
"""

from __future__ import annotations

import math

import torch

from perfbench.reference.precision import matmul


def _rms(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) \
        * scale.float()


def _rope(x: torch.Tensor, base: float) -> torch.Tensor:
    """x (T, heads, D) rotated at positions 0..T-1."""
    t, _, dim = x.shape
    half = dim // 2
    freqs = torch.exp(-math.log(base) * torch.arange(
        half, dtype=torch.float32, device=x.device) / half)
    ang = torch.arange(t, dtype=torch.float32, device=x.device)[:, None] \
        * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _proj(h, w, precision):
    """h (T, d) @ w (d, heads, D) -> (T, heads, D)."""
    d, heads, dim = w.shape
    return matmul(h, w.reshape(d, heads * dim), precision).reshape(
        -1, heads, dim)


@torch.no_grad()
def logits(c: dict, w: dict, tokens: torch.Tensor, positions: torch.Tensor,
           precision: str = "float32") -> torch.Tensor:
    """Float32 logits (len(positions), vocab) at ``positions`` of a
    causal pass over ``tokens`` (1-D)."""
    eps = c["rms_norm_eps"]
    h_q, h_kv = c["num_attention_heads"], c["num_key_value_heads"]
    groups = h_q // h_kv
    t = tokens.shape[0]
    x = w["embed"][tokens].float()
    causal = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
    for i in range(c["num_hidden_layers"]):
        h = _rms(x, w["norm_mixer"][i], eps)
        q = _rope(_proj(h, w["wq"][i], precision), c["rope_theta"])
        k = _rope(_proj(h, w["wk"][i], precision), c["rope_theta"])
        v = _proj(h, w["wv"][i], precision)
        k = k.repeat_interleave(groups, dim=1)
        v = v.repeat_interleave(groups, dim=1)
        scores = torch.einsum("qhd,khd->hqk", q, k) / math.sqrt(q.shape[-1])
        scores = scores.masked_fill(~causal, float("-inf"))
        ctx = torch.einsum("hqk,khd->qhd", torch.softmax(scores, -1), v)
        wo = w["wo"][i]
        x = x + matmul(ctx.reshape(t, -1), wo.reshape(-1, wo.shape[-1]),
                       precision)
        h = _rms(x, w["norm_ffn"][i], eps)
        gate = torch.nn.functional.silu(matmul(h, w["w_gate"][i], precision))
        x = x + matmul(gate * matmul(h, w["w_up"][i], precision),
                       w["w_down"][i], precision)
    x = _rms(x[positions], w["final_norm"], eps)
    head = (w["embed"].t() if c["tie_word_embeddings"] else w["lm_head"])
    return matmul(x, head, precision)
