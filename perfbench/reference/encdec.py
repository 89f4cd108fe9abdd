"""Plain reference of the encoder-decoder the port trains (seamless).

Float32 arithmetic throughout, TF32 off, autograd for the gradients, no
kernels, no remat.  The block is the one the configuration file states
(``departures`` there lists where it leaves the published model):

    encoder (over frame embeddings, positions 0..S-1), per layer:
        x = x + attn(rmsnorm(x) * norm_attn)            (no mask)
        x = x + ffn(rmsnorm(x) * norm_ffn)
    enc = rmsnorm(x) * enc_final_norm
    decoder (x = embed[tokens], positions 0..T-1), per layer:
        x = x + attn(rmsnorm(x) * norm_attn)            (causal)
        x = x + cross(rmsnorm(x) * norm_cross, enc)     (no mask)
        x = x + ffn(rmsnorm(x) * norm_ffn)
    logits = (rmsnorm(x) * dec_final_norm) @ embed^T

Attention: q = rope(h wq), k = rope(h wk), v = h wv, softmax(q k^T /
sqrt(head_dim)) v wo; in cross-attention the queries take RoPE at their
decoder positions and the keys at their source positions.  FFN:
(silu(h w_gate) * (h w_up)) w_down.  Loss: the mean next-token
cross-entropy over every target position.

The update is AdamW as the configuration's ``optimizer`` states it:
global-norm clipping, a linear warmup, bias correction, weight decay on
matrices only; the moments in float32; each parameter kept in its
stored type (bf16 matrices, float32 norm scales) between steps, as the
configuration's ``torch_dtype`` states.

The batch runs in blocks of rows, each block's share of the mean
backpropagated on its own and the gradients summed, so that the float32
activations fit beside the float32 state.
"""

from __future__ import annotations

import math

import torch

from perfbench.reference.precision import matmul


def _rms(x, scale, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale


def _rope(x, base):
    """x (B, T, heads, D) rotated at positions 0..T-1."""
    t, dim = x.shape[1], x.shape[-1]
    half = dim // 2
    freqs = torch.exp(-math.log(base) * torch.arange(
        half, dtype=torch.float32, device=x.device) / half)
    ang = torch.arange(t, dtype=torch.float32, device=x.device)[:, None] \
        * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _proj(h, w, p):
    d, heads, dim = w.shape
    return matmul(h, w.reshape(d, heads * dim), p).reshape(
        h.shape[:-1] + (heads, dim))


def _attend(q, k, v, wo, causal, p):
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(q.shape[-1])
    if causal:
        t = q.shape[1]
        mask = torch.ones(t, t, dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~mask, float("-inf"))
    ctx = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(scores, -1), v)
    return matmul(ctx.reshape(ctx.shape[0], ctx.shape[1], -1),
                  wo.reshape(-1, wo.shape[-1]), p)


def _ffn(h, w, stack, i, p):
    gate = torch.nn.functional.silu(matmul(h, w[f"{stack}_w_gate"][i], p))
    return matmul(gate * matmul(h, w[f"{stack}_w_up"][i], p),
                  w[f"{stack}_w_down"][i], p)


def nll_sum(c: dict, w: dict, batch: dict, p: str) -> torch.Tensor:
    """Summed next-token NLL of ``batch`` under float32 weights ``w``."""
    eps, base = c["rms_norm_eps"], c["rope_theta"]
    x = batch["src_embeds"].float()
    for i in range(c["encoder_layers"]):
        h = _rms(x, w["enc_norm_attn"][i], eps)
        q = _rope(_proj(h, w["enc_attn_wq"][i], p), base)
        k = _rope(_proj(h, w["enc_attn_wk"][i], p), base)
        v = _proj(h, w["enc_attn_wv"][i], p)
        x = x + _attend(q, k, v, w["enc_attn_wo"][i], False, p)
        x = x + _ffn(_rms(x, w["enc_norm_ffn"][i], eps), w, "enc", i, p)
    enc = _rms(x, w["enc_final_norm"], eps)
    x = w["embed"][batch["tgt_tokens"].long()]
    for i in range(c["decoder_layers"]):
        h = _rms(x, w["dec_norm_attn"][i], eps)
        q = _rope(_proj(h, w["dec_attn_wq"][i], p), base)
        k = _rope(_proj(h, w["dec_attn_wk"][i], p), base)
        v = _proj(h, w["dec_attn_wv"][i], p)
        x = x + _attend(q, k, v, w["dec_attn_wo"][i], True, p)
        h = _rms(x, w["dec_norm_cross"][i], eps)
        q = _rope(_proj(h, w["dec_cross_wq"][i], p), base)
        k = _rope(_proj(enc, w["dec_cross_wk"][i], p), base)
        v = _proj(enc, w["dec_cross_wv"][i], p)
        x = x + _attend(q, k, v, w["dec_cross_wo"][i], False, p)
        x = x + _ffn(_rms(x, w["dec_norm_ffn"][i], eps), w, "dec", i, p)
    x = _rms(x, w["dec_final_norm"], eps)
    logits = matmul(x, w["embed"].t(), p)
    gold = logits.gather(-1, batch["labels"].long()[..., None])[..., 0]
    return (torch.logsumexp(logits, -1) - gold).sum()


def train_steps(c: dict, stored: dict, batches: list, precision: str = "float32",
                rows: int = 4, rows_used=None) -> dict:
    """Run ``len(batches)`` AdamW steps from the parameters ``stored``
    (kept in their stored types; the dict is updated in place).

    Returns each step's loss, the norm of each leaf's clipped gradient
    at the first step (what the update takes), and the norm of each
    leaf's change over all the steps.  ``rows_used`` keeps only that
    many rows of each batch (the fault of a step that drops rows)."""
    o = c["optimizer"]
    start = {k: v.clone() for k, v in stored.items()}
    m = {k: torch.zeros(v.shape, dtype=torch.float32, device=v.device)
         for k, v in stored.items()}
    s2 = {k: torch.zeros_like(t) for k, t in m.items()}
    losses, grad_norms = [], {}
    for step, batch in enumerate(batches, start=1):
        if rows_used is not None:
            batch = {k: t[:rows_used] for k, t in batch.items()}
        n_rows = batch["tgt_tokens"].shape[0]
        n_tok = batch["labels"].numel()
        leaves = {k: v.to(torch.float32, copy=True).requires_grad_()
                  for k, v in stored.items()}
        grads = {k: torch.zeros_like(t) for k, t in leaves.items()}
        total = 0.0
        for r in range(0, n_rows, rows):
            part = {k: t[r: r + rows] for k, t in batch.items()}
            with torch.enable_grad():
                loss = nll_sum(c, leaves, part, precision) / n_tok
                g = torch.autograd.grad(loss, list(leaves.values()),
                                        allow_unused=True)
            total += loss.item()
            for (k, acc), gk in zip(grads.items(), g):
                if gk is not None:
                    acc.add_(gk)
        del leaves
        losses.append(total)
        with torch.no_grad():
            gnorm = math.sqrt(sum(float((g * g).sum()) for g in grads.values()))
            scale = min(o["grad_clip"] / max(gnorm, 1e-9), 1.0)
            lr = o["lr"] * min(step / max(o["warmup_steps"], 1), 1.0)
            c1, c2 = 1 - o["b1"] ** step, 1 - o["b2"] ** step
            for k, p in stored.items():
                g = grads[k] * scale
                if step == 1:
                    grad_norms[k] = float(g.norm())
                m[k].mul_(o["b1"]).add_((1 - o["b1"]) * g)
                s2[k].mul_(o["b2"]).add_((1 - o["b2"]) * g * g)
                upd = (m[k] / c1) / (torch.sqrt(s2[k] / c2) + o["eps"])
                if o["weight_decay"] and p.dim() >= 2:
                    upd = upd + o["weight_decay"] * p.float()
                p.copy_((p.float() - lr * upd).to(p.dtype))
        del grads
    change = {k: float((stored[k].float() - start[k].float()).norm())
              for k in stored}
    return {"losses": losses, "grad_norms": grad_norms,
            "change_norms": change}
