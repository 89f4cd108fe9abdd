"""Seeded weights, drawn on the device in the type they are served in.

One ``torch.Generator`` on the device, one draw a stacked leaf (every
layer of a kind at once), so a full-width model takes a dozen calls.
Matrices are normal with standard deviation 1/sqrt(fan-in of one layer,
over the axes the matmul contracts); embeddings 0.02; norm scales one.
At the fan-in of one layer the residual stream and the attention scores
stay of order one through every layer, so the greedy tokens depend on
the context the pages hold.

The layout is the benchmark's own (flat names, a leading layer axis);
:func:`lm_program_tree` and :func:`encdec_program_tree` hand the same
tensors, not copies, to the program in its tree form.
"""

from __future__ import annotations

import math

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _draw(gen, shape, fan_in, dtype, device):
    w = torch.randn(shape, generator=gen, dtype=dtype, device=device)
    return w.mul_(1.0 / math.sqrt(fan_in))


def lm_shapes(c: dict) -> dict:
    """``{name: (shape, fan_in or None for ones, dtype)}`` of the
    decoder LM, in draw order; an untied head is drawn last."""
    L, d, h, kv, hd, f, v = (c["num_hidden_layers"], c["hidden_size"],
                             c["num_attention_heads"],
                             c["num_key_value_heads"], c["head_dim"],
                             c["intermediate_size"], c["vocab_size"])
    dt = c["torch_dtype"]
    return {
        "embed": ((v, d), "embed", dt),
        "final_norm": ((d,), None, "float32"),
        "norm_mixer": ((L, d), None, "float32"),
        "wq": ((L, d, h, hd), d, dt),
        "wk": ((L, d, kv, hd), d, dt),
        "wv": ((L, d, kv, hd), d, dt),
        "wo": ((L, h, hd, d), h * hd, dt),
        "norm_ffn": ((L, d), None, "float32"),
        "w_gate": ((L, d, f), d, dt),
        "w_up": ((L, d, f), d, dt),
        "w_down": ((L, f, d), f, dt),
        **({} if c["tie_word_embeddings"] else {"lm_head": ((d, v), d, dt)}),
    }


def encdec_shapes(c: dict) -> dict:
    """The encoder-decoder's leaves, ``enc_``/``dec_`` stacks."""
    d, h, hd, f, v = (c["hidden_size"], c["encoder_attention_heads"],
                      c["head_dim"], c["encoder_ffn_dim"], c["vocab_size"])
    dt = c["torch_dtype"]
    out = {"embed": ((v, d), "embed", dt),
           "enc_final_norm": ((d,), None, "float32"),
           "dec_final_norm": ((d,), None, "float32")}
    for stack, n, parts in (("enc", c["encoder_layers"], ("attn",)),
                            ("dec", c["decoder_layers"], ("attn", "cross"))):
        out[f"{stack}_norm_attn"] = ((n, d), None, "float32")
        for part in parts:
            if part == "cross":
                out[f"{stack}_norm_cross"] = ((n, d), None, "float32")
            out[f"{stack}_{part}_wq"] = ((n, d, h, hd), d, dt)
            out[f"{stack}_{part}_wk"] = ((n, d, h, hd), d, dt)
            out[f"{stack}_{part}_wv"] = ((n, d, h, hd), d, dt)
            out[f"{stack}_{part}_wo"] = ((n, h, hd, d), h * hd, dt)
        out[f"{stack}_norm_ffn"] = ((n, d), None, "float32")
        out[f"{stack}_w_gate"] = ((n, d, f), d, dt)
        out[f"{stack}_w_up"] = ((n, d, f), d, dt)
        out[f"{stack}_w_down"] = ((n, f, d), f, dt)
    return out


def make(shapes: dict, seed: int, device) -> dict:
    """Draw every leaf of ``shapes`` from ``seed`` on ``device``."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    out = {}
    for name, (shape, fan_in, dtype) in shapes.items():
        dt = DTYPES[dtype]
        if fan_in is None:
            out[name] = torch.ones(shape, dtype=dt, device=device)
        elif fan_in == "embed":
            out[name] = torch.randn(shape, generator=gen, dtype=dt,
                                    device=device).mul_(0.02)
        else:
            out[name] = _draw(gen, shape, fan_in, dt, device)
    return out


def lm_program_tree(w: dict) -> dict:
    """The port's decoder-LM parameter tree over the same tensors."""
    tree = {"embed": w["embed"], "final_norm": w["final_norm"],
            "segments": [[{
                "norm_mixer": w["norm_mixer"],
                "attn": {k: w[k] for k in ("wq", "wk", "wv", "wo")},
                "norm_ffn": w["norm_ffn"],
                "ffn": {k: w[k] for k in ("w_up", "w_down", "w_gate")},
            }]]}
    if "lm_head" in w:
        tree["lm_head"] = w["lm_head"]
    return tree


def encdec_program_tree(w: dict) -> dict:
    """The port's encoder-decoder tree over the same tensors."""
    def attn(prefix):
        return {k: w[f"{prefix}_{k}"] for k in ("wq", "wk", "wv", "wo")}

    def ffn(stack):
        return {k: w[f"{stack}_{k}"] for k in ("w_up", "w_down", "w_gate")}

    return {
        "embed": w["embed"], "enc_final_norm": w["enc_final_norm"],
        "dec_final_norm": w["dec_final_norm"],
        "encoder": {"norm_attn": w["enc_norm_attn"], "attn": attn("enc_attn"),
                    "norm_ffn": w["enc_norm_ffn"], "ffn": ffn("enc")},
        "decoder": {"norm_attn": w["dec_norm_attn"], "attn": attn("dec_attn"),
                    "norm_cross": w["dec_norm_cross"],
                    "cross": attn("dec_cross"),
                    "norm_ffn": w["dec_norm_ffn"], "ffn": ffn("dec")},
    }


def encdec_from_program_tree(t: dict) -> dict:
    """The inverse of :func:`encdec_program_tree` (the program's tree
    after a step, back in the benchmark's names)."""
    w = {"embed": t["embed"], "enc_final_norm": t["enc_final_norm"],
         "dec_final_norm": t["dec_final_norm"]}
    for stack, key in (("enc", "encoder"), ("dec", "decoder")):
        s = t[key]
        w[f"{stack}_norm_attn"] = s["norm_attn"]
        w[f"{stack}_norm_ffn"] = s["norm_ffn"]
        for k in ("wq", "wk", "wv", "wo"):
            w[f"{stack}_attn_{k}"] = s["attn"][k]
            if stack == "dec":
                w[f"dec_cross_{k}"] = s["cross"][k]
        if stack == "dec":
            w["dec_norm_cross"] = s["norm_cross"]
        for k in ("w_up", "w_down", "w_gate"):
            w[f"{stack}_{k}"] = s["ffn"][k]
    return w
