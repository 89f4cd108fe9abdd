"""The encoder-decoder (seamless-m4t-large-v2): ``enc_``/``dec_`` stacks
of attention and a gated FFN, the decoder with cross-attention.

The harness loads this file by the ``family`` that a configuration file
names; the training driver takes from it the weights' layout, the port's
configuration and tree (both ways), and the model FLOPs of a step.
"""

from __future__ import annotations

import dataclasses


def shapes(c: dict) -> dict:
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


def program_config(c: dict):
    """``(arch, EncDecConfig)`` of the port with the file's sizes."""
    from repro_torch.configs import get_arch
    arch = get_arch(c["port_arch"])
    cfg = dataclasses.replace(
        arch.make_config(), enc_layers=c["encoder_layers"],
        dec_layers=c["decoder_layers"], d_model=c["hidden_size"],
        n_heads=c["encoder_attention_heads"],
        n_kv=c["encoder_attention_heads"], head_dim=c["head_dim"],
        d_ff=c["encoder_ffn_dim"], vocab=c["vocab_size"],
        dtype=c["torch_dtype"], remat=c["remat"])
    return arch, cfg


def program_tree(w: dict) -> dict:
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


def from_program_tree(t: dict) -> dict:
    """The inverse of :func:`program_tree` (the program's tree after a
    step, back in the benchmark's names)."""
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


def layer_params(c: dict) -> tuple:
    """``(encoder layer, decoder layer)`` matmul weights: attention q, k,
    v, o; the decoder's cross-attention the same again; the gated
    FFN."""
    d, h, hd, f = (c["hidden_size"], c["encoder_attention_heads"],
                   c["head_dim"], c["encoder_ffn_dim"])
    attn = 4 * d * h * hd
    ffn = 3 * d * f
    return attn + ffn, 2 * attn + ffn


def train_flops(c: dict, batch: int, src: int, tgt: int) -> float:
    """Model FLOPs of one training step: 6 x the matmul weights each
    token passes (source frames through the encoder, target tokens
    through the decoder and the head), plus 3 x the attention forward
    (self over the source, causal self and cross over the target)."""
    enc, dec = layer_params(c)
    d, vocab = c["hidden_size"], c["vocab_size"]
    le, ld = c["encoder_layers"], c["decoder_layers"]
    matmul = batch * (src * le * enc + tgt * (ld * dec + d * vocab))
    hd = c["encoder_attention_heads"] * c["head_dim"]
    attn = batch * (le * 4 * hd * src * src
                    + ld * 4 * hd * tgt * (tgt + 1) / 2
                    + ld * 4 * hd * tgt * src)
    return 6.0 * matmul + 3.0 * attn
