"""A family for the tests: the port's MoE decoder LM (olmoe-1b-7b), GQA
attention and a routed-expert FFN in every layer, one uniform segment.

It shows that an architecture other than the dense LM reaches the
serving driver from new files alone: its own weights' layout and tree,
FLOPs that count only the ``num_experts_per_tok`` experts a token
reaches (and the router), and KV pages of every layer.
"""

from __future__ import annotations

import dataclasses


def shapes(c: dict) -> dict:
    """``{name: (shape, fan_in or None for ones, dtype)}`` in draw
    order; an untied head is drawn last."""
    L, d, h, kv, hd, f, e, v = (c["num_hidden_layers"], c["hidden_size"],
                                c["num_attention_heads"],
                                c["num_key_value_heads"], c["head_dim"],
                                c["intermediate_size"], c["num_experts"],
                                c["vocab_size"])
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
        "router": ((L, d, e), d, "float32"),
        "w_gate": ((L, e, d, f), d, dt),
        "w_up": ((L, e, d, f), d, dt),
        "w_down": ((L, e, f, d), f, dt),
        **({} if c["tie_word_embeddings"] else {"lm_head": ((d, v), d, dt)}),
    }


def program_config(c: dict):
    """``(arch, LMConfig)`` of the port with the file's sizes."""
    from repro_torch.configs import get_arch
    from repro_torch.models.moe import MoEConfig
    arch = get_arch(c["port_arch"])
    cfg = dataclasses.replace(
        arch.make_config(), n_layers=c["num_hidden_layers"],
        d_model=c["hidden_size"], n_heads=c["num_attention_heads"],
        n_kv=c["num_key_value_heads"], head_dim=c["head_dim"],
        d_ff=c["intermediate_size"], vocab=c["vocab_size"],
        dtype=c["torch_dtype"], tie_embeddings=c["tie_word_embeddings"],
        moe=MoEConfig(n_experts=c["num_experts"],
                      top_k=c["num_experts_per_tok"],
                      d_model=c["hidden_size"], d_ff=c["intermediate_size"],
                      capacity_factor=c["capacity_factor"]))
    return arch, cfg


def program_tree(w: dict) -> dict:
    """The port's MoE-LM parameter tree over the same tensors."""
    tree = {"embed": w["embed"], "final_norm": w["final_norm"],
            "segments": [[{
                "norm_mixer": w["norm_mixer"],
                "attn": {k: w[k] for k in ("wq", "wk", "wv", "wo")},
                "norm_ffn": w["norm_ffn"],
                "moe": {k: w[k] for k in ("router", "w_gate", "w_up",
                                          "w_down")},
            }]]}
    if "lm_head" in w:
        tree["lm_head"] = w["lm_head"]
    return tree


def matmul_params(c: dict) -> int:
    """Weights one token multiplies through: q, k, v, o, the router and
    the gated FFNs of the experts it is routed to, and the head."""
    d, h, kv, hd, f = (c["hidden_size"], c["num_attention_heads"],
                       c["num_key_value_heads"], c["head_dim"],
                       c["intermediate_size"])
    attn = d * h * hd + 2 * d * kv * hd + h * hd * d
    ffn = d * c["num_experts"] + c["num_experts_per_tok"] * 3 * d * f
    return c["num_hidden_layers"] * (attn + ffn) + d * c["vocab_size"]


def attn_flops(c: dict, context: int) -> float:
    """Scores and weighted values of one query over ``context`` keys."""
    return (4.0 * c["num_attention_heads"] * c["head_dim"] * context
            * c["num_hidden_layers"])


def decode_flops(c: dict, context: int) -> float:
    return 2.0 * matmul_params(c) + attn_flops(c, context)


def prefill_flops(c: dict, n: int) -> float:
    return (2.0 * matmul_params(c) * n
            + attn_flops(c, 1) * n * (n + 1) / 2)


def page_bytes(c: dict, page_tokens: int, block_bytes: int) -> int:
    """K and V of ``page_tokens`` tokens over every layer, each layer's
    share padded to the protection block."""
    per_layer = page_tokens * c["num_key_value_heads"] * c["head_dim"] * 2
    per_layer = -(-per_layer // block_bytes) * block_bytes
    return 2 * c["num_hidden_layers"] * per_layer
