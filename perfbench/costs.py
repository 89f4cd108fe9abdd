"""The yardstick: the card's published peaks and the work a cell requires.

Every count here is computed from a configuration file's numbers and the
shapes a tick or a step used, never from what the program allocates or
launches, so it reads the same work whatever implements it.

Peaks (NVIDIA H100 SXM data sheet, dense rates, at the 700 W limit):

* ``BF16_FLOPS`` 989e12: the tensor-core bf16 rate, the denominator of
  every ``mfu`` metric;
* ``HBM_BYTES_PER_S`` 3.35e12;
* ``INT_OPS_PER_S`` 67e12: the data sheet gives no 32-bit integer rate,
  so the float32 rate outside the tensor cores stands in for it.  This
  is an assumed peak, named as such wherever a share is reported
  against it.
"""

from __future__ import annotations

BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12
INT_OPS_PER_S = 67e12

# One AES-128 block evaluation (16 bytes of keystream): 9 rounds of 16
# bytes x 7 operations, the last round's 16 x 2, the first AddRoundKey's
# 16.
AES_OPS = 1056
SEGMENT_BYTES = 16
PAGE_MAC_BYTES = 8


def bound_s(nbytes: float, ops: float) -> tuple:
    """``(seconds, "bytes" | "operations")``: the least time the card
    takes to move ``nbytes`` through HBM and do ``ops`` integer
    operations, and which of the two bounds it."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / INT_OPS_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# -- the decoder LM (minitron-4b) ------------------------------------------

def lm_matmul_params(c: dict) -> int:
    """Weights one token multiplies through: q, k, v, o, the gated FFN
    and the head, over every layer."""
    d, h, kv, hd, f = (c["hidden_size"], c["num_attention_heads"],
                       c["num_key_value_heads"], c["head_dim"],
                       c["intermediate_size"])
    attn = d * h * hd + 2 * d * kv * hd + h * hd * d
    ffn = 3 * d * f
    return c["num_hidden_layers"] * (attn + ffn) + d * c["vocab_size"]


def lm_attn_flops(c: dict, context: int) -> float:
    """Scores and weighted values of one query over ``context`` keys."""
    return (4.0 * c["num_attention_heads"] * c["head_dim"] * context
            * c["num_hidden_layers"])


def lm_decode_flops(c: dict, context: int) -> float:
    """One decoded token attending over ``context`` positions."""
    return 2.0 * lm_matmul_params(c) + lm_attn_flops(c, context)


def lm_prefill_flops(c: dict, n: int) -> float:
    """A causal prefill of ``n`` prompt tokens (pads excluded)."""
    return (2.0 * lm_matmul_params(c) * n
            + lm_attn_flops(c, 1) * n * (n + 1) / 2)


def kv_page_bytes(c: dict, page_tokens: int, block_bytes: int) -> int:
    """Ciphertext bytes of one KV page: k and v of ``page_tokens`` tokens
    over every layer, each layer's share padded to the protection
    block."""
    per_layer = page_tokens * c["num_key_value_heads"] * c["head_dim"] * 2
    per_layer = -(-per_layer // block_bytes) * block_bytes
    return 2 * c["num_hidden_layers"] * per_layer


def crossing_ops(nbytes: float, block_bytes: int) -> float:
    """SeDA's integer work over ``nbytes`` of one crossing: per
    protection block one AES evaluation for the B-AES base pad and one
    for the MAC finalizer, the segment XORs and the NH pairs."""
    segments = block_bytes // SEGMENT_BYTES
    blocks = nbytes / block_bytes
    return blocks * (2 * AES_OPS + 16 * segments + 16)


def page_crossing_work(c: dict, deploy: dict, pages_read: int,
                       pages_written: int) -> tuple:
    """``(bytes, ops)`` a tick's crossings require: the ciphertext and
    page MACs of the pages read and of the pages written."""
    page = kv_page_bytes(c, deploy["page_tokens"], deploy["block_bytes"])
    pages = pages_read + pages_written
    nbytes = pages * (page + PAGE_MAC_BYTES)
    return nbytes, crossing_ops(pages * page, deploy["block_bytes"])


# -- the encoder-decoder (seamless-m4t-large-v2) ----------------------------

def encdec_layer_params(c: dict) -> tuple:
    """``(encoder layer, decoder layer)`` matmul weights: attention q, k,
    v, o; the decoder's cross-attention the same again; the gated
    FFN."""
    d, h, hd, f = (c["hidden_size"], c["encoder_attention_heads"],
                   c["head_dim"], c["encoder_ffn_dim"])
    attn = 4 * d * h * hd
    ffn = 3 * d * f
    return attn + ffn, 2 * attn + ffn


def encdec_train_flops(c: dict, batch: int, src: int, tgt: int) -> float:
    """Model FLOPs of one training step: 6 x the matmul weights each
    token passes (source frames through the encoder, target tokens
    through the decoder and the head), plus 3 x the attention forward
    (self over the source, causal self and cross over the target)."""
    enc, dec = encdec_layer_params(c)
    d, vocab = c["hidden_size"], c["vocab_size"]
    le, ld = c["encoder_layers"], c["decoder_layers"]
    matmul = batch * (src * le * enc + tgt * (ld * dec + d * vocab))
    hd = c["encoder_attention_heads"] * c["head_dim"]
    attn = batch * (le * 4 * hd * src * src
                    + ld * 4 * hd * tgt * (tgt + 1) / 2
                    + ld * 4 * hd * tgt * src)
    return 6.0 * matmul + 3.0 * attn


def adamw_bytes(n_params: int, param_bytes: int, grad_bytes: int,
                moment_bytes: int) -> int:
    """Each parameter, gradient and both moments read once; each
    parameter and both moments written once."""
    return n_params * (2 * param_bytes + grad_bytes + 4 * moment_bytes)


def weights_crossing_work(plain_bytes: int, block_bytes: int) -> tuple:
    """``(bytes, ops)`` of one unprotect and one protect of the weights:
    ciphertext in and plaintext out, plaintext in and ciphertext out,
    and the crossing operations each way.  The block MACs fold into one
    tag per layer on the chip, so no tag traffic is counted."""
    return 4 * plain_bytes, 2 * crossing_ops(plain_bytes, block_bytes)
