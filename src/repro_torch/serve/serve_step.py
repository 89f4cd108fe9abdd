"""Serve steps (prefill and one-token decode) and greedy sampling.

The port of ``repro.serve.serve_step``: the unprotected dense loop of
the launcher's ``--engine simple`` (a prefill over the batch, then one
token per step against the dense KV cache).  For the encoder-decoder
(``arch.kind == "encdec"``) the prefill encodes ``src_embeds`` and runs
the decoder over ``tgt_tokens``; decode steps the decoder against its
self-attention cache and the cached cross K/V.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models import encdec as ed
from repro_torch.models import lm as lm_mod
from repro_torch.obs import trace as trace_mod

__all__ = ["make_prefill_step", "make_decode_step", "greedy_sample"]


def greedy_sample(logits: torch.Tensor) -> torch.Tensor:
    """(B, L, V) logits -> (B, 1) int32: argmax of the last position.

    ``torch.argmax`` returns the first maximum, as ``jnp.argmax`` does.
    """
    with trace_mod.span("model.sample"):
        return torch.argmax(logits[:, -1, :], dim=-1).to(
            torch.int32)[:, None]


def make_prefill_step(arch, cfg, max_len: int) -> Callable:
    """prefill(params, {"tokens": (B, L)}) -> (logits, caches); for
    encdec, ``{"src_embeds": (B, S, d), "tgt_tokens": (B, L)}``."""
    if arch.kind == "encdec":
        def prefill(params, batch):
            return ed.decoder_prefill(cfg, params, batch, max_len)
        return prefill

    def prefill(params, batch):
        return lm_mod.lm_prefill(cfg, params, batch, max_len)
    return prefill


def make_decode_step(arch, cfg) -> Callable:
    """decode(params, tokens (B, 1), caches) -> (logits, new caches)."""
    if arch.kind == "encdec":
        def decode(params, tokens, caches):
            return ed.decoder_decode(cfg, params, tokens, caches)
        return decode

    def decode(params, tokens, caches):
        return lm_mod.lm_decode(cfg, params, tokens, caches)
    return decode
