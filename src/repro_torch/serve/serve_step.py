"""Serve steps (prefill and one-token decode) and greedy sampling.

The port of ``repro.serve.serve_step``: the unprotected dense loop of
the launcher's ``--engine simple`` (a prefill over the batch, then one
token per step against the dense KV cache).  Decoder-only LMs only: the
encoder-decoder branch waits for its model family.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models import lm as lm_mod

__all__ = ["make_prefill_step", "make_decode_step", "greedy_sample"]


def greedy_sample(logits: torch.Tensor) -> torch.Tensor:
    """(B, L, V) logits -> (B, 1) int32: argmax of the last position.

    ``torch.argmax`` returns the first maximum, as ``jnp.argmax`` does.
    """
    return torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)[:, None]


def _lm_only(arch) -> None:
    if arch.kind != "lm":
        raise NotImplementedError(f"serve steps for {arch.kind!r} models are "
                                  "not ported (decoder-only LMs only)")


def make_prefill_step(arch, cfg, max_len: int) -> Callable:
    """prefill(params, {"tokens": (B, L)}) -> (logits, caches)."""
    _lm_only(arch)

    def prefill(params, batch):
        return lm_mod.lm_prefill(cfg, params, batch, max_len)
    return prefill


def make_decode_step(arch, cfg) -> Callable:
    """decode(params, tokens (B, 1), caches) -> (logits, new caches)."""
    _lm_only(arch)

    def decode(params, tokens, caches):
        return lm_mod.lm_decode(cfg, params, tokens, caches)
    return decode
