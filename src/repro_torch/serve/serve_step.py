"""Greedy sampling for the serving engine."""

from __future__ import annotations

import torch

__all__ = ["greedy_sample"]


def greedy_sample(logits: torch.Tensor) -> torch.Tensor:
    """(B, L, V) logits -> (B, 1) int32: argmax of the last position.

    ``torch.argmax`` returns the first maximum, as ``jnp.argmax`` does.
    """
    return torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)[:, None]
