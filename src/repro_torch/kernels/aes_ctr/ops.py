"""Public wrappers of the AES-CTR keystream kernel."""

from __future__ import annotations

import torch

from repro_torch.kernels.aes_ctr.kernel import aes_ctr_keystream

__all__ = ["keystream_lanes", "keystream_bytes"]


def keystream_lanes(counter_words: torch.Tensor,
                    round_keys: torch.Tensor) -> torch.Tensor:
    """OTPs as (N, 4) u32 little-endian lanes (int32 storage)."""
    return aes_ctr_keystream(counter_words, round_keys)


def keystream_bytes(counter_words: torch.Tensor,
                    round_keys: torch.Tensor) -> torch.Tensor:
    """OTPs as (N, 16) uint8, the :mod:`repro_torch.core.ctr` layout."""
    lanes = keystream_lanes(counter_words, round_keys)
    return lanes.view(torch.uint8).reshape(lanes.shape[0], 16)
