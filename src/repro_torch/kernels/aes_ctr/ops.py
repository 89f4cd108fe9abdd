"""Public wrappers of the AES-CTR keystream kernel."""

from __future__ import annotations

import torch

from repro_torch.kernels.aes_ctr.kernel import (aes_ctr_keystream,
                                                aes_ctr_keystream_multi)

__all__ = ["keystream_lanes", "keystream_bytes", "keystream_lanes_multi",
           "keystream_bytes_multi"]


def keystream_lanes(counter_words: torch.Tensor,
                    round_keys: torch.Tensor) -> torch.Tensor:
    """OTPs as (N, 4) u32 little-endian lanes (int32 storage)."""
    return aes_ctr_keystream(counter_words, round_keys)


def keystream_bytes(counter_words: torch.Tensor,
                    round_keys: torch.Tensor) -> torch.Tensor:
    """OTPs as (N, 16) uint8, the :mod:`repro_torch.core.ctr` layout."""
    lanes = keystream_lanes(counter_words, round_keys)
    return lanes.view(torch.uint8).reshape(lanes.shape[0], 16)


def keystream_lanes_multi(counter_words: torch.Tensor,
                          bank_round_keys: torch.Tensor,
                          row_idx: torch.Tensor) -> torch.Tensor:
    """Mixed-key OTPs: block ``i`` under ``bank_round_keys[row_idx[i]]``,
    as (N, 4) u32 lanes (int32 storage)."""
    return aes_ctr_keystream_multi(counter_words, bank_round_keys, row_idx)


def keystream_bytes_multi(counter_words: torch.Tensor,
                          bank_round_keys: torch.Tensor,
                          row_idx: torch.Tensor) -> torch.Tensor:
    """Mixed-key OTPs as (N, 16) uint8."""
    lanes = keystream_lanes_multi(counter_words, bank_round_keys, row_idx)
    return lanes.view(torch.uint8).reshape(lanes.shape[0], 16)
