"""Plain PyTorch versions of the AES-CTR keystream kernels.

It reuses the FIPS-validated cipher of :mod:`repro_torch.core.aes`, so the
kernel's bytes chain back to FIPS-197.
"""

from __future__ import annotations

import torch

from repro_torch.core import ctr

__all__ = ["aes_ctr_keystream_ref", "aes_ctr_keystream_lanes_ref",
           "aes_ctr_keystream_multi_lanes_ref"]


def aes_ctr_keystream_ref(counter_words: torch.Tensor,
                          round_keys: torch.Tensor) -> torch.Tensor:
    """(N, 4) u32 counters + (11, 16) uint8 schedule -> (N, 16) uint8 OTPs."""
    return ctr.ctr_keystream(round_keys, counter_words)


def aes_ctr_keystream_lanes_ref(counter_words: torch.Tensor,
                                round_keys: torch.Tensor) -> torch.Tensor:
    """The same OTPs as (N, 4) little-endian u32 lanes (int32 storage),
    the kernel's output layout."""
    otp = aes_ctr_keystream_ref(counter_words, round_keys)
    return otp.contiguous().view(torch.int32).reshape(otp.shape[0], 4)


def aes_ctr_keystream_multi_lanes_ref(counter_words: torch.Tensor,
                                      bank_round_keys: torch.Tensor,
                                      row_idx: torch.Tensor) -> torch.Tensor:
    """Mixed-key OTP lanes: block ``i`` under schedule
    ``bank_round_keys[row_idx[i]]``.  (N, 4) counters, (K, 11, 16) bank,
    (N,) rows -> (N, 4) u32 lanes (int32 storage).

    The per-block schedule table is gathered in full, as the TPU
    kernel's caller does.
    """
    per_block = bank_round_keys[row_idx.to(torch.int64)]      # (N, 11, 16)
    otp = ctr.ctr_keystream(per_block, counter_words)
    return otp.contiguous().view(torch.int32).reshape(otp.shape[0], 4)
