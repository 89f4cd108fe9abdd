"""Plain PyTorch version of the AES-CTR keystream kernel.

It reuses the FIPS-validated cipher of :mod:`repro_torch.core.aes`, so the
kernel's bytes chain back to FIPS-197.
"""

from __future__ import annotations

import torch

from repro_torch.core import ctr

__all__ = ["aes_ctr_keystream_ref", "aes_ctr_keystream_lanes_ref"]


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
