"""AES-CTR with SeDA's counter construction (paper Eq. 1/2).

counter = PA (64b) || VN (64b), carried as four u32 words
``[pa_hi, pa_lo, vn_hi, vn_lo]`` and serialized big-endian per word.
This is the T-AES route of the ``sgx*`` and ``mgx*`` schemes: one AES
invocation per 16 B segment.
"""

from __future__ import annotations

import torch

from repro_torch.core import aes
from repro_torch.core.bytesutil import i64

__all__ = ["counter_blocks", "ctr_keystream"]


def counter_blocks(words: torch.Tensor) -> torch.Tensor:
    """(..., 4) u32 counter words -> (..., 16) uint8 counter blocks,
    each word big-endian."""
    w = i64(words)
    shifts = torch.tensor([24, 16, 8, 0], dtype=torch.int64,
                          device=w.device)
    per_word = (w[..., :, None] >> shifts) & 0xFF
    return per_word.to(torch.uint8).reshape(words.shape[:-1] + (16,))


def ctr_keystream(round_keys: torch.Tensor,
                  counter_words: torch.Tensor) -> torch.Tensor:
    """OTP = AES-CTR_{Ke}(PA || VN): (..., 4) u32 counters -> (..., 16) u8."""
    return aes.aes128_encrypt_block(counter_blocks(counter_words), round_keys)
