"""AES-CTR with SeDA's counter construction (paper Eq. 1/2).

counter = PA (64b) || VN (64b), carried as four u32 words
``[pa_hi, pa_lo, vn_hi, vn_lo]`` and serialized big-endian per word.
This is the T-AES route of the ``sgx*`` and ``mgx*`` schemes: one AES
invocation per 16 B segment.
"""

from __future__ import annotations

import torch

from repro_torch.core import aes
from repro_torch.core.bytesutil import MASK32, i64

__all__ = ["counter_blocks", "ctr_keystream", "ctr_encrypt", "ctr_decrypt"]


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


def ctr_encrypt(plaintext: torch.Tensor, round_keys: torch.Tensor, pa_hi,
                pa_lo, vn_hi, vn_lo) -> torch.Tensor:
    """T-AES: one AES call per 16 B segment of a flat uint8 buffer; the
    segment at byte ``16 * i`` uses counter ``(PA + i) || VN`` (the
    64-bit PA carries from ``pa_lo`` into ``pa_hi``)."""
    segs = plaintext.reshape(-1, 16)
    lo = int(pa_lo) + torch.arange(segs.shape[0], dtype=torch.int64,
                                   device=segs.device)
    hi = (int(pa_hi) + (lo >> 32)) & MASK32
    vn = torch.tensor([int(vn_hi), int(vn_lo)], dtype=torch.int64,
                      device=segs.device).expand(segs.shape[0], 2)
    counters = torch.cat([torch.stack([hi, lo & MASK32], dim=-1), vn], dim=-1)
    otp = ctr_keystream(round_keys, counters)
    return (segs ^ otp).reshape(plaintext.shape)


# CTR decryption is the same operation (Eq. 2).
ctr_decrypt = ctr_encrypt
