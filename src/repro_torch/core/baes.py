"""Bandwidth-aware encryption (B-AES), the paper's §III-B mechanism.

A wide block of ``block_bytes`` is encrypted with ONE AES invocation:
base OTP = AES-CTR_{Ke}(PA || VN), and segment ``i`` XORs the base OTP
with diversifier ``i`` (segment 0: zero; segments 1..10: round keys
1..10).  Wide mode (more than 11 segments, e.g. ``seda512``) derives
extra schedules from ``key ^ (PA || VN) ^ (j + 1)`` per block.
"""

from __future__ import annotations

import torch

from repro_torch.core import aes, ctr

__all__ = ["n_diversifiers", "diversifiers", "baes_otps", "baes_encrypt"]

_DIVERSIFIERS_PER_SCHEDULE = 10


def n_diversifiers(n_segments: int) -> int:
    """Number of extra key schedules needed for ``n_segments`` segments."""
    extra = max(0, n_segments - 1 - _DIVERSIFIERS_PER_SCHEDULE)
    return (extra + _DIVERSIFIERS_PER_SCHEDULE - 1) // _DIVERSIFIERS_PER_SCHEDULE


def _narrow_diversifiers(round_keys: torch.Tensor,
                         n_segments: int) -> torch.Tensor:
    """Rows 0..min(S, 11)-1: zeros, then round keys 1..10."""
    take = min(n_segments - 1, _DIVERSIFIERS_PER_SCHEDULE)
    zero = torch.zeros((1, 16), dtype=torch.uint8, device=round_keys.device)
    return torch.cat([zero, round_keys[1: 1 + take]], dim=0)


def _wide_diversifiers(key: torch.Tensor, counter_words: torch.Tensor,
                       n_segments: int) -> torch.Tensor:
    """Per-block extra diversifiers: (N, S - 11, 16) uint8."""
    ctr_bytes = ctr.counter_blocks(counter_words)            # (N, 16)
    remaining = n_segments - 1 - _DIVERSIFIERS_PER_SCHEDULE
    extra = []
    for j in range(n_diversifiers(n_segments)):
        seed = key[None, :] ^ ctr_bytes ^ (j + 1)
        sched = aes.key_expansion(seed)                      # (N, 11, 16)
        take = min(remaining, _DIVERSIFIERS_PER_SCHEDULE)
        extra.append(sched[:, 1: 1 + take])
        remaining -= take
    return torch.cat(extra, dim=1)


def diversifiers(round_keys: torch.Tensor, n_segments: int,
                 counter_words: torch.Tensor | None = None,
                 key: torch.Tensor | None = None) -> torch.Tensor:
    """Per-segment XOR diversifiers of one block: (n_segments, 16) uint8.

    Wide mode needs the raw ``key`` and that block's ``(4,)`` counter.
    """
    narrow = _narrow_diversifiers(round_keys, n_segments)
    if n_segments - 1 <= _DIVERSIFIERS_PER_SCHEDULE:
        return narrow
    if key is None or counter_words is None:
        raise ValueError("wide-mode B-AES needs the raw key and counter words")
    wide = _wide_diversifiers(key, counter_words.reshape(1, 4), n_segments)
    return torch.cat([narrow, wide[0]], dim=0)


def baes_otps(round_keys: torch.Tensor, counter_words: torch.Tensor, *,
              n_segments: int,
              key: torch.Tensor | None = None) -> torch.Tensor:
    """OTPs of every segment of every wide block: (N, S, 16) uint8.

    ``counter_words`` is (N, 4) u32 (PA || VN per wide block).
    """
    base = ctr.ctr_keystream(round_keys, counter_words)      # (N, 16)
    narrow = _narrow_diversifiers(round_keys, n_segments)
    if n_segments - 1 <= _DIVERSIFIERS_PER_SCHEDULE:
        return base[:, None, :] ^ narrow[None, :, :]
    if key is None:
        raise ValueError("wide-mode B-AES needs the raw key and counter words")
    wide = _wide_diversifiers(key, counter_words, n_segments)
    div = torch.cat([narrow[None].expand(base.shape[0], -1, -1), wide], dim=1)
    return base[:, None, :] ^ div


def baes_encrypt(plaintext: torch.Tensor, round_keys: torch.Tensor,
                 counter_words: torch.Tensor, *, block_bytes: int,
                 key: torch.Tensor | None = None) -> torch.Tensor:
    """Encrypt a flat uint8 buffer (len % block_bytes == 0) with B-AES."""
    n_segments = block_bytes // 16
    blocks = plaintext.reshape(-1, n_segments, 16)
    otps = baes_otps(round_keys, counter_words, n_segments=n_segments,
                     key=key)
    return (blocks ^ otps).reshape(plaintext.shape)

