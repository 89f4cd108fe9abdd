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

__all__ = ["n_diversifiers", "diversifiers", "baes_otps", "baes_encrypt",
           "baes_decrypt", "shared_otp_encrypt"]

_DIVERSIFIERS_PER_SCHEDULE = 10


def n_diversifiers(n_segments: int) -> int:
    """Number of extra key schedules needed for ``n_segments`` segments."""
    extra = max(0, n_segments - 1 - _DIVERSIFIERS_PER_SCHEDULE)
    return (extra + _DIVERSIFIERS_PER_SCHEDULE - 1) // _DIVERSIFIERS_PER_SCHEDULE


def _narrow_diversifiers(round_keys: torch.Tensor,
                         n_segments: int) -> torch.Tensor:
    """Rows 0..min(S, 11)-1: zeros, then round keys 1..10.

    (11, 16) schedule -> (min(S, 11), 16); a batch of schedules
    (..., 11, 16) gives (..., min(S, 11), 16).
    """
    take = min(n_segments - 1, _DIVERSIFIERS_PER_SCHEDULE)
    zero = torch.zeros(round_keys.shape[:-2] + (1, 16), dtype=torch.uint8,
                       device=round_keys.device)
    return torch.cat([zero, round_keys[..., 1: 1 + take, :]], dim=-2)


def _wide_diversifiers(key: torch.Tensor, counter_words: torch.Tensor,
                       n_segments: int) -> torch.Tensor:
    """Per-block extra diversifiers: (..., S - 11, 16) uint8 for (..., 4)
    counters; ``key`` is (16,) or broadcasts against the counters'
    (..., 16) bytes (one key per page)."""
    ctr_bytes = ctr.counter_blocks(counter_words)            # (..., 16)
    remaining = n_segments - 1 - _DIVERSIFIERS_PER_SCHEDULE
    extra = []
    for j in range(n_diversifiers(n_segments)):
        seed = key ^ ctr_bytes ^ (j + 1)
        sched = aes.key_expansion(seed)                      # (..., 11, 16)
        take = min(remaining, _DIVERSIFIERS_PER_SCHEDULE)
        extra.append(sched[..., 1: 1 + take, :])
        remaining -= take
    return torch.cat(extra, dim=-2)


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
    """OTPs of every segment of every wide block: (..., S, 16) uint8.

    ``counter_words`` is (..., 4) u32 (PA || VN per wide block).  One
    key, ``round_keys`` (11, 16) and ``key`` (16,), or one per page:
    counters (P, B, 4) with ``round_keys`` (P, 1, 11, 16) and ``key``
    (P, 1, 16) (the multi-tenant route).
    """
    base = ctr.ctr_keystream(round_keys, counter_words)      # (..., 16)
    narrow = _narrow_diversifiers(round_keys, n_segments)
    if n_segments - 1 <= _DIVERSIFIERS_PER_SCHEDULE:
        return base[..., None, :] ^ narrow
    if key is None:
        raise ValueError("wide-mode B-AES needs the raw key and counter words")
    wide = _wide_diversifiers(key, counter_words, n_segments)
    narrow = narrow.expand(base.shape[:-1] + narrow.shape[-2:])
    return base[..., None, :] ^ torch.cat([narrow, wide], dim=-2)


def baes_encrypt(plaintext: torch.Tensor, round_keys: torch.Tensor,
                 counter_words: torch.Tensor, *, block_bytes: int,
                 key: torch.Tensor | None = None) -> torch.Tensor:
    """Encrypt a uint8 buffer (numel % block_bytes == 0) with B-AES; keys
    as in :func:`baes_otps`."""
    otps = baes_otps(round_keys, counter_words,
                     n_segments=block_bytes // 16, key=key)
    return (plaintext.reshape(otps.shape) ^ otps).reshape(plaintext.shape)



# XOR stream cipher: decryption == encryption.
baes_decrypt = baes_encrypt


def shared_otp_encrypt(plaintext: torch.Tensor, round_keys: torch.Tensor,
                       counter_words: torch.Tensor, *,
                       block_bytes: int) -> torch.Tensor:
    """The INSECURE strawman (paper §III-B challenge 2): every 16 B
    segment of a wide block reuses the same OTP.  Exists so tests and
    examples can show the SECA attack succeeding against it."""
    blocks = plaintext.reshape(-1, block_bytes // 16, 16)
    base = ctr.ctr_keystream(round_keys, counter_words)      # (n, 16)
    return (blocks ^ base[:, None, :]).reshape(plaintext.shape)
