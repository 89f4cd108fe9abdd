"""Full B-AES encryption built from the two kernels (the Crypt Engine of
Fig. 3(a)): the AES-CTR keystream kernel makes one base OTP per wide
block, the diversify + XOR kernel applies it to every segment.  Bytes
equal :func:`repro_torch.core.baes.baes_encrypt` in narrow mode.
"""

from __future__ import annotations

import torch

from repro_torch.core import baes
from repro_torch.core.bytesutil import bytes_to_u32, u32, u32_to_bytes
from repro_torch.kernels.aes_ctr.ops import keystream_lanes
from repro_torch.kernels.otp_xor.kernel import otp_xor

__all__ = ["otp_xor", "baes_encrypt_kernel"]


def _div_lanes(round_keys: torch.Tensor, n_segments: int) -> torch.Tensor:
    """Diversifiers as (S, 4) u32 lanes, int32 storage (row 0 = zeros)."""
    div_u8 = baes.diversifiers(round_keys, n_segments)        # (S, 16) u8
    return div_u8.contiguous().view(torch.int32).reshape(n_segments, 4)


def baes_encrypt_kernel(plaintext_u8: torch.Tensor, round_keys: torch.Tensor,
                        counter_words: torch.Tensor, *,
                        block_bytes: int) -> torch.Tensor:
    """Kernel-backed B-AES over a flat uint8 buffer (numel % block_bytes
    == 0); ``counter_words`` (n_blocks, 4) u32, int32 or int64 storage.

    Narrow mode only (at most 11 segments: segment 0 keeps the base OTP,
    1..10 take round keys 1..10); wide mode derives per-block schedules
    and stays in plain :mod:`repro_torch.core.baes`.  XOR cipher, so it
    decrypts too.
    """
    n_segments = block_bytes // 16
    if baes.n_diversifiers(n_segments):
        raise ValueError("kernel path supports narrow mode (<= 11 segments); "
                         "use repro_torch.core.baes for wide mode")
    base = keystream_lanes(u32(counter_words), round_keys)    # (N, 4)
    data = bytes_to_u32(plaintext_u8).reshape(-1, n_segments * 4)
    ct = otp_xor(data, base, _div_lanes(round_keys, n_segments))
    return u32_to_bytes(ct).reshape(plaintext_u8.shape)
