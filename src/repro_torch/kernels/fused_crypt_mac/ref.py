"""Plain PyTorch versions of the fused crypt + NH kernels."""

from __future__ import annotations

import torch

from repro_torch.core import mac
from repro_torch.core.bytesutil import u32
from repro_torch.kernels.otp_xor.ref import otp_xor_ref

__all__ = ["otp_xor_ref", "fused_crypt_mac_ref", "fused_crypt_mac_write_ref",
           "fused_crypt_mac_mixed_ref", "fused_crypt_mac_write_mixed_ref"]


def _nh_pairs(lanes: torch.Tensor, bind_words: torch.Tensor,
              key_u32: torch.Tensor) -> torch.Tensor:
    hi, lo = mac.nh_hash(torch.cat([lanes, bind_words], dim=-1), key_u32)
    return u32(torch.stack([hi, lo], dim=-1))


def fused_crypt_mac_ref(ct_lanes: torch.Tensor, base_otp_lanes: torch.Tensor,
                        div_lanes: torch.Tensor, bind_words: torch.Tensor,
                        key_u32: torch.Tensor):
    """Decrypt wide blocks AND hash them (over the ciphertext).

    ct (N, 4S), base (N, 4), div (S, 4), bind (N, 8), key (4S + 8,), all
    u32 in int32 storage.  Returns (plaintext lanes (N, 4S), NH (N, 2)).
    """
    pt = otp_xor_ref(ct_lanes, base_otp_lanes, div_lanes)
    return pt, _nh_pairs(ct_lanes, bind_words, key_u32)


def fused_crypt_mac_write_ref(pt_lanes: torch.Tensor,
                              base_otp_lanes: torch.Tensor,
                              div_lanes: torch.Tensor,
                              bind_words: torch.Tensor,
                              key_u32: torch.Tensor):
    """Encrypt, then hash the FRESH ciphertext (same shapes as the read)."""
    ct = otp_xor_ref(pt_lanes, base_otp_lanes, div_lanes)
    return ct, _nh_pairs(ct, bind_words, key_u32)


def _gather_rows(div_bank: torch.Tensor, key_bank: torch.Tensor,
                 row_idx: torch.Tensor):
    """Per-block tables from the banks: div (N, S, 4), key (N, 4S + 8)."""
    rows = row_idx.to(torch.int64)
    return div_bank[rows], key_bank[rows]


def fused_crypt_mac_mixed_ref(ct_lanes: torch.Tensor,
                              base_otp_lanes: torch.Tensor,
                              div_bank: torch.Tensor,
                              bind_words: torch.Tensor,
                              key_bank: torch.Tensor,
                              row_idx: torch.Tensor):
    """Mixed-key decrypt + NH: block ``i`` uses diversifiers
    ``div_bank[row_idx[i]]`` (bank (K, S, 4)) and NH key
    ``key_bank[row_idx[i]]`` (bank (K, 4S + 8)).  The per-block tables
    are gathered in full, as the TPU kernel's caller does."""
    div, key = _gather_rows(div_bank, key_bank, row_idx)
    pt = otp_xor_ref(ct_lanes, base_otp_lanes, div)
    return pt, _nh_pairs(ct_lanes, bind_words, key)


def fused_crypt_mac_write_mixed_ref(pt_lanes: torch.Tensor,
                                    base_otp_lanes: torch.Tensor,
                                    div_bank: torch.Tensor,
                                    bind_words: torch.Tensor,
                                    key_bank: torch.Tensor,
                                    row_idx: torch.Tensor):
    """Mixed-key encrypt, then NH of the fresh ciphertext."""
    div, key = _gather_rows(div_bank, key_bank, row_idx)
    ct = otp_xor_ref(pt_lanes, base_otp_lanes, div)
    return ct, _nh_pairs(ct, bind_words, key)
