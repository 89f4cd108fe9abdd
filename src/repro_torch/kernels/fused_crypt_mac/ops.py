"""Fused secure read and write of flat buffers.

``secure_read_kernel`` decrypts and hashes incoming ciphertext;
``secure_write_kernel`` encrypts and hashes the fresh ciphertext.  Each
is three kernel calls: the AES keystream for the base pads, the fused
crypt + NH pass, and the AES keystream again over
:func:`repro_torch.core.mac.finalize_words` for the MAC pads.  The
``_mixed`` variants take a key bank and one bank row per optBlk, so one
call serves pages owned by different (tenant, epoch) rows; their three
calls are the mixed-key kernels.
"""

from __future__ import annotations

import torch

from repro_torch.core import baes, mac
from repro_torch.core.bytesutil import bytes_to_u32, i64, u32, u32_to_bytes
from repro_torch.kernels.aes_ctr.ops import (keystream_bytes,
                                             keystream_bytes_multi,
                                             keystream_lanes,
                                             keystream_lanes_multi)
from repro_torch.kernels.fused_crypt_mac.kernel import (
    MAX_SEGMENTS, fused_crypt_mac, fused_crypt_mac_mixed,
    fused_crypt_mac_write, fused_crypt_mac_write_mixed)
from repro_torch.kernels.otp_xor.ops import _div_lanes

__all__ = ["secure_read_kernel", "secure_write_kernel",
           "secure_read_kernel_mixed", "secure_write_kernel_mixed",
           "fused_crypt_mac", "fused_crypt_mac_write",
           "fused_crypt_mac_mixed", "fused_crypt_mac_write_mixed"]


def _div_bank(bank_round_keys: torch.Tensor, n_segments: int) -> torch.Tensor:
    """Diversifiers of every bank row as (K, S, 4) u32 lanes (int32
    storage): a function of each row's schedule, built once per call."""
    div_u8 = baes.diversifiers(bank_round_keys, n_segments)   # (K, S, 16)
    return div_u8.contiguous().view(torch.int32).reshape(
        bank_round_keys.shape[0], n_segments, 4)


def _secure_crossing(data_u8: torch.Tensor, binding: mac.Binding,
                     round_keys: torch.Tensor, counter_words: torch.Tensor,
                     hash_key_u32: torch.Tensor, kernel, *,
                     block_bytes: int):
    """Single-key crossing: one fused pass + AES MAC finalization.

    Read and write share every step but the fused ``kernel`` body (hash
    the incoming vs. the outgoing bytes).
    """
    n_segments = block_bytes // 16
    if n_segments > MAX_SEGMENTS:
        raise ValueError("kernel path supports narrow mode (<= 11 segments)")
    base = keystream_lanes(u32(counter_words), round_keys)
    data = bytes_to_u32(data_u8).reshape(-1, n_segments * 4)
    div = _div_lanes(round_keys, n_segments)
    bind_words = u32(binding.words(data.shape[0]))
    key = hash_key_u32[: data.shape[1] + 8].to(torch.int32).contiguous()
    out_lanes, hashes = kernel(data, base, div, bind_words, key)
    fin = mac.finalize_words(i64(hashes[:, 0]), i64(hashes[:, 1]), binding)
    pads = keystream_bytes(u32(fin), round_keys)
    out = u32_to_bytes(out_lanes).reshape(data_u8.shape)
    return out, pads[:, : mac.MAC_BYTES]


def _secure_crossing_mixed(data_u8: torch.Tensor, binding: mac.Binding,
                           bank_round_keys: torch.Tensor,
                           counter_words: torch.Tensor,
                           bank_hash_key: torch.Tensor,
                           row_idx: torch.Tensor, kernel, *,
                           block_bytes: int):
    """Mixed-key crossing: the three calls of :func:`_secure_crossing`,
    each block under bank row ``row_idx[i]``.  The kernels take the bank
    and the rows; no per-block key table is built."""
    n_segments = block_bytes // 16
    if n_segments > MAX_SEGMENTS:
        raise ValueError("kernel path supports narrow mode (<= 11 segments)")
    rows = row_idx.to(torch.int32).contiguous()
    base = keystream_lanes_multi(u32(counter_words), bank_round_keys, rows)
    data = bytes_to_u32(data_u8).reshape(-1, n_segments * 4)
    div_bank = _div_bank(bank_round_keys, n_segments)
    bind_words = u32(binding.words(data.shape[0]))
    key_bank = bank_hash_key[:, : data.shape[1] + 8].to(
        torch.int32).contiguous()
    out_lanes, hashes = kernel(data, base, div_bank, bind_words, key_bank,
                               rows)
    fin = mac.finalize_words(i64(hashes[:, 0]), i64(hashes[:, 1]), binding)
    pads = keystream_bytes_multi(u32(fin), bank_round_keys, rows)
    out = u32_to_bytes(out_lanes).reshape(data_u8.shape)
    return out, pads[:, : mac.MAC_BYTES]


def secure_read_kernel(ct_u8: torch.Tensor, binding: mac.Binding,
                       round_keys: torch.Tensor, counter_words: torch.Tensor,
                       hash_key_u32: torch.Tensor, *, block_bytes: int):
    """Kernel-backed secure read: (plaintext_u8, block_macs_u8)."""
    return _secure_crossing(ct_u8, binding, round_keys, counter_words,
                            hash_key_u32, fused_crypt_mac,
                            block_bytes=block_bytes)


def secure_write_kernel(pt_u8: torch.Tensor, binding: mac.Binding,
                        round_keys: torch.Tensor, counter_words: torch.Tensor,
                        hash_key_u32: torch.Tensor, *, block_bytes: int):
    """Kernel-backed secure write: (ciphertext_u8, block_macs_u8)."""
    return _secure_crossing(pt_u8, binding, round_keys, counter_words,
                            hash_key_u32, fused_crypt_mac_write,
                            block_bytes=block_bytes)


def secure_read_kernel_mixed(ct_u8: torch.Tensor, binding: mac.Binding,
                             bank_round_keys: torch.Tensor,
                             counter_words: torch.Tensor,
                             bank_hash_key: torch.Tensor,
                             row_idx: torch.Tensor, *, block_bytes: int):
    """Mixed-key secure read: (plaintext_u8, block_macs_u8).

    ``bank_round_keys`` (K, 11, 16) uint8 and ``bank_hash_key``
    (K, n_lanes) u32 are the key bank; ``row_idx`` (N,) selects each
    optBlk's row (a page's row repeated over its blocks).
    """
    return _secure_crossing_mixed(ct_u8, binding, bank_round_keys,
                                  counter_words, bank_hash_key, row_idx,
                                  fused_crypt_mac_mixed,
                                  block_bytes=block_bytes)


def secure_write_kernel_mixed(pt_u8: torch.Tensor, binding: mac.Binding,
                              bank_round_keys: torch.Tensor,
                              counter_words: torch.Tensor,
                              bank_hash_key: torch.Tensor,
                              row_idx: torch.Tensor, *, block_bytes: int):
    """Mixed-key secure write: (ciphertext_u8, block_macs_u8)."""
    return _secure_crossing_mixed(pt_u8, binding, bank_round_keys,
                                  counter_words, bank_hash_key, row_idx,
                                  fused_crypt_mac_write_mixed,
                                  block_bytes=block_bytes)
