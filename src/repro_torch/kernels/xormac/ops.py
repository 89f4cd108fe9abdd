"""Kernel-backed optBlk MACs and layer MAC, bytes equal to
:func:`repro_torch.core.mac.block_macs` with the ``nh`` engine.

The NH compression runs in the NH kernel; the AES PRF finalization
reuses the AES-CTR keystream kernel on the (N, 4) finalization words.
"""

from __future__ import annotations

import torch

from repro_torch.core import mac
from repro_torch.core.bytesutil import i64, u32
from repro_torch.kernels.aes_ctr.ops import keystream_bytes
from repro_torch.kernels.xormac.kernel import nh_hash_kernel_call

__all__ = ["block_macs_kernel", "layer_mac_kernel", "nh_hash_kernel_call"]


def block_macs_kernel(blocks_u8: torch.Tensor, binding: mac.Binding, *,
                      hash_key_u32: torch.Tensor,
                      round_keys: torch.Tensor) -> torch.Tensor:
    """(n_blocks, block_bytes) u8 -> (n_blocks, 8) u8 MACs."""
    payload = mac.nh_payload_u32(blocks_u8, binding)
    lanes = payload.shape[-1]
    mac.check_nh_key(hash_key_u32, lanes)
    hashes = nh_hash_kernel_call(payload,
                                 u32(hash_key_u32[:lanes]).contiguous())
    del payload
    fin = mac.finalize_words(i64(hashes[:, 0]), i64(hashes[:, 1]), binding)
    return keystream_bytes(u32(fin), round_keys)[:, : mac.MAC_BYTES]


def layer_mac_kernel(blocks_u8: torch.Tensor, binding: mac.Binding, *,
                     hash_key_u32: torch.Tensor,
                     round_keys: torch.Tensor) -> torch.Tensor:
    """Layer MAC = XOR of the kernel-computed optBlk MACs -> (8,) u8."""
    return mac.xor_aggregate(block_macs_kernel(
        blocks_u8, binding, hash_key_u32=hash_key_u32, round_keys=round_keys))
