"""Plain PyTorch versions of the NH-hash / XOR-MAC kernel and its ops."""

from __future__ import annotations

import torch

from repro_torch.core import mac
from repro_torch.core.bytesutil import u32

__all__ = ["nh_hash_ref", "block_macs_ref", "layer_mac_ref"]


def nh_hash_ref(payload_u32: torch.Tensor,
                key_u32: torch.Tensor) -> torch.Tensor:
    """(N, L) u32 payload + (L,) u32 key -> (N, 2) u32 (hi, lo), int32
    storage."""
    hi, lo = mac.nh_hash(payload_u32, key_u32)
    return u32(torch.stack([hi, lo], dim=-1))


def block_macs_ref(blocks_u8, binding, *, hash_key_u32, round_keys):
    return mac.block_macs(blocks_u8, binding, hash_key_u32=hash_key_u32,
                          round_keys=round_keys, engine="nh")


def layer_mac_ref(blocks_u8, binding, *, hash_key_u32, round_keys):
    return mac.layer_mac(blocks_u8, binding, hash_key_u32=hash_key_u32,
                         round_keys=round_keys, engine="nh")
