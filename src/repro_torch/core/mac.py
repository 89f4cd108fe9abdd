"""Integrity MACs for SeDA (paper §III-C, Alg. 2).

Per-optBlk MAC, XOR-aggregated layer MAC, and model MAC.  Three block
MAC engines, as in the reference:

* ``nh`` (every entry of ``SCHEMES``): AES_{Ke}(NH(payload ‖ binding) ‖
  binding words), truncated to :data:`MAC_BYTES`;
* ``cbc``: AES-CBC-MAC over binding block ‖ payload segments;
* ``naive``: the RePA-vulnerable strawman, a CBC-MAC of the ciphertext
  only (no binding), for the attack demonstration.

The binding tuple (PA, VN, layer_id, fmap_idx, blk_idx) is the RePA
defense: it is hashed into every ``nh`` and ``cbc`` block MAC.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import aes, ctr
from repro_torch.core.bytesutil import MASK32, i64, u32

__all__ = ["MAC_BYTES", "Binding", "nh_hash", "nh_payload", "nh_payload_u32",
           "check_nh_key", "finalize_words", "finalize_macs", "block_macs",
           "xor_aggregate", "layer_mac", "model_mac", "verify_layer"]

MAC_BYTES = 8


class Binding(NamedTuple):
    """Location details bound into each optBlk MAC (Alg. 2, line 8).

    Fields are int64 tensors of u32 values, broadcastable to (n_blocks,).
    """

    pa: torch.Tensor
    vn: torch.Tensor
    layer_id: torch.Tensor
    fmap_idx: torch.Tensor
    blk_idx: torch.Tensor

    @staticmethod
    def make(pa, vn, layer_id, fmap_idx, blk_idx) -> "Binding":
        return Binding(i64(pa), i64(vn), i64(layer_id), i64(fmap_idx),
                       i64(blk_idx))

    def words(self, n_blocks: int) -> torch.Tensor:
        """(n_blocks, 8) u32 words (int64): the five fields, zero-padded."""
        cols = [f.expand(n_blocks) for f in self]
        cols += [torch.zeros_like(cols[0])] * (8 - len(cols))
        return torch.stack(cols, dim=-1)


def _mul32x32(a: torch.Tensor, b: torch.Tensor):
    """Exact 64-bit product of u32 operands held in int64 -> (hi, lo)."""
    p_lo = (a & 0xFFFF) * b                   # < 2**48
    p_hi = (a >> 16) * b                      # < 2**48
    low = p_lo + ((p_hi & 0xFFFF) << 16)      # < 2**49
    return ((p_hi >> 16) + (low >> 32)) & MASK32, low & MASK32


def nh_hash(lanes_u32: torch.Tensor, key_u32: torch.Tensor):
    """NH over the last axis: (..., 2L) u32 data, (2L,) u32 key.

    NH(m, k) = sum_i (m_{2i} + k_{2i}) * (m_{2i+1} + k_{2i+1})  mod 2^64,
    lane sums mod 2^32.  Returns (hi, lo) int64 u32 words of shape (...,).
    """
    m, k = i64(lanes_u32), i64(key_u32)
    a = (m[..., 0::2] + k[..., 0::2]) & MASK32
    b = (m[..., 1::2] + k[..., 1::2]) & MASK32
    hi, lo = _mul32x32(a, b)
    lo_sum = lo.sum(dim=-1)                   # < 2**(32 + log2 L): exact
    hi_sum = hi.sum(dim=-1) + (lo_sum >> 32)
    return hi_sum & MASK32, lo_sum & MASK32


def nh_payload_u32(blocks_u8: torch.Tensor,
                   binding: Binding) -> torch.Tensor:
    """NH input lanes, data lanes ‖ binding words, even length: (N, L)
    u32 in int32 storage (the NH kernel's operand)."""
    n_blocks, block_bytes = blocks_u8.shape
    lanes = block_bytes // 4
    width = lanes + 8 + (lanes % 2)
    # Filled column by column: no (N, 8) int64 binding table.
    payload = torch.zeros((n_blocks, width), dtype=torch.int32,
                          device=blocks_u8.device)
    payload[:, :lanes] = blocks_u8.contiguous().view(torch.int32)
    for j, field in enumerate(binding):
        payload[:, lanes + j] = u32(field.expand(n_blocks))
    return payload


def nh_payload(blocks_u8: torch.Tensor, binding: Binding) -> torch.Tensor:
    """NH input lanes as int64 u32 words."""
    return i64(nh_payload_u32(blocks_u8, binding))


def finalize_words(hi: torch.Tensor, lo: torch.Tensor,
                   binding: Binding) -> torch.Tensor:
    """Counter words for the AES PRF finalization: (n, 4) int64 u32."""
    hi, lo = i64(hi), i64(lo)
    shape = hi.shape
    w2 = binding.pa.expand(shape) ^ binding.layer_id.expand(shape)
    w3 = (binding.vn.expand(shape)
          ^ ((binding.fmap_idx.expand(shape) << 16) & MASK32)
          ^ binding.blk_idx.expand(shape))
    return torch.stack([hi, lo, w2, w3], dim=-1)


def finalize_macs(hi: torch.Tensor, lo: torch.Tensor, binding: Binding,
                  round_keys: torch.Tensor) -> torch.Tensor:
    """AES(K, hash64 ‖ binding) -> truncated (n, MAC_BYTES) uint8 MACs."""
    fin = finalize_words(hi, lo, binding)
    return ctr.ctr_keystream(round_keys, fin)[:, :MAC_BYTES]


def check_nh_key(hash_key_u32: torch.Tensor, lanes: int) -> None:
    if hash_key_u32.shape[-1] < lanes:
        raise ValueError(
            f"NH key too short: {hash_key_u32.shape[-1]} lanes for "
            f"{lanes}-lane payload (optBlk too large)")


def _nh_block_macs(blocks_u8, binding, hash_key_u32, round_keys):
    payload = nh_payload(blocks_u8, binding)
    check_nh_key(hash_key_u32, payload.shape[-1])
    hi, lo = nh_hash(payload, hash_key_u32[: payload.shape[-1]])
    return finalize_macs(hi, lo, binding, round_keys)


def _cbc_chain(state: torch.Tensor, blocks_u8: torch.Tensor,
               round_keys: torch.Tensor) -> torch.Tensor:
    """CBC-MAC chain over the 16 B segments of each block -> (n, 8) u8."""
    segs = blocks_u8.reshape(blocks_u8.shape[0], -1, 16)
    for i in range(segs.shape[1]):
        state = aes.aes128_encrypt_block(state ^ segs[:, i], round_keys)
    return state[:, :MAC_BYTES]


def _cbc_block_macs(blocks_u8, binding, round_keys):
    """AES-CBC-MAC over binding block ‖ payload segments."""
    bind_words = binding.words(blocks_u8.shape[0])[:, :4]
    state = ctr.ctr_keystream(round_keys, bind_words)
    return _cbc_chain(state, blocks_u8, round_keys)


def _naive_block_macs(blocks_u8, round_keys):
    """RePA-VULNERABLE strawman: the MAC depends on the ciphertext only."""
    state = torch.zeros((blocks_u8.shape[0], 16), dtype=torch.uint8,
                        device=blocks_u8.device)
    return _cbc_chain(state, blocks_u8, round_keys)


def block_macs(blocks_u8: torch.Tensor, binding: Binding, *,
               hash_key_u32: torch.Tensor, round_keys: torch.Tensor,
               engine: str = "nh") -> torch.Tensor:
    """Per-optBlk MACs: (n_blocks, block_bytes) u8 -> (n_blocks, 8) u8."""
    if engine == "nh":
        return _nh_block_macs(blocks_u8, binding, hash_key_u32, round_keys)
    if engine == "cbc":
        return _cbc_block_macs(blocks_u8, binding, round_keys)
    if engine == "naive":
        return _naive_block_macs(blocks_u8, round_keys)
    raise ValueError(f"unknown MAC engine: {engine}")


def xor_aggregate(macs_u8: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """XOR-MAC aggregation: XOR of all MACs along ``axis``.

    (..., MAC_BYTES) uint8 -> the same with ``axis`` removed; a pairwise
    tree of XORs over 64-bit views (log2 steps, not one per block).
    """
    axis = axis % (macs_u8.dim() - 1)
    if macs_u8.numel() == 0:
        shape = macs_u8.shape[:axis] + macs_u8.shape[axis + 1:]
        return torch.zeros(shape, dtype=torch.uint8, device=macs_u8.device)
    words = macs_u8.contiguous().view(torch.int64)[..., 0].movedim(axis, 0)
    while words.shape[0] > 1:
        if words.shape[0] % 2:
            words = torch.cat([words, torch.zeros_like(words[:1])])
        words = words[0::2] ^ words[1::2]
    return words[0].unsqueeze(-1).view(torch.uint8)


def layer_mac(blocks_u8: torch.Tensor, binding: Binding, *, hash_key_u32,
              round_keys, engine: str = "nh") -> torch.Tensor:
    """Layer MAC = XOR of all optBlk MACs within the layer -> (8,) u8."""
    return xor_aggregate(
        block_macs(blocks_u8, binding, hash_key_u32=hash_key_u32,
                   round_keys=round_keys, engine=engine))


def model_mac(layer_macs_u8: torch.Tensor) -> torch.Tensor:
    """Model MAC: one MAC over all layer MACs -> (8,) u8."""
    return xor_aggregate(layer_macs_u8)


def verify_layer(blocks_u8: torch.Tensor, binding: Binding,
                 expected_mac: torch.Tensor, *, hash_key_u32, round_keys,
                 engine: str = "nh") -> torch.Tensor:
    """Recompute a layer MAC and compare: a scalar bool tensor."""
    got = layer_mac(blocks_u8, binding, hash_key_u32=hash_key_u32,
                    round_keys=round_keys, engine=engine)
    return torch.all(got == expected_mac)
