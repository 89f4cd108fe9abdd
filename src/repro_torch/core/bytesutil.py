"""Byte and 32-bit word views for the secure-memory layer.

Storage convention: u32 data (lanes, counter words, NH keys, VNs) is
stored as ``torch.int32`` bit patterns, because torch lacks shifts,
adds, compares and sums on ``torch.uint32``.  Arithmetic on such words
runs in ``int64`` holding values in ``[0, 2**32)`` (:func:`i64`) and is
masked back with :data:`MASK32` after every add and shift; :func:`u32`
returns to the int32 storage form.  Both frameworks are little-endian,
so the byte views below match ``jax.lax.bitcast_convert_type``.
"""

from __future__ import annotations

import torch

__all__ = ["MASK32", "bytes_to_u32", "u32_to_bytes", "i64", "u32"]

MASK32 = 0xFFFFFFFF


def bytes_to_u32(buf: torch.Tensor) -> torch.Tensor:
    """View a flat uint8 buffer (len % 4 == 0) as little-endian u32 lanes
    (int32 storage)."""
    return buf.contiguous().reshape(-1).view(torch.int32)


def u32_to_bytes(lanes: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`bytes_to_u32`: flat uint8 bytes."""
    return lanes.contiguous().reshape(-1).view(torch.uint8)


def i64(x) -> torch.Tensor:
    """u32 words (int32 / uint32 storage, or int64) -> int64 in [0, 2**32)."""
    x = torch.as_tensor(x)
    return x.to(torch.int64) & MASK32


def u32(x: torch.Tensor) -> torch.Tensor:
    """int64 words -> int32 storage of their low 32 bits (u32 wrap)."""
    x = x.to(torch.int64) & MASK32
    return torch.where(x >= 2 ** 31, x - 2 ** 32, x).to(torch.int32)
