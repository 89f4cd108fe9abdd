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

import math
from typing import NamedTuple

import torch

__all__ = ["MASK32", "TensorSpec", "dtype_name", "torch_dtype",
           "tensor_to_bytes", "bytes_to_tensor", "pad_to_multiple",
           "bytes_to_u32", "u32_to_bytes", "i64", "u32"]

MASK32 = 0xFFFFFFFF


def dtype_name(dtype) -> str:
    """numpy/JAX name of a dtype (``torch.bfloat16`` -> ``"bfloat16"``);
    a name passes through."""
    return dtype if isinstance(dtype, str) else str(dtype).removeprefix(
        "torch.")


def torch_dtype(name) -> torch.dtype:
    """Inverse of :func:`dtype_name`."""
    dtype = name if isinstance(name, torch.dtype) else getattr(
        torch, name, None)
    if not isinstance(dtype, torch.dtype):
        raise TypeError(f"not a torch dtype: {name!r}")
    return dtype


class TensorSpec(NamedTuple):
    """Static metadata needed to rebuild a tensor from its bytes.

    ``dtype`` is the numpy/JAX name (``"bfloat16"``), as it lands in a
    checkpoint manifest.
    """

    shape: tuple
    dtype: str
    nbytes: int  # unpadded payload size

    @staticmethod
    def of(x) -> "TensorSpec":
        """Of a tensor, or of a spec with ``shape`` and ``dtype``."""
        shape = tuple(int(s) for s in x.shape)
        name = dtype_name(x.dtype)
        return TensorSpec(shape, name,
                          math.prod(shape) * torch_dtype(name).itemsize)


def pad_to_multiple(buf: torch.Tensor, multiple: int) -> torch.Tensor:
    """Zero-pad a flat uint8 buffer to a length multiple (no copy when
    it is one already)."""
    n = buf.shape[0]
    padded = (n + multiple - 1) // multiple * multiple
    if padded == n:
        return buf
    return torch.cat([buf, buf.new_zeros(padded - n)])


def tensor_to_bytes(x: torch.Tensor, *, multiple: int = 16) -> torch.Tensor:
    """Any tensor as a flat, padded uint8 buffer (a little-endian view
    of its bytes)."""
    return pad_to_multiple(x.contiguous().reshape(-1).view(torch.uint8),
                           multiple)


def bytes_to_tensor(buf: torch.Tensor, spec: TensorSpec) -> torch.Tensor:
    """Inverse of :func:`tensor_to_bytes` given the spec (a view of
    ``buf``)."""
    return buf[: spec.nbytes].view(torch_dtype(spec.dtype)).reshape(
        spec.shape)


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
    """int64 words -> int32 storage of their low 32 bits (u32 wrap);
    int32 storage passes through."""
    if x.dtype == torch.int32:
        return x
    x = x.to(torch.int64) & MASK32
    return torch.where(x >= 2 ** 31, x - 2 ** 32, x).to(torch.int32)
