"""Wrapper of the CUDA NH hash kernel (``csrc/xormac.cu``).

Replaces ``repro/kernels/xormac/kernel.py::nh_hash_kernel_call``.  CPU
operands run the plain version in :mod:`~repro_torch.kernels.xormac.ref`;
CUDA operands launch the kernel or raise.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import LAUNCHES, build, charge
from repro_torch.kernels.common import (bind_c, check_operand, nh_hash_ops,
                                        on_cpu, raise_on_error,
                                        stream_handle)
from repro_torch.kernels.xormac.ref import nh_hash_ref
from repro_torch.obs import trace as trace_mod

__all__ = ["nh_hash_kernel_call", "MAX_PAIRS"]

# The reference kernel's exactness bound for its 16-bit split sums; the
# port keeps the same contract (its uint64 sums need none).
MAX_PAIRS = 65536


def nh_hash_kernel_call(payload_u32: torch.Tensor,
                        key_u32: torch.Tensor) -> torch.Tensor:
    """(N, L) u32 payload + (L,) u32 key (int32 storage) -> (N, 2) u32
    NH hashes (hi, lo)."""
    if payload_u32.dim() != 2:
        raise ValueError(f"payload_u32: expected (N, L), got "
                         f"{tuple(payload_u32.shape)}")
    n, lanes = payload_u32.shape
    if lanes % 2 or lanes // 2 > MAX_PAIRS:
        raise ValueError(f"nh_hash_kernel_call: {lanes} lanes; NH takes an "
                         f"even count of at most {2 * MAX_PAIRS}")
    if on_cpu(payload_u32, key_u32):
        if tuple(key_u32.shape) != (lanes,):
            raise ValueError(f"key_u32: expected ({lanes},), got "
                             f"{tuple(key_u32.shape)}")
        return nh_hash_ref(payload_u32, key_u32)
    check_operand(payload_u32, "payload_u32", torch.int32, (n, lanes))
    check_operand(key_u32, "key_u32", torch.int32, (lanes,))
    out = torch.empty((n, 2), dtype=torch.int32, device=payload_u32.device)
    if n == 0 or lanes == 0:
        return out.zero_()
    entry = bind_c(build.load("xormac").nh_hash, 3, 2)
    with trace_mod.span("kernel.nh_hash_kernel_call"):
        rc = entry(payload_u32.data_ptr(), key_u32.data_ptr(),
                   out.data_ptr(), n, lanes, stream_handle())
    raise_on_error(rc, "nh_hash_kernel_call")
    LAUNCHES["nh_hash_kernel_call"] += 1
    charge("nh_hash_kernel_call", __file__, (payload_u32, key_u32, out),
           nh_hash_ops(n, lanes))
    return out
