"""Wrapper of the CUDA B-AES diversify + XOR kernel (``csrc/otp_xor.cu``).

Replaces ``repro/kernels/otp_xor/kernel.py::otp_xor``.  CPU operands run
the plain version in :mod:`~repro_torch.kernels.otp_xor.ref`; CUDA
operands launch the kernel or raise.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import LAUNCHES, build
from repro_torch.kernels.common import (MAX_SHARED_BYTES, bind_c,
                                        check_operand, on_cpu,
                                        raise_on_error, stream_handle)
from repro_torch.kernels.otp_xor.ref import otp_xor_ref

__all__ = ["otp_xor"]


def otp_xor(data_lanes: torch.Tensor, base_otp_lanes: torch.Tensor,
            div_lanes: torch.Tensor) -> torch.Tensor:
    """(N, 4S) u32 data, (N, 4) u32 base OTPs, (S, 4) u32 diversifiers
    (int32 storage) -> (N, 4S) u32 lanes."""
    if on_cpu(data_lanes, base_otp_lanes, div_lanes):
        return otp_xor_ref(data_lanes, base_otp_lanes, div_lanes)
    if div_lanes.dim() != 2 or div_lanes.shape[0] < 1:
        raise ValueError(f"div_lanes: expected (S, 4) with S >= 1, got "
                         f"{tuple(div_lanes.shape)}")
    s = div_lanes.shape[0]
    if 16 * s > MAX_SHARED_BYTES:
        raise ValueError(f"otp_xor: {s} diversifiers do not fit in a thread "
                         f"block's {MAX_SHARED_BYTES} bytes of shared memory")
    n = data_lanes.shape[0]
    check_operand(data_lanes, "data_lanes", torch.int32, (n, 4 * s))
    check_operand(base_otp_lanes, "base_otp_lanes", torch.int32, (n, 4))
    check_operand(div_lanes, "div_lanes", torch.int32, (s, 4))
    if n * s >= 2 ** 31:
        raise ValueError(f"otp_xor: {n} x {s} segments exceed the kernel's "
                         "int32 index")
    out = torch.empty_like(data_lanes)
    if n == 0:
        return out
    entry = bind_c(build.load("otp_xor").otp_xor, 4, 2)
    rc = entry(data_lanes.data_ptr(), base_otp_lanes.data_ptr(),
               div_lanes.data_ptr(), out.data_ptr(), n, s, stream_handle())
    raise_on_error(rc, "otp_xor")
    LAUNCHES["otp_xor"] += 1
    return out
