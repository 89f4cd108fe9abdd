"""Wrapper of the CUDA AES-CTR keystream kernel (``csrc/aes_ctr.cu``).

Replaces ``repro/kernels/aes_ctr/kernel.py::aes_ctr_keystream``.  CPU
operands run :func:`~repro_torch.kernels.aes_ctr.ref.aes_ctr_keystream_lanes_ref`;
CUDA operands launch the kernel or raise.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.aes import SBOX_NP
from repro_torch.kernels import LAUNCHES, build
from repro_torch.kernels.aes_ctr.ref import aes_ctr_keystream_lanes_ref
from repro_torch.kernels.common import (bind_c, check_operand, on_cpu,
                                        raise_on_error, stream_handle)

__all__ = ["aes_ctr_keystream"]

_SBOX: dict = {}


def _entry():
    lib = build.load("aes_ctr")
    return bind_c(lib.aes_ctr_keystream, 4, 1)


def _sbox(device) -> torch.Tensor:
    key = str(device)
    if key not in _SBOX:
        _SBOX[key] = torch.as_tensor(np.ascontiguousarray(SBOX_NP),
                                     device=device)
    return _SBOX[key]


def aes_ctr_keystream(counter_words: torch.Tensor,
                      round_keys: torch.Tensor) -> torch.Tensor:
    """(N, 4) u32 counters (int32 storage) + (11, 16) uint8 schedule ->
    (N, 4) u32 OTP lanes (int32 storage)."""
    if on_cpu(counter_words, round_keys):
        return aes_ctr_keystream_lanes_ref(counter_words, round_keys)
    check_operand(counter_words, "counter_words", torch.int32, (None, 4))
    check_operand(round_keys, "round_keys", torch.uint8, (11, 16))
    out = torch.empty_like(counter_words)
    n = counter_words.shape[0]
    if n == 0:
        return out
    rc = _entry()(counter_words.data_ptr(), round_keys.data_ptr(),
                  _sbox(counter_words.device).data_ptr(), out.data_ptr(), n,
                  stream_handle())
    raise_on_error(rc, "aes_ctr_keystream")
    LAUNCHES["aes_ctr_keystream"] += 1
    return out
