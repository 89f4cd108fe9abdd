"""Wrappers of the CUDA AES-CTR keystream kernels (``csrc/aes_ctr.cu``).

Replace ``repro/kernels/aes_ctr/kernel.py::aes_ctr_keystream`` and
``::aes_ctr_keystream_multi``.  CPU operands run the plain versions in
:mod:`~repro_torch.kernels.aes_ctr.ref`; CUDA operands launch the kernel
or raise.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.aes import SBOX_NP
from repro_torch.kernels import LAUNCHES, build
from repro_torch.kernels.aes_ctr.ref import (
    aes_ctr_keystream_lanes_ref, aes_ctr_keystream_multi_lanes_ref)
from repro_torch.kernels.common import (bind_c, check_operand,
                                        check_shared_bytes, on_cpu,
                                        raise_on_error, stream_handle)

__all__ = ["aes_ctr_keystream", "aes_ctr_keystream_multi"]

_SBOX: dict = {}


def _entry(name: str = "aes_ctr_keystream", n_pointers: int = 4,
           n_ints: int = 1):
    return bind_c(getattr(build.load("aes_ctr"), name), n_pointers, n_ints)


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


def aes_ctr_keystream_multi(counter_words: torch.Tensor,
                            bank_round_keys: torch.Tensor,
                            row_idx: torch.Tensor) -> torch.Tensor:
    """Mixed-key keystream: (N, 4) u32 counters (int32 storage), a
    (K, 11, 16) uint8 schedule bank and (N,) int32 bank rows -> (N, 4)
    u32 OTP lanes, block ``i`` under schedule ``row_idx[i]``.

    The kernel stages the whole bank in shared memory (K * 176 bytes)
    instead of reading a per-block schedule table from device memory.
    """
    if on_cpu(counter_words, bank_round_keys, row_idx):
        return aes_ctr_keystream_multi_lanes_ref(counter_words,
                                                 bank_round_keys, row_idx)
    n = counter_words.shape[0]
    check_operand(counter_words, "counter_words", torch.int32, (n, 4))
    check_operand(bank_round_keys, "bank_round_keys", torch.uint8,
                  (None, 11, 16))
    check_operand(row_idx, "row_idx", torch.int32, (n,))
    k = bank_round_keys.shape[0]
    if k < 1:
        raise ValueError("aes_ctr_keystream_multi: empty key bank")
    check_shared_bytes("aes_ctr_keystream_multi", 256 + 176 * k, k)
    out = torch.empty_like(counter_words)
    if n == 0:
        return out
    rc = _entry("aes_ctr_keystream_multi", 5, 2)(
        counter_words.data_ptr(), bank_round_keys.data_ptr(),
        row_idx.data_ptr(), _sbox(counter_words.device).data_ptr(),
        out.data_ptr(), n, k, stream_handle())
    raise_on_error(rc, "aes_ctr_keystream_multi")
    LAUNCHES["aes_ctr_keystream_multi"] += 1
    return out
