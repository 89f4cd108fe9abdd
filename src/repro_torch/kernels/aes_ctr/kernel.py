"""Wrappers of the CUDA AES-CTR keystream kernels (``csrc/aes_ctr.cu``).

Replace ``repro/kernels/aes_ctr/kernel.py::aes_ctr_keystream`` and
``::aes_ctr_keystream_multi``.  CPU operands run the plain versions in
:mod:`~repro_torch.kernels.aes_ctr.ref`; CUDA operands launch the kernel
or raise.

The kernels run word-wide T-table AES: one table, :func:`te0_table_np`,
built here from the S-box and handed to the kernel as a device tensor
(:func:`t_table`).  The kernel stages it, and its 16-bit rotation, once
per lane in shared memory (64 KB per thread block), so lookups are free
of bank conflicts.  Thread blocks are persistent: as many as the card
holds at once (:func:`grid_blocks`), each walking the counters with a
grid stride.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.core.aes import SBOX_NP
from repro_torch.kernels import LAUNCHES, build
from repro_torch.kernels.aes_ctr.ref import (
    aes_ctr_keystream_lanes_ref, aes_ctr_keystream_multi_lanes_ref)
from repro_torch.kernels.common import (MAX_SHARED_BYTES, bind_c,
                                        check_operand, check_shared_bytes,
                                        on_cpu, raise_on_error, stream_handle)

__all__ = ["aes_ctr_keystream", "aes_ctr_keystream_multi", "te0_table_np",
           "t_table", "grid_blocks", "TABLE_SHARED_BYTES", "MAX_BANK_ROWS"]

# The kernels' shared memory: Te0 and Te2 once per lane (256 entries x
# 2 x 32 x 4 bytes), then the schedules (176 bytes a row; one row for
# the single-key kernel, the bank for the mixed one).
TABLE_SHARED_BYTES = 256 * 2 * 32 * 4
ROW_BYTES = 11 * 16
MAX_BANK_ROWS = (MAX_SHARED_BYTES - TABLE_SHARED_BYTES) // ROW_BYTES
MAX_BLOCKS = 2 ** 31          # the kernels index blocks in 32 bits

_TABLES: dict = {}


def _entry(name: str = "aes_ctr_keystream", n_pointers: int = 4,
           n_ints: int = 1):
    return bind_c(getattr(build.load("aes_ctr"), name), n_pointers, n_ints)


def te0_table_np() -> np.ndarray:
    """The kernels' T-table, (256,) u32: entry ``x`` is the MixColumns
    column of ``S[x]`` standing in row 0, ``(2 S[x], S[x], S[x],
    3 S[x])`` from the low byte up.  Rows 1-3 are the entry rotated left
    by 8, 16 and 24 bits; ``S[x]`` itself is byte 1."""
    s = SBOX_NP.astype(np.uint32)
    s2 = ((s << 1) ^ np.where(s & 0x80, 0x1B, 0).astype(np.uint32)) & 0xFF
    return s2 | (s << 8) | (s << 16) | ((s2 ^ s) << 24)


def t_table(device) -> torch.Tensor:
    """:func:`te0_table_np` as a (256,) int32 tensor on ``device``
    (cached), the operand the kernels take."""
    key = str(device)
    if key not in _TABLES:
        _TABLES[key] = torch.from_numpy(
            te0_table_np().view(np.int32)).to(device)
    return _TABLES[key]


def grid_blocks(k: int | None = None) -> int:
    """Thread blocks (256 threads each) a launch over many counters uses
    on the current CUDA device: the single-key kernel, or with ``k`` the
    mixed kernel over a ``k``-row bank."""
    fn = build.load("aes_ctr").aes_ctr_grid_blocks
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
    got = fn(0 if k is None else k)
    if got <= 0:
        raise RuntimeError(f"aes_ctr_grid_blocks: cudaError_t {-got}")
    return got


def _check_count(n: int, kernel: str) -> None:
    if n >= MAX_BLOCKS:
        raise ValueError(f"{kernel}: {n} counter blocks; the kernel takes "
                         f"fewer than 2^31 per call")


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
    _check_count(n, "aes_ctr_keystream")
    rc = _entry()(counter_words.data_ptr(), round_keys.data_ptr(),
                  t_table(counter_words.device).data_ptr(), out.data_ptr(),
                  n, stream_handle())
    raise_on_error(rc, "aes_ctr_keystream")
    LAUNCHES["aes_ctr_keystream"] += 1
    return out


def aes_ctr_keystream_multi(counter_words: torch.Tensor,
                            bank_round_keys: torch.Tensor,
                            row_idx: torch.Tensor) -> torch.Tensor:
    """Mixed-key keystream: (N, 4) u32 counters (int32 storage), a
    (K, 11, 16) uint8 schedule bank and (N,) int32 bank rows -> (N, 4)
    u32 OTP lanes, block ``i`` under schedule ``row_idx[i]``.

    The kernel stages the whole bank in shared memory (K * 176 bytes,
    after the 64 KB of tables) instead of reading a per-block schedule
    table from device memory, so a bank holds at most
    :data:`MAX_BANK_ROWS` (948) rows.
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
    check_shared_bytes("aes_ctr_keystream_multi",
                       TABLE_SHARED_BYTES + ROW_BYTES * k, k, MAX_BANK_ROWS)
    out = torch.empty_like(counter_words)
    if n == 0:
        return out
    _check_count(n, "aes_ctr_keystream_multi")
    rc = _entry("aes_ctr_keystream_multi", 5, 2)(
        counter_words.data_ptr(), bank_round_keys.data_ptr(),
        row_idx.data_ptr(), t_table(counter_words.device).data_ptr(),
        out.data_ptr(), n, k, stream_handle())
    raise_on_error(rc, "aes_ctr_keystream_multi")
    LAUNCHES["aes_ctr_keystream_multi"] += 1
    return out
