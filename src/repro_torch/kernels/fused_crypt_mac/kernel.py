"""Wrappers of the CUDA fused crypt + NH kernels (``csrc/fused_crypt_mac.cu``).

Replace ``repro/kernels/fused_crypt_mac/kernel.py::fused_crypt_mac``,
``::fused_crypt_mac_write``, ``::fused_crypt_mac_mixed`` and
``::fused_crypt_mac_write_mixed``.  CPU operands run the plain versions in
:mod:`~repro_torch.kernels.fused_crypt_mac.ref`; CUDA operands launch the
kernel or raise.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import LAUNCHES, build, charge
from repro_torch.kernels.common import (bind_c, check_operand,
                                        check_shared_bytes,
                                        fused_crypt_mac_ops, on_cpu,
                                        raise_on_error, stream_handle)
from repro_torch.kernels.fused_crypt_mac.ref import (
    fused_crypt_mac_mixed_ref, fused_crypt_mac_ref,
    fused_crypt_mac_write_mixed_ref, fused_crypt_mac_write_ref)
from repro_torch.obs import trace as trace_mod

__all__ = ["fused_crypt_mac", "fused_crypt_mac_write",
           "fused_crypt_mac_mixed", "fused_crypt_mac_write_mixed",
           "MAX_SEGMENTS", "mixed_shared_bytes"]

MAX_SEGMENTS = 11


def _segments(name: str, data) -> tuple:
    n, lanes = data.shape
    s = lanes // 4
    if lanes != 4 * s or not 1 <= s <= MAX_SEGMENTS:
        raise ValueError(f"{name}: {lanes} lanes per block; the kernel takes "
                         f"4*S lanes with S in 1..{MAX_SEGMENTS}")
    return n, s


def mixed_shared_bytes(k: int, s: int) -> int:
    """Shared memory a mixed-key thread block stages: K diversifier rows
    of S x 16 bytes and K NH key rows of (4S + 8) x 4 bytes."""
    return k * (16 * s + 4 * (4 * s + 8))


def _launch(name: str, data, base, div, bind, key):
    n, s = _segments(name, data)
    check_operand(data, "data_lanes", torch.int32, (n, 4 * s))
    check_operand(base, "base_otp_lanes", torch.int32, (n, 4))
    check_operand(div, "div_lanes", torch.int32, (s, 4))
    check_operand(bind, "bind_words", torch.int32, (n, 8))
    check_operand(key, "key_u32", torch.int32, (4 * s + 8,))
    out = torch.empty_like(data)
    nh = torch.empty((n, 2), dtype=torch.int32, device=data.device)
    if n == 0:
        return out, nh
    entry = bind_c(getattr(build.load("fused_crypt_mac"), name), 7, 2)
    with trace_mod.span(f"kernel.{name}"):
        rc = entry(data.data_ptr(), base.data_ptr(), div.data_ptr(),
                   bind.data_ptr(), key.data_ptr(), out.data_ptr(),
                   nh.data_ptr(), n, s, stream_handle())
    raise_on_error(rc, name)
    LAUNCHES[name] += 1
    charge(name, __file__, (data, base, div, bind, key, out, nh),
           fused_crypt_mac_ops(n, s))
    return out, nh


def _launch_mixed(name: str, data, base, div_bank, bind, key_bank, rows):
    n, s = _segments(name, data)
    check_operand(data, "data_lanes", torch.int32, (n, 4 * s))
    check_operand(base, "base_otp_lanes", torch.int32, (n, 4))
    check_operand(div_bank, "div_bank", torch.int32, (None, s, 4))
    k = div_bank.shape[0]
    if k < 1:
        raise ValueError(f"{name}: empty key bank")
    check_operand(bind, "bind_words", torch.int32, (n, 8))
    check_operand(key_bank, "key_bank", torch.int32, (k, 4 * s + 8))
    check_operand(rows, "row_idx", torch.int32, (n,))
    check_shared_bytes(name, mixed_shared_bytes(k, s), k)
    out = torch.empty_like(data)
    nh = torch.empty((n, 2), dtype=torch.int32, device=data.device)
    if n == 0:
        return out, nh
    entry = bind_c(getattr(build.load("fused_crypt_mac"), name), 8, 3)
    with trace_mod.span(f"kernel.{name}"):
        rc = entry(data.data_ptr(), base.data_ptr(), div_bank.data_ptr(),
                   bind.data_ptr(), key_bank.data_ptr(), rows.data_ptr(),
                   out.data_ptr(), nh.data_ptr(), n, s, k, stream_handle())
    raise_on_error(rc, name)
    LAUNCHES[name] += 1
    charge(name, __file__,
           (data, base, div_bank, bind, key_bank, rows, out, nh),
           fused_crypt_mac_ops(n, s))
    return out, nh


def fused_crypt_mac(ct_lanes, base_otp_lanes, div_lanes, bind_words, key_u32):
    """Decrypt + NH of the ciphertext: (pt lanes (N, 4S), NH (N, 2))."""
    args = (ct_lanes, base_otp_lanes, div_lanes, bind_words, key_u32)
    if on_cpu(*args):
        return fused_crypt_mac_ref(*args)
    return _launch("fused_crypt_mac", *args)


def fused_crypt_mac_write(pt_lanes, base_otp_lanes, div_lanes, bind_words,
                          key_u32):
    """Encrypt + NH of the fresh ciphertext: (ct lanes (N, 4S), NH (N, 2))."""
    args = (pt_lanes, base_otp_lanes, div_lanes, bind_words, key_u32)
    if on_cpu(*args):
        return fused_crypt_mac_write_ref(*args)
    return _launch("fused_crypt_mac_write", *args)


def fused_crypt_mac_mixed(ct_lanes, base_otp_lanes, div_bank, bind_words,
                          key_bank, row_idx):
    """Mixed-key decrypt + NH: diversifier bank (K, S, 4), NH key bank
    (K, 4S + 8) and one int32 bank row per block (N,).  Returns
    (pt lanes (N, 4S), NH (N, 2))."""
    args = (ct_lanes, base_otp_lanes, div_bank, bind_words, key_bank, row_idx)
    if on_cpu(*args):
        return fused_crypt_mac_mixed_ref(*args)
    return _launch_mixed("fused_crypt_mac_mixed", *args)


def fused_crypt_mac_write_mixed(pt_lanes, base_otp_lanes, div_bank,
                                bind_words, key_bank, row_idx):
    """Mixed-key encrypt + NH of the fresh ciphertext (shapes as
    :func:`fused_crypt_mac_mixed`)."""
    args = (pt_lanes, base_otp_lanes, div_bank, bind_words, key_bank, row_idx)
    if on_cpu(*args):
        return fused_crypt_mac_write_mixed_ref(*args)
    return _launch_mixed("fused_crypt_mac_write_mixed", *args)
