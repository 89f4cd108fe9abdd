"""Wrappers of the CUDA fused crypt + NH kernels (``csrc/fused_crypt_mac.cu``).

Replace ``repro/kernels/fused_crypt_mac/kernel.py::fused_crypt_mac`` and
``::fused_crypt_mac_write``.  CPU operands run the plain versions in
:mod:`~repro_torch.kernels.fused_crypt_mac.ref`; CUDA operands launch the
kernel or raise.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import LAUNCHES, build
from repro_torch.kernels.common import (bind_c, check_operand, on_cpu,
                                        raise_on_error, stream_handle)
from repro_torch.kernels.fused_crypt_mac.ref import (fused_crypt_mac_ref,
                                                     fused_crypt_mac_write_ref)

__all__ = ["fused_crypt_mac", "fused_crypt_mac_write", "MAX_SEGMENTS"]

MAX_SEGMENTS = 11


def _launch(name: str, data, base, div, bind, key):
    n, lanes = data.shape
    s = lanes // 4
    if lanes != 4 * s or not 1 <= s <= MAX_SEGMENTS:
        raise ValueError(f"{name}: {lanes} lanes per block; the kernel takes "
                         f"4*S lanes with S in 1..{MAX_SEGMENTS}")
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
    rc = entry(data.data_ptr(), base.data_ptr(), div.data_ptr(),
               bind.data_ptr(), key.data_ptr(), out.data_ptr(), nh.data_ptr(),
               n, s, stream_handle())
    raise_on_error(rc, name)
    LAUNCHES[name] += 1
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
