"""Argument checks, launch plumbing and operation counts shared by the
kernel wrappers.

The ``*_ops`` functions count the integer operations one launch does,
from its shapes: what a profile charges a launch
(:func:`repro_torch.kernels.charge`) and what the least time of a
kernel on the card is computed from.
"""

from __future__ import annotations

import ctypes

import torch

__all__ = ["check_operand", "check_shared_bytes", "on_cpu", "stream_handle",
           "raise_on_error", "bind_c", "cdiv", "MAX_SHARED_BYTES",
           "AES_OPS_PER_BLOCK", "aes_ctr_ops", "fused_crypt_mac_ops",
           "otp_xor_ops", "nh_hash_ops"]

# Shared memory one thread block may use on Hopper (227 KB of the SM's
# 256 KB; above 48 KB only as dynamic shared memory, which the C entry
# points opt into).
MAX_SHARED_BYTES = 232448

# One AES-128 block: 9 rounds x 16 B x 7 + the final round's 16 x 2 + the
# first AddRoundKey's 16.
AES_OPS_PER_BLOCK = 1056


def aes_ctr_ops(n: int) -> int:
    """B1 / B4: one AES block per counter."""
    return n * AES_OPS_PER_BLOCK


def fused_crypt_mac_ops(n: int, s: int) -> int:
    """B2, B3, B5, B6 over ``n`` blocks of ``s`` segments: the XORs of
    the pads per lane and the NH pairs of ct and binding."""
    return n * (16 * s + 16)


def otp_xor_ops(n: int, s: int) -> int:
    """B7: two XORs per lane."""
    return n * 4 * s * 2


def nh_hash_ops(n: int, lanes: int) -> int:
    """B8: per pair two adds, a 64-bit multiply and an accumulate."""
    return n * lanes // 2 * 4


def cdiv(a: int, b: int) -> int:
    """Ceiling division (the reference's ``kernels.common.cdiv``)."""
    return -(-a // b)


def on_cpu(*tensors) -> bool:
    """True when the operands lie on the CPU (the plain route); False for
    CUDA operands (the kernel route); raises on anything else."""
    devices = {t.device.type for t in tensors}
    if devices == {"cpu"}:
        return True
    if devices == {"cuda"}:
        return False
    raise ValueError(f"kernel operands on devices {sorted(devices)}: all "
                     "must be on the CPU or all on one CUDA device")


def check_operand(t: torch.Tensor, name: str, dtype: torch.dtype,
                  shape: tuple) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` whose
    shape matches ``shape`` (``None`` entries match any size) with a
    16-byte-aligned start."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != len(shape) or any(
            want is not None and got != want
            for got, want in zip(t.shape, shape)):
        raise ValueError(f"{name}: expected shape {shape}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: start is not 16-byte aligned")


def check_shared_bytes(kernel: str, n_bytes: int, k: int,
                       max_rows: int | None = None) -> None:
    """Raise when a bank of ``k`` rows needs more shared memory than a
    thread block has: the kernel would not launch.  ``max_rows``, where
    given, is the largest bank that fits, for the message."""
    if n_bytes > MAX_SHARED_BYTES:
        limit = "" if max_rows is None else f" (at most {max_rows} rows)"
        raise ValueError(
            f"{kernel}: a key bank of {k} rows needs {n_bytes} bytes of "
            f"shared memory per thread block; Hopper allows "
            f"{MAX_SHARED_BYTES}{limit}.  Use fewer tenants or a smaller "
            f"retain window, or split the call by bank row")


def stream_handle() -> int:
    return torch.cuda.current_stream().cuda_stream


def raise_on_error(rc: int, kernel: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{kernel}: launch failed with cudaError_t {rc}")


def bind_c(fn, n_pointers: int, n_ints: int):
    """Declare a C entry point taking pointers, then ints, then a stream."""
    fn.argtypes = ([ctypes.c_void_p] * n_pointers + [ctypes.c_int] * n_ints
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn
