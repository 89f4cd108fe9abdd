"""Hand-written Hopper kernels (CUDA C++, ``sm_90a``) and their wrappers.

Each kernel module keeps a plain PyTorch version beside the kernel
(``ref.py``).  A wrapper given CPU tensors runs the plain version; given
CUDA tensors it launches its kernel or raises — there is no fallback.
Every launch adds one to :data:`LAUNCHES` under the kernel's name, so a
run can show that its main path went through the kernels, and calls
:func:`charge`, which hands the launch's bytes and integer operations to
every active cost profile (:mod:`repro_torch.obs.profiler`): a kernel
launched through ``ctypes`` is invisible to a dispatch mode.  The
operation counts are :mod:`repro_torch.kernels.common`'s ``*_ops``.

The mixed-key kernels take a key bank and one int32 bank row per block.
The wrappers check the rows' type and shape, not their values (a device
range check would cost a host sync per call):
:meth:`repro_torch.serve.kv_pages.PageKeyCtx.make` refuses rows outside
the bank on the host, and the kernels clamp a row into ``[0, K)`` before
they touch shared memory.
"""

from __future__ import annotations

__all__ = ["LAUNCHES", "COST_SINKS", "charge", "reset_launches"]

LAUNCHES = {
    "aes_ctr_keystream": 0,
    "fused_crypt_mac": 0,
    "fused_crypt_mac_write": 0,
    "aes_ctr_keystream_multi": 0,
    "fused_crypt_mac_mixed": 0,
    "fused_crypt_mac_write_mixed": 0,
    "otp_xor": 0,
    "nh_hash_kernel_call": 0,
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# Active cost profiles: ``sink(name, source_file, nbytes, ops)`` per
# launch.  Empty unless a profile runs.
COST_SINKS: list = []


def charge(name: str, source_file: str, tensors, ops: float) -> None:
    """Charge one launch of kernel ``name`` (wrapper in ``source_file``)
    to the active cost profiles: the bytes of ``tensors`` (its operands
    and outputs, each once) and ``ops`` integer operations.  Does
    nothing when no profile is active."""
    if not COST_SINKS:
        return
    nbytes = float(sum(t.numel() * t.element_size() for t in tensors))
    for sink in COST_SINKS:
        sink(name, source_file, nbytes, float(ops))
