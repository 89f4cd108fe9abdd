"""Hand-written Hopper kernels (CUDA C++, ``sm_90a``) and their wrappers.

Each kernel module keeps a plain PyTorch version beside the kernel
(``ref.py``).  A wrapper given CPU tensors runs the plain version; given
CUDA tensors it launches its kernel or raises — there is no fallback.
Every launch adds one to :data:`LAUNCHES` under the kernel's name, so a
run can show that its main path went through the kernels.

The mixed-key kernels take a key bank and one int32 bank row per block.
The wrappers check the rows' type and shape, not their values (a device
range check would cost a host sync per call):
:meth:`repro_torch.serve.kv_pages.PageKeyCtx.make` refuses rows outside
the bank on the host, and the kernels clamp a row into ``[0, K)`` before
they touch shared memory.
"""

from __future__ import annotations

__all__ = ["LAUNCHES", "reset_launches"]

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
