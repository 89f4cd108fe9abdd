"""Hand-written Hopper kernels (CUDA C++, ``sm_90a``) and their wrappers.

Each kernel module keeps a plain PyTorch version beside the kernel
(``ref.py``).  A wrapper given CPU tensors runs the plain version; given
CUDA tensors it launches its kernel or raises — there is no fallback.
Every launch adds one to :data:`LAUNCHES` under the kernel's name, so a
run can show that its main path went through the kernels.
"""

from __future__ import annotations

__all__ = ["LAUNCHES", "reset_launches"]

LAUNCHES = {
    "aes_ctr_keystream": 0,
    "fused_crypt_mac": 0,
    "fused_crypt_mac_write": 0,
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
