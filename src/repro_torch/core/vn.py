"""On-chip version numbers for KV-cache pages (paper §II-C, Tab. III)."""

from __future__ import annotations

from enum import IntEnum

__all__ = ["Role", "kv_page_vn"]


class Role(IntEnum):
    WEIGHT = 0
    ACTIVATION = 1
    KVCACHE = 2
    OPT_STATE = 3
    GRADIENT = 4
    DATA = 5


def kv_page_vn(write_epoch: int) -> int:
    """VN for a KV-cache page: KVCACHE role tag | 29-bit write epoch.

    The pool bumps one global write epoch per protected write event;
    CTR uniqueness comes from the (PA, VN) pair.  Host-side u32 int.
    """
    return ((int(Role.KVCACHE) << 29)
            | (int(write_epoch) & ((1 << 29) - 1))) & 0xFFFFFFFF
