"""On-chip version numbers (paper §II-C, Tab. III).

The VN of any tensor crossing the boundary is derived on-chip from
(tensor role, layer id, slot, step), so no VN is stored off-chip.
"""

from __future__ import annotations

from enum import IntEnum

import torch

from repro_torch.core.bytesutil import i64, u32

__all__ = ["Role", "vn_for", "vn_words", "kv_page_vn"]


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


def vn_for(role, *, layer_id=0, step=0, slot=0):
    """Deterministic 32-bit VN: role (3b) | layer (9b) | slot (8b) |
    step (12b).

    Host ints give a host int; a tensor field gives int32-stored u32
    words of its shape.
    """
    fields = (layer_id, step, slot)
    if not any(isinstance(f, torch.Tensor) for f in fields):
        return (((int(role) & 0x7) << 29) | ((int(layer_id) & 0x1FF) << 20)
                | ((int(slot) & 0xFF) << 12) | (int(step) & 0xFFF))
    layer, step_, slot_ = (i64(f) for f in fields)
    return u32(((int(role) & 0x7) << 29) | ((layer & 0x1FF) << 20)
               | ((slot_ & 0xFF) << 12) | (step_ & 0xFFF))


def vn_words(role, *, layer_id=0, step=0, slot=0):
    """(vn_hi, vn_lo) pair for counter construction; vn_hi is zero."""
    lo = vn_for(role, layer_id=layer_id, step=step, slot=slot)
    return (torch.zeros_like(lo) if isinstance(lo, torch.Tensor) else 0), lo
