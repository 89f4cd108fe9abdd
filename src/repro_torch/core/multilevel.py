"""Multi-level integrity verification policy (paper §III-C, Table I).

optBlk MAC (off-chip, flexible), layer MAC (XOR of a layer's optBlk
MACs) and model MAC (deferred).  ``VerifyPolicy`` says which level gates
a read and which is deferred.
"""

from __future__ import annotations

import enum
from typing import NamedTuple

__all__ = ["Level", "Residency", "VerifyPolicy", "SEDA_DEFAULT", "SGX_LIKE",
           "MGX_LIKE"]


class Level(enum.IntEnum):
    OPTBLK = 0
    LAYER = 1
    MODEL = 2


class Residency(enum.IntEnum):
    ONCHIP = 0
    OFFCHIP = 1


class VerifyPolicy(NamedTuple):
    """Which MAC levels exist, where they live, and which gates reads."""

    gate_level: Level
    deferred_model_mac: bool
    layer_residency: Residency
    optblk_residency: Residency
    has_integrity_tree: bool
    per_block_vn_offchip: bool

    @property
    def name(self) -> str:
        return f"gate={self.gate_level.name.lower()}"


SEDA_DEFAULT = VerifyPolicy(Level.LAYER, True, Residency.ONCHIP,
                            Residency.ONCHIP, False, False)
SGX_LIKE = VerifyPolicy(Level.OPTBLK, False, Residency.OFFCHIP,
                        Residency.OFFCHIP, True, True)
MGX_LIKE = VerifyPolicy(Level.OPTBLK, False, Residency.OFFCHIP,
                        Residency.OFFCHIP, False, False)
