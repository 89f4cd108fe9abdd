"""Session keys for the secure-memory boundary."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import aes

__all__ = ["SecureKeys"]


class SecureKeys(NamedTuple):
    key: torch.Tensor         # (16,) uint8 AES key (Ke)
    round_keys: torch.Tensor  # (11, 16) uint8 schedule
    hash_key: torch.Tensor    # (n_lanes,) u32 NH key (Kh), int32 storage

    @staticmethod
    def derive(seed: int, *, nh_lanes: int = 2048,
               device=None) -> "SecureKeys":
        """Derive session keys from a seed with numpy's generator, so the
        same seed gives the reference package's bytes exactly.

        ``nh_lanes`` bounds the optBlk size: block_bytes/4 + 8 lanes.
        The keys land on ``device``: the card unless ``"cpu"``.
        """
        device = resolve_device(device)
        rng = np.random.default_rng(np.uint32(seed) if np.isscalar(seed)
                                    else None)
        key_np = rng.integers(0, 256, size=16, dtype=np.uint8)
        hash_np = rng.integers(0, 2 ** 32, size=nh_lanes, dtype=np.uint32)
        return SecureKeys(
            key=torch.as_tensor(key_np, device=device),
            round_keys=torch.as_tensor(aes.key_expansion_np(key_np),
                                       device=device),
            hash_key=torch.as_tensor(hash_np.view(np.int32), device=device))

    def to(self, device) -> "SecureKeys":
        return SecureKeys(*(t.to(device) for t in self))
