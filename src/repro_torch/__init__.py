"""PyTorch + CUDA port of the SeDA reproduction (NVIDIA Hopper).

Mirrors the layout of the JAX package ``repro``: ``core`` (crypto and
MACs in plain torch), ``kernels`` (hand-written CUDA kernels for
``sm_90a`` beside their plain versions), ``models`` (dense-attention
LM), ``serve`` (paged secure serving) and ``configs``.  The JAX package
stays the reference; this package imports torch and numpy only.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(see :func:`resolve_device`); they never fall back to the CPU silently.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``None`` means the card: raise when there is none.

    An explicit ``"cpu"`` (what the tests pass) runs every kernel
    wrapper through its plain version.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run the plain versions")
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device
