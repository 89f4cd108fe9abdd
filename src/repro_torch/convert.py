"""Carry a parameter tree across from numpy arrays.

The reference package's parameters, turned into numpy arrays leaf by
leaf, have the same tree layout as the port's specs
(:func:`repro_torch.models.lm.lm_specs`, with ``img_proj`` for a VLM;
:func:`repro_torch.models.encdec.encdec_specs` for the encoder-decoder);
:func:`params_from_numpy` makes them torch tensors, so both packages
compute the same function on the same weights, and their flat leaf
order (:func:`repro_torch.core.layout.tree_flatten`) is the
reference's, on which the secure state and checkpoints depend.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models.encdec import EncDecConfig, encdec_specs
from repro_torch.models.layers import DTYPES, ParamSpec
from repro_torch.models.lm import LMConfig, lm_specs

__all__ = ["params_from_numpy"]


def _tensor(arr: np.ndarray, dtype: str, device) -> torch.Tensor:
    arr = np.array(arr, copy=True)         # owned and writable
    if arr.dtype.name == "bfloat16":       # ml_dtypes: no torch from_numpy
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device=device, dtype=DTYPES[dtype])


def params_from_numpy(cfg: LMConfig | EncDecConfig, tree: Any,
                      device=None) -> dict:
    """Numpy parameter tree (reference layout) -> torch parameter tree.

    Leaves are matched by key path and checked against the config's
    specs.
    """
    device = resolve_device(device)

    def walk(s: Any, t: Any, path: str) -> Any:
        if isinstance(s, ParamSpec):
            if tuple(np.shape(t)) != s.shape:
                raise ValueError(f"{path}: shape {tuple(np.shape(t))} != "
                                 f"{s.shape}")
            return _tensor(t, s.dtype, device)
        if isinstance(s, dict):
            return {k: walk(v, t[k], f"{path}[{k!r}]") for k, v in s.items()}
        if len(s) != len(t):
            raise ValueError(f"{path}: {len(t)} entries, expected {len(s)}")
        return [walk(a, b, f"{path}[{i}]") for i, (a, b) in
                enumerate(zip(s, t))]

    specs = (encdec_specs(cfg) if isinstance(cfg, EncDecConfig)
             else lm_specs(cfg))
    return walk(specs, tree, "params")
