"""Seeded weights, drawn on the device in the type they are served in.

One ``torch.Generator`` on the device, one draw a stacked leaf (every
layer of a kind at once), so a full-width model takes a dozen calls.
Matrices are normal with standard deviation 1/sqrt(fan-in of one layer,
over the axes the matmul contracts); embeddings 0.02; norm scales one.
At the fan-in of one layer the residual stream and the attention scores
stay of order one through every layer, so the greedy tokens depend on
the context the pages hold.

The layout is each family's own (``perfbench/families/<family>.py``
``shapes``: flat names, a leading layer axis); the family's
``program_tree`` hands the same tensors, not copies, to the program in
its tree form.
"""

from __future__ import annotations

import math

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _draw(gen, shape, fan_in, dtype, device):
    w = torch.randn(shape, generator=gen, dtype=dtype, device=device)
    return w.mul_(1.0 / math.sqrt(fan_in))


def make(shapes: dict, seed: int, device) -> dict:
    """Draw every leaf of ``shapes`` from ``seed`` on ``device``."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    out = {}
    for name, (shape, fan_in, dtype) in shapes.items():
        dt = DTYPES[dtype]
        if fan_in is None:
            out[name] = torch.ones(shape, dtype=dt, device=device)
        elif fan_in == "embed":
            out[name] = torch.randn(shape, generator=gen, dtype=dt,
                                    device=device).mul_(0.02)
        else:
            out[name] = _draw(gen, shape, fan_in, dt, device)
    return out
