"""Matmuls of the plain references, in float32 or in a lower precision.

``"float32"``: an exact float32 product; the module turns TF32 off for
the whole process when it is imported.  ``"fp8"``: the control, a
product whose operands are first rounded to float8 e4m3 (the weight per
output column, the activation per row, each scaled by its largest
magnitude over 448, e4m3's largest finite value), then multiplied in
float32: the step from bf16 a later change would be tempted to take.
In training the rounding passes gradients straight through.
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

E4M3_MAX = 448.0


def fake_fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` rounded to e4m3 at a scale per slice along ``dim``, back in
    float32."""
    amax = x.detach().abs().amax(dim=dim, keepdim=True).clamp(min=1e-12)
    scale = amax / E4M3_MAX
    q = (x.detach() / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    return x + (q - x).detach()


def matmul(x: torch.Tensor, w: torch.Tensor, precision: str) -> torch.Tensor:
    """``x (..., k) @ w (k, n)`` in float32, or through the fp8 control."""
    x, w = x.float(), w.float()
    if precision == "fp8":
        x = fake_fp8(x, -1)
        w = fake_fp8(w, 0)
    elif precision != "float32":
        raise ValueError(f"unknown precision {precision!r}")
    return x @ w
