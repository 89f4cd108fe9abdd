"""Plain PyTorch version of the B-AES diversify + XOR kernel."""

from __future__ import annotations

import torch

__all__ = ["otp_xor_ref"]


def otp_xor_ref(data_lanes: torch.Tensor, base_otp_lanes: torch.Tensor,
                div_lanes: torch.Tensor) -> torch.Tensor:
    """Apply per-segment diversified OTPs to wide blocks (int32 storage):

        out[n, 4s + l] = data[n, 4s + l] ^ base[n, l] ^ div[s, l]

    data (N, 4S), base (N, 4), div (S, 4), or per-block (N, S, 4) for
    the mixed-key callers.
    """
    n, lanes = data_lanes.shape
    s = div_lanes.shape[-2]
    pads = base_otp_lanes[:, None, :] ^ div_lanes
    return (data_lanes.reshape(n, s, 4) ^ pads).reshape(n, lanes)
