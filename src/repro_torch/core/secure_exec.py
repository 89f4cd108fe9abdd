"""Protection schemes (paper Table III) and the SGX tree-traffic probe.

  off      — no protection (unprotected baseline)
  sgx64    — 64B granularity, per-block gate, off-chip VN + emulated tree
  sgx512   — 512B granularity variant
  mgx64    — 64B granularity, per-block MACs, on-chip VNs (no tree)
  mgx512   — 512B granularity variant
  seda     — B-AES + multi-level MACs: layer MAC gate, model MAC deferred
  seda512  — wide-block B-AES (512B optBlk, wide-mode diversifiers)
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["SchemeConfig", "SCHEMES", "emulated_tree_probe"]


def emulated_tree_probe(n_blocks: int, device=None) -> torch.Tensor:
    """Touch VN-table + 8-ary-tree-node bytes so traffic matches SGX.

    The check is a tautology (traffic is modelled, not a second MAC
    hierarchy): a scalar bool tensor that is True.
    """
    n_nodes = 0
    level = max(1, n_blocks)
    while level > 1:
        level = (level + 7) // 8
        n_nodes += level
    vn_table = torch.zeros((max(1, n_blocks), 2), dtype=torch.int64,
                           device=device)
    tree_nodes = torch.zeros((max(1, n_nodes), 16), dtype=torch.int64,
                             device=device)
    return (vn_table.sum() + tree_nodes.sum()) == 0


@dataclasses.dataclass(frozen=True)
class SchemeConfig:
    name: str
    block_bytes: int          # protection granularity
    verify: str               # "layer" | "block" | "none"
    mac_engine: str           # "nh" | "cbc" | "naive"
    emulate_vn_offchip: bool  # SGX: VN table in untrusted memory
    emulate_tree: bool        # SGX: integrity-tree traffic
    baes: bool                # bandwidth-aware encryption (False = T-AES)


SCHEMES = {
    "off": SchemeConfig("off", 64, "none", "nh", False, False, True),
    "sgx64": SchemeConfig("sgx64", 64, "block", "nh", True, True, False),
    "sgx512": SchemeConfig("sgx512", 512, "block", "nh", True, True, False),
    "mgx64": SchemeConfig("mgx64", 64, "block", "nh", False, False, False),
    "mgx512": SchemeConfig("mgx512", 512, "block", "nh", False, False, False),
    "seda": SchemeConfig("seda", 64, "layer", "nh", False, False, True),
    "seda512": SchemeConfig("seda512", 512, "layer", "nh", False, False, True),
}
