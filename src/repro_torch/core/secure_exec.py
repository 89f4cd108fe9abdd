"""SecureExecutor, the protection schemes (paper Table III) and the SGX
tree-traffic probe.

``SecureExecutor`` wraps a step function so that designated trees
(params, optimizer state) live protected in untrusted memory: the step
decrypts + verifies on entry and re-encrypts + MACs on exit.

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
from typing import Any, Callable

import torch

from repro_torch.core import secure_memory as sm
from repro_torch.core import vn

__all__ = ["SchemeConfig", "SCHEMES", "SecureExecutor", "emulated_tree_probe"]


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


class SecureExecutor:
    """Wraps ``step_fn(params, *args) -> (params, aux)`` with the boundary.

    Typical use::

        ex = SecureExecutor(scheme="seda", keys=SecureKeys.derive(0))
        spec = ex.region_spec(params)
        protected = ex.protect(params, spec, step=0)
        step = ex.make_secure_step(step_fn, spec)
        protected, aux, ok = step(protected, 0, *args)

    Without ``keys`` the executor derives seed-0 keys on ``device``: the
    card unless ``"cpu"``.
    """

    def __init__(self, scheme: str = "seda",
                 keys: sm.SecureKeys | None = None,
                 role: int = int(vn.Role.WEIGHT), *, device=None):
        self.cfg = SCHEMES[scheme]
        self.keys = (keys if keys is not None
                     else sm.SecureKeys.derive(0, device=device))
        self.role = role

    # -- region handling ----------------------------------------------------

    def region_spec(self, tree: Any, layer_of=None) -> sm.RegionSpec:
        return sm.make_region_spec(
            tree, block_bytes=self.cfg.block_bytes,
            mac_engine=self.cfg.mac_engine, role=self.role, layer_of=layer_of,
            use_baes=self.cfg.baes)

    def protect(self, tree: Any, spec: sm.RegionSpec, *, step=0):
        if self.cfg.name == "off":
            return tree  # passthrough: unprotected baseline
        return sm.protect(tree, self.keys, spec, step=step)

    def unprotect(self, state, spec: sm.RegionSpec) -> tuple:
        """``(tree, ok)``, ``ok`` a scalar bool tensor."""
        if self.cfg.name == "off":
            return state, torch.tensor(True, device=self.keys.key.device)
        verify = {"layer": "layer", "block": "layer",
                  "none": "none"}[self.cfg.verify]
        tree, ok = sm.unprotect(state, self.keys, spec, verify=verify)
        if self.cfg.emulate_tree:
            ok = ok & self._emulated_tree_check(state)
        return tree, ok

    # -- the wrapped step ----------------------------------------------------

    def make_secure_step(self, step_fn: Callable,
                         spec: sm.RegionSpec) -> Callable:
        """``(state, step_idx, *args) -> (state', aux, ok)``."""
        if self.cfg.name == "off":
            def insecure_step(state, step_idx, *args):
                new_tree, aux = step_fn(state, *args)
                return new_tree, aux, torch.tensor(
                    True, device=self.keys.key.device)
            return insecure_step

        def secure_step(state: sm.SecureState, step_idx, *args):
            tree, ok = self.unprotect(state, spec)
            new_tree, aux = step_fn(tree, *args)
            new_state = sm.protect(new_tree, self.keys, spec,
                                   step=step_idx + 1)
            return new_state, aux, ok

        return secure_step

    # -- SGX integrity-tree emulation ----------------------------------------

    def _emulated_tree_check(self, state: sm.SecureState) -> torch.Tensor:
        total_blocks = sum(ct.shape[0] // self.cfg.block_bytes
                           for ct in state.ciphertexts)
        return emulated_tree_probe(total_blocks,
                                   device=self.keys.key.device)
