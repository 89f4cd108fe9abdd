"""SecureRegion: the boundary crossing for trees of tensors.

``protect``   = encrypt (B-AES) + multi-level MAC   (write to untrusted)
``unprotect`` = decrypt + verify                    (read from untrusted)

The static structure (address map, specs, granularity) lives in a
:class:`RegionSpec` built once per tree structure.  Leaves are processed
one at a time, so one leaf's intermediates are freed before the next.

Routing on a CUDA device: narrow B-AES (at most 11 segments, ``seda``)
runs the AES-CTR keystream and diversify + XOR kernels
(:func:`~repro_torch.kernels.otp_xor.ops.baes_encrypt_kernel`), and every
``nh`` block MAC the NH and AES-CTR kernels
(:func:`~repro_torch.kernels.xormac.ops.block_macs_kernel`); on the CPU
those wrappers run their plain versions.  Wide B-AES (``seda512``),
T-AES and the ``cbc``/``naive`` engines are plain torch, as in the
reference; the plain ciphers run in chunks of blocks so their int64
intermediates stay bounded at full model width.  The bytes equal the
reference's ``repro.core.secure_memory`` on every route.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import aes, baes, ctr, mac, vn
from repro_torch.core.bytesutil import (MASK32, bytes_to_tensor,
                                       tensor_to_bytes, u32)
from repro_torch.core.layout import (SEGMENT_BYTES, AddressMap,
                                     build_address_map, tree_flatten,
                                     tree_unflatten)
from repro_torch.kernels.otp_xor import ops as otp_ops
from repro_torch.kernels.xormac import ops as xormac_ops

__all__ = ["SecureKeys", "RegionSpec", "SecureState", "protect", "unprotect",
           "make_region_spec"]

# The plain ciphers run in chunks of about this many AES invocations.
_PLAIN_AES_CHUNK = 1 << 20


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


class RegionSpec(NamedTuple):
    """Static description of a protected tree."""

    treedef: Any
    addr_map: AddressMap
    block_bytes: int
    mac_engine: str
    role: int
    n_layers: int
    use_baes: bool = True  # False = T-AES: one AES call per 16 B segment


class SecureState(NamedTuple):
    """The tree as it lives in untrusted memory."""

    ciphertexts: tuple         # flat tuple of uint8 buffers (padded)
    layer_macs: torch.Tensor   # (n_layers, 8) uint8
    model_mac: torch.Tensor    # (8,) uint8
    vn_lo: int                 # the u32 version number used (host int)


def make_region_spec(tree: Any, *, block_bytes: int = 64,
                     mac_engine: str = "nh", role: int = int(vn.Role.WEIGHT),
                     layer_of=None, use_baes: bool = True) -> RegionSpec:
    """``tree`` holds tensors or specs with ``shape`` and ``dtype``."""
    _, treedef = tree_flatten(tree)
    addr_map = build_address_map(tree, block_bytes=block_bytes,
                                 layer_of=layer_of)
    n_layers = 1 + max((l.layer_id for l in addr_map.leaves), default=0)
    return RegionSpec(treedef, addr_map, block_bytes, mac_engine, role,
                      n_layers, use_baes)


def _leaf_pa(layout, n_blocks: int, block_bytes: int, device) -> torch.Tensor:
    """Each block's PA (int64 u32 words, wrapping as the reference's u32)."""
    seg_per_blk = block_bytes // SEGMENT_BYTES
    pa = torch.arange(n_blocks, dtype=torch.int64, device=device)
    return (pa * seg_per_blk + layout.pa_base) & MASK32


def _leaf_counters(layout, n_blocks: int, vn_lo: int, block_bytes: int,
                   device) -> torch.Tensor:
    """(n_blocks, 4) PA || VN counter words, int32 storage."""
    counters = torch.zeros((n_blocks, 4), dtype=torch.int32, device=device)
    counters[:, 1] = u32(_leaf_pa(layout, n_blocks, block_bytes, device))
    counters[:, 3] = vn_lo - 2 ** 32 if vn_lo >= 2 ** 31 else vn_lo
    return counters


def _crypt(buf: torch.Tensor, keys: SecureKeys, spec: RegionSpec, layout,
           vn_lo: int) -> torch.Tensor:
    """B-AES (one AES per wide block) or T-AES (one per segment) of one
    leaf's padded bytes; the XOR cipher decrypts the same way."""
    n_segments = spec.block_bytes // SEGMENT_BYTES
    n_blocks = buf.shape[0] // spec.block_bytes
    counters = _leaf_counters(layout, n_blocks, vn_lo, spec.block_bytes,
                              buf.device)
    if spec.use_baes and not baes.n_diversifiers(n_segments):
        return otp_ops.baes_encrypt_kernel(buf, keys.round_keys, counters,
                                           block_bytes=spec.block_bytes)
    per_block = (1 + baes.n_diversifiers(n_segments) if spec.use_baes
                 else n_segments)
    step = max(1, _PLAIN_AES_CHUNK // per_block)
    blocks = buf.reshape(n_blocks, spec.block_bytes)
    out = torch.empty_like(blocks)
    for i in range(0, n_blocks, step):
        chunk = blocks[i: i + step]
        if spec.use_baes:
            out[i: i + step] = baes.baes_encrypt(
                chunk, keys.round_keys, counters[i: i + step],
                block_bytes=spec.block_bytes, key=keys.key)
        else:
            out[i: i + step] = ctr.ctr_encrypt(
                chunk, keys.round_keys, 0, layout.pa_base + i * n_segments,
                0, vn_lo)
    return out.reshape(buf.shape)


def _leaf_mac(ct: torch.Tensor, keys: SecureKeys, spec: RegionSpec, layout,
              vn_lo: int) -> torch.Tensor:
    """XOR of one leaf's optBlk MACs -> (8,) uint8."""
    n_blocks = ct.shape[0] // spec.block_bytes
    scalar = lambda v: torch.tensor(v, dtype=torch.int64,  # noqa: E731
                                    device=ct.device)
    binding = mac.Binding.make(
        _leaf_pa(layout, n_blocks, spec.block_bytes, ct.device),
        scalar(vn_lo), scalar(layout.layer_id), scalar(layout.fmap_idx),
        torch.arange(n_blocks, dtype=torch.int64, device=ct.device))
    blocks = ct.reshape(n_blocks, spec.block_bytes)
    if spec.mac_engine == "nh":
        macs = xormac_ops.block_macs_kernel(
            blocks, binding, hash_key_u32=keys.hash_key,
            round_keys=keys.round_keys)
    else:
        macs = mac.block_macs(blocks, binding, hash_key_u32=keys.hash_key,
                              round_keys=keys.round_keys,
                              engine=spec.mac_engine)
    return mac.xor_aggregate(macs)


def _protect_leaf(leaf: torch.Tensor, keys: SecureKeys, spec: RegionSpec,
                  layout, vn_lo: int) -> tuple:
    buf = tensor_to_bytes(leaf.to(keys.key.device),
                          multiple=spec.block_bytes)
    ct = _crypt(buf, keys, spec, layout, vn_lo)
    return ct, _leaf_mac(ct, keys, spec, layout, vn_lo)


def protect(tree: Any, keys: SecureKeys, spec: RegionSpec, *,
            step=0) -> SecureState:
    """Encrypt + MAC a tree for residency in untrusted memory, on the
    keys' device."""
    leaves, _ = tree_flatten(tree)
    vn_lo = int(vn.vn_for(spec.role, layer_id=0, step=step))
    layer_macs = torch.zeros((spec.n_layers, mac.MAC_BYTES),
                             dtype=torch.uint8, device=keys.key.device)
    ciphertexts = []
    for leaf, layout in zip(leaves, spec.addr_map.leaves, strict=True):
        ct, leaf_mac = _protect_leaf(leaf, keys, spec, layout, vn_lo)
        layer_macs[layout.layer_id] ^= leaf_mac
        ciphertexts.append(ct)
    return SecureState(tuple(ciphertexts), layer_macs,
                       mac.model_mac(layer_macs), vn_lo)


def unprotect(state: SecureState, keys: SecureKeys, spec: RegionSpec, *,
              verify: str = "layer") -> tuple:
    """Decrypt + verify on the keys' device; returns ``(tree, ok)`` with
    ``ok`` a scalar bool tensor.

    verify: ``"layer"`` recomputes the layer MACs and compares (the SeDA
    gate); ``"model"`` compares only the model MAC (deferred check);
    ``"none"`` skips verification (unprotected read).
    """
    if verify not in ("layer", "model", "none"):
        raise ValueError(f"verify must be layer, model or none: {verify!r}")
    device = keys.key.device
    vn_lo = int(state.vn_lo)
    layer_macs = torch.zeros((spec.n_layers, mac.MAC_BYTES),
                             dtype=torch.uint8, device=device)
    leaves = []
    for ct, layout in zip(state.ciphertexts, spec.addr_map.leaves,
                          strict=True):
        ct = ct.to(device)
        if verify != "none":
            layer_macs[layout.layer_id] ^= _leaf_mac(ct, keys, spec, layout,
                                                     vn_lo)
        pt = _crypt(ct, keys, spec, layout, vn_lo)
        leaves.append(bytes_to_tensor(pt, layout.spec))
    tree = tree_unflatten(spec.treedef, leaves)
    if verify == "layer":
        ok = torch.all(layer_macs == state.layer_macs.to(device))
    elif verify == "model":
        ok = torch.all(mac.model_mac(layer_macs) == state.model_mac.to(device))
    else:
        ok = torch.tensor(True, device=device)
    return tree, ok
