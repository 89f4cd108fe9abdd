"""Hierarchical tenant key derivation (per-tenant cryptographic domains).

A copy of the reference's KDF (``repro.tenancy.keys``) on the port's
AES (:mod:`repro_torch.core.aes`); every derived byte, NH lane and salt
equals the reference's.

::

    root (16B)
     └─ tenant master   M_t = PRF(root, "tenant" ‖ tenant_id)
         ├─ encrypt     E_t = PRF(M_t, "purpose:enc")
         ├─ MAC         H_t = PRF(M_t, "purpose:mac")
         └─ VN          V_t = PRF(M_t, "purpose:vn")
             per epoch e:
               cipher key    E_{t,e}  = PRF(E_t, "epoch" ‖ u64le(e))
               NH hash key   lanes    = AES-CTR_{PRF(H_t, "epoch" ‖ u64le(e))}
               counter salt  s_{t,e}  = PRF(V_t, "epoch" ‖ u64le(e))[:4]
             plus one epoch-independent branch (label "cache:prefix").

PRF is AES-128-CBC-MAC over ISO/IEC 9797-1 method-2 padded blocks.
Derivation runs on the host at registration and rotation, never on
the decode path; the derived :class:`SecureKeys` land on the
hierarchy's device (the card unless ``device="cpu"``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import aes
from repro_torch.core.secure_memory import SecureKeys

__all__ = ["KeyHierarchy", "TenantKeySet", "prf"]


def _aes_blocks_np(blocks: np.ndarray, round_keys: np.ndarray) -> np.ndarray:
    """AES-128 of (n, 16) u8 blocks on the host."""
    out = aes.aes128_encrypt_block(torch.from_numpy(np.ascontiguousarray(
        blocks, np.uint8)), torch.from_numpy(round_keys))
    return out.numpy()


def _pad_message(msg: bytes) -> np.ndarray:
    """ISO/IEC 9797-1 method-2 padding: 0x80 then zeros to 16B blocks."""
    buf = msg + b"\x80"
    buf += b"\x00" * (-len(buf) % 16)
    return np.frombuffer(buf, np.uint8).reshape(-1, 16)


def prf(key: np.ndarray, msg: bytes) -> np.ndarray:
    """AES-128-CBC-MAC PRF: (16,) u8 key x message bytes -> (16,) u8."""
    round_keys = aes.key_expansion_np(np.asarray(key, np.uint8).reshape(16))
    state = np.zeros(16, np.uint8)
    for block in _pad_message(msg):
        state = _aes_blocks_np((state ^ block)[None], round_keys)[0]
    return state


def _expand_lanes(seed_key: np.ndarray, n_lanes: int) -> np.ndarray:
    """AES-CTR keystream under ``seed_key`` -> (n_lanes,) u32 NH lanes
    (the block index big-endian in bytes 12..15, lanes little-endian)."""
    round_keys = aes.key_expansion_np(seed_key)
    n_blocks = -(-n_lanes * 4 // 16)
    counters = np.zeros((n_blocks, 16), np.uint8)
    idx = np.arange(n_blocks, dtype=np.uint32)
    for shift, col in zip((24, 16, 8, 0), range(12, 16)):
        counters[:, col] = (idx >> shift) & 0xFF
    stream = _aes_blocks_np(counters, round_keys).reshape(-1)
    return stream[: n_lanes * 4].view(np.uint32).copy()


def _secure_keys(cipher: np.ndarray, lanes: np.ndarray, device) -> SecureKeys:
    return SecureKeys(
        key=torch.as_tensor(cipher, device=device),
        round_keys=torch.as_tensor(aes.key_expansion_np(cipher),
                                   device=device),
        hash_key=torch.as_tensor(lanes.view(np.int32), device=device))


def _derive(enc_key, mac_key, vn_key, label: bytes, nh_lanes: int, device):
    cipher = prf(enc_key, label)
    lanes = _expand_lanes(prf(mac_key, label), nh_lanes)
    salt = int(prf(vn_key, label)[:4].view(np.uint32)[0])   # little-endian
    return _secure_keys(cipher, lanes, device), salt


@dataclasses.dataclass
class TenantKeySet:
    """One tenant's subtree of the hierarchy, with live epoch state.

    Epoch material is held per epoch; :meth:`drop_before` destroys the
    epochs that leave the registry's retained window.
    """

    tenant_id: str
    master: np.ndarray
    enc_key: np.ndarray
    mac_key: np.ndarray
    vn_key: np.ndarray
    nh_lanes: int
    device: torch.device
    current_epoch: int = 0
    _epochs: dict = dataclasses.field(default_factory=dict)
    _cache: tuple = None

    def epoch_keys(self, epoch: int) -> SecureKeys:
        """Data-plane keys for one (tenant, epoch)."""
        return self._materialize(epoch)[0]

    def epoch_salt(self, epoch: int) -> int:
        """u32 CTR-counter salt derived from the VN purpose key."""
        return self._materialize(epoch)[1]

    def _materialize(self, epoch: int):
        if epoch < 0:
            raise KeyError(f"tenant {self.tenant_id!r}: negative epoch")
        if epoch not in self._epochs:
            if epoch < self.current_epoch:
                raise KeyError(
                    f"tenant {self.tenant_id!r}: epoch {epoch} key material "
                    f"was dropped (current epoch {self.current_epoch})")
            label = b"epoch" + int(epoch).to_bytes(8, "little")
            self._epochs[epoch] = _derive(self.enc_key, self.mac_key,
                                          self.vn_key, label, self.nh_lanes,
                                          self.device)
        return self._epochs[epoch]

    def cache_keys(self) -> SecureKeys:
        """Keys of this tenant's epoch-independent prefix-cache binding."""
        return self._materialize_cache()[0]

    def cache_salt(self) -> int:
        return self._materialize_cache()[1]

    def _materialize_cache(self):
        if self._cache is None:
            self._cache = _derive(self.enc_key, self.mac_key, self.vn_key,
                                  b"cache:prefix", self.nh_lanes, self.device)
        return self._cache

    def rotate(self) -> int:
        """Bump the epoch and derive its keys."""
        self.current_epoch += 1
        self._materialize(self.current_epoch)
        return self.current_epoch

    def drop_before(self, epoch: int) -> None:
        """Destroy key material for epochs < ``epoch`` (retention edge)."""
        for e in [e for e in self._epochs if e < epoch]:
            del self._epochs[e]


class KeyHierarchy:
    """Root of the KDF tree: derives per-tenant key subtrees.

    ``root`` is an int seed (the reference's numpy draw, so the same
    seed gives the same root) or 16 raw bytes.  Derived keys live on
    ``device``: the card unless ``device="cpu"``.
    """

    def __init__(self, root, *, nh_lanes: int = 2048, device=None):
        if isinstance(root, (int, np.integer)):
            rng = np.random.default_rng(np.uint32(root))
            root = rng.integers(0, 256, size=16, dtype=np.uint8)
        root = np.asarray(
            np.frombuffer(root, np.uint8) if isinstance(root, bytes) else root,
            np.uint8).reshape(16)
        self._root = root
        self.nh_lanes = nh_lanes
        self.device = resolve_device(device)

    def derive_tenant(self, tenant_id: str) -> TenantKeySet:
        master = prf(self._root, b"tenant" + tenant_id.encode())
        return TenantKeySet(
            tenant_id=tenant_id, master=master,
            enc_key=prf(master, b"purpose:enc"),
            mac_key=prf(master, b"purpose:mac"),
            vn_key=prf(master, b"purpose:vn"),
            nh_lanes=self.nh_lanes, device=self.device)
