"""Tenant registry: identities, quotas, sessions, and the key bank.

A port of ``repro.tenancy.registry``:

* **registration** gives each tenant a dense index, a scheduling weight
  and a page quota (the cap on its resident KV pages);
* **session handles** are the revocable capability a request carries
  into :meth:`repro_torch.serve.engine.SecureServingEngine.submit`;
* the **key bank** holds every retained (tenant, epoch) key set as
  tensors on a device; the decode step picks per-page keys from it by
  row index, so one step serves pages of many tenants and epochs;
* **rotation** bumps a tenant's epoch: pre-rotation hooks run while the
  dying epoch's row is still banked (engines reseal there), then the
  new epoch's keys overwrite that row and post hooks run.

Bank rows: ``row(tenant, epoch) = index * retain + epoch % retain``;
after the epoch rows, ``cache_row(tenant) = max_tenants * retain +
index`` holds the tenant's epoch-independent prefix-cache keys.

Unlike the reference, whose bank is an immutable value replaced on
every change, the port writes a changed row IN PLACE, into the bank and
into every device replica handed out by :meth:`TenantRegistry.bank_for`.
Engines therefore see a rotation without fetching the bank again.  On
one CUDA stream in eager mode the copy is ordered after every launch
already queued that reads the old row (the pre-rotation reseal
included); a captured CUDA graph that reads the bank must keep that
order too.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.tenancy.keys import KeyHierarchy

__all__ = ["KeyBank", "SessionHandle", "Tenant", "TenantRegistry"]


class KeyBank(NamedTuple):
    """Stacked per-row data-plane keys (tensors on one device).

    Unregistered rows are zero (any page claiming them fails its MAC
    gate).  u32 words are int32 storage, as everywhere in the port.
    """

    key: torch.Tensor         # (K, 16) uint8 cipher keys
    round_keys: torch.Tensor  # (K, 11, 16) uint8 schedules
    hash_key: torch.Tensor    # (K, n_lanes) u32 NH lanes
    salt: torch.Tensor        # (K,) u32 CTR-counter salts

    def to(self, device) -> "KeyBank":
        return KeyBank(*(t.to(device) for t in self))


class SessionHandle(NamedTuple):
    """Capability a request carries: who it is + a revocable token."""

    tenant_id: str
    index: int
    token: int


@dataclasses.dataclass
class Tenant:
    tenant_id: str
    index: int
    weight: float
    page_quota: int
    keyset: object           # tenancy.keys.TenantKeySet

    @property
    def current_epoch(self) -> int:
        return self.keyset.current_epoch


class TenantRegistry:
    """Control plane over a :class:`~repro_torch.tenancy.keys.KeyHierarchy`.

    The bank lives on ``device``: the hierarchy's device when one is
    given, else the card unless ``device="cpu"``.
    """

    def __init__(self, hierarchy: Optional[KeyHierarchy] = None, *,
                 max_tenants: int = 8, retain: int = 2,
                 default_quota: Optional[int] = None, device=None):
        if retain < 2:
            raise ValueError("retain < 2 would drop the previous epoch key "
                             "lazy rotation still needs for reads")
        if device is None and hierarchy is not None:
            device = hierarchy.device
        self.device = resolve_device(device)
        self.hierarchy = hierarchy or KeyHierarchy(0, device=self.device)
        self.max_tenants = max_tenants
        self.retain = retain
        self.default_quota = default_quota
        self.tenants: dict = {}
        self._by_index: list = []
        self._sessions: dict = {}
        self._next_token = 0
        self._rotation_hooks: list = []
        self._pre_rotation_hooks: list = []
        self._bank_replicas: dict = {}      # device -> KeyBank copy
        k = max_tenants * (retain + 1)      # epoch rows + one cache row each
        lanes = self.hierarchy.nh_lanes
        dev = self.device
        self._bank = KeyBank(
            key=torch.zeros((k, 16), dtype=torch.uint8, device=dev),
            round_keys=torch.zeros((k, 11, 16), dtype=torch.uint8,
                                   device=dev),
            hash_key=torch.zeros((k, lanes), dtype=torch.int32, device=dev),
            salt=torch.zeros((k,), dtype=torch.int32, device=dev))

    # -- registration / sessions --------------------------------------------

    def register(self, tenant_id: str, *, weight: float = 1.0,
                 page_quota: Optional[int] = None) -> Tenant:
        if tenant_id in self.tenants:
            raise ValueError(f"tenant {tenant_id!r} already registered")
        if len(self._by_index) >= self.max_tenants:
            raise ValueError(f"registry full ({self.max_tenants} tenants)")
        if weight <= 0:
            raise ValueError("tenant weight must be positive")
        quota = page_quota if page_quota is not None else self.default_quota
        tenant = Tenant(tenant_id=tenant_id, index=len(self._by_index),
                        weight=weight,
                        page_quota=quota if quota is not None else 1 << 30,
                        keyset=self.hierarchy.derive_tenant(tenant_id))
        self.tenants[tenant_id] = tenant
        self._by_index.append(tenant)
        self._install_epoch(tenant, tenant.current_epoch)
        self._install_cache_row(tenant)
        return tenant

    def open_session(self, tenant_id: str) -> SessionHandle:
        tenant = self.tenants[tenant_id]
        token = self._next_token
        self._next_token += 1
        self._sessions[token] = tenant_id
        return SessionHandle(tenant_id, tenant.index, token)

    def revoke(self, handle: SessionHandle) -> None:
        self._sessions.pop(handle.token, None)

    def validate(self, handle: SessionHandle) -> Tenant:
        if self._sessions.get(handle.token) != handle.tenant_id:
            raise PermissionError(
                f"invalid or revoked session for tenant {handle.tenant_id!r}")
        tenant = self.tenants[handle.tenant_id]
        if tenant.index != handle.index:
            raise PermissionError("session handle/tenant index mismatch")
        return tenant

    def by_index(self, index: int) -> Tenant:
        return self._by_index[index]

    @property
    def n_tenants(self) -> int:
        return len(self._by_index)

    # -- key bank / rotation -------------------------------------------------

    @property
    def bank(self) -> KeyBank:
        return self._bank

    def bank_for(self, device=None) -> KeyBank:
        """The key bank on ``device`` (the registry's own when None).

        Replicas on other devices are made once and then kept current
        in place by every row install.
        """
        if device is None:
            return self._bank
        device = resolve_device(device)
        if device == self.device:
            return self._bank
        if device not in self._bank_replicas:
            self._bank_replicas[device] = self._bank.to(device)
        return self._bank_replicas[device]

    def key_row(self, index: int, epoch: int) -> int:
        """Bank row for (tenant index, epoch); KeyError outside retention."""
        tenant = self._by_index[index]
        if not (tenant.current_epoch - self.retain < epoch
                <= tenant.current_epoch):
            raise KeyError(
                f"tenant {tenant.tenant_id!r}: epoch {epoch} outside the "
                f"retained window (current {tenant.current_epoch}, "
                f"retain {self.retain})")
        return index * self.retain + epoch % self.retain

    def cache_row(self, index: int) -> int:
        """Bank row holding ``index``'s epoch-independent cache keys."""
        if not (0 <= index < len(self._by_index)):
            raise KeyError(f"tenant index {index} not registered")
        return self.max_tenants * self.retain + index

    def attach_rotation_hook(self, hook, *, pre: bool = False) -> None:
        """Register ``hook(tenant, new_epoch)`` to run around rotations.

        ``pre=True`` hooks run before any key moves (the epoch about to
        leave the window is still banked); post hooks run after the new
        keys are installed.  The registry holds a strong reference.
        """
        (self._pre_rotation_hooks if pre else self._rotation_hooks).append(
            hook)

    def rotate(self, tenant_id: str) -> int:
        """Bump ``tenant_id``'s epoch (live rotation); see the module doc."""
        tenant = self.tenants[tenant_id]
        new_epoch = tenant.current_epoch + 1
        for hook in self._pre_rotation_hooks:
            hook(tenant, new_epoch)
        if tenant.keyset.rotate() != new_epoch:
            raise RuntimeError("keyset rotation desynced from the epoch "
                               "announced to pre-rotation hooks")
        tenant.keyset.drop_before(new_epoch - self.retain + 1)
        self._install_epoch(tenant, new_epoch)
        for hook in self._rotation_hooks:
            hook(tenant, new_epoch)
        return new_epoch

    def keys_for(self, index: int, epoch: int):
        return self._by_index[index].keyset.epoch_keys(epoch)

    def _install_epoch(self, tenant: Tenant, epoch: int) -> None:
        keys = tenant.keyset.epoch_keys(epoch)
        self._install_row(self.key_row(tenant.index, epoch), keys,
                          tenant.keyset.epoch_salt(epoch))

    def _install_cache_row(self, tenant: Tenant) -> None:
        self._install_row(self.cache_row(tenant.index),
                          tenant.keyset.cache_keys(),
                          tenant.keyset.cache_salt())

    def _install_row(self, row: int, keys, salt: int) -> None:
        """Write one row in place, in the bank and every replica."""
        salt_i32 = int(np.uint32(salt).view(np.int32))
        for bank in (self._bank, *self._bank_replicas.values()):
            bank.key[row] = keys.key.to(bank.key.device)
            bank.round_keys[row] = keys.round_keys.to(bank.key.device)
            bank.hash_key[row] = keys.hash_key[: bank.hash_key.shape[1]].to(
                bank.key.device)
            bank.salt[row] = salt_i32
