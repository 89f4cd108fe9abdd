"""Multi-tenant key management for the port's secure serving engine.

`keys`     — hierarchical AES-based KDF: root key -> per-tenant master
             -> purpose-split {encrypt, MAC, VN} keys -> numbered epoch
             keys, with explicit epoch rotation.
`registry` — tenant registration, per-tenant page quotas / weights,
             session handles, and the device key bank the data plane
             picks per-page keys from.
"""

from repro_torch.tenancy.keys import KeyHierarchy, TenantKeySet
from repro_torch.tenancy.registry import (KeyBank, SessionHandle, Tenant,
                                          TenantRegistry)

__all__ = ["KeyHierarchy", "TenantKeySet", "KeyBank", "SessionHandle",
           "Tenant", "TenantRegistry"]
