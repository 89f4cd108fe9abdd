"""SeDA-secured checkpoints: weights at rest in untrusted storage.

A checkpoint is a tree crossing the untrusted boundary.  Every leaf is
B-AES encrypted and MACed (:func:`repro_torch.core.secure_memory.protect`);
the manifest records the layer MACs, the model MAC, the version number
and any serving audit proofs.  Restore verifies before trusting: a
flipped byte anywhere fails loudly.  Leaf files and ``manifest.json``
are byte-identical to the reference's (``repro.checkpoint.secure_ckpt``)
for the same tree and keys, so checkpoints cross between the packages.

Crash safety: leaves and manifest are fsynced into ``<dir>.tmp``, the
manifest is written last, and the publish is a rename that never
destroys the previous checkpoint first (the old directory is moved
aside and removed only after the new one is in place), so a crash at
any point leaves either the old or the new checkpoint discoverable,
never a torn one; :func:`latest_step` and :func:`load_checkpoint`
ignore ``.tmp``/``.old`` debris and manifest-less directories.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import secure_memory as sm
from repro_torch.core import vn as vn_mod
from repro_torch.serve import merkle_pool as mkp

__all__ = ["save_checkpoint", "load_checkpoint", "latest_step",
           "CheckpointError"]

MANIFEST = "manifest.json"


class CheckpointError(RuntimeError):
    pass


def _write_durable(path: str, data) -> None:
    """Write + flush + fsync: the bytes are on disk before the rename."""
    with open(path, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())


def _fsync_dir(path: str) -> None:
    """Persist directory entries (renames); best effort on filesystems
    that refuse directory fds."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _is_complete(path: str) -> bool:
    """A checkpoint directory counts only once its manifest exists: the
    manifest is written last, so its presence implies every leaf."""
    return os.path.isfile(os.path.join(path, MANIFEST))


def save_checkpoint(directory: str, step: int, tree: Any,
                    keys: sm.SecureKeys, *, block_bytes: int = 512,
                    extra_state: Optional[dict] = None,
                    mesh_shape: Optional[tuple] = None,
                    audit_proofs: Optional[list] = None) -> str:
    """Protect ``tree`` on the keys' device and write it atomically.

    ``audit_proofs`` are :class:`repro_torch.serve.merkle_pool.AuditProof`
    objects or their ``to_dict()`` forms; :func:`load_checkpoint`
    re-verifies each.  ``mesh_shape`` is stored as given.  Returns the
    checkpoint path ``<directory>/step_<step>``.
    """
    spec = sm.make_region_spec(tree, block_bytes=block_bytes,
                               role=int(vn_mod.Role.WEIGHT))
    state = sm.protect(tree, keys, spec, step=step)

    final = os.path.join(directory, f"step_{step:08d}")
    tmp, old = final + ".tmp", final + ".old"
    for stale in (tmp, old):            # debris from a prior crash
        if os.path.exists(stale):
            shutil.rmtree(stale)
    os.makedirs(tmp, exist_ok=True)

    files = [f"leaf_{i:05d}.bin" for i in range(len(state.ciphertexts))]
    for ct, fname in zip(state.ciphertexts, files):
        _write_durable(os.path.join(tmp, fname), ct.cpu().numpy())

    manifest = {
        "step": step,
        "block_bytes": block_bytes,
        "vn_lo": int(state.vn_lo),
        "layer_macs": state.layer_macs.cpu().numpy().tolist(),
        "model_mac": state.model_mac.cpu().numpy().tolist(),
        "leaves": [
            {"file": fname, "path": layout.path,
             "shape": list(layout.spec.shape), "dtype": layout.spec.dtype,
             "nbytes": layout.spec.nbytes, "layer_id": layout.layer_id}
            for fname, layout in zip(files, spec.addr_map.leaves)
        ],
        "mesh_shape": list(mesh_shape) if mesh_shape else None,
        "extra_state": extra_state or {},
        "audit_proofs": [p if isinstance(p, dict) else p.to_dict()
                         for p in (audit_proofs or [])],
    }
    # The manifest is written LAST (and fsynced): its presence is the
    # commit record for the whole directory.
    _write_durable(os.path.join(tmp, MANIFEST),
                   json.dumps(manifest, indent=1).encode())
    _fsync_dir(tmp)
    # Publish without a destroy-then-rename window: move any previous
    # checkpoint aside, rename the new one in, only then drop the old.
    if os.path.exists(final):
        os.rename(final, old)
    os.rename(tmp, final)
    _fsync_dir(directory)
    if os.path.exists(old):
        shutil.rmtree(old)
    return final


def load_checkpoint(path: str, template: Any, keys: sm.SecureKeys, *,
                    verify: str = "layer", device=None) -> tuple:
    """Load + decrypt + verify; returns ``(tree, manifest)``.

    ``template`` fixes the tree structure: tensors, or specs with
    ``shape`` and ``dtype`` (``ParamSpec``, ``TensorSpec``).  The tree
    lands on ``device``, the card unless ``"cpu"``; the keys move there.
    Raises :class:`CheckpointError` when the directory is not a
    published checkpoint, does not match the template, or fails
    verification.
    """
    device = resolve_device(device)
    if not _is_complete(path):
        raise CheckpointError(f"no manifest in {path}: not a published "
                              f"checkpoint (torn or foreign directory)")
    with open(os.path.join(path, MANIFEST)) as f:
        manifest = json.load(f)

    spec = sm.make_region_spec(template,
                               block_bytes=int(manifest["block_bytes"]),
                               role=int(vn_mod.Role.WEIGHT))
    if len(spec.addr_map.leaves) != len(manifest["leaves"]):
        raise CheckpointError(
            f"leaf count mismatch: template {len(spec.addr_map.leaves)} vs "
            f"checkpoint {len(manifest['leaves'])}")
    for layout, entry in zip(spec.addr_map.leaves, manifest["leaves"]):
        if (list(layout.spec.shape) != entry["shape"]
                or layout.spec.dtype != entry["dtype"]):
            raise CheckpointError(
                f"spec mismatch at {layout.path}: template "
                f"{layout.spec.shape}/{layout.spec.dtype} vs checkpoint "
                f"{entry['shape']}/{entry['dtype']}")

    cts = []
    for layout, entry in zip(spec.addr_map.leaves, manifest["leaves"]):
        raw = np.fromfile(os.path.join(path, entry["file"]), dtype=np.uint8)
        if raw.size != layout.padded_bytes:
            raise CheckpointError(f"truncated leaf file {entry['file']}")
        cts.append(torch.from_numpy(raw).to(device))

    state = sm.SecureState(
        ciphertexts=tuple(cts),
        layer_macs=torch.tensor(manifest["layer_macs"], dtype=torch.uint8,
                                device=device),
        model_mac=torch.tensor(manifest["model_mac"], dtype=torch.uint8,
                               device=device),
        vn_lo=int(manifest["vn_lo"]))
    tree, ok = sm.unprotect(state, keys.to(device), spec, verify=verify)
    if not bool(ok):
        raise CheckpointError(
            f"integrity verification FAILED for checkpoint {path} "
            f"(tampered or wrong key)")
    _verify_manifest_proofs(path, manifest)
    return tree, manifest


def _verify_manifest_proofs(path: str, manifest: dict) -> None:
    """Re-verify the serving audit proofs riding in the manifest: a
    tampered transcript fails the restore like a tampered leaf."""
    for i, entry in enumerate(manifest.get("audit_proofs") or []):
        try:
            mkp.verify_proof(mkp.proof_from_dict(entry))
        except mkp.ProofError as err:
            raise CheckpointError(
                f"audit proof {i} in checkpoint {path} failed verification "
                f"({type(err).__name__}: {err}) — session transcript "
                f"tampered") from err


def latest_step(directory: str) -> Optional[int]:
    """The newest *published* step: ``.tmp``/``.old`` debris and
    directories without a manifest are never offered for restore."""
    if not os.path.isdir(directory):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(directory)
             if d.startswith("step_")
             and not d.endswith(".tmp") and not d.endswith(".old")
             and _is_complete(os.path.join(directory, d))]
    return max(steps) if steps else None
