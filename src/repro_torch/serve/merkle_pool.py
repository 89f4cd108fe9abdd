"""Merkle pool integrity: auditable roots and per-tenant membership proofs.

The port's copy of the reference module (it imports only numpy and
hashlib); every digest and proof is byte-identical.  The port uses it
for the audit proofs a checkpoint manifest carries; wiring it into the
serving engine is not ported yet.

The deferred pool MAC and the cluster root (``sharded_pool``) are
*verifier-side* levels: a tenant has to trust that the host actually
runs ``deferred_pool_check`` and tears the process down on a failed
verdict.  This module adds the first **auditable** level of the
hierarchy — an incrementally-maintained Merkle tree over the per-page
MACs — so every tenant can hold an O(log n) membership proof for its
resident pages and check it against an attested root with *no pool
access and no host trust*:

    per-block MAC+VN  ->  deferred pool MAC  ->  Merkle root  ->  cluster root
    (read gate)           (XOR fold, in-jit)    (this module)     (compression
                                                                   over shard
                                                                   Merkle roots)

Design points:

* **Listener-driven.**  :class:`MerklePagePool` attaches to the
  engine's pool-listener interface (the same contract the sharded
  pool's mirror fold uses).  The listener itself is O(1) — it only
  records the freshest pool object; leaf hashing and path recompute
  are batched and amortized at ``_tick_end`` (:meth:`sync`), off the
  decode critical path, exactly like the deferred check.
* **Resync-by-assignment.**  A ``(None, new_pool)`` listener event —
  the wholesale re-adoption fired by ``_commit_repair`` after
  quarantine or a pool-MAC rebuild — schedules a from-scratch rebuild,
  never an incremental delta: tamper bypassed the setter, so no delta
  can be trusted.
* **Quarantine exclusion.**  Frames retired by the fault-containment
  layer hash to a distinguished *retired* leaf (not a data leaf over
  the scrubbed zero MAC), so the rebuilt tree provably excludes them
  and any pre-repair proof stops verifying.
* **Tenant binding.**  Each data leaf folds the owning tenant index
  into the hash, so a proof replayed by another tenant fails
  cryptographically, not just by label comparison.
* **Host-independent verification.**  :func:`verify_proof` depends on
  nothing but ``hashlib`` — a tenant can run it standalone.  Each of
  the five forgery classes in the threat model fails with a *distinct*
  error type (see the ``ProofError`` taxonomy).

The incremental update is the textbook one: a dirty leaf invalidates
exactly its root path, so a sync over ``d`` dirty pages recomputes at
most ``d * ceil(log2 n)`` interior nodes (shared ancestors are
deduplicated level by level).
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Callable, Iterable, List, Optional, Sequence, Tuple

import numpy as np

MAC_BYTES = 8           # must match repro_torch.core.mac.MAC_BYTES
HASH_BYTES = 32
PROOF_VERSION = 1

# Domain-separation tags: a leaf can never be confused with an interior
# node (classic second-preimage fix), a retired frame can never be
# presented as a data leaf, and the cluster compression can never be
# confused with an in-tree node.
_TAG_LEAF = b"\x00seda.leaf"
_TAG_RETIRED = b"\x01seda.retired"
_TAG_EMPTY = b"\x02seda.empty"
_TAG_NODE = b"\x03seda.node"
_TAG_CLUSTER = b"\x04seda.cluster"

_FREE_OWNER = -1        # owner index of unowned (free / cache) frames


def _u32(x: int) -> bytes:
    return int(x & 0xFFFFFFFF).to_bytes(4, "big")


def _sha(*parts: bytes) -> bytes:
    h = hashlib.sha256()
    for p in parts:
        h.update(p)
    return h.digest()


def leaf_hash(shard: int, index: int, owner: int, mac: bytes) -> bytes:
    """Data leaf: binds shard, frame index, owning tenant and page MAC."""
    if len(mac) != MAC_BYTES:
        raise ValueError(f"page MAC must be {MAC_BYTES} bytes, got {len(mac)}")
    return _sha(_TAG_LEAF, _u32(shard), _u32(index), _u32(owner), mac)


def retired_leaf(shard: int, index: int) -> bytes:
    """Leaf of a quarantined frame — excluded from the data tree."""
    return _sha(_TAG_RETIRED, _u32(shard), _u32(index))


def empty_leaf(shard: int, index: int) -> bytes:
    """Padding leaf (tree width is the next power of two)."""
    return _sha(_TAG_EMPTY, _u32(shard), _u32(index))


def node_hash(left: bytes, right: bytes) -> bytes:
    return _sha(_TAG_NODE, left, right)


def tree_depth(n_pages: int) -> int:
    """Path length of every proof over an ``n_pages``-frame pool."""
    if n_pages < 1:
        raise ValueError("n_pages must be >= 1")
    d, width = 0, 1
    while width < n_pages:
        width <<= 1
        d += 1
    return d


def build_tree(macs: np.ndarray, owners: np.ndarray,
               quarantined: np.ndarray, *, shard: int) -> List[List[bytes]]:
    """From-scratch tree over ``n_pages`` frames; the reference algebra.

    ``levels[0]`` are the (padded) leaves, ``levels[-1][0]`` the root.
    The incremental maintainer must be node-for-node identical to this.
    """
    n_pages = len(macs)
    width = 1 << tree_depth(n_pages)
    leaves = []
    for i in range(width):
        if i >= n_pages:
            leaves.append(empty_leaf(shard, i))
        elif quarantined[i]:
            leaves.append(retired_leaf(shard, i))
        else:
            leaves.append(leaf_hash(shard, i, int(owners[i]),
                                    bytes(macs[i])))
    levels = [leaves]
    while len(levels[-1]) > 1:
        prev = levels[-1]
        levels.append([node_hash(prev[2 * j], prev[2 * j + 1])
                       for j in range(len(prev) // 2)])
    return levels


def compress_roots(pairs: Sequence[Tuple[int, bytes]]) -> bytes:
    """Cluster root: ordered compression over active (shard, root) pairs.

    Binds value, order AND shard count — same contract as the pool-MAC
    CBC compression it sits beside, but hash-based so a tenant can
    recompute it host-independently from the published shard roots.
    """
    h = hashlib.sha256()
    h.update(_TAG_CLUSTER)
    h.update(_u32(len(pairs)))
    for shard, root in pairs:
        if len(root) != HASH_BYTES:
            raise ValueError("shard root must be a digest")
        h.update(_u32(shard))
        h.update(root)
    return h.digest()


# -- proof objects -------------------------------------------------------


class ProofError(Exception):
    """Base class: ``verify_proof`` failed.  Each forgery class in the
    threat model maps to a distinct subclass."""


class MalformedProofError(ProofError):
    """Structurally invalid proof (bad hex, out-of-range frame index,
    internally inconsistent tenant/owner fields)."""


class TenantMismatchError(ProofError):
    """Cross-tenant proof reuse: the proof names a different tenant
    than the verifying one (and the tenant is folded into every leaf,
    so relabeling the field breaks the leaf hash instead)."""


class PathLengthError(ProofError):
    """Truncated or extended sibling path: the path length does not
    match the tree depth implied by the pool geometry."""


class LeafMacError(ProofError):
    """The leaf MAC does not hash to the committed leaf digest
    (flipped / substituted page MAC)."""


class SiblingPathError(ProofError):
    """The sibling path does not fold to the stated root (swapped or
    substituted sibling)."""


class StaleRootError(ProofError):
    """The proof is internally consistent but speaks for a root the
    verifier no longer accepts (replay after rotation / repair)."""


class ClusterRootError(ProofError):
    """The cluster section does not recompute: the shard root is not
    bound into the published cluster root."""


@dataclasses.dataclass(frozen=True)
class PageProof:
    """O(log n) membership proof for one resident frame."""
    page: int                   # frame index (position in the leaf row)
    owner: int                  # tenant index folded into the leaf
    mac: str                    # page MAC, hex
    leaf: str                   # committed leaf digest, hex
    path: Tuple[str, ...]       # sibling digests, leaf -> root, hex

    def to_dict(self) -> dict:
        return {"page": self.page, "owner": self.owner, "mac": self.mac,
                "leaf": self.leaf, "path": list(self.path)}


@dataclasses.dataclass(frozen=True)
class AuditProof:
    """Per-tenant audit proof: every resident frame of one session /
    tenant on one shard, plus the shard root they verify against and
    (for cluster proofs) the shard-root set binding that root into the
    cluster root."""
    shard: int
    n_pages: int
    tenant: Optional[int]       # tenant index, None on single-tenant engines
    root: str                   # shard Merkle root, hex
    pages: Tuple[PageProof, ...]
    version: int = PROOF_VERSION
    cluster: Optional[dict] = None  # {"shard_roots": [[shard, hex], ...],
    #                                  "root": hex} — order is normative

    def to_dict(self) -> dict:
        d = {"version": self.version, "shard": self.shard,
             "n_pages": self.n_pages, "tenant": self.tenant,
             "root": self.root,
             "pages": [p.to_dict() for p in self.pages]}
        if self.cluster is not None:
            d["cluster"] = {"shard_roots": [[int(s), r] for s, r in
                                            self.cluster["shard_roots"]],
                            "root": self.cluster["root"]}
        return d


def proof_from_dict(d: dict) -> AuditProof:
    """Inverse of :meth:`AuditProof.to_dict` (checkpoint manifests)."""
    try:
        pages = tuple(PageProof(page=int(p["page"]), owner=int(p["owner"]),
                                mac=p["mac"], leaf=p["leaf"],
                                path=tuple(p["path"]))
                      for p in d["pages"])
        cluster = None
        if d.get("cluster") is not None:
            cluster = {"shard_roots": [(int(s), r) for s, r in
                                       d["cluster"]["shard_roots"]],
                       "root": d["cluster"]["root"]}
        return AuditProof(shard=int(d["shard"]), n_pages=int(d["n_pages"]),
                          tenant=(None if d.get("tenant") is None
                                  else int(d["tenant"])),
                          root=d["root"], pages=pages,
                          version=int(d.get("version", PROOF_VERSION)),
                          cluster=cluster)
    except (KeyError, TypeError, ValueError) as err:
        raise MalformedProofError(f"undecodable proof: {err}") from err


def _hex_digest(s: str, what: str) -> bytes:
    try:
        raw = bytes.fromhex(s)
    except (ValueError, TypeError) as err:
        raise MalformedProofError(f"{what} is not valid hex") from err
    if len(raw) != HASH_BYTES and what != "page MAC":
        raise MalformedProofError(f"{what} has wrong digest length")
    return raw


def verify_proof(proof: AuditProof, *, expected_root: Optional[str] = None,
                 tenant: Optional[int] = None) -> bool:
    """Host-independent proof verification (``hashlib`` only).

    Checks run in a fixed order so each forgery class fails with a
    distinct :class:`ProofError` subclass:

    1. structural decode            -> :class:`MalformedProofError`
    2. tenant binding (``tenant=``) -> :class:`TenantMismatchError`
    3. path length vs tree depth    -> :class:`PathLengthError`
    4. leaf MAC -> leaf digest      -> :class:`LeafMacError`
    5. path fold -> stated root     -> :class:`SiblingPathError`
    6. stated vs attested root      -> :class:`StaleRootError`
    7. cluster compression          -> :class:`ClusterRootError`

    Returns ``True`` (never ``False``) — failure is always an
    exception, so a caller cannot accidentally ignore a verdict.
    """
    if not isinstance(proof, AuditProof):
        raise MalformedProofError("not an AuditProof")
    if proof.version != PROOF_VERSION:
        raise MalformedProofError(f"unknown proof version {proof.version}")
    if proof.n_pages < 1:
        raise MalformedProofError("n_pages must be >= 1")
    if tenant is not None and proof.tenant != tenant:
        raise TenantMismatchError(
            f"proof speaks for tenant {proof.tenant}, verifier is {tenant}")
    depth = tree_depth(proof.n_pages)
    root = _hex_digest(proof.root, "root")
    for p in proof.pages:
        if not (0 <= p.page < proof.n_pages):
            raise MalformedProofError(f"frame {p.page} outside the pool")
        if proof.tenant is not None and p.owner != proof.tenant:
            raise MalformedProofError(
                f"frame {p.page} owner {p.owner} contradicts proof tenant "
                f"{proof.tenant}")
        if len(p.path) != depth:
            raise PathLengthError(
                f"frame {p.page}: path length {len(p.path)} != tree depth "
                f"{depth}")
        mac = _hex_digest(p.mac, "page MAC")
        committed = _hex_digest(p.leaf, "leaf digest")
        if leaf_hash(proof.shard, p.page, p.owner, mac) != committed:
            raise LeafMacError(
                f"frame {p.page}: page MAC does not hash to the committed "
                "leaf")
        node, idx = committed, p.page
        for sib_hex in p.path:
            sib = _hex_digest(sib_hex, "sibling digest")
            node = (node_hash(sib, node) if idx & 1
                    else node_hash(node, sib))
            idx >>= 1
        if node != root:
            raise SiblingPathError(
                f"frame {p.page}: sibling path does not fold to the stated "
                "root")
    if expected_root is not None and proof.root != expected_root:
        raise StaleRootError(
            "proof root is not the attested current root (stale replay "
            "after rotation or repair)")
    if proof.cluster is not None:
        pairs = [(int(s), _hex_digest(r, "shard root"))
                 for s, r in proof.cluster["shard_roots"]]
        if compress_roots(pairs).hex() != proof.cluster["root"]:
            raise ClusterRootError(
                "shard-root set does not compress to the stated cluster "
                "root")
        if (proof.shard, root) not in pairs:
            raise ClusterRootError(
                "proof's shard root is not bound into the cluster root")
    return True


# -- the incremental maintainer ------------------------------------------


class MerklePagePool:
    """Incrementally-maintained Merkle tree over one engine's page MACs.

    Attached via ``engine.attach_pool_listener``; the listener is O(1)
    (records the freshest pool object), and :meth:`sync` — called from
    ``_tick_end`` at the deferred-check cadence, and on demand before a
    proof or root read — pulls the (tiny) MAC table to the host, diffs
    it against the leaf mirror, and recomputes only the dirty paths.

    ``leaf_fn(pool)`` extracts the real-page MAC rows from a pool
    object so this module stays free of any tensor framework;
    ``owners_fn()`` and ``quarantined_fn()`` report the engine's
    host-side frame ownership and quarantine set at sync time.
    """

    def __init__(self, n_pages: int, *, shard: int = 0,
                 leaf_fn: Callable = None,
                 owners_fn: Optional[Callable] = None,
                 quarantined_fn: Optional[Callable] = None):
        if leaf_fn is None:
            raise ValueError("MerklePagePool needs a leaf_fn")
        self.n_pages = int(n_pages)
        self.shard = int(shard)
        self._leaf_fn = leaf_fn
        self._owners_fn = owners_fn
        self._quar_fn = quarantined_fn
        self._depth = tree_depth(self.n_pages)
        self._width = 1 << self._depth
        self._pool_obj = None
        self._pending = False       # a listener event since the last sync
        self._need_full = True      # resync-by-assignment / first build
        self._macs = np.zeros((self.n_pages, MAC_BYTES), np.uint8)
        self._owners = np.full(self.n_pages, _FREE_OWNER, np.int64)
        self._quar = np.zeros(self.n_pages, bool)
        self._levels: Optional[List[List[bytes]]] = None

    # -- listener side (hot path, O(1)) ----------------------------------

    def on_pool_update(self, old_pool, new_pool) -> None:
        """Pool-listener entry point (``listener(old, new)`` contract).

        ``old is None`` is the resync-by-assignment signal fired by
        ``_commit_repair``: the previous pool state cannot be trusted,
        so the next :meth:`sync` rebuilds from scratch instead of
        applying a delta.
        """
        self._pool_obj = new_pool
        self._pending = True
        if old_pool is None:
            self._need_full = True

    # -- sync / amortized maintenance ------------------------------------

    def _inputs(self):
        # Copies, not views: the mirrors (_macs/_owners/_quar) must stay
        # frozen at the last-synced state — np.asarray would alias a
        # caller-owned array and the dirty diff would never fire.
        macs = np.array(self._leaf_fn(self._pool_obj), np.uint8)
        if macs.shape != (self.n_pages, MAC_BYTES):
            raise ValueError(f"leaf_fn returned {macs.shape}, expected "
                             f"{(self.n_pages, MAC_BYTES)}")
        owners = (np.array(self._owners_fn(), np.int64)
                  if self._owners_fn is not None
                  else np.full(self.n_pages, _FREE_OWNER, np.int64))
        quar = np.zeros(self.n_pages, bool)
        if self._quar_fn is not None:
            ids = [p for p in self._quar_fn() if 0 <= p < self.n_pages]
            quar[ids] = True
        return macs, owners, quar

    def sync(self) -> Tuple[int, int]:
        """Fold pending pool state into the tree.

        Returns ``(root_updates, leaf_updates)``: 1 if the root was
        recomputed this call, and the number of leaves rehashed —
        these feed the ``merkle_root_updates`` / ``merkle_leaf_updates``
        counters.
        """
        if self._pool_obj is None:
            return (0, 0)
        macs, owners, quar = self._inputs()
        if self._need_full or self._levels is None:
            levels = build_tree(macs, owners, quar, shard=self.shard)
            changed = (self.n_pages if self._levels is None else
                       sum(a != b for a, b in
                           zip(levels[0], self._levels[0])))
            self._levels = levels
            self._macs, self._owners, self._quar = macs, owners, quar
            self._need_full = self._pending = False
            return (1, int(changed))
        dirty = np.nonzero((macs != self._macs).any(axis=1)
                           | (owners != self._owners)
                           | (quar != self._quar))[0]
        self._pending = False
        if dirty.size == 0:
            return (0, 0)
        leaves = self._levels[0]
        for i in dirty:
            i = int(i)
            leaves[i] = (retired_leaf(self.shard, i) if quar[i]
                         else leaf_hash(self.shard, i, int(owners[i]),
                                        bytes(macs[i])))
        touched = {int(i) for i in dirty}
        for level in range(self._depth):
            parents = {i >> 1 for i in touched}
            row, up = self._levels[level], self._levels[level + 1]
            for j in parents:
                up[j] = node_hash(row[2 * j], row[2 * j + 1])
            touched = parents
        self._macs, self._owners, self._quar = macs, owners, quar
        return (1, int(dirty.size))

    # -- roots / verification --------------------------------------------

    def root(self) -> bytes:
        self.sync()
        return self._levels[-1][0]

    def root_hex(self) -> str:
        return self.root().hex()

    def snapshot(self) -> List[List[bytes]]:
        """Copy of every tree level (node-for-node test support)."""
        self.sync()
        return [list(level) for level in self._levels]

    def verify_against(self, actual_macs: np.ndarray) -> bool:
        """True iff the maintained tree matches a from-scratch rebuild
        over the *actual* pool MACs — a pool state swapped in without
        the listener (direct ``_pool`` write) diverges here, the Merkle
        analogue of the mirror-vs-recompute root check."""
        self.sync()
        macs = np.asarray(actual_macs, np.uint8)
        rebuilt = build_tree(macs, self._owners, self._quar,
                             shard=self.shard)
        return rebuilt[-1][0] == self._levels[-1][0]

    # -- proofs -----------------------------------------------------------

    def page_proof(self, page: int) -> PageProof:
        self.sync()
        if not (0 <= page < self.n_pages):
            raise ValueError(f"frame {page} outside the pool")
        if self._quar[page]:
            raise ValueError(f"frame {page} is quarantined — retired "
                             "frames have no membership proof")
        path, idx = [], page
        for level in range(self._depth):
            path.append(self._levels[level][idx ^ 1].hex())
            idx >>= 1
        return PageProof(page=page, owner=int(self._owners[page]),
                         mac=bytes(self._macs[page]).hex(),
                         leaf=self._levels[0][page].hex(),
                         path=tuple(path))

    def audit_proof(self, pages: Iterable[int],
                    tenant: Optional[int] = None) -> AuditProof:
        """Membership proof for a session's resident frames.

        Every requested frame must be owned by ``tenant`` (when given)
        — issuing a proof over someone else's frames is refused at the
        source, not just rejected at verification."""
        self.sync()
        proofs = []
        for p in sorted(set(int(p) for p in pages)):
            pp = self.page_proof(p)
            if tenant is not None and pp.owner != tenant:
                raise ValueError(
                    f"frame {p} is owned by tenant {pp.owner}, not "
                    f"{tenant} — refusing to issue a cross-tenant proof")
            proofs.append(pp)
        return AuditProof(shard=self.shard, n_pages=self.n_pages,
                          tenant=tenant, root=self.root_hex(),
                          pages=tuple(proofs))
