"""Sharded view over the per-shard paged KV pools, and the cluster root MAC.

The port of ``repro.serve.sharded_pool``.  One
:class:`~repro_torch.serve.engine.SecureServingEngine` per shard owns a
pool whose RePA bindings and CTR counters carry that shard's id
(:mod:`repro_torch.serve.kv_pages`).  A :class:`ShardedKVPool`
aggregates them into one logical cache with

* **shard-local free lists** — allocation never leaves a shard; the
  cluster scheduler moves requests, or whole pages by secure migration;
* **a cluster root MAC** — each shard's deferred pool MAC is mirrored
  incrementally, and the root is a keyed CBC-MAC compression over the
  ordered ``(shard id, pool MAC)`` pairs, seeded with the shard count,
  so it binds value, order and fan-out;
* **a deferred root check** — every shard's pool MAC against its page
  MACs, and the compression of the actual pool MACs against that of the
  mirrors: a pool state swapped in around the listeners fails it;
* **an auditable cluster root** — the ordered ``(shard, Merkle root)``
  pairs hash-compressed (:func:`repro_torch.serve.merkle_pool.
  compress_roots`), so a tenant chains a page proof up to the cluster
  root with no key.

**In-place pools.**  The reference mirrors ``old.pool_mac ^
new.pool_mac`` on every pool assignment.  The port's crossings write the
pool in place and its pool listeners see ``old is new``, so that delta
is zero.  So every pool update hands the listeners its own pool-MAC
delta (a write's is the bytes it XORed in, an assignment's ``old ^
new``), and the mirror folds exactly that: a pool state swapped in
without a listened update is never absorbed by a later legitimate one.
A repair (no delta) re-adopts the pool MAC wholesale, as in the
reference.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import aes, ctr, mac
from repro_torch.serve import kv_pages as kvp
from repro_torch.serve import merkle_pool as mkp

__all__ = ["ShardedKVPool"]


class ShardedKVPool:
    """Aggregate view and root MAC over the pools of N shard engines.

    Built by :class:`repro_torch.serve.cluster.ClusterEngine`; usable on
    its own over engines whose specs share one layout::

        sharded = ShardedKVPool(engines)
        ...  # engines serve; every pool write folds into the mirrors
        assert sharded.deferred_root_check()

    The mirrors and the compression live on shard 0's device.
    """

    def __init__(self, engines):
        if not engines:
            raise ValueError("a sharded pool needs at least one shard")
        layouts = {(e.spec.leaves, e.spec.page_tokens, e.spec.n_pages,
                    e.spec.scheme) for e in engines}
        if len(layouts) != 1:
            raise ValueError("shard engines must share one pool layout "
                             "(leaves, page_tokens, n_pages, scheme)")
        shards = sorted(e.spec.shard for e in engines)
        if shards != list(range(len(engines))):
            raise ValueError(f"engines carry shard ids {shards}, expected "
                             f"0..{len(engines) - 1}")
        self.engines = sorted(engines, key=lambda e: e.spec.shard)
        self._root_dev = self.engines[0].device
        # The compression key: the engines' shared AES schedule (every
        # shard gets the same SecureKeys; shard 0's copy is used).
        self._root_rk = self.engines[0].keys.round_keys.to(self._root_dev)
        self._mirrors = [torch.zeros((mac.MAC_BYTES,), dtype=torch.uint8,
                                     device=self._root_dev)
                         for _ in self.engines]
        # Shards still contributing to the root (failover folds out).
        self._active = list(range(len(self.engines)))
        for shard, engine in enumerate(self.engines):
            engine.attach_pool_listener(
                lambda old, new, delta, s=shard: self._fold(s, new, delta))
            self._fold(shard, engine.pool, None)

    # -- root MAC maintenance -----------------------------------------------

    def _fold(self, shard: int, pool, delta) -> None:
        """Pool-listener side: XOR the update's pool-MAC ``delta`` into
        the shard's mirror (an 8-byte hop to the root's device; none
        when it is the shard's); a repair (``delta`` None) re-adopts the
        pool MAC wholesale, since a delta fold after a tamper that
        bypassed the listeners would carry the attacker's divergence
        into the mirror."""
        if delta is None:
            self._mirrors[shard] = pool.pool_mac.to(self._root_dev,
                                                    copy=True)
        else:
            self._mirrors[shard] ^= delta.to(self._root_dev)

    def fold_out(self, shard: int) -> None:
        """Remove one shard from the root compression (failover): the
        length seed and the positional chain re-bind the reduced set on
        the actual and the mirrored side alike."""
        if shard in self._active:
            self._active.remove(shard)

    def failing_shards(self) -> list:
        """Active shards whose pool state cannot be trusted: the pool's
        own deferred identity fails, its pool MAC diverged from the
        mirror, or its Merkle tree no longer equals a rebuild over the
        actual page MACs.  Localizes a root-check failure."""
        bad = []
        for s in self._active:
            engine = self.engines[s]
            if not bool(kvp.deferred_pool_check(engine.pool, engine.spec)):
                bad.append(s)
            elif not torch.equal(self._mirrors[s].cpu(),
                                 engine.pool.pool_mac.cpu()):
                bad.append(s)
            elif not self._merkle_ok(engine):
                bad.append(s)
        return bad

    @staticmethod
    def _merkle_ok(engine) -> bool:
        """One shard's maintained Merkle tree against a rebuild over the
        pool's actual MAC table (a pool swapped in around the listener
        diverges here even with its XOR identity patched up)."""
        if engine.merkle is None:
            return True
        return engine.merkle.verify_against(
            kvp.merkle_leaf_macs(engine.pool, engine.spec))

    def _compress(self, pool_macs) -> np.ndarray:
        """Keyed CBC-MAC over the ordered (shard, pool MAC) pairs.

        ``state_0 = AES_K(n_shards ‖ 0)``; then for each shard ``s`` in
        order ``state = AES_K(state ^ (s ‖ mac_s ‖ 0))``: it binds the
        order, each MAC and the count.  Runs at check time only.
        """
        dev = self._root_dev
        seed = torch.tensor([[len(pool_macs), 0, 0, 0]], dtype=torch.int64,
                            device=dev)
        state = aes.aes128_encrypt_block(ctr.counter_blocks(seed),
                                         self._root_rk)
        for s, m in enumerate(pool_macs):
            blk = torch.zeros((1, 16), dtype=torch.uint8, device=dev)
            blk[0, :4] = torch.tensor([s >> 24 & 0xFF, s >> 16 & 0xFF,
                                       s >> 8 & 0xFF, s & 0xFF],
                                      dtype=torch.uint8)
            if not isinstance(m, torch.Tensor):
                m = torch.from_numpy(np.asarray(m, np.uint8))
            blk[0, 4: 4 + mac.MAC_BYTES] = m.to(dev, torch.uint8)
            state = aes.aes128_encrypt_block(state ^ blk, self._root_rk)
        return state[0, : mac.MAC_BYTES].cpu().numpy()

    @property
    def root_mac(self) -> torch.Tensor:
        """The cluster root MAC: the compression of the incrementally
        kept mirrors of the active shards."""
        return torch.from_numpy(self._compress(
            [self._mirrors[s] for s in self._active]))

    # -- auditable Merkle level ---------------------------------------------

    def merkle_roots(self) -> list:
        """Ordered ``(shard, root)`` pairs of the active shards' Merkle
        roots (each maintainer synced first); failed-over shards are
        folded out as they are from the pool-MAC compression."""
        pairs = []
        for s in self._active:
            engine = self.engines[s]
            if engine.merkle is None:
                raise ValueError(f"shard {s} was built with merkle=False — "
                                 "no auditable root to compress")
            pairs.append((s, engine.merkle.root()))
        return pairs

    @property
    def merkle_root(self) -> bytes:
        """The auditable cluster root: :func:`~repro_torch.serve.
        merkle_pool.compress_roots` over the active ``(shard, Merkle
        root)`` pairs, which a tenant recomputes from the published
        shard roots with no key."""
        return mkp.compress_roots(self.merkle_roots())

    @property
    def n_shards(self) -> int:
        return len(self.engines)

    @property
    def pools(self) -> list:
        return [e.pool for e in self.engines]

    @property
    def specs(self) -> list:
        return [e.spec for e in self.engines]

    # -- aggregate bookkeeping ----------------------------------------------

    def free_pages(self, shard: int) -> int:
        """Shard-local free list depth (allocation never leaves a shard)."""
        return len(self.engines[shard].free_pages)

    def occupancy(self) -> list:
        """Per-shard resident page count (n_pages - free)."""
        return [e.n_pages - len(e.free_pages) for e in self.engines]

    # -- deferred verification ----------------------------------------------

    def deferred_root_check(self) -> bool:
        """Whole-cluster deferred MAC: every active shard's pool MAC
        verifies against its page MACs, the compression of the actual
        ``(shard, pool MAC)`` sequence equals that of the mirrors, and
        every active shard's Merkle tree equals a rebuild.  Failed-over
        shards are no longer checked: nothing may trust them."""
        for s in self._active:
            engine = self.engines[s]
            if not bool(kvp.deferred_pool_check(engine.pool, engine.spec)):
                return False
        actual = self._compress([self.engines[s].pool.pool_mac
                                 for s in self._active])
        mirrored = self._compress([self._mirrors[s] for s in self._active])
        if not np.array_equal(actual, mirrored):
            return False
        return all(self._merkle_ok(self.engines[s]) for s in self._active)
