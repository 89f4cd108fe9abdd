"""Paged, MAC-protected KV-cache pool.

The cache is a pool of fixed-size pages (``page_tokens`` tokens per
page, spanning all layers).  Each page's per-layer payload is padded to
the scheme's optBlk size, so a page is a whole number of protection
blocks.  Each page carries a MAC (XOR of its optBlk MACs) and a VN;
reads verify the pages a decode touches; writes re-MAC only dirty
pages; a pool-level deferred MAC is kept incrementally.

Every crossing takes an optional per-page tenant key context
(:class:`PageKeyCtx`): each page is encrypted and MACed under the bank
row it selects, and its owner and key epoch are folded into the CTR
counters and the RePA binding.  ``ctx=None`` uses the engine-wide keys.

On ``seda`` with ``use_kernel`` both directions run the fused CUDA
kernels (:mod:`repro_torch.kernels.fused_crypt_mac.ops`): the
single-key ones for ``ctx=None`` and for a ctx the caller declares
``uniform`` (one bank row for every page), the mixed-key ones for any
other ctx.  The other schemes run the plain core crypto, with per-page
schedules batched over pages for a mixed ctx.

Unlike the reference, whose pool is an immutable value rewritten by
every write, :meth:`PageIO.write` updates the pool tensors IN PLACE and
returns the same pool, then calls each of ``PageIO.write_listeners``
with it and the write's pool-MAC delta (the engine's Merkle level learns
of changes this way, and the cluster's root-MAC mirrors fold the delta).
Scatters with repeated indices only ever repeat the scratch page, so
which write wins there does not matter.  For the same reason every
crossing that reads before it writes (:meth:`PageIO.reseal`,
:meth:`PageIO.copy`, :meth:`PageIO.migrate`) syncs on the read verdict
first and writes nothing when it fails.

:class:`PrefixCache` is the host-side index of the secure shared-prefix
cache: pages sealed under a tenant's cache binding (epoch word
:data:`PREFIX_ROLE`) and found by the chain hash of the tokens they
hold.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import baes, ctr, mac
from repro_torch.core.bytesutil import MASK32, i64, u32
from repro_torch.core.layout import SEGMENT_BYTES
from repro_torch.core.secure_exec import SCHEMES, SchemeConfig, emulated_tree_probe
from repro_torch.models.attention import CacheSpec
from repro_torch.obs import trace as trace_mod

__all__ = ["LeafPageSpec", "PageSpec", "PagedKVPool", "PageKeyCtx", "PageIO",
           "TwoLevelPageTable", "page_count_bucket", "PAGED_FIELDS",
           "paged_flags", "length_flags", "cache_leaves", "cache_unflatten",
           "build_page_spec", "init_pool", "deferred_pool_check",
           "PREFIX_ROLE", "PrefixCache", "PrefixCacheEntry", "read_pages",
           "write_pages", "write_prefill", "write_dirty", "read_pages_raw",
           "reseal_pages", "migrate_pages", "merkle_leaf_macs"]

# fmap-word bit budget: leaf idx (0-7) | tenant (8-15) | epoch word
# (16-27) | shard (28-31).  The epoch word's top bit (fmap bit 27) is the
# prefix-cache ROLE: a page sealed into the shared-prefix cache carries
# epoch word PREFIX_ROLE instead of a session epoch, selecting the
# tenant's epoch-independent cache keys; session epochs use the other 11
# bits.  The crypt/MAC plumbing is role-agnostic: the bit rides inside
# the epoch word through _tenant_words / _block_binding unchanged.
MAX_SHARDS = 16
PREFIX_ROLE = 0x800          # bit 11 of the epoch word -> fmap bit 27

# Cache fields whose leaves have a (steps, B, max_len, ...) layout and
# cross the untrusted boundary; everything else stays on-chip.
PAGED_FIELDS = frozenset({"k", "v", "c_kv", "k_pe"})


class LeafPageSpec(NamedTuple):
    """Static page layout for one paged cache leaf."""

    leaf_idx: int        # index in the flat cache-leaf list (MAC binding)
    steps: int           # layer-stack dim of the segment
    base_layer: int      # global layer id of stack index 0 (MAC binding)
    rest: tuple          # per-token trailing dims, e.g. (n_kv, head_dim)
    dtype: str
    tok_bytes: int       # bytes per token per layer
    lp_bytes: int        # per-layer page payload, padded to block_bytes
    page_bytes: int      # steps * lp_bytes
    n_blocks: int        # optBlks per page
    pa_base: int         # pool base address in 16B-segment units


class PageSpec(NamedTuple):
    """Static description of the whole paged pool."""

    leaves: tuple
    page_tokens: int
    pages_per_slot: int
    n_pages: int         # real pages; tensors carry one extra scratch row
    max_slots: int
    max_len: int
    scheme: str
    use_kernel: bool
    shard: int = 0
    n_shards: int = 1

    @property
    def cfg(self) -> SchemeConfig:
        return SCHEMES[self.scheme]

    @property
    def scratch_page(self) -> int:
        """Write sink for inactive slots / unallocated table entries."""
        return self.n_pages

    @property
    def blocks_per_read(self) -> int:
        """optBlks touched by one full gather (tree-traffic emulation)."""
        return (sum(leaf.n_blocks for leaf in self.leaves)
                * self.max_slots * self.pages_per_slot)


class PagedKVPool(NamedTuple):
    """The cache as it lives across the boundary, plus its metadata."""

    cts: tuple                 # per paged leaf: (n_pages + 1, page_bytes) u8
    page_macs: torch.Tensor    # (n_pages + 1, MAC_BYTES) u8
    block_macs: tuple          # block-gated: per leaf (n_pages+1, n_blocks, 8)
    page_vns: torch.Tensor     # (n_pages + 1,) u32, int32 storage
    pool_mac: torch.Tensor     # (MAC_BYTES,) u8 — deferred model-level MAC


class PageKeyCtx(NamedTuple):
    """Per-page tenant key selection for one boundary crossing.

    The four ``bank_*`` tensors are the registry's key bank (K rows, one
    per retained (tenant, epoch)); the three per-page tensors select a
    row and carry the identity folded into the counters and the RePA
    binding.
    """

    bank_key: torch.Tensor         # (K, 16) uint8 cipher keys
    bank_round_keys: torch.Tensor  # (K, 11, 16) uint8 schedules
    bank_hash_key: torch.Tensor    # (K, n_lanes) u32 NH lanes
    bank_salt: torch.Tensor        # (K,) u32 CTR-counter salts
    key_idx: torch.Tensor          # (N,) int64 bank row per page
    owners: torch.Tensor           # (N,) int64 tenant index per page
    epochs: torch.Tensor           # (N,) int64 u32 key epoch per page

    @classmethod
    def make(cls, bank, key_idx, owners, epochs) -> "PageKeyCtx":
        """Build from a registry ``KeyBank`` and per-page selections
        (host arrays or tensors), moved to the bank's device.

        Rows outside the bank raise here: the reference's gathers clamp
        such an index, torch's raise, and the CUDA kernels would clamp.
        The check reads host data only; rows given as CUDA tensors are
        the caller's contract.
        """
        dev = bank.key.device
        k = bank.key.shape[0]
        rows = torch.as_tensor(key_idx).to(torch.int64)
        if rows.device.type == "cpu" and rows.numel() and (
                int(rows.min()) < 0 or int(rows.max()) >= k):
            raise IndexError(f"key rows {int(rows.min())}..{int(rows.max())} "
                             f"outside the {k}-row key bank")
        return cls(bank.key, bank.round_keys, bank.hash_key, bank.salt,
                   rows.to(dev), i64(torch.as_tensor(owners)).to(dev),
                   i64(torch.as_tensor(epochs)).to(dev))

    def take(self, n: int) -> "PageKeyCtx":
        """Ctx for the first ``n`` pages."""
        return self._replace(key_idx=self.key_idx[:n],
                             owners=self.owners[:n], epochs=self.epochs[:n])


# ---------------------------------------------------------------------------
# Two-level page table: slot directory -> bucketed page windows.
# ---------------------------------------------------------------------------


def page_count_bucket(n: int, cap: int) -> int:
    """Round a live page count up to the next power of two, capped."""
    b = 1
    while b < n:
        b <<= 1
    return min(b, cap)


class TwoLevelPageTable:
    """Host-side page table: a slot directory (level 1) read live into
    fixed-shape ``(max_slots, bucket)`` page windows (level 2).

    A window is a prefix of each slot's page list and its pow2 bucket
    covers every live slot's dirty write page.
    """

    def __init__(self, max_slots: int, pages_per_slot: int):
        self.max_slots = max_slots
        self.pages_per_slot = pages_per_slot
        self._entries: list = [None] * max_slots

    def install(self, idx: int, entry) -> None:
        self._entries[idx] = entry

    def clear(self, idx: int) -> None:
        self._entries[idx] = None

    def bucket_for(self, live_lengths, page_tokens: int) -> int:
        need = 1
        for ln in live_lengths:
            need = max(need, ln // page_tokens + 1)
        return page_count_bucket(need, self.pages_per_slot)

    def window(self, bucket: int) -> np.ndarray:
        """(max_slots, bucket) int32 page ids, -1 where there is none."""
        tab = np.full((self.max_slots, bucket), -1, np.int32)
        for i, entry in enumerate(self._entries):
            pages = None if entry is None else entry.pages
            if not pages:
                continue
            k = min(len(pages), bucket)
            tab[i, :k] = pages[:k]
        return tab


# ---------------------------------------------------------------------------
# Cache trees: flat leaf order + structure classification.
# ---------------------------------------------------------------------------


def _is_leaf(node: Any) -> bool:
    return isinstance(node, (torch.Tensor, CacheSpec))


def cache_leaves(node: Any) -> list:
    """Flat leaves in the reference's order (NamedTuple fields in order,
    lists in order, dict keys sorted)."""
    if _is_leaf(node):
        return [node]
    if isinstance(node, dict):
        return [l for k in sorted(node) for l in cache_leaves(node[k])]
    return [l for child in node for l in cache_leaves(child)]


def cache_unflatten(template: Any, leaves: list) -> Any:
    """Rebuild ``template``'s structure with ``leaves`` in flat order."""
    return _unflatten(template, iter(leaves))


def _unflatten(node: Any, it) -> Any:
    # A module function, not a closure that calls itself: such a closure
    # is a reference cycle that kept ``leaves`` (a tick's decrypted
    # window) alive until the collector ran.
    if _is_leaf(node):
        return next(it)
    if isinstance(node, dict):
        return {k: _unflatten(node[k], it) for k in sorted(node)}
    if hasattr(node, "_fields"):
        return type(node)(*(_unflatten(c, it) for c in node))
    return type(node)(_unflatten(c, it) for c in node)


def _iter_field_flags(node: Any, wanted: frozenset):
    """One bool per flat leaf: is it under a ``wanted`` field?"""
    if _is_leaf(node):
        yield False
    elif hasattr(node, "_fields"):
        for name in node._fields:
            sub = getattr(node, name)
            for _ in range(len(cache_leaves(sub))):
                yield name in wanted
    elif isinstance(node, dict):
        for key in sorted(node):
            yield from _iter_field_flags(node[key], wanted)
    else:
        for child in node:
            yield from _iter_field_flags(child, wanted)


def paged_flags(cache_tree: Any) -> list:
    return list(_iter_field_flags(cache_tree, PAGED_FIELDS))


def length_flags(cache_tree: Any) -> list:
    return list(_iter_field_flags(cache_tree, frozenset({"length"})))


def _torch_dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def build_page_spec(cache_tree: Any, *, scheme: str, page_tokens: int,
                    n_pages: int, max_slots: int, max_len: int,
                    use_kernel: bool = False, shard: int = 0,
                    n_shards: int = 1) -> PageSpec:
    """Lay the paged leaves of a cache-spec tree out as a protected pool;
    each leaf's per-layer page payload is padded to the optBlk size."""
    if max_len % page_tokens:
        raise ValueError(f"max_len {max_len} not a multiple of "
                         f"page_tokens {page_tokens}")
    if not 0 < n_shards <= MAX_SHARDS or not 0 <= shard < n_shards:
        raise ValueError(f"shard {shard} / n_shards {n_shards} outside the "
                         f"{MAX_SHARDS}-shard fmap-word budget")
    cfg = SCHEMES[scheme]
    flags = paged_flags(cache_tree)
    leaves = cache_leaves(cache_tree)
    specs = []
    cursor = 0
    base_layer = 0
    for idx, (leaf, is_paged) in enumerate(zip(leaves, flags)):
        if not is_paged:
            continue
        steps, bsz, seq = leaf.shape[0], leaf.shape[1], leaf.shape[2]
        if bsz != max_slots or seq != max_len:
            raise ValueError(f"paged leaf {idx} has shape {leaf.shape}, "
                             f"expected (steps, {max_slots}, {max_len}, ...)")
        rest = tuple(int(d) for d in leaf.shape[3:])
        tok_bytes = _torch_dtype(leaf.dtype).itemsize * int(np.prod(rest))
        lp_bytes = (-(-page_tokens * tok_bytes // cfg.block_bytes)
                    * cfg.block_bytes)
        page_bytes = steps * lp_bytes
        specs.append(LeafPageSpec(
            leaf_idx=idx, steps=steps, base_layer=base_layer, rest=rest,
            dtype=leaf.dtype, tok_bytes=tok_bytes, lp_bytes=lp_bytes,
            page_bytes=page_bytes, n_blocks=page_bytes // cfg.block_bytes,
            pa_base=cursor // SEGMENT_BYTES))
        cursor += (n_pages + 1) * page_bytes
        base_layer += steps
    if not specs:
        raise ValueError("cache tree has no paged (KV/latent) leaves — "
                         "the paged engine needs at least one attention "
                         "or MLA layer")
    return PageSpec(tuple(specs), page_tokens, max_len // page_tokens,
                    n_pages, max_slots, max_len, scheme, use_kernel, shard,
                    n_shards)


def init_pool(spec: PageSpec, device=None) -> PagedKVPool:
    """An all-zero pool on ``device``: the card unless ``"cpu"``."""
    device = resolve_device(device)
    cfg = spec.cfg
    rows = spec.n_pages + 1
    u8 = dict(dtype=torch.uint8, device=device)
    block_macs = ()
    if cfg.verify == "block":
        block_macs = tuple(torch.zeros((rows, l.n_blocks, mac.MAC_BYTES), **u8)
                           for l in spec.leaves)
    return PagedKVPool(
        cts=tuple(torch.zeros((rows, l.page_bytes), **u8)
                  for l in spec.leaves),
        page_macs=torch.zeros((rows, mac.MAC_BYTES), **u8),
        block_macs=block_macs,
        page_vns=torch.zeros((rows,), dtype=torch.int32, device=device),
        pool_mac=torch.zeros((mac.MAC_BYTES,), **u8))


# ---------------------------------------------------------------------------
# Per-page crypto/MAC primitives (flattened over a batch of pages).
# Page ids and VNs are int64 tensors; u32 words are int64 in [0, 2**32).
# ---------------------------------------------------------------------------


def _block_pa(spec: PageSpec, leaf: LeafPageSpec,
              page_ids: torch.Tensor) -> torch.Tensor:
    """(N,) page ids -> (N, n_blocks) optBlk PAs (16B-segment units)."""
    step = spec.cfg.block_bytes // SEGMENT_BYTES
    blk = torch.arange(leaf.n_blocks, device=page_ids.device) * step
    segs_per_page = leaf.page_bytes // SEGMENT_BYTES
    return (leaf.pa_base + page_ids[:, None] * segs_per_page
            + blk[None, :]) & MASK32


def _shard_ctr_word(spec: PageSpec) -> int:
    """Shard id XORed into CTR counter word 0 (zero for shard 0)."""
    return (spec.shard << 24) & MASK32


def _tenant_words(ctx: PageKeyCtx, per_page: int):
    """Per-entry (salt, tenant ‖ epoch) u32 words, repeated ``per_page``."""
    salts = i64(ctx.bank_salt[ctx.key_idx]).repeat_interleave(per_page)
    tenant = (((ctx.owners << 16) | (ctx.epochs & 0xFFFF))
              & MASK32).repeat_interleave(per_page)
    return salts, tenant


def _counter_words(spec: PageSpec, pa: torch.Tensor, vn_col: torch.Tensor,
                   ctx: PageKeyCtx | None, per_page: int) -> torch.Tensor:
    """(PA, VN) columns -> (M, 4) counter words.  With a tenant ctx,
    word 0 carries the tenant-epoch salt (XOR the shard word) and word 2
    ``owner << 16 | epoch & 0xFFFF``, so CTR streams never collide across
    tenants or epochs at equal (PA, VN)."""
    shard_w = _shard_ctr_word(spec)
    if ctx is None:
        return torch.stack([torch.full_like(pa, shard_w), pa,
                            torch.zeros_like(pa), vn_col], dim=-1)
    salts, tenant = _tenant_words(ctx, per_page)
    return torch.stack([salts ^ shard_w, pa, tenant, vn_col], dim=-1)


def _block_counters(spec: PageSpec, leaf: LeafPageSpec,
                    page_ids: torch.Tensor, vns: torch.Tensor,
                    ctx: PageKeyCtx | None = None) -> torch.Tensor:
    """PA||VN counter words per optBlk: (N * n_blocks, 4) int64 u32."""
    with trace_mod.span("pageio.bind"):
        pa = _block_pa(spec, leaf, page_ids).reshape(-1)
        vn_col = vns.repeat_interleave(leaf.n_blocks)
        return _counter_words(spec, pa, vn_col, ctx, leaf.n_blocks)


def _block_binding(spec: PageSpec, leaf: LeafPageSpec,
                   page_ids: torch.Tensor, vns: torch.Tensor,
                   ctx: PageKeyCtx | None = None) -> mac.Binding:
    """MAC binding tuple for every optBlk of N pages (flattened).

    With a tenant ctx the fmap word becomes ``leaf_idx | owner << 8 |
    (epoch & 0xFFF) << 16 | shard << 28``: each block MAC is bound to
    its owner and key epoch, so a page moved across tenants or replayed
    from a stale epoch fails even apart from the key mismatch.
    """
    with trace_mod.span("pageio.bind"):
        n = page_ids.shape[0]
        blocks_per_layer = leaf.lp_bytes // spec.cfg.block_bytes
        blk = torch.arange(leaf.n_blocks, device=page_ids.device)
        layer = leaf.base_layer + blk // blocks_per_layer
        fmap = torch.tensor((leaf.leaf_idx | (spec.shard << 28)) & MASK32,
                            device=page_ids.device)
        if ctx is not None:
            fmap = ((fmap | (ctx.owners << 8) | ((ctx.epochs & 0xFFF) << 16))
                    & MASK32).repeat_interleave(leaf.n_blocks)
        return mac.Binding.make(
            _block_pa(spec, leaf, page_ids).reshape(-1),
            vns.repeat_interleave(leaf.n_blocks),
            layer.repeat(n), fmap, blk.repeat(n))


def _uniform_keys(ctx: PageKeyCtx):
    """Single-row key view for the uniform route (the row of page 0;
    ``index_select`` keeps it on the device, with no host sync)."""
    row = ctx.key_idx[:1]
    return (ctx.bank_key.index_select(0, row)[0],
            ctx.bank_round_keys.index_select(0, row)[0],
            ctx.bank_hash_key.index_select(0, row)[0])


def _page_keys(ctx: PageKeyCtx):
    """Mixed route: each page's cipher key (N, 1, 16) and schedule
    (N, 1, 11, 16), shaped to broadcast over the page's blocks."""
    return (ctx.bank_key[ctx.key_idx][:, None],
            ctx.bank_round_keys[ctx.key_idx][:, None])


def _crypt(spec: PageSpec, leaf: LeafPageSpec, buf: torch.Tensor,
           page_ids: torch.Tensor, vns: torch.Tensor, keys,
           ctx: PageKeyCtx | None = None,
           uniform: bool = False) -> torch.Tensor:
    """XOR-crypt (enc == dec) page payloads.  buf: (N, page_bytes) u8.

    ``ctx=None``: every page under the engine-wide ``keys``.  A mixed ctx
    runs each page under its own bank row, batched over pages (the
    reference vmaps per page); ``uniform=True`` promises one row for
    every page and runs the flat single-key route with the same
    counters.  (The reference's otp_xor kernel route here needs
    ``use_kernel`` with ``verify == "none"`` on a B-AES scheme, which no
    SCHEMES entry is: ``off`` returns first.)
    """
    cfg = spec.cfg
    if cfg.name == "off":
        return buf
    mixed = ctx is not None and not uniform
    if ctx is None:
        key, round_keys = keys.key, keys.round_keys
    elif uniform:
        key, round_keys, _ = _uniform_keys(ctx)
    else:
        key, round_keys = _page_keys(ctx)
    n = page_ids.shape[0]
    if cfg.baes:
        counters = _block_counters(spec, leaf, page_ids, vns, ctx)
        if mixed:
            counters = counters.reshape(n, leaf.n_blocks, 4)
        out = baes.baes_encrypt(buf, round_keys, counters,
                                block_bytes=cfg.block_bytes, key=key)
        return out.reshape(buf.shape)
    # T-AES: one AES invocation per 16B segment, PA advancing per segment.
    segs_per_page = leaf.page_bytes // SEGMENT_BYTES
    seg = torch.arange(segs_per_page, device=page_ids.device)
    pa = ((leaf.pa_base + page_ids[:, None] * segs_per_page + seg[None, :])
          & MASK32).reshape(-1)
    vn_col = vns.repeat_interleave(segs_per_page)
    counters = _counter_words(spec, pa, vn_col, ctx, segs_per_page)
    if mixed:
        counters = counters.reshape(n, segs_per_page, 4)
    otp = ctr.ctr_keystream(round_keys, counters)
    return (buf.reshape(otp.shape) ^ otp).reshape(buf.shape)


def _page_block_macs(spec: PageSpec, leaf: LeafPageSpec, ct: torch.Tensor,
                     page_ids: torch.Tensor, vns: torch.Tensor, keys,
                     ctx: PageKeyCtx | None = None,
                     uniform: bool = False) -> torch.Tensor:
    """optBlk MACs of N ciphertext pages: (N, n_blocks, MAC_BYTES) u8."""
    cfg = spec.cfg
    n = page_ids.shape[0]
    binding = _block_binding(spec, leaf, page_ids, vns, ctx)
    blocks = ct.reshape(-1, cfg.block_bytes)
    if ctx is not None and not uniform and cfg.mac_engine != "nh":
        # The AES-chained engines (cbc, naive): one block_macs call per
        # page under its own bank row, as the reference vmaps them.
        nb = leaf.n_blocks
        fields = [torch.broadcast_to(f, (n * nb,)).reshape(n, nb)
                  for f in binding]
        return torch.stack([
            mac.block_macs(blocks[i * nb:(i + 1) * nb],
                           mac.Binding(*(f[i] for f in fields)),
                           hash_key_u32=ctx.bank_hash_key[ctx.key_idx[i]],
                           round_keys=ctx.bank_round_keys[ctx.key_idx[i]],
                           engine=cfg.mac_engine)
            for i in range(n)])
    if ctx is not None and not uniform:
        # Per-page NH key and finalizer schedule, batched over pages.
        payload = mac.nh_payload(blocks, binding)
        lanes = payload.shape[-1]
        if ctx.bank_hash_key.shape[-1] < lanes:
            raise ValueError(
                f"NH key too short: {ctx.bank_hash_key.shape[-1]} lanes for "
                f"{lanes}-lane payload (optBlk too large)")
        hash_keys = ctx.bank_hash_key[ctx.key_idx][:, None, :lanes]
        hi, lo = mac.nh_hash(payload.reshape(n, leaf.n_blocks, lanes),
                             hash_keys)
        fin = mac.finalize_words(hi.reshape(-1), lo.reshape(-1), binding)
        round_keys = ctx.bank_round_keys[ctx.key_idx][:, None]
        pads = ctr.ctr_keystream(round_keys, fin.reshape(n, leaf.n_blocks, 4))
        return pads[..., : mac.MAC_BYTES]
    if ctx is None:
        hash_key, round_keys = keys.hash_key, keys.round_keys
    else:
        _, round_keys, hash_key = _uniform_keys(ctx)
    macs = mac.block_macs(blocks, binding, hash_key_u32=hash_key,
                          round_keys=round_keys, engine=cfg.mac_engine)
    return macs.reshape(n, leaf.n_blocks, mac.MAC_BYTES)


def _fused_crossing(spec: PageSpec, leaf: LeafPageSpec, buf: torch.Tensor,
                    page_ids: torch.Tensor, vns: torch.Tensor, keys,
                    ctx: PageKeyCtx | None, uniform: bool, write: bool):
    """One kernel-fused crypt + optBlk-MAC pass over page bytes: decrypt +
    hash the incoming ciphertext (read) or encrypt + hash the fresh
    ciphertext (write), with the same binding and counters.  ``ctx=None``
    and uniform ctxs run the single-key kernels; a mixed ctx runs the
    mixed-key kernels with each page's bank row repeated over its
    blocks."""
    from repro_torch.kernels.fused_crypt_mac import ops as fused_ops
    cfg = spec.cfg
    binding = _block_binding(spec, leaf, page_ids, vns, ctx)
    counters = _block_counters(spec, leaf, page_ids, vns, ctx)
    with trace_mod.span("pageio.crypt"):
        if ctx is not None and not uniform:
            kernel = (fused_ops.secure_write_kernel_mixed if write
                      else fused_ops.secure_read_kernel_mixed)
            rows = ctx.key_idx.repeat_interleave(leaf.n_blocks)
            out, macs = kernel(buf.reshape(-1), binding,
                               ctx.bank_round_keys, counters,
                               ctx.bank_hash_key, rows,
                               block_bytes=cfg.block_bytes)
        else:
            kernel = (fused_ops.secure_write_kernel if write
                      else fused_ops.secure_read_kernel)
            if ctx is None:
                round_keys, hash_key = keys.round_keys, keys.hash_key
            else:
                _, round_keys, hash_key = _uniform_keys(ctx)
            out, macs = kernel(buf.reshape(-1), binding, round_keys,
                               counters, hash_key,
                               block_bytes=cfg.block_bytes)
    return (out.reshape(buf.shape),
            macs.reshape(page_ids.shape[0], leaf.n_blocks, mac.MAC_BYTES))


def _kernel_read_ok(spec: PageSpec) -> bool:
    cfg = spec.cfg
    return (spec.use_kernel and cfg.baes and cfg.mac_engine == "nh"
            and cfg.block_bytes // SEGMENT_BYTES <= 11)


# The fused write kernel has the read kernel's envelope.
_kernel_write_ok = _kernel_read_ok


def _crossing(spec: PageSpec, leaf: LeafPageSpec, buf: torch.Tensor,
              page_ids: torch.Tensor, vns: torch.Tensor, keys,
              ctx: PageKeyCtx | None, uniform: bool, write: bool):
    """Crypt one leaf's page bytes and MAC their ciphertext:
    ``(out, macs)``, ``macs`` None when the scheme verifies nothing.

    The fused kernels when the spec qualifies (reads and writes share
    one envelope), else the plain core crypto; a read hashes the
    incoming bytes, a write the fresh ones.
    """
    need_macs = spec.cfg.verify != "none"
    if need_macs and _kernel_read_ok(spec):
        return _fused_crossing(spec, leaf, buf, page_ids, vns, keys, ctx,
                               uniform, write)
    with trace_mod.span("pageio.crypt"):
        out = _crypt(spec, leaf, buf, page_ids, vns, keys, ctx, uniform)
        if not need_macs:
            return out, None
        ct = out if write else buf
        return out, _page_block_macs(spec, leaf, ct, page_ids, vns, keys,
                                     ctx, uniform)


# ---------------------------------------------------------------------------
# Dense <-> page byte layout (little-endian bitcasts via .view).
# ---------------------------------------------------------------------------


def _pages_to_dense(spec: PageSpec, leaf: LeafPageSpec, pt: torch.Tensor,
                    lengths: torch.Tensor) -> torch.Tensor:
    """(S, P, page_bytes) u8 -> (steps, S, P*page_tokens, *rest), with
    token positions >= length zeroed."""
    with trace_mod.span("pageio.layout"):
        s, p = pt.shape[:2]
        ptok = spec.page_tokens
        win_len = p * ptok
        dtype = _torch_dtype(leaf.dtype)
        payload = pt.reshape(s, p, leaf.steps, leaf.lp_bytes)[
            ..., : ptok * leaf.tok_bytes].contiguous()
        vals = payload.view(dtype).reshape((s, p, leaf.steps, ptok)
                                           + leaf.rest)
        dense = vals.movedim(2, 0).reshape((leaf.steps, s, win_len)
                                           + leaf.rest)
        valid = (torch.arange(win_len, device=pt.device)[None, :]
                 < lengths[:, None])
        valid = valid.reshape((1, s, win_len) + (1,) * len(leaf.rest))
        return torch.where(valid, dense, torch.zeros((), dtype=dtype,
                                                     device=pt.device))


def _dense_to_pages(spec: PageSpec, leaf: LeafPageSpec,
                    pages: torch.Tensor) -> torch.Tensor:
    """(N, steps, ptok, *rest) token data -> (N, page_bytes) u8."""
    with trace_mod.span("pageio.layout"):
        n = pages.shape[0]
        flat = pages.contiguous().view(torch.uint8).reshape(
            n, leaf.steps, spec.page_tokens * leaf.tok_bytes)
        pad = leaf.lp_bytes - spec.page_tokens * leaf.tok_bytes
        if pad:
            flat = torch.nn.functional.pad(flat, (0, pad))
        return flat.reshape(n, leaf.page_bytes)


def _bytes_to_tokens(spec: PageSpec, leaf: LeafPageSpec,
                     buf: torch.Tensor) -> torch.Tensor:
    """(N, page_bytes) u8 -> (N, steps, ptok, *rest) token data."""
    with trace_mod.span("pageio.layout"):
        n = buf.shape[0]
        ptok = spec.page_tokens
        payload = buf.reshape(n, leaf.steps, leaf.lp_bytes)[
            ..., : ptok * leaf.tok_bytes].contiguous()
        return payload.view(_torch_dtype(leaf.dtype)).reshape(
            (n, leaf.steps, ptok) + leaf.rest)


# ---------------------------------------------------------------------------
# PageIO: the IO surface over the pool for one (spec, keys) binding.
# ---------------------------------------------------------------------------


def _page_ids(spec: PageSpec, ids, device) -> torch.Tensor:
    """Host-built page ids as an int64 tensor on ``device``.

    Ids outside ``[0, scratch_page]`` raise here: the reference's
    gathers clamp such an id, torch's raise (on the card, as a device
    fault).  As in :meth:`PageKeyCtx.make`, only host data is checked.
    """
    ids = torch.as_tensor(ids).to(torch.int64)
    if ids.device.type == "cpu" and ids.numel() and (
            int(ids.min()) < 0 or int(ids.max()) > spec.scratch_page):
        raise IndexError(f"page ids {int(ids.min())}..{int(ids.max())} "
                         f"outside the pool (0..{spec.scratch_page})")
    return ids.to(device)


class PageIO:
    """Pool boundary crossings for one ``(spec, keys)`` pair.

    ``write_listeners`` are called as ``listener(pool, delta)`` after
    every write into a pool (the pool is updated in place), ``delta``
    the (MAC_BYTES,) u8 device tensor that write XORed into
    ``pool.pool_mac``.

    ``verdict_hooks`` observe every MAC-gate verdict the caller syncs to
    the host and hands to :meth:`report_verdict`, as
    ``hook(ok, op, ctx)``; ``fault_hooks`` (fault injection,
    :mod:`repro_torch.serve.faults`) may rewrite a verdict first, so an
    injected failure looks like a real one downstream.  Both are empty
    unless an engine or a test attaches one.
    """

    def __init__(self, spec: PageSpec, keys):
        self.spec = spec
        self.keys = keys
        self.write_listeners: list = []
        self.verdict_hooks: list = []
        self.fault_hooks: list = []

    def report_verdict(self, ok, op: str, **ctx) -> bool:
        """Sync one gate verdict and fan it out to the hooks.

        Returns ``bool(ok)`` after the fault hooks, so a gate reads
        ``if not io.report_verdict(ok, "decode"): ...`` with the one
        device sync the gate needs anyway.
        """
        ok = bool(ok)
        for hook in self.fault_hooks:
            ok = bool(hook(ok, op, ctx))
        for hook in self.verdict_hooks:
            hook(ok, op, ctx)
        return ok

    def read(self, pool: PagedKVPool, page_table: torch.Tensor,
             lengths: torch.Tensor, ctx: PageKeyCtx | None = None,
             uniform: bool = False):
        """Gather + decrypt + verify the paged leaves for a batched decode.

        ``page_table`` is (max_slots, P) with -1 for no page (read as the
        scratch page); ``lengths`` (max_slots,) valid tokens per slot;
        ``ctx`` optional per-page tenant keys (max_slots * P entries,
        row-major over the table), ``uniform`` the host-side promise
        that every entry selects one bank row.
        Returns ``(dense_leaves, ok)``: one (steps, S, P*page_tokens,
        *rest) tensor per paged leaf and the AND of every gated MAC check
        over the touched pages (pages holding positions < length).
        """
        with trace_mod.span("pageio.read"):
            spec, keys = self.spec, self.keys
            cfg = spec.cfg
            s, p = page_table.shape
            dev = page_table.device
            with trace_mod.span("pageio.gather"):
                ptab = torch.where(page_table < 0, spec.scratch_page,
                                   page_table).to(torch.int64)
                flat_ids = ptab.reshape(-1)
                vns = i64(pool.page_vns[flat_ids])
            with trace_mod.span("pageio.verify"):
                page_start = torch.arange(p, device=dev) * spec.page_tokens
                touched = page_start[None, :] < lengths[:, None]   # (S, P)
                ok = torch.ones((), dtype=torch.bool, device=dev)
                agg = torch.zeros((s, p, mac.MAC_BYTES), dtype=torch.uint8,
                                  device=dev)
            dense = []
            for li, leaf in enumerate(spec.leaves):
                with trace_mod.span("pageio.gather"):
                    ct = pool.cts[li][flat_ids]
                pt, macs = _crossing(spec, leaf, ct, flat_ids, vns, keys,
                                     ctx, uniform, write=False)
                pt = pt.reshape(s, p, leaf.page_bytes)
                with trace_mod.span("pageio.verify"):
                    if cfg.verify == "block":
                        macs = macs.reshape(s, p, leaf.n_blocks,
                                            mac.MAC_BYTES)
                        stored = pool.block_macs[li][flat_ids].reshape(
                            macs.shape)
                        ok = ok & ((macs == stored)
                                   | ~touched[..., None, None]).all()
                    elif cfg.verify == "layer":
                        agg = agg ^ mac.xor_aggregate(
                            macs.reshape(s, p, leaf.n_blocks, mac.MAC_BYTES),
                            axis=2)
                dense.append(_pages_to_dense(spec, leaf, pt, lengths))
            with trace_mod.span("pageio.verify"):
                if cfg.verify == "layer":
                    stored = pool.page_macs[flat_ids].reshape(
                        s, p, mac.MAC_BYTES)
                    ok = ok & ((agg == stored) | ~touched[..., None]).all()
                if cfg.emulate_tree:
                    ok = ok & emulated_tree_probe(
                        sum(leaf.n_blocks for leaf in spec.leaves) * s * p,
                        device=dev)
            return dense, ok

    def write(self, pool: PagedKVPool, page_ids: torch.Tensor,
              leaf_pages: list, vn: int, real_mask: torch.Tensor,
              ctx: PageKeyCtx | None = None,
              uniform: bool = False) -> PagedKVPool:
        """Encrypt + MAC N pages and scatter them into the pool in place.

        ``page_ids`` (N,) destinations (the scratch row for masked
        slots); ``leaf_pages`` per paged leaf (N, steps, page_tokens,
        *rest); ``vn`` the u32 version of this write event; ``real_mask``
        (N,) marks writes to real pages (they join the deferred pool MAC);
        ``ctx`` optional per-page tenant keys (N entries).
        """
        with trace_mod.span("pageio.write"):
            spec, keys = self.spec, self.keys
            cfg = spec.cfg
            page_ids = page_ids.to(torch.int64)
            n = page_ids.shape[0]
            vns = torch.full((n,), int(vn) & MASK32, dtype=torch.int64,
                             device=page_ids.device)
            agg = torch.zeros((n, mac.MAC_BYTES), dtype=torch.uint8,
                              device=page_ids.device)
            for li, leaf in enumerate(spec.leaves):
                buf = _dense_to_pages(spec, leaf, leaf_pages[li])
                ct, macs = _crossing(spec, leaf, buf, page_ids, vns, keys,
                                     ctx, uniform, write=True)
                with trace_mod.span("pageio.scatter"):
                    pool.cts[li][page_ids] = ct
                    if cfg.verify == "block":
                        pool.block_macs[li][page_ids] = macs
                if cfg.verify != "none":
                    with trace_mod.span("pageio.verify"):
                        agg = agg ^ mac.xor_aggregate(macs, axis=1)
            with trace_mod.span("pageio.scatter"):
                old_macs = pool.page_macs[page_ids]      # read before scatter
                pool.page_macs[page_ids] = agg
                pool.page_vns[page_ids] = u32(vns)
            with trace_mod.span("pageio.verify"):
                delta = mac.xor_aggregate(torch.where(
                    real_mask[:, None], old_macs ^ agg,
                    torch.zeros_like(agg)))
                pool.pool_mac.bitwise_xor_(delta)
            for listener in self.write_listeners:
                listener(pool, delta)
            return pool

    def write_prefill(self, pool: PagedKVPool, page_ids: torch.Tensor,
                      dense_leaves: list, n_write_pages: int, vn: int,
                      ctx: PageKeyCtx | None = None,
                      uniform: bool = False) -> PagedKVPool:
        """Protect the first ``n_write_pages`` pages of one freshly
        prefilled slot; ``dense_leaves`` per paged leaf (steps, 1,
        max_len, *rest)."""
        with trace_mod.span("pageio.write_prefill"):
            spec = self.spec
            ptok = spec.page_tokens
            leaf_pages = []
            for leaf, dense_leaf in zip(spec.leaves, dense_leaves):
                toks = dense_leaf[:, 0, : n_write_pages * ptok]
                pages = toks.reshape((leaf.steps, n_write_pages, ptok)
                                     + leaf.rest)
                leaf_pages.append(pages.movedim(1, 0))
            ids = page_ids[:n_write_pages].to(torch.int64)
            if ctx is not None:
                ctx = ctx.take(n_write_pages)
            return self.write(pool, ids, leaf_pages, vn, ids < spec.n_pages,
                              ctx, uniform)

    def write_dirty(self, pool: PagedKVPool, page_table: torch.Tensor,
                    dense_leaves: list, lengths: torch.Tensor,
                    active: torch.Tensor, vn: int,
                    ctx: PageKeyCtx | None = None,
                    uniform: bool = False) -> PagedKVPool:
        """Re-encrypt + re-MAC the ONE dirty page per active slot.

        ``lengths`` are pre-increment, so the dirty page is
        ``length // page_tokens``; inactive slots write the scratch row.
        The window covers every active slot's dirty page (the bucket
        invariant); the clamp keeps inactive slots' gathers in range.
        ``ctx`` (one entry per slot) carries each slot's CURRENT tenant
        epoch: a page's next dirty write re-encrypts it under the new
        epoch's keys (lazy rotation).
        """
        with trace_mod.span("pageio.write_dirty"):
            spec = self.spec
            s, p = page_table.shape
            ptok = spec.page_tokens
            with trace_mod.span("pageio.layout"):
                dirty = torch.clamp(lengths.to(torch.int64) // ptok,
                                    max=p - 1)
                pid = page_table.to(torch.int64).gather(
                    1, dirty[:, None])[:, 0]
                real = active & (pid >= 0)
                pid = torch.where(real, pid, spec.scratch_page)
                tok_idx = (dirty[:, None] * ptok
                           + torch.arange(ptok, device=dirty.device)[None])
                leaf_pages = []
                for leaf, dense_leaf in zip(spec.leaves, dense_leaves):
                    idx = tok_idx.reshape((1, s, ptok)
                                          + (1,) * len(leaf.rest))
                    idx = idx.expand((leaf.steps, s, ptok) + leaf.rest)
                    page = torch.gather(dense_leaf, 2, idx)
                    leaf_pages.append(page.movedim(0, 1))  # (S, steps, ...)
            return self.write(pool, pid, leaf_pages, vn, real, ctx, uniform)

    def read_raw(self, pool: PagedKVPool, page_ids: torch.Tensor,
                 ctx: PageKeyCtx | None = None, uniform: bool = False):
        """Decrypt + verify N whole pages, returning token payloads.

        Page-shaped, not slot-shaped: per paged leaf a (N, steps,
        page_tokens, *rest) tensor (the layout :meth:`write` takes), and
        the AND of every gated MAC check over the REAL pages (scratch
        entries are ignored, so callers may pad).  The read half of
        resealing.
        """
        with trace_mod.span("pageio.read_raw"):
            spec, keys = self.spec, self.keys
            cfg = spec.cfg
            page_ids = page_ids.to(torch.int64)
            n = page_ids.shape[0]
            dev = page_ids.device
            with trace_mod.span("pageio.gather"):
                vns = i64(pool.page_vns[page_ids])
            real = page_ids < spec.n_pages
            ok = torch.ones((), dtype=torch.bool, device=dev)
            agg = torch.zeros((n, mac.MAC_BYTES), dtype=torch.uint8,
                              device=dev)
            out = []
            for li, leaf in enumerate(spec.leaves):
                with trace_mod.span("pageio.gather"):
                    ct = pool.cts[li][page_ids]
                pt, macs = _crossing(spec, leaf, ct, page_ids, vns, keys,
                                     ctx, uniform, write=False)
                with trace_mod.span("pageio.verify"):
                    if cfg.verify == "block":
                        stored = pool.block_macs[li][page_ids]
                        ok = ok & ((macs == stored)
                                   | ~real[:, None, None]).all()
                    elif cfg.verify == "layer":
                        agg = agg ^ mac.xor_aggregate(macs, axis=1)
                out.append(_bytes_to_tokens(spec, leaf, pt))
            with trace_mod.span("pageio.verify"):
                if cfg.verify == "layer":
                    stored = pool.page_macs[page_ids]
                    ok = ok & ((agg == stored) | ~real[:, None]).all()
                if cfg.emulate_tree:
                    ok = ok & emulated_tree_probe(
                        n * sum(leaf.n_blocks for leaf in spec.leaves),
                        device=dev)
            return out, ok

    def reseal(self, pool: PagedKVPool, page_ids: torch.Tensor, vn: int,
               old_ctx: PageKeyCtx | None = None,
               new_ctx: PageKeyCtx | None = None, uniform: bool = False):
        """Decrypt N pages under ``old_ctx`` and re-protect them under
        ``new_ctx`` at the same page ids (the eager-rotation primitive).

        Plaintext is preserved bit for bit.  Returns ``(pool, ok)``,
        ``ok`` the host verdict.  The pool is written in place, so
        unlike the reference this method syncs on the read verdict first
        and writes nothing when it fails: resealing tampered bytes would
        launder them under fresh, valid MACs.
        """
        with trace_mod.span("pageio.reseal"):
            leaf_pages, ok = self.read_raw(pool, page_ids, old_ctx, uniform)
            ok = bool(ok)
            if not ok:
                return pool, ok
            page_ids = page_ids.to(torch.int64)
            real = page_ids < self.spec.n_pages
            return self.write(pool, page_ids, leaf_pages, vn, real, new_ctx,
                              uniform), ok

    def copy(self, pool: PagedKVPool, src_ids, dst_ids, vn: int,
             src_ctx: PageKeyCtx | None = None,
             dst_ctx: PageKeyCtx | None = None):
        """Reseal N pages to *other* page ids within one pool.

        Decrypt + verify the source pages under ``src_ctx``, re-encrypt
        + re-MAC the same plaintext into ``dst_ids`` under ``dst_ctx``:
        the rebinding primitive of the prefix cache (insert: session
        page -> cache page, epoch word :data:`PREFIX_ROLE`;
        copy-on-write: cache page -> session page; reseal-on-share: one
        tenant's cache page -> another's).  Lanes may be padded with the
        scratch page on both sides.  Returns ``(pool, ok)``; nothing is
        written when ``ok`` fails (see :meth:`migrate`).
        """
        with trace_mod.span("pageio.copy"):
            return self.migrate(pool, self.spec, pool, src_ids, dst_ids, vn,
                                src_ctx, dst_ctx)

    def migrate(self, src_pool: PagedKVPool, src_spec: PageSpec,
                dst_pool: PagedKVPool, src_ids, dst_ids, vn: int,
                src_ctx: PageKeyCtx | None = None,
                dst_ctx: PageKeyCtx | None = None):
        """Reseal N pages from ``src_pool`` (laid out by ``src_spec``,
        e.g. another shard's binding) into this IO's ``dst_pool``.

        Both pools must live on one device.  For pools on different
        devices, run :meth:`read_raw` on the source device, move the
        plaintext leaf pages, and :meth:`write` on the destination (what
        the cluster engine does).  The pool is written in place, so
        unlike the reference this syncs on the source verdict first and
        writes nothing when it fails: a tampered source must not be
        laundered into freshly MACed pages.  ``src_ids`` / ``dst_ids`` are host
        arrays (checked against the pools here) or tensors.  Returns
        ``(dst_pool, ok)``, ``ok`` the host verdict (the one sync).
        """
        dst_spec = self.spec
        if src_spec.leaves != dst_spec.leaves:
            raise ValueError("migration needs identically-laid-out pools")
        device = dst_pool.page_macs.device
        if src_pool.page_macs.device != device:
            raise ValueError("migrate needs both pools on one device "
                             f"(pools on {src_pool.page_macs.device} and "
                             f"{device}): read_raw on the source, move the "
                             "plaintext, write on the destination")
        src_ids = _page_ids(src_spec, src_ids, device)
        dst_ids = _page_ids(dst_spec, dst_ids, device)
        if src_ids.shape != dst_ids.shape:
            raise ValueError(f"{src_ids.shape[0]} source pages for "
                             f"{dst_ids.shape[0]} destinations")
        leaf_pages, ok = PageIO(src_spec, self.keys).read_raw(
            src_pool, src_ids, src_ctx)
        ok = bool(ok)
        if not ok:
            return dst_pool, ok
        real = dst_ids < dst_spec.n_pages
        return self.write(dst_pool, dst_ids, leaf_pages, vn, real,
                          dst_ctx), ok


# ---------------------------------------------------------------------------
# Free-function wrappers: the reference's pre-PageIO module API.
# ---------------------------------------------------------------------------


def read_pages(pool: PagedKVPool, spec: PageSpec, keys,
               page_table: torch.Tensor, lengths: torch.Tensor,
               ctx: PageKeyCtx | None = None, uniform: bool = False):
    """:meth:`PageIO.read` as a function."""
    return PageIO(spec, keys).read(pool, page_table, lengths, ctx, uniform)


def write_pages(pool: PagedKVPool, spec: PageSpec, keys,
                page_ids: torch.Tensor, leaf_pages: list, vn: int,
                real_mask: torch.Tensor, ctx: PageKeyCtx | None = None,
                uniform: bool = False) -> PagedKVPool:
    """:meth:`PageIO.write` as a function."""
    return PageIO(spec, keys).write(pool, page_ids, leaf_pages, vn,
                                    real_mask, ctx, uniform)


def write_prefill(pool: PagedKVPool, spec: PageSpec, keys,
                  page_ids: torch.Tensor, dense_leaves: list,
                  n_write_pages: int, vn: int,
                  ctx: PageKeyCtx | None = None,
                  uniform: bool = False) -> PagedKVPool:
    """:meth:`PageIO.write_prefill` as a function."""
    return PageIO(spec, keys).write_prefill(pool, page_ids, dense_leaves,
                                            n_write_pages, vn, ctx, uniform)


def write_dirty(pool: PagedKVPool, spec: PageSpec, keys,
                page_table: torch.Tensor, dense_leaves: list,
                lengths: torch.Tensor, active: torch.Tensor, vn: int,
                ctx: PageKeyCtx | None = None,
                uniform: bool = False) -> PagedKVPool:
    """:meth:`PageIO.write_dirty` as a function."""
    return PageIO(spec, keys).write_dirty(pool, page_table, dense_leaves,
                                          lengths, active, vn, ctx, uniform)


def read_pages_raw(pool: PagedKVPool, spec: PageSpec, keys,
                   page_ids: torch.Tensor, ctx: PageKeyCtx | None = None,
                   uniform: bool = False):
    """:meth:`PageIO.read_raw` as a function."""
    return PageIO(spec, keys).read_raw(pool, page_ids, ctx, uniform)


def reseal_pages(pool: PagedKVPool, spec: PageSpec, keys,
                 page_ids: torch.Tensor, vn: int,
                 old_ctx: PageKeyCtx | None = None,
                 new_ctx: PageKeyCtx | None = None, uniform: bool = False):
    """:meth:`PageIO.reseal` as a function."""
    return PageIO(spec, keys).reseal(pool, page_ids, vn, old_ctx, new_ctx,
                                     uniform)


def migrate_pages(src_pool: PagedKVPool, src_spec: PageSpec,
                  dst_pool: PagedKVPool, dst_spec: PageSpec, keys,
                  src_ids, dst_ids, vn: int,
                  src_ctx: PageKeyCtx | None = None,
                  dst_ctx: PageKeyCtx | None = None):
    """:meth:`PageIO.migrate` as a function."""
    return PageIO(dst_spec, keys).migrate(src_pool, src_spec, dst_pool,
                                          src_ids, dst_ids, vn, src_ctx,
                                          dst_ctx)


def deferred_pool_check(pool: PagedKVPool, spec: PageSpec) -> torch.Tensor:
    """Model-level deferred MAC: the XOR of every real page MAC equals the
    incrementally kept pool MAC."""
    return (mac.xor_aggregate(pool.page_macs[: spec.n_pages])
            == pool.pool_mac).all()


def merkle_leaf_macs(pool: PagedKVPool, spec: PageSpec) -> np.ndarray:
    """Host copy of the real pages' MAC rows: the Merkle leaf material
    (the scratch row is in no integrity fold).  A tiny transfer, run
    at the deferred-check cadence or for a proof, never per decode."""
    return pool.page_macs[: spec.n_pages].cpu().numpy().copy()


# ---------------------------------------------------------------------------
# PrefixCache: content-addressed index over cache-bound shared pages.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PrefixCacheEntry:
    """One cached prefix chunk: a sealed page and its chain position.

    ``key`` is ``(tenant_index, chain_hash)``, the chain hash covering
    every token from position 0 through this chunk, so a page is only
    reachable by walking its whole ancestry.  ``n_tokens`` may be short
    of a full page for the chain's leaf chunk; only leaves may be
    partial.
    """

    key: tuple
    parent: Optional["PrefixCacheEntry"]
    page_id: int
    n_tokens: int
    refs: int = 0
    last_use: int = 0


class PrefixCache:
    """Host-side content-addressed secure prefix cache (the reference's
    ``repro.serve.kv_pages.PrefixCache``, same behaviour).

    Entries index pool pages sealed under the owning tenant's cache
    binding (epoch word :data:`PREFIX_ROLE`, the tenant's
    epoch-independent cache keys, ``TenantRegistry.cache_row``).  A
    page sealed once is verify-read by every session that matches its
    chain, and keys are per tenant, so a match only ever hands a
    session pages its own tenant sealed; cross-tenant sharing goes
    through the engine's explicit reseal-on-share.

    **Keying.**  Token streams are cut into page-sized chunks; chunk
    ``i``'s chain hash is ``H(chain[i-1] || tokens_i)``.  Lookup walks
    the chain from chunk 0 and returns the longest run of full matches,
    then the longest matching *partial* leaf, so a hit is always a
    page-aligned prefix of the slot's context.

    **Lifecycle.**  Slots ``acquire`` the whole matched chain (every
    ancestor's refcount rises, so a parent's refcount dominates its
    children's) and ``release`` it on finish, preemption or
    copy-on-write.  ``reclaim`` evicts LRU over refcount-zero *leaf*
    entries, which by that dominance never strands a referenced
    descendant.

    The cache holds page ids only; the engine seals bytes in and out of
    those pages through :class:`PageIO`.
    """

    def __init__(self, page_tokens: int, capacity_pages: int):
        if capacity_pages < 1:
            raise ValueError("prefix cache needs capacity >= 1 page")
        self.page_tokens = page_tokens
        self.capacity_pages = capacity_pages
        self._entries: dict[tuple, PrefixCacheEntry] = {}
        self._children: dict[tuple, set] = {}
        self._clock = 0

    # -- chain hashing ------------------------------------------------------

    @staticmethod
    def _chain_hash(parent_hash: bytes, chunk) -> bytes:
        buf = np.asarray(list(chunk), np.uint32).tobytes()
        return hashlib.sha256(parent_hash + buf).digest()

    def _chain(self, tokens):
        """Page-sized chunks of ``tokens`` with their chain hashes:
        ``[(hash, n_tokens), ...]``; only the last may be partial."""
        out, h = [], b""
        ptok = self.page_tokens
        for start in range(0, len(tokens), ptok):
            chunk = tokens[start: start + ptok]
            h = self._chain_hash(h, chunk)
            out.append((h, len(chunk)))
        return out

    # -- lookup / refcounts -------------------------------------------------

    def match(self, tenant_index: int, tokens) -> list:
        """Longest cached chain covering a prefix of ``tokens``.

        Pure (no refcount or LRU side effect).  Walks full page-sized
        chunks first; after the first miss, probes partial leaves of the
        next chunk longest-first, so an exact-length partial page cached
        by a shorter prompt still hits.
        """
        matched, h = [], b""
        ptok = self.page_tokens
        consumed = 0
        while consumed < len(tokens):
            chunk = tokens[consumed: consumed + ptok]
            full_h = self._chain_hash(h, chunk)
            entry = self._entries.get((tenant_index, full_h))
            if entry is not None and entry.n_tokens == len(chunk):
                matched.append(entry)
                h = full_h
                consumed += len(chunk)
                continue
            for c in range(len(chunk) - 1, 0, -1):
                part_h = self._chain_hash(h, chunk[:c])
                entry = self._entries.get((tenant_index, part_h))
                if entry is not None and entry.n_tokens == c:
                    matched.append(entry)
                    break
            break
        return matched

    def match_tokens(self, tenant_index: int, tokens) -> int:
        """Tokens a :meth:`match` would cover."""
        return sum(e.n_tokens for e in self.match(tenant_index, tokens))

    def missing(self, tenant_index: int, tokens):
        """Insertion plan after the longest match: ``(matched, missing)``,
        ``missing`` the ``[(key, n_tokens), ...]`` of the chunks after
        the match, in chain order.  As in the reference, their hashes
        chain from the start of ``tokens[covered:]``, not from the
        match, so they extend a chain only when nothing matched."""
        matched = self.match(tenant_index, tokens)
        covered = sum(e.n_tokens for e in matched)
        if matched and matched[-1].n_tokens % self.page_tokens:
            return matched, []          # partial leaf: chain can't extend
        missing = [((tenant_index, ch), n)
                   for ch, n in self._chain(tokens[covered:])]
        return matched, missing

    def acquire(self, entries) -> None:
        """Pin a matched chain: every entry's refcount rises by one."""
        self._clock += 1
        for e in entries:
            e.refs += 1
            e.last_use = self._clock

    def release(self, entries) -> None:
        for e in entries:
            if e.refs <= 0:
                raise RuntimeError(f"prefix-cache refcount underflow on "
                                   f"{e.key[1].hex()[:12]}")
            e.refs -= 1

    # -- insertion / eviction -----------------------------------------------

    def insert(self, key: tuple, parent: Optional[PrefixCacheEntry],
               page_id: int, n_tokens: int) -> PrefixCacheEntry:
        """Index a freshly cache-sealed page under its chain key.

        The caller has already copied the page's bytes into ``page_id``
        under the cache binding (:meth:`PageIO.copy`).  New entries
        start unreferenced: the inserting slot keeps decoding on its
        private pages.
        """
        if key in self._entries:
            raise ValueError("prefix chunk already cached")
        if len(self._entries) >= self.capacity_pages:
            raise ValueError("prefix cache over capacity — reclaim first")
        if parent is not None and parent.n_tokens % self.page_tokens:
            raise ValueError("cannot extend a partial (leaf) chunk")
        entry = PrefixCacheEntry(key=key, parent=parent, page_id=page_id,
                                 n_tokens=n_tokens)
        self._clock += 1
        entry.last_use = self._clock
        self._entries[key] = entry
        if parent is not None:
            self._children.setdefault(parent.key, set()).add(key)
        return entry

    @property
    def pages_used(self) -> int:
        return len(self._entries)

    @property
    def total_refs(self) -> int:
        """Refcount pins over every entry."""
        return sum(e.refs for e in self._entries.values())

    def free_capacity(self) -> int:
        return self.capacity_pages - len(self._entries)

    def _evict(self, entry: PrefixCacheEntry) -> None:
        del self._entries[entry.key]
        if entry.parent is not None:
            kids = self._children.get(entry.parent.key)
            if kids is not None:
                kids.discard(entry.key)
                if not kids:
                    del self._children[entry.parent.key]

    def reclaim(self, n_pages: int) -> list:
        """Evict up to ``n_pages`` unreferenced entries, LRU leaf-first;
        returns the freed page ids for the engine to reuse."""
        freed = []
        while len(freed) < n_pages:
            cands = [e for e in self._entries.values()
                     if e.refs == 0 and not self._children.get(e.key)]
            if not cands:
                break
            victim = min(cands, key=lambda e: e.last_use)
            self._evict(victim)
            freed.append(victim.page_id)
        return freed

    def evict_pages(self, page_ids) -> int:
        """Drop every entry holding one of ``page_ids``, and its
        descendants (unreachable without it), whatever their refcounts:
        a retired frame must never satisfy a match.  Pinned slots keep
        their entry objects (:meth:`release` works on objects); the
        chain just stops being found.  Returns the entries dropped."""
        bad = {int(p) for p in page_ids}
        dropped, progress = 0, True
        while progress:
            progress = False
            for e in list(self._entries.values()):
                orphaned = (e.parent is not None
                            and e.parent.key not in self._entries)
                if e.page_id in bad or orphaned:
                    self._evict(e)
                    dropped += 1
                    progress = True
        return dropped

    def flush(self, tenant_index: Optional[int] = None) -> list:
        """Evict every unreferenced entry (optionally one tenant's): the
        revocation path of the epoch-independent cache binding.  Returns
        the freed page ids; referenced chains survive."""
        freed, progress = [], True
        while progress:
            progress = False
            for e in list(self._entries.values()):
                if tenant_index is not None and e.key[0] != tenant_index:
                    continue
                if e.refs == 0 and not self._children.get(e.key):
                    self._evict(e)
                    freed.append(e.page_id)
                    progress = True
        return freed
