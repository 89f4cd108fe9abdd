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
returns the same pool.  Scatters with repeated indices only ever repeat
the scratch page, so which write wins there does not matter.

The prefix cache, migration between pools and the Merkle level are not
ported yet.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import baes, ctr, mac
from repro_torch.core.bytesutil import MASK32, i64, u32
from repro_torch.core.layout import SEGMENT_BYTES
from repro_torch.core.secure_exec import SCHEMES, SchemeConfig, emulated_tree_probe
from repro_torch.models.attention import CacheSpec

__all__ = ["LeafPageSpec", "PageSpec", "PagedKVPool", "PageKeyCtx", "PageIO",
           "TwoLevelPageTable", "page_count_bucket", "PAGED_FIELDS",
           "paged_flags", "length_flags", "cache_leaves", "cache_unflatten",
           "build_page_spec", "init_pool", "deferred_pool_check"]

MAX_SHARDS = 16

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
    it = iter(leaves)

    def build(node):
        if _is_leaf(node):
            return next(it)
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if hasattr(node, "_fields"):
            return type(node)(*(build(c) for c in node))
        return type(node)(build(c) for c in node)

    return build(template)


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
        raise ValueError("cache tree has no paged (KV) leaves")
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
    if ctx is not None and not uniform:
        # Per-page NH key and finalizer schedule, batched over pages.
        if cfg.mac_engine != "nh":
            raise ValueError(f"MAC engine {cfg.mac_engine!r} is not ported "
                             "(nh only)")
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
    if ctx is not None and not uniform:
        kernel = (fused_ops.secure_write_kernel_mixed if write
                  else fused_ops.secure_read_kernel_mixed)
        rows = ctx.key_idx.repeat_interleave(leaf.n_blocks)
        out, macs = kernel(buf.reshape(-1), binding, ctx.bank_round_keys,
                           counters, ctx.bank_hash_key, rows,
                           block_bytes=cfg.block_bytes)
    else:
        kernel = (fused_ops.secure_write_kernel if write
                  else fused_ops.secure_read_kernel)
        if ctx is None:
            round_keys, hash_key = keys.round_keys, keys.hash_key
        else:
            _, round_keys, hash_key = _uniform_keys(ctx)
        out, macs = kernel(buf.reshape(-1), binding, round_keys, counters,
                           hash_key, block_bytes=cfg.block_bytes)
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
    out = _crypt(spec, leaf, buf, page_ids, vns, keys, ctx, uniform)
    if not need_macs:
        return out, None
    ct = out if write else buf
    return out, _page_block_macs(spec, leaf, ct, page_ids, vns, keys, ctx,
                                 uniform)


# ---------------------------------------------------------------------------
# Dense <-> page byte layout (little-endian bitcasts via .view).
# ---------------------------------------------------------------------------


def _pages_to_dense(spec: PageSpec, leaf: LeafPageSpec, pt: torch.Tensor,
                    lengths: torch.Tensor) -> torch.Tensor:
    """(S, P, page_bytes) u8 -> (steps, S, P*page_tokens, *rest), with
    token positions >= length zeroed."""
    s, p = pt.shape[:2]
    ptok = spec.page_tokens
    win_len = p * ptok
    dtype = _torch_dtype(leaf.dtype)
    payload = pt.reshape(s, p, leaf.steps, leaf.lp_bytes)[
        ..., : ptok * leaf.tok_bytes].contiguous()
    vals = payload.view(dtype).reshape((s, p, leaf.steps, ptok) + leaf.rest)
    dense = vals.movedim(2, 0).reshape((leaf.steps, s, win_len) + leaf.rest)
    valid = (torch.arange(win_len, device=pt.device)[None, :]
             < lengths[:, None])
    valid = valid.reshape((1, s, win_len) + (1,) * len(leaf.rest))
    return torch.where(valid, dense, torch.zeros((), dtype=dtype,
                                                 device=pt.device))


def _dense_to_pages(spec: PageSpec, leaf: LeafPageSpec,
                    pages: torch.Tensor) -> torch.Tensor:
    """(N, steps, ptok, *rest) token data -> (N, page_bytes) u8."""
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
    n = buf.shape[0]
    ptok = spec.page_tokens
    payload = buf.reshape(n, leaf.steps, leaf.lp_bytes)[
        ..., : ptok * leaf.tok_bytes].contiguous()
    return payload.view(_torch_dtype(leaf.dtype)).reshape(
        (n, leaf.steps, ptok) + leaf.rest)


# ---------------------------------------------------------------------------
# PageIO: the IO surface over the pool for one (spec, keys) binding.
# ---------------------------------------------------------------------------


class PageIO:
    """Pool boundary crossings for one ``(spec, keys)`` pair."""

    def __init__(self, spec: PageSpec, keys):
        self.spec = spec
        self.keys = keys

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
        spec, keys = self.spec, self.keys
        cfg = spec.cfg
        s, p = page_table.shape
        ptab = torch.where(page_table < 0, spec.scratch_page,
                           page_table).to(torch.int64)
        flat_ids = ptab.reshape(-1)
        vns = i64(pool.page_vns[flat_ids])
        page_start = torch.arange(p, device=ptab.device) * spec.page_tokens
        touched = page_start[None, :] < lengths[:, None]           # (S, P)

        ok = torch.ones((), dtype=torch.bool, device=ptab.device)
        agg = torch.zeros((s, p, mac.MAC_BYTES), dtype=torch.uint8,
                          device=ptab.device)
        dense = []
        for li, leaf in enumerate(spec.leaves):
            ct = pool.cts[li][flat_ids]
            pt, macs = _crossing(spec, leaf, ct, flat_ids, vns, keys, ctx,
                                 uniform, write=False)
            pt = pt.reshape(s, p, leaf.page_bytes)
            if cfg.verify == "block":
                macs = macs.reshape(s, p, leaf.n_blocks, mac.MAC_BYTES)
                stored = pool.block_macs[li][flat_ids].reshape(macs.shape)
                ok = ok & ((macs == stored)
                           | ~touched[..., None, None]).all()
            elif cfg.verify == "layer":
                agg = agg ^ mac.xor_aggregate(
                    macs.reshape(s, p, leaf.n_blocks, mac.MAC_BYTES), axis=2)
            dense.append(_pages_to_dense(spec, leaf, pt, lengths))
        if cfg.verify == "layer":
            stored = pool.page_macs[flat_ids].reshape(s, p, mac.MAC_BYTES)
            ok = ok & ((agg == stored) | ~touched[..., None]).all()
        if cfg.emulate_tree:
            ok = ok & emulated_tree_probe(
                sum(leaf.n_blocks for leaf in spec.leaves) * s * p,
                device=ptab.device)
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
            ct, macs = _crossing(spec, leaf, buf, page_ids, vns, keys, ctx,
                                 uniform, write=True)
            pool.cts[li][page_ids] = ct
            if cfg.verify != "none":
                if cfg.verify == "block":
                    pool.block_macs[li][page_ids] = macs
                agg = agg ^ mac.xor_aggregate(macs, axis=1)
        old_macs = pool.page_macs[page_ids]              # read before scatter
        pool.page_macs[page_ids] = agg
        pool.page_vns[page_ids] = u32(vns)
        delta = torch.where(real_mask[:, None], old_macs ^ agg,
                            torch.zeros_like(agg))
        pool.pool_mac.bitwise_xor_(mac.xor_aggregate(delta))
        return pool

    def write_prefill(self, pool: PagedKVPool, page_ids: torch.Tensor,
                      dense_leaves: list, n_write_pages: int, vn: int,
                      ctx: PageKeyCtx | None = None,
                      uniform: bool = False) -> PagedKVPool:
        """Protect the first ``n_write_pages`` pages of one freshly
        prefilled slot; ``dense_leaves`` per paged leaf (steps, 1,
        max_len, *rest)."""
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
        return self.write(pool, ids, leaf_pages, vn, ids < spec.n_pages, ctx,
                          uniform)

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
        spec = self.spec
        s, p = page_table.shape
        ptok = spec.page_tokens
        dirty = torch.clamp(lengths.to(torch.int64) // ptok, max=p - 1)
        pid = page_table.to(torch.int64).gather(1, dirty[:, None])[:, 0]
        real = active & (pid >= 0)
        pid = torch.where(real, pid, spec.scratch_page)
        tok_idx = (dirty[:, None] * ptok
                   + torch.arange(ptok, device=dirty.device)[None])  # (S, ptok)
        leaf_pages = []
        for leaf, dense_leaf in zip(spec.leaves, dense_leaves):
            idx = tok_idx.reshape((1, s, ptok) + (1,) * len(leaf.rest))
            idx = idx.expand((leaf.steps, s, ptok) + leaf.rest)
            page = torch.gather(dense_leaf, 2, idx)
            leaf_pages.append(page.movedim(0, 1))        # (S, steps, ...)
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
        spec, keys = self.spec, self.keys
        cfg = spec.cfg
        page_ids = page_ids.to(torch.int64)
        n = page_ids.shape[0]
        vns = i64(pool.page_vns[page_ids])
        real = page_ids < spec.n_pages
        ok = torch.ones((), dtype=torch.bool, device=page_ids.device)
        agg = torch.zeros((n, mac.MAC_BYTES), dtype=torch.uint8,
                          device=page_ids.device)
        out = []
        for li, leaf in enumerate(spec.leaves):
            ct = pool.cts[li][page_ids]
            pt, macs = _crossing(spec, leaf, ct, page_ids, vns, keys, ctx,
                                 uniform, write=False)
            if cfg.verify == "block":
                stored = pool.block_macs[li][page_ids]
                ok = ok & ((macs == stored) | ~real[:, None, None]).all()
            elif cfg.verify == "layer":
                agg = agg ^ mac.xor_aggregate(macs, axis=1)
            out.append(_bytes_to_tokens(spec, leaf, pt))
        if cfg.verify == "layer":
            stored = pool.page_macs[page_ids]
            ok = ok & ((agg == stored) | ~real[:, None]).all()
        if cfg.emulate_tree:
            ok = ok & emulated_tree_probe(
                n * sum(leaf.n_blocks for leaf in spec.leaves),
                device=page_ids.device)
        return out, ok

    def reseal(self, pool: PagedKVPool, page_ids: torch.Tensor, vn: int,
               old_ctx: PageKeyCtx | None = None,
               new_ctx: PageKeyCtx | None = None, uniform: bool = False):
        """Decrypt N pages under ``old_ctx`` and re-protect them under
        ``new_ctx`` at the same page ids (the eager-rotation primitive).

        Plaintext is preserved bit for bit.  Returns ``(pool, ok)``.  The
        pool is written in place, so unlike the reference this method
        syncs on the read verdict first and writes nothing when it
        fails: resealing tampered bytes would launder them under fresh,
        valid MACs.
        """
        leaf_pages, ok = self.read_raw(pool, page_ids, old_ctx, uniform)
        if not bool(ok):
            return pool, ok
        page_ids = page_ids.to(torch.int64)
        real = page_ids < self.spec.n_pages
        return self.write(pool, page_ids, leaf_pages, vn, real, new_ctx,
                          uniform), ok


def deferred_pool_check(pool: PagedKVPool, spec: PageSpec) -> torch.Tensor:
    """Model-level deferred MAC: the XOR of every real page MAC equals the
    incrementally kept pool MAC."""
    return (mac.xor_aggregate(pool.page_macs[: spec.n_pages])
            == pool.pool_mac).all()
