#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Phases, in order, each printing one JSON line; any failure prints that
phase's line with ``"ok": false`` and exits non-zero without a result:

1. setup   — needs a CUDA device; prints the card's name and power limit
             (``nvidia-smi``), builds every kernel from ``csrc/`` and
             reports ``-Xptxas -v`` and the AES kernels' SASS counts.
2. kernels — each CUDA kernel against its plain PyTorch version on the
             card at the serve, tenants and weights phases' shapes (bytes
             equal; the fused kernels also at S = 11; the mixed-key ones
             over a 12-row key bank with rows mixed, the mixed AES also
             with one row per page; the single-key AES, otp_xor and the
             NH kernel also at the weights' largest leaf in 64 B blocks),
             with median times over 25 launches and the card's least
             time for the same work.
3. reference — the smoke config (float32) served by the engine under
             ``seda`` with the kernels gives the tokens of a plain
             prefill + decode loop.
4. serve   — full-width minitron-4b (32 layers, d_model 3072, vocab
             256000, bf16, random weights from a seed) served by
             ``SecureServingEngine(scheme="seda", use_kernel=True)``: 8
             requests, 64-token prompts, 16 new tokens, page_tokens 8.
             Every kernel's launch count must be > 0; the same requests
             under ``use_kernel=False`` and under ``off`` must give the
             same tokens.  The three configs run in turns, twice each.
5. profile — where a steady decode tick's time goes (CUPTI trace):
             device busy time, idle share, the crypto kernels' share;
             single-tenant seda, off, and the tenants phase's config.
             Then each engine's ``profile()`` between two ticks: the
             protection/model split of the all-resident decode variant
             and its H100 roofline beside the traced device ms.  Each
             kernel's charges equal its calls' operand + output bytes and
             operations, counted from the page spec; launch counts and
             pool bytes stay; each engine finishes with the serve phase's
             tokens; ``off`` < 0.01 and seda > 0.01 on both ratios.
6. tamper  — one flipped ciphertext byte of a live page makes the next
             ``step()`` raise ``IntegrityError``.
7. tenants — the serve phase's weights and requests through a
             ``TenantRegistry`` of 4 tenants (sessions round-robin, one
             rotation every tick, so reseals fire): seda with and without
             the kernels, in turns.  Tokens must equal the serve phase's;
             every tick must run the mixed-key kernels, whose launch
             counts must be > 0.
8. tenant_tamper — tenant B's slot given tenant A's pages: the next
             ``step()`` raises ``IntegrityError``.
9. prefix  — the serve phase's weights through the secure prefix cache:
             4 tenants (a rotation every 4 ticks), each with a 52-token
             system prompt sent alone (miss + insert) and twice with a
             12-token user turn (hit on 7 pages, copy-on-write, 12 replay
             ticks); then tenant 0's prompt is reseal-shared with tenant
             1, whose request with it must hit.  seda with and without the
             kernels and ``off`` (in turns, twice each) give the same
             tokens and prefix counters, all > 0; the mixed-key kernels
             launch; the engine without the cache runs the same traffic
             (tokens compared, not gated: bf16), and both run it once
             more in float32 (compared, not gated).  After 3 ticks the
             Merkle tree equals a rebuild node for node, every tenant's
             audit proof verifies and a flipped leaf MAC is rejected.  A
             flipped byte of a cached page fails the next hit; tenant 0's
             cache page in tenant 1's slot fails; one 7-page copy is
             timed; the smoke config (float32) with the cache gives the
             tokens of the engine without it.
10. faults — the serve phase's weights and requests through the
             fault-tolerant engine (seda, kernels, ``trace`` and ``audit``
             on, 16 spare frames): one plan with a bitflip, a VN bump, a
             page swap and a transient verdict fault single-tenant, one
             with a bitflip and a corrupted page MAC over the tenants
             phase's 4 tenants.  No ``IntegrityError`` escapes; the
             quarantine counter equals the pages condemned; no
             quarantined frame is free or in a slot after any tick; the
             Merkle tree equals a rebuild; the audit chain verifies;
             ``export_trace`` is Chrome JSON; un-faulted sessions keep the
             serve phase's tokens.  Each containment's host ms and its
             probes' launches (B1 + B2, B4 + B5) are printed.  The same
             single-tenant plan in float32 at full width gives every
             session the fault-free tokens; tracing + audit against none
             in turns.
11. weights — the serve phase's full-width params through
             ``SecureExecutor("seda")``: protect, then unprotect with the
             layer check, bit-equal and verified (median of 3 each, and
             one of each under a CUPTI trace); a flipped ciphertext byte
             and a stale VN (replay) fail the check; the protect runs
             the AES-CTR, otp_xor and NH kernels.  Then ``seda512`` once
             (plain wide B-AES, the NH kernel at L = 136).
12. checkpoint — minitron-4b at full width and 2 layers saved as a
             secure checkpoint, found by ``latest_step``, loaded and
             verified bit-equal; the engine serves the same tokens from
             the restored and the original weights; a flipped byte of a
             leaf file raises ``CheckpointError``.
13. shards — the serve phase's weights and requests through
             ``ClusterEngine``: 2 logical shards on the card, 4 slots and
             40 pages a shard.  seda with and without the kernels and
             ``off`` (in turns, twice each) give identical tokens, both
             shards' pools (cts, page MACs, VNs, pool MAC) are
             byte-equal with the kernels on and off, B1-B3 launch and
             the deferred cluster root MAC holds.  In float32 at full
             width: the cluster's tokens are the single engine's; three
             requests whose growth one shard cannot hold migrate a slot
             (no preemption, every request admitted once, the single
             engine's tokens, every migration proof verified; each
             migration's host ms and launches printed); ``shard_kill`` on
             shard 1 at tick 3 fails over with no session lost and the
             fault-free tokens (its host ms printed).  The tenants
             phase's 4 tenants across the shards: kernels and plain give
             equal tokens, B4-B6 launch, reseals fire on both shards.
             A page of shard 0 copied into shard 1's pool fails the next
             tick; a pool swapped in around the listeners fails the
             root, and still does one tick later.  A CUPTI trace of 3
             steady cluster ticks beside the profile phase's tick, then
             ``ClusterEngine.profile()``'s rollup, after which the pools
             and the cluster root MAC are unchanged and the deferred
             root check holds.
14. launch — the port's launcher (``repro_torch.launch.serve.main``) at
             full width with 4 tenants and a rotation every tick, after
             the earlier model is freed: 8 x 16 tokens, mixed-key ticks,
             the deferred pool MAC OK; ``--audit-proof-out`` writes one
             proof per tenant, each verified against its root;
             ``--fault-tolerance`` with the trace, metrics and audit-log
             files, each parsed (the chain verifies, the snapshot's
             counters are the run's, the engine's ``tick`` span).  The
             same run with ``--shards 2``: the deferred cluster root MAC
             OK, one proof per tenant and shard, each verified against
             its shard root and chained to the cluster root, the
             cluster's snapshot, per shard labels and ``cluster_tick``
             spans.  Then ``--engine simple`` gives the tokens of
             ``--engine paged --scheme off`` on the same prompts.
15. archs  — the attention-family configs at full width, each after the
             earlier model is freed: minitron-8b, olmoe-1b-7b (64-expert
             top-8 MoE) and granite-34b (GELU MLP, MQA) at full depth,
             deepseek-v3-671b (MLA latent pages, shared expert, untied
             head) cut to 4 layers (3 dense + 1 MoE), random weights
             drawn in bf16 on the card at one layer's (one expert's)
             fan-in, the serve phase's requests and pool.  Per config:
             seda with and without the kernels and ``off`` once each give
             identical tokens, the seda pools (cts, page MACs, VNs, pool
             MAC) are byte-equal with the kernels on and off, B1-B3
             launch, the deferred MAC holds; tok/s, host ms per tick,
             peak memory, the weights a tick reads against the card's
             bytes rate, and a CUPTI trace of 3 steady ticks (device busy,
             idle share, launches, crypto ms; the model's steps replay
             CUDA graphs, so no stage of them is split out).
             deepseek: a flipped byte of a live ``c_kv`` page and of a
             ``k_pe`` page each raise ``IntegrityError``; its requests
             over 4 tenants rotating every tick give the single-tenant
             tokens with B4-B6 launching.  olmoe through the launcher
             (the deferred MAC OK).  In float32 on the card, each
             config's smoke config served under seda with the kernels
             gives the tokens of a plain prefill + decode loop fed as the
             engine feeds it (prompt padded to its bucket; one slot for
             MoE, whose rows compete for expert capacity).
16. ssm    — the Mamba-2 mixer, each model after the earlier one is
             freed.  In float32 on the card: the chunked SSD scan equals
             the sequential recurrence (L = 200, chunk 64); mamba2's
             smoke dense loop gives the tokens of a loop that re-runs
             the prefill over prompt + generated; jamba's smoke config
             (seda, kernels, one slot) gives the plain CPU run's tokens,
             and so do a contained bitflip on an attention page, a pool
             small enough to preempt and a 2-shard cluster that migrates
             a slot with its recurrent state.  mamba2-780m at full width
             (48 layers, bf16) through the dense loop on the serve
             phase's requests, no crypto kernel launched, its paged
             engine refused with the reference's ``ValueError``;
             jamba-v0.1-52b at full width cut to 24 of 32 layers (three
             8-layer periods) through the archs phase's cell (seda
             kernels/plain/off tokens and pools equal, B1-B3, a k and a
             v page tamper, 4 tenants with B4-B6).  Both with a CUPTI
             trace of 3 steady ticks (mamba2's dense loop also each Mamba
             decode stage's device ms), against the bytes a tick reads:
             weights, and the recurrent state in and out.
17. train  — secure training, each model after the earlier one is freed.
             In float32: the smoke configs of smollm, pixtral (image
             prefix), seamless, deepseek and jamba on the card give the
             CPU port's loss and every gradient within 1e-4 (relative to
             the leaf's largest), and after one AdamW step its loss and
             params; seamless's greedy decode tokens equal the CPU's.
             seamless-m4t-large-v2 at full width and depth (24 + 24
             layers, bf16, remat) through ``repro_torch.launch.train.
             main`` at the launcher's defaults (global batch 8, 256
             target and 128 source tokens), 6 steps under ``seda`` and 6
             under ``off``: each step's wall ms, loss and B1/B7/B8
             launches (4/2/2 a leaf on every seda step), CUPTI traces
             of a 7th step (device busy, idle share, launches) and an 8th
             (the device ms of protect, unprotect and the AdamW update),
             peak memory; every loss finite, every entry check passed, the
             first losses bitwise equal and the later ones within 1e-3;
             a flipped ciphertext byte makes the next secure step report
             ``integrity_ok`` false.  Then seamless's decoder at full
             width through the serve steps: 8 requests over 1,024
             encoder frames, 64-token prompts, 16 new tokens (tok/s,
             peak memory, share of distinct tokens).

Each path whose launches are reported (serve, tenants, prefix, each
containment of the faults phase, weights, the shards phase's first
kernel runs, each archs and ssm config's runs, each train step) is
driven with the counts set to 0 just before it and read just after.
Then a ``{"kernels": [...]}`` line and, last, the device line.

Run from the root of a checkout: ``python3 chip_smoke.py``.
"""

from __future__ import annotations

import os

# Deterministic cuBLAS (set before CUDA initializes), so the three serve
# runs differ only in their crypto.
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import json  # noqa: E402
import math  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import time  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s and the float32
# rate outside the tensor cores.  The data sheet gives no 32-bit integer
# rate; counting integer operations against the float32 rate keeps each
# bound a lower bound on time.  A kernel's operations are the package's
# own counts (``repro_torch.kernels.common.*_ops``), the ones a cost
# profile charges its launches.
HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12

SERVE = dict(n_requests=8, prompt_len=64, new_tokens=16, page_tokens=8)
PAGES_PER_SLOT = 10        # 64 + 16 tokens = 10 pages of 8
N_TENANTS = 4              # the tenants phase: K = 4 x (retain 2 + 1) rows
CKPT_LAYERS = 2            # the checkpoint phase's depth (full width)
SINGLE_KEY = ("aes_ctr_keystream", "fused_crypt_mac", "fused_crypt_mac_write")
WEIGHTS_KEY = ("aes_ctr_keystream", "otp_xor", "nh_hash_kernel_call")
MIXED_KEY = ("aes_ctr_keystream_multi", "fused_crypt_mac_mixed",
             "fused_crypt_mac_write_mixed")
# The prefix phase: per tenant a 52-token system prompt (6 full pages of
# 8 and one of 4) and two 12-token user turns after it.
PREFIX = dict(max_slots=8, page_tokens=8, pages_per_slot=10, n_pages=112,
              prefix_cache_pages=32, rotate_every=4)
SYSTEM_LEN, USER_LEN = 52, 12
PREFIX_COUNTERS = ("prefix_hit_pages", "prefill_pages_skipped",
                   "prefix_cow_pages", "prefix_inserted_pages",
                   "prefix_shared_pages")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def median_ms(fn, n: int = 25, warmup: int = 3) -> float:
    """Median over ``n`` calls of CUDA-event time around one call: what
    a caller waits for, host-side launch gaps included."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def _device_events(prof) -> list:
    """The kernel executions a profiler trace saw on the card."""
    from torch.autograd import DeviceType
    return [e for e in prof.events()
            if getattr(e, "device_type", None) == DeviceType.CUDA
            and e.device_time_total > 0]


def kernel_ms(fn, symbol: str, n: int = 25) -> tuple:
    """Median device time of the CUDA kernel ``symbol`` over ``n`` calls of
    ``fn``, from the profiler's CUPTI trace ("cupti"; a trace that lost
    launches is taken once more).  Where the trace shows no device time,
    the median of CUDA-event times around batches of 10 back-to-back
    calls, per call ("events"), host launch gaps included."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        times = sorted(e.device_time_total / 1e3
                       for e in _device_events(prof) if symbol in e.name)
        if len(times) >= n:
            return times[len(times) // 2], "cupti"
    return median_ms(lambda: [fn() for _ in range(10)], n=n) / 10, "events"


def aes_bytes(n: int, k=None) -> int:
    """B1 (B4 over a ``k``-row bank) on ``n`` counters, each operand and
    output once: counters in, lanes out, the 1 KB T-table, the schedule
    (or the bank and one int32 row per block)."""
    return n * 32 + 1024 + (176 if k is None else n * 4 + 176 * k)


def fused_bytes(n: int, s: int, k=None) -> int:
    """B2 / B3 (B5 / B6 over a ``k``-row bank) on ``n`` blocks of ``s``
    segments, each operand and output once: data, base pads and binding
    in, data and NH out per block (and a row); the diversifiers and NH
    key (the banks) once."""
    from repro_torch.kernels.fused_crypt_mac.kernel import mixed_shared_bytes
    per_block = 16 * s + 16 + 32 + 16 * s + 8 + (0 if k is None else 4)
    return n * per_block + mixed_shared_bytes(1 if k is None else k, s)


def bound(bytes_moved: float, ops: float) -> tuple:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / OPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def phase_setup() -> dict:
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
          else f"nvidia-smi failed: {smi.stderr.strip()}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    paths = build.build()
    build_s = time.perf_counter() - t0
    regs = {name: _ptxas(name) for name in paths}
    return {"torch": torch.__version__, "cuda": torch.version.cuda,
            "device": torch.cuda.get_device_name(0),
            "build_s": round(build_s, 3),
            "libraries": {k: str(v.relative_to(ROOT)) if v.is_relative_to(ROOT)
                          else str(v) for k, v in paths.items()},
            "ptxas": regs, "aes_sass": _aes_sass()}


def _aes_sass() -> dict:
    """SASS of each AES kernel body (``cuobjdump -sass``): instructions
    in all and the ten commonest opcodes; the launch's thread blocks."""
    from repro_torch.kernels import build
    from repro_torch.kernels.aes_ctr import kernel as aes_k
    out = {}
    for symbol, counts in build.sass_counts("aes_ctr").items():
        for name in ("aes_ctr_keystream_multi_kernel",
                     "aes_ctr_keystream_kernel"):
            if name in symbol:
                top = sorted(((k, v) for k, v in counts.items()
                              if k != "instructions"), key=lambda kv: -kv[1])
                out[name] = {"instructions": counts["instructions"],
                             "opcodes": dict(top[:10])}
                break
    out["grid_blocks"] = {"single_key": aes_k.grid_blocks(),
                          "mixed_k12": aes_k.grid_blocks(12)}
    return out


def _serve_shapes(cfg) -> dict:
    """optBlk counts the serve phase gives each kernel (64 B blocks)."""
    tok_bytes = cfg.n_kv * cfg.head_dim * 2                  # bf16 K or V
    blocks_per_page = (cfg.n_layers * SERVE["page_tokens"] * tok_bytes) // 64
    return {"read": SERVE["n_requests"] * PAGES_PER_SLOT * blocks_per_page,
            "write": SERVE["n_requests"] * blocks_per_page}


def phase_kernels(cfg, results: dict) -> dict:
    import numpy as np
    import torch

    from repro_torch.core.secure_memory import SecureKeys
    from repro_torch.kernels.aes_ctr import kernel as aes_k
    from repro_torch.kernels.aes_ctr import ref as aes_ref
    from repro_torch.kernels.common import aes_ctr_ops, fused_crypt_mac_ops
    from repro_torch.kernels.fused_crypt_mac import kernel as fused_k
    from repro_torch.kernels.fused_crypt_mac import ops as fused_ops
    from repro_torch.kernels.fused_crypt_mac import ref as fused_ref

    dev = torch.device("cuda")
    shapes = _serve_shapes(cfg)
    keys = SecureKeys.derive(0, device=dev)
    rng = np.random.default_rng(0)

    def u32(shape) -> torch.Tensor:
        a = rng.integers(0, 2 ** 32, shape, dtype=np.uint32).view(np.int32)
        return torch.from_numpy(a).to(dev)

    def err(a, b) -> int:
        if torch.equal(a, b):
            return 0
        return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())

    out = {}
    n = shapes["read"]
    counters = u32((n, 4))
    got = aes_k.aes_ctr_keystream(counters, keys.round_keys)
    torch.cuda.synchronize()
    want = aes_ref.aes_ctr_keystream_lanes_ref(counters, keys.round_keys)
    e = err(got, want)
    if e:
        raise AssertionError(f"aes_ctr_keystream differs from plain: {e}")
    b_ms, b_by = bound(aes_bytes(n), aes_ctr_ops(n))
    call = lambda: aes_k.aes_ctr_keystream(counters, keys.round_keys)
    ms, timing = kernel_ms(call, "aes_ctr_keystream_kernel")
    out["aes_ctr_keystream"] = dict(
        n=n, max_abs_err=e, ms=ms, timing=timing, call_ms=median_ms(call),
        plain_ms=median_ms(lambda: aes_ref.aes_ctr_keystream_lanes_ref(
            counters, keys.round_keys), n=20),
        bound_ms=b_ms, bound_by=b_by, ptxas=_ptxas("aes_ctr"),
        at_largest_leaf=_keystream_at_largest_leaf(cfg, keys, err))

    for name, fn, ref, n in (
            ("fused_crypt_mac", fused_k.fused_crypt_mac,
             fused_ref.fused_crypt_mac_ref, shapes["read"]),
            ("fused_crypt_mac_write", fused_k.fused_crypt_mac_write,
             fused_ref.fused_crypt_mac_write_ref, shapes["write"])):
        worst = 0
        for s in (4, 11):
            args = (u32((n, 4 * s)), u32((n, 4)),
                    fused_ops._div_lanes(keys.round_keys, s), u32((n, 8)),
                    keys.hash_key[: 4 * s + 8].contiguous())
            got_out, got_nh = fn(*args)
            torch.cuda.synchronize()
            want_out, want_nh = ref(*args)
            worst = max(worst, err(got_out, want_out), err(got_nh, want_nh))
            if worst:
                raise AssertionError(f"{name} (S={s}) differs from plain: "
                                     f"{worst}")
            if s == 4:
                timed = args
        s = 4
        b_ms, b_by = bound(fused_bytes(n, s), fused_crypt_mac_ops(n, s))
        ms, timing = kernel_ms(lambda: fn(*timed), "fused_crypt_mac_kernel")
        out[name] = dict(
            n=n, max_abs_err=worst, ms=ms, timing=timing,
            call_ms=median_ms(lambda: fn(*timed)),
            plain_ms=median_ms(lambda: ref(*timed), n=20),
            bound_ms=b_ms, bound_by=b_by)
    out.update(_mixed_kernels(dev, shapes, u32, err))
    out.update(_weights_kernels(cfg, dev, err))
    results.update(out)
    return {k: {kk: (round(vv, 6) if isinstance(vv, float) else vv)
                for kk, vv in v.items()} for k, v in out.items()}


def _keystream_at_largest_leaf(cfg, keys, err) -> dict:
    """B1 at the weights phase's largest leaf (one counter per 64 B
    block, as ``protect`` launches it), compared with its plain version
    over the first 655,360 blocks."""
    import torch

    from repro_torch.kernels.aes_ctr import kernel as aes_k
    from repro_torch.kernels.aes_ctr import ref as aes_ref
    from repro_torch.kernels.common import aes_ctr_ops
    path, n = _largest_leaf(cfg)
    counters = torch.randint(-2 ** 31, 2 ** 31, (n, 4), dtype=torch.int32,
                             device="cuda",
                             generator=torch.Generator("cuda").manual_seed(6))
    got = aes_k.aes_ctr_keystream(counters, keys.round_keys)
    torch.cuda.synchronize()
    m = min(n, 655360)
    e = err(got[:m], aes_ref.aes_ctr_keystream_lanes_ref(counters[:m],
                                                         keys.round_keys))
    if e:
        raise AssertionError(f"aes_ctr_keystream differs from plain at the "
                             f"largest leaf: {e}")
    del got
    b_ms, b_by = bound(aes_bytes(n), aes_ctr_ops(n))
    call = lambda: aes_k.aes_ctr_keystream(counters, keys.round_keys)
    ms, timing = kernel_ms(call, "aes_ctr_keystream_kernel")
    res = dict(leaf=path, n=n, compared_blocks=m, max_abs_err=e, ms=ms,
               timing=timing, call_ms=median_ms(call), bound_ms=b_ms,
               bound_by=b_by)
    del counters, call
    torch.cuda.empty_cache()
    return res


def _tenant_registry(device, rotate: int = 0):
    """4 tenants over ``KeyHierarchy(0)`` (a K = 12 row bank), with
    ``rotate`` rotations of tenant 1 so both of its epoch rows hold keys."""
    from repro_torch.tenancy import KeyHierarchy, TenantRegistry
    reg = TenantRegistry(KeyHierarchy(0, device=device),
                         max_tenants=N_TENANTS)
    for t in range(N_TENANTS):
        reg.register(f"tenant-{t}")
    for _ in range(rotate):
        reg.rotate("tenant-1")
    return reg


def _mixed_kernels(dev, shapes, u32, err) -> dict:
    """Queue B 4-6 against their plain versions over a 12-row bank with
    rows drawn at random per block."""
    import numpy as np
    import torch

    from repro_torch.kernels.aes_ctr import kernel as aes_k
    from repro_torch.kernels.aes_ctr import ref as aes_ref
    from repro_torch.kernels.common import aes_ctr_ops, fused_crypt_mac_ops
    from repro_torch.kernels.fused_crypt_mac import kernel as fused_k
    from repro_torch.kernels.fused_crypt_mac import ops as fused_ops
    from repro_torch.kernels.fused_crypt_mac import ref as fused_ref

    bank = _tenant_registry(dev, rotate=1).bank
    k = bank.key.shape[0]
    rng = np.random.default_rng(3)

    def rows(n):
        return torch.from_numpy(rng.integers(0, k, n).astype(np.int32)).to(dev)

    out = {}
    n = shapes["read"]
    counters = u32((n, 4))
    # Rows drawn per block (every warp mixes rows; the row's comparable
    # number), then one row per page of 8,192 blocks, as the serving
    # path builds them.
    page = shapes["read"] // (SERVE["n_requests"] * PAGES_PER_SLOT)
    row_sets = {"random": rows(n),
                "page_uniform": rows(n // page).repeat_interleave(page)}
    timed = {}
    for kind, r in row_sets.items():
        got = aes_k.aes_ctr_keystream_multi(counters, bank.round_keys, r)
        torch.cuda.synchronize()
        e = err(got, aes_ref.aes_ctr_keystream_multi_lanes_ref(
            counters, bank.round_keys, r))
        if e:
            raise AssertionError(f"aes_ctr_keystream_multi ({kind} rows) "
                                 f"differs from plain: {e}")
        call = lambda: aes_k.aes_ctr_keystream_multi(counters,
                                                     bank.round_keys, r)
        ms, timing = kernel_ms(call, "aes_ctr_keystream_multi_kernel")
        timed[kind] = dict(ms=ms, timing=timing, call_ms=median_ms(call))
    r = row_sets["random"]
    b_ms, b_by = bound(aes_bytes(n, k), aes_ctr_ops(n))
    out["aes_ctr_keystream_multi"] = dict(
        n=n, k=k, max_abs_err=e, **timed["random"],
        page_uniform_rows=dict(page_blocks=page, **timed["page_uniform"]),
        plain_ms=median_ms(lambda: aes_ref.aes_ctr_keystream_multi_lanes_ref(
            counters, bank.round_keys, r), n=20),
        bound_ms=b_ms, bound_by=b_by)

    for name, fn, ref, n in (
            ("fused_crypt_mac_mixed", fused_k.fused_crypt_mac_mixed,
             fused_ref.fused_crypt_mac_mixed_ref, shapes["read"]),
            ("fused_crypt_mac_write_mixed", fused_k.fused_crypt_mac_write_mixed,
             fused_ref.fused_crypt_mac_write_mixed_ref, shapes["write"])):
        worst = 0
        for s in (4, 11):
            args = (u32((n, 4 * s)), u32((n, 4)),
                    fused_ops._div_bank(bank.round_keys, s), u32((n, 8)),
                    bank.hash_key[:, : 4 * s + 8].contiguous(), rows(n))
            got_out, got_nh = fn(*args)
            torch.cuda.synchronize()
            want_out, want_nh = ref(*args)
            worst = max(worst, err(got_out, want_out), err(got_nh, want_nh))
            if worst:
                raise AssertionError(f"{name} (S={s}) differs from plain: "
                                     f"{worst}")
            if s == 4:
                timed = args
        s = 4
        b_ms, b_by = bound(fused_bytes(n, s, k), fused_crypt_mac_ops(n, s))
        ms, timing = kernel_ms(lambda: fn(*timed),
                               "fused_crypt_mac_mixed_kernel")
        out[name] = dict(
            n=n, k=k, max_abs_err=worst, ms=ms, timing=timing,
            call_ms=median_ms(lambda: fn(*timed)),
            plain_ms=median_ms(lambda: ref(*timed), n=20),
            bound_ms=b_ms, bound_by=b_by)
    return out


def _largest_leaf(cfg) -> tuple:
    """(path, 64 B blocks) of the largest leaf of the params tree."""
    from repro_torch.core.bytesutil import TensorSpec
    from repro_torch.core.layout import tree_flatten_with_path
    from repro_torch.models import lm
    path, spec = max(((p, TensorSpec.of(s)) for p, s in
                      tree_flatten_with_path(lm.lm_specs(cfg))[0]),
                     key=lambda ps: ps[1].nbytes)
    return path, -(-spec.nbytes // 64)


def _ptxas(name: str) -> list:
    from repro_torch.kernels import build
    return [line.strip() for line in build.ptxas_report(name).splitlines()
            if any(w in line for w in ("registers", "spill", "entry"))]


def _weights_kernels(cfg, dev, err) -> dict:
    """Queue B 7-8 at the weights phase's largest leaf in 64 B blocks
    (S = 4, L = 24).  otp_xor is compared with its plain version over
    the whole leaf, the NH kernel over its first 655,360 blocks."""
    import torch

    from repro_torch.core.secure_memory import SecureKeys
    from repro_torch.kernels.common import nh_hash_ops, otp_xor_ops
    from repro_torch.kernels.otp_xor import kernel as ox_k
    from repro_torch.kernels.otp_xor import ops as ox_ops
    from repro_torch.kernels.otp_xor import ref as ox_ref
    from repro_torch.kernels.xormac import kernel as xm_k
    from repro_torch.kernels.xormac import ref as xm_ref

    path, n = _largest_leaf(cfg)
    keys = SecureKeys.derive(0, device=dev)
    gen = torch.Generator(dev).manual_seed(5)

    def u32(*shape) -> torch.Tensor:
        return torch.randint(-2 ** 31, 2 ** 31, shape, dtype=torch.int32,
                             device=dev, generator=gen)

    out = {}
    s = 4
    args = (u32(n, 4 * s), u32(n, 4), ox_ops._div_lanes(keys.round_keys, s))
    got = ox_k.otp_xor(*args)
    torch.cuda.synchronize()
    e = err(got, ox_ref.otp_xor_ref(*args))
    if e:
        raise AssertionError(f"otp_xor differs from plain: {e}")
    del got
    # data + base in, out; the diversifiers once.
    b_ms, b_by = bound(n * (16 * s + 16 + 16 * s) + 16 * s, otp_xor_ops(n, s))
    call = lambda: ox_k.otp_xor(*args)
    ms, timing = kernel_ms(call, "otp_xor_kernel")
    out["otp_xor"] = dict(
        leaf=path, n=n, s=s, compared_blocks=n, max_abs_err=e, ms=ms,
        timing=timing, call_ms=median_ms(call),
        plain_ms=median_ms(lambda: ox_ref.otp_xor_ref(*args), n=10),
        bound_ms=b_ms, bound_by=b_by, ptxas=_ptxas("otp_xor"))
    del args, call
    torch.cuda.empty_cache()

    lanes = 4 * s + 8
    payload, key = u32(n, lanes), keys.hash_key[:lanes].contiguous()
    got = xm_k.nh_hash_kernel_call(payload, key)
    torch.cuda.synchronize()
    m = min(n, 655360)
    e = err(got[:m], xm_ref.nh_hash_ref(payload[:m], key))
    if e:
        raise AssertionError(f"nh_hash_kernel_call differs from plain: {e}")
    del got
    # payload in, (hi, lo) out; the key once.
    b_ms, b_by = bound(n * (4 * lanes + 8) + 4 * lanes,
                       nh_hash_ops(n, lanes))
    call = lambda: xm_k.nh_hash_kernel_call(payload, key)
    ms, timing = kernel_ms(call, "nh_hash_kernel")
    out["nh_hash_kernel_call"] = dict(
        leaf=path, n=n, lanes=lanes, compared_blocks=m, max_abs_err=e, ms=ms,
        timing=timing, call_ms=median_ms(call),
        plain_ms=median_ms(lambda: xm_ref.nh_hash_ref(payload, key), n=5,
                           warmup=1),
        bound_ms=b_ms, bound_by=b_by, ptxas=_ptxas("xormac"))
    del payload, call
    torch.cuda.empty_cache()
    return out


def _dense_tokens(cfg, params, prompt: list, n_new: int, max_len: int,
                 bucketed: bool = False):
    """Plain prefill + decode loop (no pool, no crypto).  ``bucketed``
    feeds the model as the engine does: the prompt right-padded to its
    power-of-two bucket (the padded length sets an MoE prefill's
    capacity), decode from the prompt's length."""
    import torch

    from repro_torch.models import lm
    from repro_torch.serve import kv_pages as kvp
    from repro_torch.serve.engine import _bucket_len
    from repro_torch.serve.serve_step import greedy_sample
    lp = len(prompt)
    pad = _bucket_len(lp, max_len) - lp if bucketed else 0
    tokens = torch.tensor([prompt + [0] * pad], device="cuda")
    logits, caches = lm.lm_prefill(cfg, params, {"tokens": tokens}, max_len,
                                   last_pos=lp - 1)
    if pad:
        leaves = [torch.full_like(t, lp) if is_len else t for t, is_len in
                  zip(kvp.cache_leaves(caches), kvp.length_flags(caches))]
        caches = kvp.cache_unflatten(caches, leaves)
    tok = greedy_sample(logits)
    out = [int(tok[0, 0])]
    for _ in range(n_new - 1):
        logits, caches = lm.lm_decode(cfg, params, tok.long(), caches)
        tok = greedy_sample(logits)
        out.append(int(tok[0, 0]))
    return out


def phase_reference() -> dict:
    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.models import lm
    from repro_torch.models.layers import init_params
    from repro_torch.serve.engine import SecureServingEngine
    arch = get_arch("minitron-4b")
    cfg = arch.make_smoke_config()
    params = init_params(lm.lm_specs(cfg),
                         torch.Generator("cuda").manual_seed(0),
                         device="cuda")
    rng = np.random.default_rng(0)
    prompts = [list(map(int, rng.integers(1, cfg.vocab, n)))
               for n in (5, 7, 9)]
    eng = SecureServingEngine(arch, cfg, params, scheme="seda",
                              use_kernel=True, max_slots=2, page_tokens=4,
                              pages_per_slot=4)
    rids = [eng.submit(prompt=p, max_new_tokens=6) for p in prompts]
    done = eng.run()
    got = [done[r].generated for r in rids]
    with torch.no_grad():
        want = [_dense_tokens(cfg, params, p, 6, 16) for p in prompts]
    if got != want:
        raise AssertionError(f"engine tokens {got} != plain loop {want}")
    return {"config": cfg.name, "requests": len(prompts), "tokens": got}


def _full_params(cfg):
    """Random full-width weights from a seed, at per-layer fan-in scale.

    ``init_params`` follows the reference's fan-in over the stacked
    shape, which makes every 32-layer block ~sqrt(32) too small: the
    residual stream stays ~ the token embedding and greedy decoding
    repeats the last token.  Rescaling the stacked fan-in leaves to one
    layer's fan-in makes the tokens depend on attention over the
    decrypted KV pages.
    """
    import torch

    from repro_torch.models import lm
    from repro_torch.models.layers import init_params
    params = init_params(lm.lm_specs(cfg),
                         torch.Generator("cuda").manual_seed(0),
                         device="cuda")
    with torch.no_grad():
        for seg in params["segments"]:
            for block in seg:
                for group in ("attn", "ffn"):
                    for w in block[group].values():
                        w.mul_(cfg.n_layers ** 0.5)
    return params


def _engine(arch, cfg, params, prompts, scheme, use_kernel,
            tenants: bool = False, **kw):
    """The serve phase's engine with ``prompts`` submitted; with
    ``tenants``, over a 4-tenant registry (sessions round-robin) that
    rotates one tenant every tick.  ``kw`` go to the engine."""
    from repro_torch.serve.engine import SecureServingEngine
    registry = _tenant_registry("cuda") if tenants else None
    eng = SecureServingEngine(
        arch, cfg, params, scheme=scheme, use_kernel=use_kernel,
        max_slots=SERVE["n_requests"], page_tokens=SERVE["page_tokens"],
        pages_per_slot=PAGES_PER_SLOT, registry=registry,
        rotate_every=1 if tenants else 0, **kw)
    sessions = ([registry.open_session(f"tenant-{t}")
                 for t in range(N_TENANTS)] if tenants else [None])
    rids = [eng.submit(prompt=p, max_new_tokens=SERVE["new_tokens"],
                       session=sessions[i % len(sessions)])
            for i, p in enumerate(prompts)]
    return eng, rids


def _serve_once(arch, cfg, params, prompts, scheme, use_kernel,
                tenants: bool = False, **kw):
    import torch

    from repro_torch.kernels import LAUNCHES, reset_launches
    eng, rids = _engine(arch, cfg, params, prompts, scheme, use_kernel,
                        tenants, **kw)
    torch.cuda.synchronize()
    reset_launches()                       # main path starts here
    t0 = time.perf_counter()
    done = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)              # ... and ends here
    tokens = [done[r].generated for r in rids]
    n_tok = sum(len(t) for t in tokens)
    return eng, tokens, {
        "scheme": scheme, "use_kernel": use_kernel, "tenants": tenants,
        "wall_s": wall, "deferred_mac_ok": eng.deferred_check(),
        "tokens": n_tok, "tok_per_s": n_tok / wall, "ticks": eng.tick,
        "stats": dict(eng.stats), "launches": launches,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}


def phase_serve(arch, cfg, results: dict) -> dict:
    import numpy as np
    import torch
    params = _full_params(cfg)
    n_params = sum(t.numel() for t in _leaves(params))
    rng = np.random.default_rng(1)
    prompts = [list(map(int, rng.integers(1, cfg.vocab, SERVE["prompt_len"])))
               for _ in range(SERVE["n_requests"])]
    with torch.no_grad():
        logits, _ = _prefill_logits(cfg, params, prompts[0])
    if logits.shape != (1, 1, cfg.vocab) or not torch.isfinite(
            logits.float()).all():
        raise AssertionError(f"prefill logits {tuple(logits.shape)} not "
                             "finite or misshapen")
    # In turns (A B C C B A) so drift on the card hits every config alike;
    # the first seda_kernel run is the main path whose launches count.
    order = [("seda_kernel", "seda", True), ("seda_plain", "seda", False),
             ("off", "off", False)]
    runs: dict = {key: [] for key, _, _ in order}
    tokens: dict = {}
    for key, scheme, use_kernel in order + order[::-1]:
        eng, toks, run = _serve_once(arch, cfg, params, prompts, scheme,
                                     use_kernel)
        if tokens.setdefault(key, toks) != toks:
            raise AssertionError(f"{key}: tokens differ between two runs")
        runs[key].append(run)
        del eng
        torch.cuda.empty_cache()
    main = runs["seda_kernel"][0]
    zero = [k for k in SINGLE_KEY if main["launches"][k] <= 0]
    if zero:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{zero}")
    if main["stats"]["fused_write_ticks"] <= 0:
        raise AssertionError("fused_write_ticks == 0")
    if not (tokens["seda_kernel"] == tokens["seda_plain"] == tokens["off"]):
        raise AssertionError("tokens differ between seda+kernels, seda plain "
                             "and off")
    flat = [t for seq in tokens["seda_kernel"] for t in seq]
    if (any(len(t) != SERVE["new_tokens"] for t in tokens["seda_kernel"])
            or not all(0 <= t < cfg.vocab for t in flat)):
        raise AssertionError("wrong token counts or ids out of range")
    results["launches"] = main["launches"]
    results["params"] = params
    results["prompts"] = prompts
    results["serve_tokens"] = tokens["seda_kernel"]
    return {"config": cfg.name, "n_params": n_params,
            "distinct_tokens": len(set(flat)),
            "main_path": {k: main[k] for k in ("launches", "stats", "ticks")},
            "tok_per_s": {k: [r["tok_per_s"] for r in v]
                          for k, v in runs.items()},
            "wall_s": {k: [r["wall_s"] for r in v] for k, v in runs.items()},
            "peak_mem_gb": max(r["peak_mem_gb"] for v in runs.values()
                               for r in v),
            "first_request_tokens": tokens["seda_kernel"][0]}


def _profile_ticks(arch, cfg, params, prompts, scheme, use_kernel,
                   tenants: bool = False, n_ticks: int = 3) -> tuple:
    """Device busy time and the top kernels over ``n_ticks`` steady
    decode ticks (all 8 requests running), from a CUPTI trace, the
    engine, still running, and its request ids.  With ``tenants`` each
    tick also rotates a tenant and reseals its pages."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    eng, rids = _engine(arch, cfg, params, prompts, scheme, use_kernel,
                        tenants)
    for _ in range(2):                     # admission + one warm tick
        eng.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_ticks):
        eng.step()
    torch.cuda.synchronize()
    plain_wall = (time.perf_counter() - t0) / n_ticks
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_ticks):
            eng.step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / n_ticks
    return {"tick_ms": plain_wall * 1e3,
            **_device_breakdown(prof, wall * 1e3, n_ticks, "tick")}, eng, rids


CRYPTO_SYMBOLS = ("aes_ctr_keystream", "fused_crypt_mac", "otp_xor",
                  "nh_hash_kernel")


def _device_breakdown(prof, wall_ms: float, n: int, unit: str) -> dict:
    """Device busy time, idle share, launches and the top kernels per
    ``unit`` from a CUPTI trace of ``n`` units that took ``wall_ms``
    each on the host clock."""
    kernels = _device_events(prof)
    by_name: dict = {}
    for e in kernels:
        by_name[e.name] = (by_name.get(e.name, 0.0)
                           + e.device_time_total / 1e3)
    busy = sum(by_name.values()) / n
    by_symbol = {sym: sum(v for k, v in by_name.items() if sym in k) / n
                 for sym in CRYPTO_SYMBOLS}
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {f"profiled_{unit}_ms": wall_ms,
            "device_busy_ms": busy,
            "crypto_kernel_ms": sum(by_symbol.values()),
            "crypto_kernel_ms_by_symbol": by_symbol,
            "device_idle_share": (1 - busy / wall_ms) if kernels else None,
            f"kernel_launches_per_{unit}": len(kernels) / n,
            f"top_kernels_ms_per_{unit}": [(k[:90], v / n) for k, v in top]}


def _expected_charges(eng, bucket: int) -> dict:
    """``{kernel: [bytes, ops]}`` one decode call over ``bucket`` pages a
    slot should charge, from the engine's page spec: per paged leaf a
    read of every slot's window and a write of every slot's dirty page,
    each an AES keystream for the base pads, the fused pass and a
    keystream over the MAC finalization words (bytes as the kernels
    phase's bounds count them)."""
    from repro_torch.kernels.common import aes_ctr_ops, fused_crypt_mac_ops
    s = eng.spec.cfg.block_bytes // 16
    k = None if eng.registry is None else eng._bank().round_keys.shape[0]
    aes, read, write = MIXED_KEY if k else SINGLE_KEY
    out = {name: [0.0, 0.0] for name in (aes, read, write)}
    for leaf in eng.spec.leaves:
        for name, pages in ((read, eng.max_slots * bucket),
                            (write, eng.max_slots)):
            n = pages * leaf.n_blocks
            out[aes][0] += 2 * aes_bytes(n, k)
            out[aes][1] += 2 * aes_ctr_ops(n)
            out[name][0] += fused_bytes(n, s, k)
            out[name][1] += fused_crypt_mac_ops(n, s)
    return out


def _cost_profile(eng, rids, device_busy_ms: float, want_tokens) -> dict:
    """``eng.profile()`` of the all-resident decode variant between two
    ticks of a running engine, beside the device ms a traced tick took.
    Gates: each kernel's charges are the bytes and operations of its
    calls (:func:`_expected_charges`); the launch counts and the pool
    bytes do not move; the engine then finishes with the serve phase's
    tokens."""
    import torch

    from repro_torch import kernels
    charged: dict = {}

    def sink(name, source, nbytes, ops):
        c = charged.setdefault(name, [0.0, 0.0])
        c[0] += nbytes
        c[1] += ops

    launches = dict(kernels.LAUNCHES)
    pool = _pool_bytes(eng)
    kernels.COST_SINKS.append(sink)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        doc = eng.profile()
        torch.cuda.synchronize()
        profile_s = time.perf_counter() - t0
    finally:
        kernels.COST_SINKS.remove(sink)
    if dict(kernels.LAUNCHES) != launches:
        raise AssertionError("profile() moved the kernels' launch counts")
    if not _same_pools([pool], [_pool_bytes(eng)]):
        raise AssertionError("profile() changed the engine's pool")
    prof = doc["profiles"][0]
    want = (_expected_charges(eng, prof["bucket"]) if eng.spec.use_kernel
            and eng.scheme == "seda" else {})
    if charged != want:
        raise AssertionError(f"kernel charges {charged} != their calls' "
                             f"bytes and operations {want}")
    done = eng.run()
    if [done[r].generated for r in rids] != want_tokens:
        raise AssertionError("the profiled engine's tokens differ from the "
                             "serve phase's")
    roof_ms = prof["roofline"]["roofline_s"] * 1e3
    return {"profile_s": profile_s, "device_busy_ms": device_busy_ms,
            "roofline_ms": roof_ms,
            "device_busy_over_roofline": device_busy_ms / roof_ms,
            "kernel_charges": charged, **prof}


def phase_profile(arch, cfg, results: dict) -> dict:
    import torch
    out = {}
    for key, scheme, use_kernel, tenants in (
            ("seda_kernel", "seda", True, False), ("off", "off", False, False),
            ("seda_kernel_4_tenants", "seda", True, True)):
        out[key], eng, rids = _profile_ticks(
            arch, cfg, results["params"], results["prompts"], scheme,
            use_kernel, tenants)
        out[key]["cost_profile"] = _cost_profile(
            eng, rids, out[key]["device_busy_ms"], results["serve_tokens"])
        del eng
        torch.cuda.empty_cache()
    for key, v in out.items():
        ratios = (v["cost_profile"]["overhead_bytes_ratio"],
                  v["cost_profile"]["overhead_flops_ratio"])
        if not (all(r < 0.01 for r in ratios) if key == "off"
                else all(r > 0.01 for r in ratios)):
            raise AssertionError(f"{key}: overhead ratios {ratios}")
    results["profile_seda"] = {k: v for k, v in out["seda_kernel"].items()
                               if k != "cost_profile"}
    return out


def _leaves(tree) -> list:
    from repro_torch.models.layers import tree_map
    out: list = []
    tree_map(out.append, tree)
    return out


def _prefill_logits(cfg, params, prompt):
    import torch

    from repro_torch.models import lm
    tokens = torch.tensor([prompt], device="cuda")
    return lm.lm_prefill(cfg, params, {"tokens": tokens}, len(prompt))


def phase_tamper(arch, cfg, params, leaf: int = 0) -> dict:
    """A flipped byte of paged leaf ``leaf`` of a live page: the next
    ``step()`` must raise."""
    import numpy as np

    from repro_torch.serve.engine import IntegrityError, SecureServingEngine
    eng = SecureServingEngine(arch, cfg, params, scheme="seda",
                              use_kernel=True, max_slots=2,
                              page_tokens=SERVE["page_tokens"],
                              pages_per_slot=PAGES_PER_SLOT)
    rng = np.random.default_rng(2)
    for _ in range(2):
        eng.submit(prompt=list(map(int, rng.integers(1, cfg.vocab, 20))),
                   max_new_tokens=8)
    eng.step()
    eng.step()
    page = eng.slots[0].pages[0]
    eng.pool.cts[leaf][page, 123] ^= 0x10
    try:
        eng.step()
    except IntegrityError as e:
        return {"leaf": leaf, "page": int(page), "raised": type(e).__name__,
                "message": str(e)}
    raise AssertionError(f"a flipped ciphertext byte of paged leaf {leaf} "
                         "was not detected")


def phase_tenants(arch, cfg, results: dict) -> dict:
    import torch
    params, prompts = results["params"], results["prompts"]
    order = [("kernel", True), ("plain", False)]
    runs: dict = {key: [] for key, _ in order}
    tokens: dict = {}
    for key, use_kernel in order + order[::-1]:
        eng, toks, run = _serve_once(arch, cfg, params, prompts, "seda",
                                     use_kernel, tenants=True)
        if tokens.setdefault(key, toks) != toks:
            raise AssertionError(f"{key}: tokens differ between two runs")
        runs[key].append(run)
        del eng
        torch.cuda.empty_cache()
    main = runs["kernel"][0]               # the tenants path's launches
    stats = main["stats"]
    zero = [k for k in MIXED_KEY if main["launches"][k] <= 0]
    if zero:
        raise AssertionError(f"mixed-key kernels never launched: {zero}")
    if not (tokens["kernel"] == tokens["plain"] == results["serve_tokens"]):
        raise AssertionError("tenant tokens differ between kernels on, "
                             "kernels off and the single-tenant serve")
    if stats["fused_mixed_ticks"] != stats["decode_steps"] or \
            stats["uniform_fast_ticks"] != 0:
        raise AssertionError(f"not every decode tick was mixed: {stats}")
    if stats["rotations"] <= 0 or stats["reseals"] <= 0:
        raise AssertionError(f"no rotation or no reseal: {stats}")
    if not all(r["deferred_mac_ok"] for v in runs.values() for r in v):
        raise AssertionError("deferred pool MAC failed")
    results["tenant_launches"] = main["launches"]
    return {"tenants": N_TENANTS, "rotate_every": 1,
            "main_path": {k: main[k] for k in ("launches", "stats", "ticks")},
            "tok_per_s": {k: [r["tok_per_s"] for r in v]
                          for k, v in runs.items()},
            "wall_s": {k: [r["wall_s"] for r in v] for k, v in runs.items()},
            "peak_mem_gb": max(r["peak_mem_gb"] for v in runs.values()
                               for r in v)}


def phase_tenant_tamper(arch, cfg, params) -> dict:
    """Tenant B's slot reads tenant A's pages: the next tick must fail."""
    import numpy as np

    from repro_torch.serve.engine import IntegrityError
    rng = np.random.default_rng(4)
    prompts = [list(map(int, rng.integers(1, cfg.vocab, 20)))
               for _ in range(2)]
    eng, rids = _engine(arch, cfg, params, prompts, "seda", True,
                        tenants=True)
    eng.step()
    a = next(s for s in eng.slots if s and s.req.rid == rids[0])
    b = next(s for s in eng.slots if s and s.req.rid == rids[1])
    if a.tenant is b.tenant:
        raise AssertionError("the two requests share a tenant")
    b.pages, b.page_epochs = list(a.pages), list(a.page_epochs)
    try:
        eng.step()
    except IntegrityError as e:
        return {"tenants": [a.tenant.tenant_id, b.tenant.tenant_id],
                "raised": type(e).__name__, "message": str(e)}
    raise AssertionError("a cross-tenant page read was not detected")


def _prefix_traffic(vocab: int, system_len: int = SYSTEM_LEN,
                    user_len: int = USER_LEN) -> tuple:
    """``(systems, requests, shared)``: each tenant's system prompt;
    ``(tenant, prompt)`` requests, the 4 system prompts alone first
    (miss + insert), then twice each prompt with a user turn (hit +
    copy-on-write + replay); and the request tenant 1 sends with tenant
    0's system prompt after the share."""
    import numpy as np
    rng = np.random.default_rng(5)

    def tokens(n):
        return list(map(int, rng.integers(1, vocab, n)))

    systems = [tokens(system_len) for _ in range(N_TENANTS)]
    requests = [(t, systems[t]) for t in range(N_TENANTS)]
    requests += [(t, systems[t] + tokens(user_len))
                 for _ in range(2) for t in range(N_TENANTS)]
    return systems, requests, systems[0] + tokens(user_len)


def _prefix_engine(arch, cfg, params, scheme, use_kernel, cache: bool,
                   **kw):
    from repro_torch.serve.engine import SecureServingEngine
    registry = _tenant_registry("cuda")
    kw = {**PREFIX, **kw}
    if not cache:
        kw.pop("prefix_cache_pages")
    eng = SecureServingEngine(arch, cfg, params, scheme=scheme,
                              use_kernel=use_kernel, registry=registry,
                              prefix_cache=cache, **kw)
    return eng, [registry.open_session(f"tenant-{t}")
                 for t in range(N_TENANTS)]


def _merkle_probe(eng, sessions) -> dict:
    """Mid-run Merkle level checks: the incremental tree node for node
    against a rebuild, every tenant's proof verified and one with a
    flipped leaf MAC rejected."""
    import dataclasses

    from repro_torch.serve import merkle_pool as mkp
    _tree_equals_rebuild(eng)
    root = eng.merkle.root_hex()
    pages = []
    for s in sessions:
        proof = eng.audit_proof(s)
        if not proof.pages:
            raise AssertionError(f"tenant {proof.tenant} has no resident "
                                 "page to prove")
        mkp.verify_proof(proof, expected_root=root, tenant=proof.tenant)
        pages.append(len(proof.pages))
    page = proof.pages[0]
    mac = bytes([bytes.fromhex(page.mac)[0] ^ 1]) + bytes.fromhex(
        page.mac)[1:]
    bad = dataclasses.replace(proof, pages=(dataclasses.replace(
        page, mac=mac.hex()),) + proof.pages[1:])
    try:
        mkp.verify_proof(bad, expected_root=root, tenant=proof.tenant)
    except mkp.LeafMacError:
        pass
    else:
        raise AssertionError("a proof with a flipped leaf MAC verified")
    return {"tick": eng.tick, "proof_pages": pages}


def _tree_equals_rebuild(eng) -> None:
    import numpy as np

    from repro_torch.serve import kv_pages as kvp
    from repro_torch.serve import merkle_pool as mkp
    quarantined = np.zeros(eng.n_pages, bool)
    quarantined[sorted(eng.quarantined)] = True
    rebuilt = mkp.build_tree(kvp.merkle_leaf_macs(eng.pool, eng.spec),
                             eng._page_owners(), quarantined, shard=0)
    if eng.merkle.snapshot() != rebuilt:
        raise AssertionError("the incremental Merkle tree differs from a "
                             "rebuild")


def _prefix_once(arch, cfg, params, traffic, scheme, use_kernel,
                 cache: bool = True, new_tokens: int = 16, **kw):
    """The prefix traffic through one engine: the 12 requests (Merkle
    checks after 3 ticks, not timed), the share of tenant 0's prompt
    with tenant 1, and tenant 1's request with it."""
    import torch

    from repro_torch.kernels import LAUNCHES, reset_launches
    systems, requests, shared = traffic
    eng, sessions = _prefix_engine(arch, cfg, params, scheme, use_kernel,
                                   cache, **kw)
    prefills = [0]
    prefill = eng._prefill

    def counted(seq):
        prefills[0] += 1
        return prefill(seq)

    eng._prefill = counted
    syncs = []                             # host time of each Merkle sync
    sync = eng._merkle_sync

    def timed_sync():
        torch.cuda.synchronize()
        leaves = eng.stats["merkle_leaf_updates"]
        t = time.perf_counter()
        sync()
        syncs.append({"tick": eng.tick,
                      "ms": (time.perf_counter() - t) * 1e3,
                      "leaf_updates": eng.stats["merkle_leaf_updates"]
                      - leaves})

    eng._merkle_sync = timed_sync
    torch.cuda.synchronize()
    reset_launches()                       # the prefix path starts here
    t0 = time.perf_counter()
    rids = [eng.submit(prompt=p, max_new_tokens=new_tokens,
                       session=sessions[t]) for t, p in requests]
    for _ in range(3):
        eng.step()
    t1 = time.perf_counter()
    probe = _merkle_probe(eng, sessions)
    probe_s = time.perf_counter() - t1
    eng.run()
    n_shared = (eng.share_prefix(systems[0], from_session=sessions[0],
                                 to_session=sessions[1]) if cache else 0)
    hits0 = eng.stats["prefix_hit_pages"]
    rids.append(eng.submit(prompt=shared, max_new_tokens=new_tokens,
                           session=sessions[1]))
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0 - probe_s
    launches = dict(LAUNCHES)              # ... and ends here
    _tree_equals_rebuild(eng)
    if not eng.deferred_check():
        raise AssertionError("deferred pool MAC failed")
    return eng, {
        "tokens": [eng.requests[r].generated for r in rids],
        "wall_s": wall, "ticks": eng.tick, "prefills": prefills[0],
        "shared_pages": n_shared,
        "shared_request_hit_pages": eng.stats["prefix_hit_pages"] - hits0,
        "stats": dict(eng.stats), "launches": launches,
        "merkle": {**probe, "syncs": syncs}}


def phase_prefix(arch, cfg, results: dict) -> dict:
    import torch
    params = results["params"]
    traffic = _prefix_traffic(cfg.vocab)
    # In turns, twice each; the first cache-on kernel run is the prefix
    # path whose launches count.
    order = [("kernel", "seda", True, True), ("plain", "seda", False, True),
             ("off", "off", False, True), ("no_cache", "seda", True, False)]
    runs: dict = {key: [] for key, *_ in order}
    tokens: dict = {}
    main_eng = None
    for key, scheme, use_kernel, cache in order + order[::-1]:
        eng, run = _prefix_once(arch, cfg, params, traffic, scheme,
                                use_kernel, cache)
        if tokens.setdefault(key, run["tokens"]) != run["tokens"]:
            raise AssertionError(f"{key}: tokens differ between two runs")
        runs[key].append(run)
        if main_eng is None:
            main_eng = eng
        else:
            del eng
        torch.cuda.empty_cache()
    main = runs["kernel"][0]
    counters = {key: [{c: r["stats"][c] for c in PREFIX_COUNTERS}
                      for r in runs[key]] for key in ("kernel", "plain",
                                                      "off")}
    flat = [c for v in counters.values() for c in v]
    if any(c != flat[0] for c in flat):
        raise AssertionError(f"prefix counters differ: {counters}")
    zero = [c for c in PREFIX_COUNTERS if main["stats"][c] <= 0]
    if zero:
        raise AssertionError(f"prefix counters at 0: {zero}")
    if main["shared_request_hit_pages"] <= 0:
        raise AssertionError("tenant 1's request missed the shared prefix")
    zero = [k for k in MIXED_KEY if main["launches"][k] <= 0]
    if zero:
        raise AssertionError(f"mixed-key kernels never launched on the "
                             f"prefix path: {zero}")
    if not (tokens["kernel"] == tokens["plain"] == tokens["off"]):
        raise AssertionError("prefix tokens differ between seda+kernels, "
                             "seda plain and off")
    if any(len(t) != 16 for t in tokens["kernel"]):
        raise AssertionError("wrong token counts")
    agree = _agreement(tokens["kernel"], tokens["no_cache"])
    copy = _time_insert_copy(main_eng, traffic)
    cached_tamper = _tamper_cached_page(main_eng, traffic)
    del main_eng
    torch.cuda.empty_cache()
    replay = _replay_cache_page_across_tenants(arch, cfg, params, traffic)
    full_f32 = _prefix_full_f32(arch, cfg, params, traffic)
    smoke = _prefix_smoke_f32()
    results["prefix_launches"] = main["launches"]
    pick = ("wall_s", "ticks", "prefills")
    return {
        "config": {**PREFIX, "tenants": N_TENANTS, "system_len": SYSTEM_LEN,
                   "user_len": USER_LEN, "requests": len(traffic[1]) + 1},
        "main_path": {k: main[k] for k in ("launches", "stats", "ticks",
                                           "prefills", "shared_pages")},
        "runs": {k: [{p: r[p] for p in pick} for r in v]
                 for k, v in runs.items()},
        "tokens_agree_with_no_cache": agree,
        "tokens_agree_with_no_cache_f32": full_f32,
        "tokens_per_request": 16,
        "merkle": main["merkle"], "insert_copy": copy,
        "cached_page_tamper": cached_tamper, "cross_tenant_replay": replay,
        "smoke_f32": smoke}


def _whole_chain(eng, traffic, tenant: int) -> tuple:
    """``(tenant, chain)``: the given tenant's cached system prompt, or
    the next tenant's whose whole 7-page chain is still cached (the
    share may reclaim a tenant's least recently used pages)."""
    for t in [tenant] + list(range(N_TENANTS)):
        chain = eng.prefix_cache.match(t, traffic[0][t])
        if len(chain) == 7:
            return t, chain
    raise AssertionError("no tenant's system prompt is wholly cached")


def _agreement(got: list, want: list) -> list:
    """Per request, the leading tokens two runs agree on."""
    out = []
    for x, y in zip(got, want):
        n = 0
        while n < min(len(x), len(y)) and x[n] == y[n]:
            n += 1
        out.append(n)
    return out


def _prefix_full_f32(arch, cfg, params, traffic) -> list:
    """The prefix traffic at full width in float32, cache on and off
    (kernels on): per request the leading tokens the two agree on.
    Printed, not gated: it tells bf16 rounding in the replayed KV from
    a fault of the cache."""
    import dataclasses

    import torch

    from repro_torch.models.layers import tree_map
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params32 = tree_map(lambda t: t.float(), params)
    runs = [_prefix_once(arch, cfg32, params32, traffic, "seda", True,
                         cache)[1]["tokens"] for cache in (True, False)]
    del params32
    torch.cuda.empty_cache()
    return _agreement(*runs)


def _time_insert_copy(eng, traffic) -> dict:
    """One 7-page copy of a cached chain into free pages under the same
    cache binding (the kernels and shapes of an insert: the mixed-key
    read of 7 pages padded to 10 lanes, then the write): host wall and
    the device time of its kernels (CUPTI)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve import kv_pages as kvp
    tenant, chain = _whole_chain(eng, traffic, 2)
    row = eng.registry.cache_row(tenant)
    side = (tenant, row, kvp.PREFIX_ROLE)
    dst = [eng.free_pages.pop() for _ in chain]

    def copy():
        if not eng._copy_pages([e.page_id for e in chain], dst, src=side,
                               dst=side, lanes=eng.pages_per_slot):
            raise AssertionError("the timed copy failed verification")

    copy()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        copy()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    eng.free_pages.extend(dst)
    kernels = _device_events(prof)
    symbols = dict(zip(MIXED_KEY, ("aes_ctr_keystream_multi_kernel",
                                   "fused_crypt_mac_mixed_kernel<false>",
                                   "fused_crypt_mac_mixed_kernel<true>")))
    by_symbol = {name: sum(e.device_time_total for e in kernels
                           if sym in e.name) / 1e3
                 for name, sym in symbols.items()}
    return {"pages": len(chain), "lanes": eng.pages_per_slot,
            "wall_ms": wall_ms,
            "device_busy_ms": sum(e.device_time_total
                                  for e in kernels) / 1e3,
            "launches": len(kernels), "mixed_kernel_ms": by_symbol}


def _tamper_cached_page(eng, traffic) -> dict:
    """One flipped ciphertext byte of a cached page: the next hit on it
    raises ``IntegrityError``."""
    from repro_torch.serve.engine import IntegrityError
    systems = traffic[0]
    tenant, chain = _whole_chain(eng, traffic, 3)
    page = chain[0].page_id
    eng.pool.cts[0][page, 100] ^= 0x08
    eng.submit(prompt=systems[tenant] + [7] * USER_LEN, max_new_tokens=4,
               session=eng.registry.open_session(f"tenant-{tenant}"))
    try:
        eng.run()
    except IntegrityError as e:
        return {"page": int(page), "raised": type(e).__name__,
                "message": str(e)}
    raise AssertionError("a flipped byte of a cached page was not "
                         "detected")


def _replay_cache_page_across_tenants(arch, cfg, params, traffic) -> dict:
    """Tenant 0's cache page replayed into tenant 1's slot: the next
    tick raises ``IntegrityError``."""
    import numpy as np

    from repro_torch.serve import kv_pages as kvp
    from repro_torch.serve.engine import IntegrityError
    eng, sessions = _prefix_engine(arch, cfg, params, "seda", True, True)
    eng.submit(prompt=traffic[0][0], max_new_tokens=4, session=sessions[0])
    eng.run()
    entry = eng.prefix_cache.match(0, traffic[0][0])[0]
    rng = np.random.default_rng(6)
    eng.submit(prompt=list(map(int, rng.integers(1, cfg.vocab, 20))),
               max_new_tokens=8, session=sessions[1], share_prefix=False)
    eng.step()
    slot = next(s for s in eng.slots if s is not None)
    slot.pages[0] = entry.page_id
    slot.page_epochs[0] = kvp.PREFIX_ROLE
    try:
        eng.step()
    except IntegrityError as e:
        return {"page": int(entry.page_id), "raised": type(e).__name__,
                "message": str(e)}
    raise AssertionError("tenant 0's cache page read in tenant 1's slot "
                         "was not detected")


def _prefix_smoke_f32() -> dict:
    """The smoke config (float32) with the kernels: the prefix traffic
    (system prompts of 7, turns of 2 tokens, pages of 4) gives the
    tokens of the engine without the cache."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.models import lm
    from repro_torch.models.layers import init_params
    arch = get_arch("minitron-4b")
    cfg = arch.make_smoke_config()
    params = init_params(lm.lm_specs(cfg),
                         torch.Generator("cuda").manual_seed(0),
                         device="cuda")
    traffic = _prefix_traffic(cfg.vocab, system_len=7, user_len=2)
    kw = dict(max_slots=4, page_tokens=4, pages_per_slot=4, n_pages=40,
              prefix_cache_pages=12)
    got = {}
    for cache in (True, False):
        _, run = _prefix_once(arch, cfg, params, traffic, "seda", True,
                              cache, new_tokens=6, **kw)
        got[cache] = run
    if got[True]["tokens"] != got[False]["tokens"]:
        raise AssertionError(f"smoke: cache-on tokens {got[True]['tokens']} "
                             f"!= no-cache {got[False]['tokens']}")
    if got[True]["stats"]["prefix_hit_pages"] <= 0:
        raise AssertionError("smoke: no prefix hit")
    return {"config": cfg.name, "requests": len(got[True]["tokens"]),
            "stats": {c: got[True]["stats"][c] for c in PREFIX_COUNTERS},
            "tokens_equal_no_cache": True}


# The faults phase: the serve phase's requests through the fault-tolerant
# engine, with spare frames for the quarantined ones.
FAULTS_N_PAGES = SERVE["n_requests"] * PAGES_PER_SLOT + 16
SINGLE_FAULTS = (dict(tick=3, kind="bitflip", slot=0),
                 dict(tick=5, kind="vn_bump", slot=2),
                 dict(tick=7, kind="page_swap", slot=4),
                 dict(tick=9, kind="transient"))
TENANT_FAULTS = (dict(tick=3, kind="bitflip", slot=1),
                 dict(tick=5, kind="mac_corrupt", slot=2))


def _contained_once(arch, cfg, params, prompts, faults, tenants: bool,
                    **kw) -> tuple:
    """The serve phase's requests through the fault-tolerant engine with
    ``faults`` attached (seda, kernels).  Each containment is timed on
    the host clock, the card synced before and after, with the kernel
    counts set to 0 just before it and read just after; the first one
    also runs under a CUPTI trace (device busy time, every launch), so
    its host time is not comparable with the others'.  Every tick checks
    that no quarantined frame is free or in a slot."""
    import contextlib

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.serve.faults import Fault, FaultPlan
    eng, rids = _engine(arch, cfg, params, prompts, "seda", True, tenants,
                        n_pages=FAULTS_N_PAGES, fault_tolerance=True, **kw)
    plan = FaultPlan([Fault(**f) for f in faults]).attach(eng)
    containments: list = []

    def timed(name, fn):
        def wrapper(*a, **k):
            traced = not containments
            prof = (profile(activities=[ProfilerActivity.CUDA]) if traced
                    else contextlib.nullcontext())
            torch.cuda.synchronize()
            reset_launches()
            with prof:
                t0 = time.perf_counter()
                try:
                    out = fn(*a, **k)
                finally:
                    torch.cuda.synchronize()
                    host_ms = (time.perf_counter() - t0) * 1e3
                    containments.append({
                        "tick": eng.tick, "where": name, "host_ms": host_ms,
                        "traced": traced,
                        "launches": {k: v for k, v in LAUNCHES.items()
                                     if v}})
            if traced:
                trace = _device_breakdown(prof, host_ms, 1, "containment")
                containments[-1]["device"] = {
                    k: trace[k] for k in (
                        "device_busy_ms", "crypto_kernel_ms",
                        "device_idle_share",
                        "kernel_launches_per_containment")}
            return out
        return wrapper

    eng._contain_error = timed("contain_error", eng._contain_error)
    eng._decode_failure = timed("decode_failure", eng._decode_failure)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while eng._n_waiting() or any(s is not None for s in eng.slots):
        eng.step()                         # an IntegrityError escapes here
        resident = {int(p) for s in eng.slots if s is not None
                    for p in s.pages}
        leak = eng.quarantined & (resident | set(eng.free_pages))
        if leak:
            raise AssertionError(f"quarantined frames {sorted(leak)} back "
                                 f"in use at tick {eng.tick}")
    eng.run()                              # the end-of-run checks
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return eng, plan, [eng.requests[r].generated for r in rids], {
        "wall_s": wall, "ticks": eng.tick, "containments": containments}


def _containment_gates(eng, plan, faults, tokens, want) -> dict:
    """The gates of one contained run; the recovered sessions' agreement
    with the fault-free tokens is returned, not gated (bf16)."""
    import json
    import tempfile

    if len(plan.fired) != len(faults):
        raise AssertionError(f"{len(plan.fired)} of {len(faults)} faults "
                             "fired")
    condemned = {p for e in eng.audit.events("quarantine")
                 for p in e["pages"]}
    if eng.stats["integrity_quarantined_pages"] != len(condemned) or \
            condemned != eng.quarantined or not condemned:
        raise AssertionError(f"quarantined {sorted(eng.quarantined)}, "
                             f"audited {sorted(condemned)}, counter "
                             f"{eng.stats['integrity_quarantined_pages']}")
    if eng.stats["sessions_lost"] or eng.stats["sessions_recovered"] < 1:
        raise AssertionError(f"sessions lost {eng.stats['sessions_lost']}, "
                             f"recovered {eng.stats['sessions_recovered']}")
    _tree_equals_rebuild(eng)
    if not (eng.audit.verify_chain() and eng.deferred_check()):
        raise AssertionError("the audit chain or the pool MAC failed")
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.NamedTemporaryFile("w", suffix=".json", dir=ROOT / "build",
                                     delete=False) as f:
        path = f.name
    try:
        eng.export_trace(path)
        events = json.loads(Path(path).read_text())["traceEvents"]
    finally:
        Path(path).unlink()
    if not events or any(e.get("ph") != "X" or e["dur"] < 0
                         for e in events):
        raise AssertionError("export_trace is not Chrome trace JSON")
    reqs = list(eng.requests.values())
    faulted = [i for i, r in enumerate(reqs) if r.n_evictions]
    if any(tokens[i] != want[i] for i in range(len(reqs))
           if i not in faulted):
        raise AssertionError("an un-faulted session's tokens changed")
    if any(len(t) != SERVE["new_tokens"] for t in tokens):
        raise AssertionError("a session ended short")
    return {"fired": [f.kind for f in plan.fired],
            "quarantined": sorted(eng.quarantined),
            "faulted_sessions": faulted,
            "faulted_agree_bf16": [_agreement([tokens[i]], [want[i]])[0]
                                   for i in faulted],
            "counters": {k: eng.stats[k] for k in (
                "integrity_verdicts", "integrity_failures",
                "integrity_quarantined_pages", "sessions_recovered",
                "sessions_lost", "audit_events", "preemptions")},
            "audit_events": sorted({e["event"] for e in
                                    eng.audit.records()}),
            "trace_events": len(events)}


def _recovery_f32(arch, cfg, params, prompts) -> dict:
    """The recovery token gate in float32 at full width: the single-
    tenant fault plan's run gives every session the fault-free tokens."""
    import dataclasses

    import torch

    from repro_torch.models.layers import tree_map
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params32 = tree_map(lambda t: t.float(), params)
    _, want, _ = _serve_once(arch, cfg32, params32, prompts, "seda", True)
    eng, _, got, run = _contained_once(arch, cfg32, params32, prompts,
                                       SINGLE_FAULTS, False)
    stats = dict(eng.stats)
    del eng, params32
    torch.cuda.empty_cache()
    if got != want:
        raise AssertionError(f"float32 recovery: agreement "
                             f"{_agreement(got, want)} of 16 tokens")
    if stats["sessions_recovered"] < 1 or stats["sessions_lost"]:
        raise AssertionError(f"float32 recovery: {stats}")
    return {"requests": len(prompts), "tokens_equal_fault_free": True,
            "sessions_recovered": stats["sessions_recovered"],
            "sessions_lost": stats["sessions_lost"],
            "containment_host_ms": [c["host_ms"]
                                    for c in run["containments"]]}


def _obs_cost(arch, cfg, params, prompts) -> dict:
    """The serve phase's seda + kernels run with ``trace=True,
    audit=True`` and without, in turns (ABAB): host ms per tick."""
    import torch
    out: dict = {"obs": [], "bare": []}
    for key in ("obs", "bare", "obs", "bare"):
        kw = dict(trace=True, audit=True) if key == "obs" else {}
        eng, _, run = _serve_once(arch, cfg, params, prompts, "seda", True,
                                  **kw)
        out[key].append(run["wall_s"] * 1e3 / run["ticks"])
        del eng
        torch.cuda.empty_cache()
    return {"tick_ms": out, "order": "obs, bare, obs, bare"}


def phase_faults(arch, cfg, results: dict) -> dict:
    """Fault containment at full width: single tenant, then 4 tenants
    rotating every tick; the recovery token gate in float32; the cost of
    tracing + audit in turns."""
    import torch
    params, prompts = results["params"], results["prompts"]
    want = results["serve_tokens"]
    out = {"n_pages": FAULTS_N_PAGES}
    for key, faults, tenants in (("single", SINGLE_FAULTS, False),
                                 ("tenants", TENANT_FAULTS, True)):
        eng, plan, tokens, run = _contained_once(
            arch, cfg, params, prompts, faults, tenants, trace=True,
            audit=True)
        out[key] = {**_containment_gates(eng, plan, faults, tokens, want),
                    **run}
        del eng
        torch.cuda.empty_cache()
    for key, names in (("single", SINGLE_KEY[:2]), ("tenants", MIXED_KEY[:2])):
        fired = {n: sum(c["launches"].get(n, 0)
                        for c in out[key]["containments"]) for n in names}
        if not all(fired.values()):
            raise AssertionError(f"{key}: containment launched {fired}")
        out[key]["containment_launches"] = fired
    out["recovery_f32"] = _recovery_f32(arch, cfg, params, prompts)
    out["obs_cost"] = _obs_cost(arch, cfg, params, prompts)
    return out


def _timed(fn) -> tuple:
    """``(fn(), wall ms)``, the wall clock around work that ends in a
    device sync."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _bit_equal(got, want) -> bool:
    import torch

    from repro_torch.core.layout import tree_flatten
    a, b = tree_flatten(got)[0], tree_flatten(want)[0]
    return len(a) == len(b) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(a, b))


def phase_weights(results: dict) -> dict:
    """The weights boundary at full width: ``SecureExecutor("seda")``
    (kernels: AES-CTR, otp_xor, NH), then ``seda512`` once."""
    import gc
    import statistics

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import vn
    from repro_torch.core.layout import tree_flatten
    from repro_torch.core.secure_exec import SecureExecutor
    from repro_torch.core.secure_memory import SecureKeys
    from repro_torch.kernels import LAUNCHES, reset_launches

    params = results["params"]
    n_leaves = len(tree_flatten(params)[0])
    keys = SecureKeys.derive(0, device="cuda")
    gc.collect()                           # earlier phases' cycles
    torch.cuda.empty_cache()
    mem_start = torch.cuda.memory_allocated() / 1e9
    peak = {}

    def read_peak(step: str) -> None:
        peak[step] = torch.cuda.max_memory_allocated() / 1e9
        torch.cuda.reset_peak_memory_stats()

    torch.cuda.reset_peak_memory_stats()
    ex = SecureExecutor("seda", keys=keys)
    spec = ex.region_spec(params)
    protect_ms, state, launches = [], None, None
    for i in range(3):
        state = None                       # free the last ciphertexts
        if i == 0:
            reset_launches()               # the weights path starts here
        state, ms = _timed(lambda: ex.protect(params, spec, step=1))
        if i == 0:
            launches = dict(LAUNCHES)      # ... and ends here
        protect_ms.append(ms)
    zero = [k for k in WEIGHTS_KEY if launches[k] <= 0]
    if zero:
        raise AssertionError(f"kernels never launched on the weights path: "
                             f"{zero}")
    want = {"aes_ctr_keystream": 2 * n_leaves, "otp_xor": n_leaves,
            "nh_hash_kernel_call": n_leaves}
    if any(launches[k] != v for k, v in want.items()):
        raise AssertionError(f"launches per protect {launches}, want {want}")
    read_peak("protect")
    unprotect_ms = []
    for i in range(3):
        (tree, ok), ms = _timed(lambda: ex.unprotect(state, spec))
        unprotect_ms.append(ms)
        if i == 0 and not (bool(ok) and _bit_equal(tree, params)):
            raise AssertionError(f"seda round trip: ok {bool(ok)}, "
                                 f"bit-equal {_bit_equal(tree, params)}")
        del tree
    profiles = {}
    for name, fn in (("protect", lambda: ex.protect(params, spec, step=1)),
                     ("unprotect", lambda: ex.unprotect(state, spec))):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            _, ms = _timed(fn)
        profiles[name] = _device_breakdown(prof, ms, 1, "call")
    # One flipped ciphertext byte in the middle of the largest leaf.
    big = max(range(n_leaves), key=lambda j: state.ciphertexts[j].numel())
    ct = state.ciphertexts[big]
    pos = ct.numel() // 2 + 5
    ct[pos] ^= 0x01
    tampered_ok = bool(ex.unprotect(state, spec)[1])
    ct[pos] ^= 0x01
    del ct
    stale_vn = vn.vn_for(vn.Role.WEIGHT, step=0)
    replay_ok = bool(ex.unprotect(state._replace(vn_lo=stale_vn), spec)[1])
    if tampered_ok or replay_ok:
        raise AssertionError(f"not detected: tamper ok {tampered_ok}, "
                             f"replay ok {replay_ok}")
    blocks = sum(c.numel() // 64 for c in state.ciphertexts)
    state = None
    torch.cuda.empty_cache()
    read_peak("unprotect")

    ex512 = SecureExecutor("seda512", keys=keys)
    spec512 = ex512.region_spec(params)
    reset_launches()
    state, ms512 = _timed(lambda: ex512.protect(params, spec512, step=1))
    launches512 = dict(LAUNCHES)
    (tree, ok), ums512 = _timed(lambda: ex512.unprotect(state, spec512))
    if not (bool(ok) and _bit_equal(tree, params)):
        raise AssertionError("seda512 round trip failed")
    if (launches512["nh_hash_kernel_call"] != n_leaves
            or launches512["otp_xor"] != 0):
        raise AssertionError(f"seda512 launches {launches512}")
    del tree, state
    torch.cuda.empty_cache()
    read_peak("seda512")
    results["weights_launches"] = launches
    return {
        "scheme": "seda", "leaves": n_leaves, "blocks_64": blocks,
        "bytes": sum(t.numel() * t.element_size()
                     for t in tree_flatten(params)[0]),
        "launches_per_protect": {k: launches[k] for k in WEIGHTS_KEY},
        "protect_ms": protect_ms,
        "protect_ms_median": statistics.median(protect_ms),
        "unprotect_ms": unprotect_ms,
        "unprotect_ms_median": statistics.median(unprotect_ms),
        "profile": profiles,
        "tamper_ok": tampered_ok, "replay_ok": replay_ok,
        "seda512": {"protect_ms": ms512, "unprotect_ms": ums512,
                    "launches_per_protect": {k: launches512[k]
                                             for k in WEIGHTS_KEY}},
        "mem_at_start_gb": mem_start, "peak_mem_gb": peak}


def phase_checkpoint(arch, cfg, results: dict) -> dict:
    """A secure checkpoint of minitron-4b at full width and 2 layers:
    save, find, load + verify, serve from it, reject a flipped byte."""
    import dataclasses
    import shutil
    import tempfile

    import torch

    from repro_torch.checkpoint.secure_ckpt import (CheckpointError,
                                                    latest_step,
                                                    load_checkpoint,
                                                    save_checkpoint)
    from repro_torch.core.secure_memory import SecureKeys
    from repro_torch.models import lm

    cfg2 = dataclasses.replace(cfg, n_layers=CKPT_LAYERS)
    params = _full_params(cfg2)
    keys = SecureKeys.derive(0, device="cuda")
    (ROOT / "build").mkdir(exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="ckpt_smoke_", dir=ROOT / "build")
    try:
        path, save_ms = _timed(lambda: save_checkpoint(tmp, 1, params, keys))
        written = sum(f.stat().st_size for f in Path(path).iterdir())
        if latest_step(tmp) != 1:
            raise AssertionError(f"latest_step {latest_step(tmp)} != 1")
        (restored, manifest), load_ms = _timed(
            lambda: load_checkpoint(path, lm.lm_specs(cfg2), keys))
        if not _bit_equal(restored, params):
            raise AssertionError("restored weights differ from the saved")
        tokens = {}
        for key, tree in (("restored", restored), ("original", params)):
            eng, tokens[key], _ = _serve_once(arch, cfg2, tree,
                                              results["prompts"], "seda",
                                              True)
            del eng
        if tokens["restored"] != tokens["original"]:
            raise AssertionError("tokens differ between the restored and "
                                 "the original weights")
        del restored
        leaf = Path(path, manifest["leaves"][-1]["file"])
        with open(leaf, "r+b") as f:
            f.seek(leaf.stat().st_size // 2)
            byte = f.read(1)
            f.seek(-1, 1)
            f.write(bytes([byte[0] ^ 0x01]))
        try:
            load_checkpoint(path, lm.lm_specs(cfg2), keys)
        except CheckpointError as e:
            rejected = str(e)
        else:
            raise AssertionError("a flipped leaf byte was not detected")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    return {"config": f"{cfg.name} x {CKPT_LAYERS} layers",
            "leaves": len(manifest["leaves"]),
            "block_bytes": manifest["block_bytes"],
            "bytes_written": written, "save_s": save_ms / 1e3,
            "load_s": load_ms / 1e3, "tokens_equal": True,
            "first_request_tokens": tokens["restored"][0],
            "tampered_leaf": leaf.name, "rejected": rejected}


# The shards phase: 2 logical shards on the one card, per shard 4 slots
# and 40 pages (the serve phase's 8 slots and 80 pages split), so the
# serve phase's 8 requests fit without a migration.
SHARDS = dict(shards=2, max_slots=4, n_pages=40)
# The migration traffic: two long decodes routed to shard 0, a short
# one to shard 1; 16 pages a shard hold one long decode's growth, not
# two, so shard 0's queued request starves it until shard 1 drains.
MIGRATION = dict(shards=2, max_slots=2, n_pages=16, new_tokens=(16, 2, 16))


def _cluster(arch, cfg, params, scheme, use_kernel, tenants: bool = False,
             prompts=None, new_tokens=None, **kw):
    """A cluster of the serve phase's engines (page_tokens 8, 10 pages a
    slot) with ``prompts`` submitted (``new_tokens`` each, default 16);
    with ``tenants``, over the tenants phase's registry, rotating one
    tenant every tick."""
    from repro_torch.serve.cluster import ClusterEngine
    registry = _tenant_registry("cuda") if tenants else None
    kw = {**SHARDS, **kw}
    cl = ClusterEngine(arch, cfg, params, scheme=scheme,
                       use_kernel=use_kernel,
                       page_tokens=SERVE["page_tokens"],
                       pages_per_slot=PAGES_PER_SLOT, registry=registry,
                       rotate_every=1 if tenants else 0, **kw)
    sessions = ([registry.open_session(f"tenant-{t}")
                 for t in range(N_TENANTS)] if tenants else [None])
    new_tokens = new_tokens or [SERVE["new_tokens"]] * len(prompts)
    rids = [cl.submit(prompt=p, max_new_tokens=n,
                      session=sessions[i % len(sessions)])
            for i, (p, n) in enumerate(zip(prompts, new_tokens))]
    return cl, rids


def _cluster_once(arch, cfg, params, prompts, scheme, use_kernel,
                  tenants: bool = False, **kw):
    """One cluster run, its launches counted from 0 (the main path)."""
    import torch

    from repro_torch.kernels import LAUNCHES, reset_launches
    cl, rids = _cluster(arch, cfg, params, scheme, use_kernel, tenants,
                        prompts=prompts, **kw)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    done = cl.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    tokens = [done[r].generated for r in rids]
    return cl, tokens, {
        "wall_s": wall, "ticks": cl.tick, "launches": launches,
        "deferred_root_ok": cl.deferred_check(), "stats": dict(cl.stats),
        "engine_stats": cl.engine_stats,
        "per_shard": {k: [e.stats[k] for e in cl.engines]
                      for k in ("admitted", "decode_steps", "reseals",
                                "rotations")},
        "tok_per_s": sum(len(t) for t in tokens) / wall}


def _pool_bytes(eng) -> list:
    """An engine's pool (cts, page MACs, VNs, pool MAC) on the host."""
    return [t.cpu() for t in (*eng.pool.cts, eng.pool.page_macs,
                              eng.pool.page_vns, eng.pool.pool_mac)]


def _pools(cl) -> list:
    """Both shards' pools on the host."""
    return [_pool_bytes(e) for e in cl.engines]


def _same_pools(a: list, b: list) -> bool:
    import torch
    return all(torch.equal(x, y) for sa, sb in zip(a, b)
               for x, y in zip(sa, sb))


def _shards_in_turns(arch, cfg, params, prompts) -> tuple:
    """seda with kernels, seda plain and ``off`` in turns (A B C C B A):
    identical tokens; both shards' pools byte-equal with the kernels on
    and off; B1-B3 launched on the first kernel run (the main path)."""
    import torch
    order = [("seda_kernel", "seda", True), ("seda_plain", "seda", False),
             ("off", "off", False)]
    runs: dict = {key: [] for key, _, _ in order}
    tokens: dict = {}
    pools: dict = {}
    for key, scheme, use_kernel in order + order[::-1]:
        cl, toks, run = _cluster_once(arch, cfg, params, prompts, scheme,
                                      use_kernel)
        if tokens.setdefault(key, toks) != toks:
            raise AssertionError(f"{key}: tokens differ between two runs")
        if scheme == "seda":
            got = _pools(cl)
            if not _same_pools(pools.setdefault(key, got), got):
                raise AssertionError(f"{key}: pools differ between runs")
        if not run["deferred_root_ok"]:
            raise AssertionError(f"{key}: cluster root MAC failed")
        runs[key].append(run)
        del cl
        torch.cuda.empty_cache()
    if not (tokens["seda_kernel"] == tokens["seda_plain"] == tokens["off"]):
        raise AssertionError("cluster tokens differ between seda+kernels, "
                             "seda plain and off")
    if not _same_pools(pools["seda_kernel"], pools["seda_plain"]):
        raise AssertionError("shard pools differ with kernels on and off")
    main = runs["seda_kernel"][0]
    zero = [k for k in SINGLE_KEY if main["launches"][k] <= 0]
    if zero:
        raise AssertionError(f"kernels never launched on the cluster "
                             f"path: {zero}")
    if min(main["per_shard"]["decode_steps"]) <= 0:
        raise AssertionError(f"a shard never decoded: {main['per_shard']}")
    return tokens["seda_kernel"], {
        "main_path": {k: main[k] for k in ("launches", "stats",
                                           "engine_stats", "per_shard",
                                           "ticks")},
        "wall_s": {k: [r["wall_s"] for r in v] for k, v in runs.items()},
        "tok_per_s": {k: [r["tok_per_s"] for r in v]
                      for k, v in runs.items()},
        "tick_ms": {k: [r["wall_s"] * 1e3 / r["ticks"] for r in v]
                    for k, v in runs.items()}}


def _timed_migrations(cl) -> list:
    """Wrap ``cl._migrate_slot``: host ms of each migration (the card
    synced before and after) and the launches it made (the counts' delta,
    so the run's own counts stay whole)."""
    import torch

    from repro_torch.kernels import LAUNCHES
    out: list = []
    inner = cl._migrate_slot

    def wrapper(src, slot_idx, dst):
        torch.cuda.synchronize()
        before = dict(LAUNCHES)
        t0 = time.perf_counter()
        inner(src, slot_idx, dst)
        torch.cuda.synchronize()
        out.append({"from_shard": src, "to_shard": dst, "tick": cl.tick,
                    "host_ms": (time.perf_counter() - t0) * 1e3,
                    "launches": {k: v - before.get(k, 0)
                                 for k, v in LAUNCHES.items()
                                 if v - before.get(k, 0)}})

    cl._migrate_slot = wrapper
    return out


def _single_tokens(arch, cfg, params, prompts, new_tokens) -> list:
    """The single engine (one slot a request) on the same requests."""
    import torch

    from repro_torch.serve.engine import SecureServingEngine
    eng = SecureServingEngine(arch, cfg, params, scheme="seda",
                              use_kernel=True, max_slots=len(prompts),
                              page_tokens=SERVE["page_tokens"],
                              pages_per_slot=PAGES_PER_SLOT)
    rids = [eng.submit(prompt=p, max_new_tokens=n)
            for p, n in zip(prompts, new_tokens)]
    done = eng.run()
    tokens = [done[r].generated for r in rids]
    del eng
    torch.cuda.empty_cache()
    return tokens


def _shards_f32(arch, cfg, params, prompts) -> dict:
    """Float32 at full width: the cluster's tokens equal the single
    engine's on the serve requests; the migration traffic migrates with
    no preemption and the single engine's tokens, every migration proof
    verifying; ``shard_kill`` on shard 1 at tick 3 fails over with no
    session lost and the fault-free tokens."""
    import dataclasses

    import torch

    from repro_torch.models.layers import tree_map
    from repro_torch.serve import merkle_pool as mkp
    from repro_torch.serve.faults import Fault, FaultPlan
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params32 = tree_map(lambda t: t.float(), params)
    n = [SERVE["new_tokens"]] * len(prompts)
    single = _single_tokens(arch, cfg32, params32, prompts, n)
    cl, tokens, run = _cluster_once(arch, cfg32, params32, prompts, "seda",
                                    True)
    del cl
    if tokens != single:
        raise AssertionError(f"float32 cluster tokens differ from the "
                             f"single engine's: agreement "
                             f"{_agreement(tokens, single)}")
    out = {"cluster_equals_single_engine": True, "ticks": run["ticks"]}

    # Migration.
    reqs = prompts[:3]
    mig_new = list(MIGRATION["new_tokens"])
    want = _single_tokens(arch, cfg32, params32, reqs, mig_new)
    kw = {k: v for k, v in MIGRATION.items() if k != "new_tokens"}
    cl, rids = _cluster(arch, cfg32, params32, "seda", True, prompts=reqs,
                        new_tokens=mig_new, **kw)
    moves = _timed_migrations(cl)
    done = cl.run()
    got = [done[r].generated for r in rids]
    stats = cl.engine_stats
    if cl.stats["migrations"] < 1 or stats["preemptions"] or \
            stats["admitted"] != len(reqs):
        raise AssertionError(f"migration run: {dict(cl.stats)}, "
                             f"preemptions {stats['preemptions']}, "
                             f"admitted {stats['admitted']}")
    if got != want:
        raise AssertionError(f"float32 migration tokens differ from the "
                             f"single engine's: {_agreement(got, want)}")
    for entry in cl.migration_proofs:
        proof = mkp.proof_from_dict(entry["proof"])
        if proof.shard != entry["to_shard"] or not mkp.verify_proof(proof):
            raise AssertionError(f"migration proof {entry['rid']} failed")
    if len(cl.migration_proofs) != cl.stats["migrations"] or \
            not cl.deferred_check():
        raise AssertionError("migration proofs or the root MAC failed")
    out["migration"] = {"migrations": cl.stats["migrations"],
                        "preemptions": stats["preemptions"],
                        "admitted": stats["admitted"],
                        "proofs_verified": len(cl.migration_proofs),
                        "each": moves, "tokens_equal_single_engine": True}
    del cl

    # Failover.
    cl, rids = _cluster(arch, cfg32, params32, "seda", True,
                        prompts=prompts, fault_tolerance=True)
    plan = FaultPlan([Fault(tick=3, kind="shard_kill", shard=1)])
    plan.attach_cluster(cl)
    failovers: list = []
    inner = cl._failover

    def timed_failover(shard, err=None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        inner(shard, err)
        torch.cuda.synchronize()
        failovers.append({"shard": shard, "tick": cl.tick,
                          "host_ms": (time.perf_counter() - t0) * 1e3})

    cl._failover = timed_failover
    done = cl.run()
    got = [done[r].generated for r in rids if r in done]
    stats = cl.engine_stats
    if cl.stats["shard_failovers"] != 1 or stats["sessions_lost"] or \
            cl.failed_shards != {1} or cl.sharded._active != [0]:
        raise AssertionError(f"failover: {dict(cl.stats)}, lost "
                             f"{stats['sessions_lost']}, failed "
                             f"{cl.failed_shards}, active "
                             f"{cl.sharded._active}")
    if got != tokens:
        raise AssertionError(f"float32 failover tokens differ from the "
                             f"fault-free run's: {_agreement(got, tokens)}")
    if not cl.deferred_check():
        raise AssertionError("root MAC failed after the failover")
    out["failover"] = {"shard_failovers": cl.stats["shard_failovers"],
                       "rerouted": cl.stats["rerouted_preemptions"],
                       "sessions_recovered": stats["sessions_recovered"],
                       "sessions_lost": stats["sessions_lost"],
                       "each": failovers, "tokens_equal_fault_free": True}
    del cl, params32
    torch.cuda.empty_cache()
    return out


def _shards_tenants(arch, cfg, params, prompts) -> dict:
    """The tenants phase's 4 tenants, a rotation every tick, across the
    2 shards: kernels and plain (in turns) give equal tokens, B4-B6
    launch, reseals fire on both shards."""
    import torch
    order = [("kernel", True), ("plain", False)]
    runs: dict = {key: [] for key, _ in order}
    tokens: dict = {}
    for key, use_kernel in order + order[::-1]:
        cl, toks, run = _cluster_once(arch, cfg, params, prompts, "seda",
                                      use_kernel, tenants=True)
        if tokens.setdefault(key, toks) != toks:
            raise AssertionError(f"{key}: tokens differ between two runs")
        if not run["deferred_root_ok"]:
            raise AssertionError(f"{key}: cluster root MAC failed")
        runs[key].append(run)
        del cl
        torch.cuda.empty_cache()
    if tokens["kernel"] != tokens["plain"]:
        raise AssertionError("tenant cluster tokens differ with kernels on "
                             "and off")
    main = runs["kernel"][0]
    zero = [k for k in MIXED_KEY if main["launches"][k] <= 0]
    if zero:
        raise AssertionError(f"mixed-key kernels never launched: {zero}")
    if min(main["per_shard"]["reseals"]) <= 0:
        raise AssertionError(f"reseals per shard {main['per_shard']}")
    return {"main_path": {k: main[k] for k in ("launches", "stats",
                                               "per_shard", "ticks")},
            "wall_s": {k: [r["wall_s"] for r in v]
                       for k, v in runs.items()}}


def _shards_tamper(arch, cfg, params, prompts) -> dict:
    """Shard 0's page (ct, MAC, VN) copied verbatim into shard 1's pool
    fails the next ``step()``; a pool swapped into shard 0 around the
    listeners, its XOR identity patched, fails ``deferred_check()``, and
    still does after one more tick."""
    import torch

    from repro_torch.serve.engine import IntegrityError
    out = {}
    cl, _ = _cluster(arch, cfg, params, "seda", True, prompts=prompts[:2],
                     max_slots=1)
    cl.step()
    e0, e1 = cl.engines
    p0, p1 = e0.slots[0].pages[0], e1.slots[0].pages[0]
    for c0, c1 in zip(e0.pool.cts, e1.pool.cts):
        c1[p1] = c0[p0]
    e1.pool.page_macs[p1] = e0.pool.page_macs[p0]
    e1.pool.page_vns[p1] = e0.pool.page_vns[p0]
    try:
        cl.step()
    except IntegrityError as e:
        out["cross_shard_replay"] = {"raised": type(e).__name__,
                                     "message": str(e)}
    else:
        raise AssertionError("a page replayed across shards was accepted")
    del cl
    cl, _ = _cluster(arch, cfg, params, "seda", True, prompts=prompts[:4])
    cl.step()
    verdicts = [cl.deferred_check()]
    eng = cl.engines[0]
    victim = eng.free_pages[0]
    macs = eng.pool.page_macs.clone()
    macs[victim] ^= 0x5A
    pool_mac = eng.pool.pool_mac ^ 0x5A
    eng._pool = eng.pool._replace(page_macs=macs, pool_mac=pool_mac)
    verdicts.append(cl.deferred_check())
    cl.step()
    verdicts.append(cl.deferred_check())
    if verdicts != [True, False, False] or \
            cl.sharded.failing_shards() != [0]:
        raise AssertionError(f"listener-bypassing swap: verdicts "
                             f"{verdicts}, failing "
                             f"{cl.sharded.failing_shards()}")
    out["listener_bypassing_swap"] = {"verdicts": verdicts,
                                      "failing_shards": [0]}
    del cl
    torch.cuda.empty_cache()
    return out


def _profile_cluster(arch, cfg, params, prompts, n_ticks: int = 3) -> dict:
    """Device busy time, idle share and launches per cluster tick over
    ``n_ticks`` steady ticks (all 8 requests running, 4 a shard), from a
    CUPTI trace, as the profile phase takes the single engine's; then the
    cluster's device-cost rollup (``ClusterEngine.profile()``), after
    which both shards' pools and the cluster root MAC must be as they
    were and the deferred root check must hold."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    cl, _ = _cluster(arch, cfg, params, "seda", True, prompts=prompts)
    for _ in range(2):                     # admission + one warm tick
        cl.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_ticks):
        cl.step()
    torch.cuda.synchronize()
    plain_wall = (time.perf_counter() - t0) / n_ticks
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_ticks):
            cl.step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / n_ticks
    pools, root = _pools(cl), cl.sharded.root_mac
    rollup = cl.profile()["rollup"]
    if not (_same_pools(pools, _pools(cl))
            and torch.equal(root, cl.sharded.root_mac)
            and cl.deferred_check()):
        raise AssertionError("the cluster profile moved a pool or the root "
                             "MAC, or the deferred root check failed")
    del cl
    torch.cuda.empty_cache()
    return {"tick_ms": plain_wall * 1e3,
            **_device_breakdown(prof, wall * 1e3, n_ticks, "tick"),
            "cost_rollup": rollup}


def phase_shards(arch, cfg, results: dict) -> dict:
    """Sharded serving at full width: 2 logical shards on the card."""
    params, prompts = results["params"], results["prompts"]
    tokens, out = _shards_in_turns(arch, cfg, params, prompts)
    out["agree_bf16_single_engine"] = _agreement(tokens,
                                                 results["serve_tokens"])
    out["f32"] = _shards_f32(arch, cfg, params, prompts)
    out["tenants"] = _shards_tenants(arch, cfg, params, prompts)
    out["tamper"] = _shards_tamper(arch, cfg, params, prompts)
    out["profile"] = {"cluster_seda_kernel": _profile_cluster(
        arch, cfg, params, prompts),
        "single_engine_seda_kernel": results.get("profile_seda")}
    return {"config": {**SHARDS, "page_tokens": SERVE["page_tokens"],
                       "pages_per_slot": PAGES_PER_SLOT,
                       "migration": MIGRATION}, **out}


def _launch_with_files(launch, argv: list) -> tuple:
    """``launch.main(argv + file options)``; returns the run's result
    and its proof bundle, trace, metrics snapshot, Prometheus text and
    audit log, each read back from its file."""
    import shutil
    import tempfile

    from repro_torch.obs.audit import AuditLog
    (ROOT / "build").mkdir(exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="launch_smoke_", dir=ROOT / "build")
    files = {name: str(Path(tmp, name)) for name in (
        "proofs.json", "trace.json", "metrics.json", "metrics.prom",
        "audit.jsonl")}
    try:
        out = launch.main(argv + [
            "--audit-proof-out", files["proofs.json"],
            "--trace-out", files["trace.json"],
            "--metrics-json", files["metrics.json"],
            "--metrics-prom", files["metrics.prom"],
            "--audit-out", files["audit.jsonl"]])
        return (out, json.loads(Path(files["proofs.json"]).read_text()),
                json.loads(Path(files["trace.json"]).read_text()),
                json.loads(Path(files["metrics.json"]).read_text()),
                Path(files["metrics.prom"]).read_text(),
                AuditLog.load(files["audit.jsonl"]))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _launch_summary(argv, out, bundle, trace, prom, log) -> dict:
    return {"argv": argv, "tokens_shape": tuple(out["tokens"].shape),
            "tok_per_s": out["tok_per_s"], "stats": out["stats"],
            "latency": out["latency"],
            "obs_files": {"trace_events": len(trace["traceEvents"]),
                          "audit_records": len(log),
                          "audit_events": sorted({r["event"]
                                                  for r in log.records()}),
                          "prometheus_lines": len(prom.splitlines())},
            "audit_proofs": {"verified": len(bundle["proofs"]),
                             "tick": bundle["tick"],
                             "pages": [len(d["pages"])
                                       for d in bundle["proofs"]]}}


def _check_launch_tokens(out) -> None:
    shape = tuple(out["tokens"].shape)
    if shape != (SERVE["n_requests"], SERVE["new_tokens"]):
        raise AssertionError(f"launcher served tokens of shape {shape}")
    if out["stats"]["fused_mixed_ticks"] <= 0 or not out["deferred_mac_ok"]:
        raise AssertionError(f"launcher run: {out['stats']}, deferred MAC "
                             f"{out['deferred_mac_ok']}")


def phase_launch(results: dict) -> dict:
    import gc

    import torch

    from repro_torch.launch import serve as launch
    from repro_torch.serve import merkle_pool as mkp
    results.pop("params", None)            # free the earlier model
    gc.collect()
    torch.cuda.empty_cache()
    shape_args = ["--arch", "minitron-4b",
                  "--batch", str(SERVE["n_requests"]),
                  "--prompt-len", str(SERVE["prompt_len"]),
                  "--gen-len", str(SERVE["new_tokens"])]
    argv = shape_args + [
        "--engine", "paged", "--scheme", "seda",
        "--tenants", str(N_TENANTS), "--rotate-every", "1",
        "--fault-tolerance"]
    out, bundle, trace, snap, prom, log = _launch_with_files(launch, argv)
    if snap["counters"] != out["stats"]:
        raise AssertionError("the metrics snapshot's counters differ from "
                             "the run's")
    if not (log.verify_chain()
            and len(log) == out["stats"]["audit_events"] > 0):
        raise AssertionError(f"audit log: {len(log)} records, chain "
                             f"{log.verify_chain()}")
    phases = {e["name"] for e in trace["traceEvents"]}
    if not {"tick", "decode_dispatch", "decode_collect"} <= phases:
        raise AssertionError(f"trace spans {sorted(phases)}")
    if "# TYPE repro_decode_steps counter" not in prom:
        raise AssertionError("no Prometheus text")
    _check_launch_tokens(out)
    # Each tenant's proof (taken after the first tick) verifies against
    # the root it was issued under; the final root is a digest.
    tenants = sorted(d["tenant"] for d in bundle["proofs"])
    if tenants != list(range(N_TENANTS)):
        raise AssertionError(f"proof bundle covers tenants {tenants}")
    for d in bundle["proofs"]:
        if not d["pages"]:
            raise AssertionError(f"tenant {d['tenant']}'s proof is empty")
        mkp.verify_proof(mkp.proof_from_dict(d), expected_root=d["root"],
                         tenant=d["tenant"])
    if len(bytes.fromhex(bundle["final"]["root"])) != mkp.HASH_BYTES:
        raise AssertionError("the bundle's final root is not a digest")
    single = _launch_summary(argv, out, bundle, trace, prom, log)
    single["audit_proofs"]["final_root"] = bundle["final"]["root"]

    # The same run through the cluster: 2 logical shards on the card.
    argv = argv + ["--shards", "2"]
    out, bundle, trace, snap, prom, log = _launch_with_files(launch, argv)
    # The cluster's snapshot: its own counters, each shard's, the sum.
    merged = dict(snap["rollup"], **snap["counters"])
    if merged != out["stats"] or [s["labels"] for s in snap["shards"]] != \
            [{"shard": "0"}, {"shard": "1"}]:
        raise AssertionError("the cluster's metrics snapshot differs from "
                             "the run's")
    # One chained log: the shards' events (counted by the shards) and the
    # cluster's own (shard -1).
    cluster_events = sum(1 for r in log.records() if r["shard"] == -1)
    if not (log.verify_chain() and len(log) ==
            out["stats"]["audit_events"] + cluster_events > 0):
        raise AssertionError(f"cluster audit log: {len(log)} records, "
                             f"chain {log.verify_chain()}")
    # The cluster drives each shard's phases itself, so its tick span is
    # cluster_tick (the shards' own step, and its tick span, never run).
    phases = {e["name"] for e in trace["traceEvents"]}
    if not {"cluster_tick", "tick_begin", "decode_dispatch",
            "decode_collect", "tick_end"} <= phases:
        raise AssertionError(f"cluster trace spans {sorted(phases)}")
    if 'repro_decode_steps{shard="1"}' not in prom:
        raise AssertionError("no per-shard Prometheus text")
    _check_launch_tokens(out)
    # Each tenant's proofs (taken after the first tick, one per shard
    # holding its frames) verify against the shard roots they were
    # issued under, chained to the cluster root; the final cluster root
    # compresses the final shard roots.
    tenants = sorted({d["tenant"] for d in bundle["proofs"]})
    if tenants != list(range(N_TENANTS)):
        raise AssertionError(f"cluster proof bundle covers tenants "
                             f"{tenants}")
    for d in bundle["proofs"]:
        if not d["pages"] or d["cluster"] is None:
            raise AssertionError(f"tenant {d['tenant']}'s proof is empty "
                                 "or not chained to the cluster root")
        mkp.verify_proof(mkp.proof_from_dict(d), expected_root=d["root"],
                         tenant=d["tenant"])
    final = bundle["final"]
    pairs = [(s, bytes.fromhex(r)) for s, r in final["shard_roots"]]
    if [s for s, _ in pairs] != [0, 1] or \
            mkp.compress_roots(pairs).hex() != final["cluster_root"]:
        raise AssertionError("the bundle's final cluster root does not "
                             "compress its shard roots")
    cluster = _launch_summary(argv, out, bundle, trace, prom, log)
    cluster["audit_proofs"]["final_cluster_root"] = final["cluster_root"]

    # The dense loop and the paged off engine on the same prompts.
    simple = launch.main(shape_args + ["--engine", "simple"])
    paged_off = launch.main(shape_args + ["--engine", "paged",
                                          "--scheme", "off"])
    if simple["tokens"].tolist() != paged_off["tokens"].tolist():
        raise AssertionError(
            f"--engine simple tokens differ from paged off: agreement "
            f"{_agreement(simple['tokens'].tolist(), paged_off['tokens'].tolist())}")
    return {**single, "cluster": cluster,
            "simple": {"tok_per_s": simple["tok_per_s"],
                       "tokens_equal_paged_off": True,
                       "first_request_tokens": simple["tokens"][0].tolist()}}


# The archs phase: the attention-family configs at full width, in the
# order they are served (the largest, granite, after the MoE one).
ARCH_NAMES = ("minitron-8b", "olmoe-1b-7b", "granite-34b", "deepseek-v3-671b")
DEEPSEEK_LAYERS = 4        # of 61: the 3 dense layers and 1 MoE layer
# The attn mixer's wq and wk are drawn at this multiple of their fan-in
# scale.  At fan-in scale each head's softmax averages most of the
# window, and granite's 88 GELU + MQA layers then give every position of
# a request the same hidden state: greedy decoding repeats one token per
# request, whatever the decrypted pages hold.  Near-hard attention makes
# each head pick positions, so the tokens depend on the KV pages.
ATTN_QK_SCALE = 8.0
# A cell fails when its greedy tokens hold fewer distinct ids than this
# share of the tokens generated: the tokens would not depend on the KV.
MIN_DISTINCT_SHARE = 0.5
MOE_SPANS = ("_route", "_dispatch", "_experts", "_combine")
# The ssm phase: jamba cut in depth to three of its four 8-layer periods
# (76.9 GB of bf16 weights; four need 102.4 GB).
JAMBA_LAYERS = 24
MAMBA_SPANS = ("_in_proj", "_conv_step", "_ssm_step", "_out_proj")
# The reference's refusal of an arch with no paged cache leaf.
NO_PAGED_LEAVES = ("cache tree has no paged (KV/latent) leaves — the paged "
                   "engine needs at least one attention or MLA layer")


def _arch_config(name: str) -> tuple:
    """(arch, full-width config, the depth cut or None)."""
    import dataclasses

    from repro_torch.configs import get_arch
    arch = get_arch(name)
    cfg = arch.make_config()
    cut = None
    if name == "deepseek-v3-671b":
        cut = (f"n_layers {cfg.n_layers} -> {DEEPSEEK_LAYERS} (3 dense + 1 "
               "MoE, moe_start_layer 3, full width): 61 layers need ~1.3 TB")
        cfg = dataclasses.replace(cfg, n_layers=DEEPSEEK_LAYERS)
    if name == "jamba-v0.1-52b":
        cut = (f"n_layers {cfg.n_layers} -> {JAMBA_LAYERS}, three 8-layer "
               "periods, full width: 32 layers need 102.4 GB of weights, "
               "24 need 76.9 GB")
        cfg = dataclasses.replace(cfg, n_layers=JAMBA_LAYERS)
    return arch, cfg, cut


def _arch_params(cfg, seed: int = 0, specs=None):
    """Random full-width weights from a seed, drawn on the card straight
    in each leaf's dtype (no float32 temporary: granite's stacked
    ``w_up`` alone holds 13.3 G elements), at one layer's fan-in as
    :func:`_full_params` rescales to, and at one expert's for the routed
    experts' stacked (E, d, f) leaves; the attn mixer's wq and wk at
    ``ATTN_QK_SCALE`` times that.  ``specs`` defaults to the LM's; an
    encoder-decoder's stacks are ``encoder`` and ``decoder``."""
    import math

    import torch

    from repro_torch.models import lm
    from repro_torch.models.layers import DTYPES, ParamSpec
    gen = torch.Generator("cuda").manual_seed(seed)

    def draw(s, path):
        t = torch.empty(s.shape, dtype=DTYPES[s.dtype], device="cuda")
        if s.init == "ones":
            return t.fill_(1)
        if s.init == "zeros":
            return t.zero_()
        if s.init == "embed":
            return t.normal_(0.0, 0.02, generator=gen)
        # The stacked layer axis, and the expert axis of routed experts.
        skip = int(path[0] in ("segments", "encoder", "decoder"))
        skip += int(len(path) > 1 and path[-2] == "moe"
                    and path[-1] in ("w_gate", "w_up", "w_down"))
        fan_in = math.prod(s.shape[skip:-1])
        std = 1.0 / math.sqrt(max(1, fan_in))
        if path[-2:] in (("attn", "wq"), ("attn", "wk")):
            std *= ATTN_QK_SCALE
        return t.normal_(0.0, std, generator=gen)

    def walk(node, path):
        if isinstance(node, ParamSpec):
            return draw(node, path)
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        return [walk(v, path + (i,)) for i, v in enumerate(node)]

    return walk(lm.lm_specs(cfg) if specs is None else specs, ())


def _state_bytes(cfg, batch: int, max_len: int) -> int:
    """Bytes of recurrent (never paged) state a decode tick reads once
    and writes once: each Mamba layer's SSM state and conv window."""
    import math

    from repro_torch.models import lm
    from repro_torch.models.layers import DTYPES
    from repro_torch.serve import kv_pages as kvp
    tree = lm.cache_specs(cfg, batch, max_len)
    flags = zip(kvp.cache_leaves(tree), kvp.paged_flags(tree),
                kvp.length_flags(tree))
    return 2 * sum(math.prod(leaf.shape) * DTYPES[leaf.dtype].itemsize
                   for leaf, paged, length in flags
                   if not paged and not length)


def _weight_read_bytes(cfg, params) -> int:
    """Bytes of weights one decode tick reads: every leaf (the reference
    runs every expert over its (E, C, d) buffer), less an untied
    embedding, of which a tick gathers only its rows."""
    total = sum(t.numel() * t.element_size() for t in _leaves(params))
    if not cfg.tie_embeddings:
        total -= params["embed"].numel() * params["embed"].element_size()
    return total


class _Spans:
    """While open, each named stage function of a model module runs
    inside a profiler range ``<module>.<stage>`` (the stages are module
    functions, patched here and restored on exit)."""

    def __init__(self, module, names):
        self.module, self.names = module, names

    def __enter__(self):
        from torch.profiler import record_function
        self.saved = {n: getattr(self.module, n) for n in self.names}
        tag = self.module.__name__.rsplit(".", 1)[-1]

        def wrap(name, fn):
            def inner(*args, **kwargs):
                with record_function(f"{tag}.{name}"):
                    return fn(*args, **kwargs)
            return inner

        for name, fn in self.saved.items():
            setattr(self.module, name, wrap(name, fn))
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.module, name, fn)
        return False


def _stage_ms(step, cfg, n_ticks: int) -> dict:
    """Each annotated stage's device ms per tick over ``n_ticks`` calls
    of ``step``: MoE's (router, dispatch = argsort + rank + gather +
    scatter, the expert GEMMs, combine = gather + un-sort + gate sum) and
    the Mamba decode's (projection, conv window, SSM step, output
    projection), for the configs that have them."""
    import contextlib

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import lm, mamba2, moe
    kinds = set(lm.layout(cfg))
    stages = {}
    if any(k.ffn == "moe" for k in kinds):
        stages["moe"] = (moe, MOE_SPANS)
    if any(k.mixer == "mamba" for k in kinds):
        stages["mamba2"] = (mamba2, MAMBA_SPANS)
    if not stages:
        return {}
    with contextlib.ExitStack() as stack:
        for module, names in stages.values():
            stack.enter_context(_Spans(module, names))
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n_ticks):
                step()
            torch.cuda.synchronize()
    out = {}
    for tag, (_, names) in stages.items():
        spans = {name: 0.0 for name in names}
        for e in prof.events():
            key = e.name[len(tag) + 1:]
            if e.name.startswith(f"{tag}.") and key in spans and \
                    e.device_type == DeviceType.CPU:
                spans[key] += e.device_time_total / 1e3 / n_ticks
        out[f"{tag}_ms_per_tick"] = spans
    if "moe" in stages:
        moe_ms = out["moe_ms_per_tick"]
        out["moe_dispatch_ms_per_tick"] = (moe_ms["_dispatch"]
                                           + moe_ms["_combine"])
    return out


def _arch_smoke_f32(name: str) -> dict:
    """The smoke config (float32) served under seda with the kernels
    gives the plain loop's tokens.  An MoE row competes for expert
    capacity with the other rows of its tick, so MoE configs take one
    slot, which the plain loop's batch of one matches."""
    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.models import lm
    from repro_torch.models.layers import init_params
    from repro_torch.serve.engine import SecureServingEngine
    arch = get_arch(name)
    cfg = arch.make_smoke_config()
    params = init_params(lm.lm_specs(cfg),
                         torch.Generator("cuda").manual_seed(0),
                         device="cuda")
    rng = np.random.default_rng(0)
    prompts = [list(map(int, rng.integers(1, cfg.vocab, n)))
               for n in (5, 7, 9)]
    slots = 1 if cfg.ffn == "moe" else 2
    eng = SecureServingEngine(arch, cfg, params, scheme="seda",
                              use_kernel=True, max_slots=slots,
                              page_tokens=4, pages_per_slot=4)
    rids = [eng.submit(prompt=p, max_new_tokens=6) for p in prompts]
    done = eng.run()
    got = [done[r].generated for r in rids]
    with torch.no_grad():
        want = [_dense_tokens(cfg, params, p, 6, 16, bucketed=True)
                for p in prompts]
    if got != want:
        raise AssertionError(f"{cfg.name}: engine tokens {got} != plain "
                             f"loop {want}")
    return {"config": cfg.name, "max_slots": slots, "tokens": got}


def _arch_tenants(arch, cfg, params, prompts, want) -> dict:
    """The cell's requests over 4 tenants, one rotation every tick: the
    single-tenant tokens, every tick mixed-key."""
    _, tokens, run = _serve_once(arch, cfg, params, prompts, "seda", True,
                                 tenants=True)
    stats = run["stats"]
    zero = [k for k in MIXED_KEY if run["launches"][k] <= 0]
    if zero:
        raise AssertionError(f"mixed-key kernels never launched: {zero}")
    if tokens != want:
        raise AssertionError("4-tenant tokens differ from the single-tenant "
                             f"run: agreement {_agreement(tokens, want)}")
    if stats["fused_mixed_ticks"] != stats["decode_steps"] or \
            stats["rotations"] <= 0 or stats["reseals"] <= 0 or \
            not run["deferred_mac_ok"]:
        raise AssertionError(f"tenants run: {stats}")
    return {"launches": {k: run["launches"][k] for k in MIXED_KEY},
            "tok_per_s": run["tok_per_s"],
            "stats": {k: stats[k] for k in ("decode_steps", "rotations",
                                            "reseals", "fused_mixed_ticks")}}


def _arch_cell(name: str) -> dict:
    """One config at full width: seda with and without the kernels and
    ``off`` once each, the pools byte-equal, B1-B3 launching, the
    deferred MAC, a traced tick; deepseek and jamba also tampered and
    tenanted."""
    import gc

    import numpy as np
    import torch
    arch, cfg, cut = _arch_config(name)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = _arch_params(cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weight_bytes = _weight_read_bytes(cfg, params)
    rng = np.random.default_rng(1)
    prompts = [list(map(int, rng.integers(1, cfg.vocab, SERVE["prompt_len"])))
               for _ in range(SERVE["n_requests"])]
    with torch.no_grad():
        logits, _ = _prefill_logits(cfg, params, prompts[0])
    if logits.shape != (1, 1, cfg.vocab) or not torch.isfinite(
            logits.float()).all():
        raise AssertionError(f"{name}: prefill logits not finite or "
                             "misshapen")
    del logits
    runs, tokens, pools = {}, {}, {}
    for key, scheme, use_kernel in (("seda_kernel", "seda", True),
                                    ("seda_plain", "seda", False),
                                    ("off", "off", False)):
        eng, tokens[key], runs[key] = _serve_once(arch, cfg, params, prompts,
                                                  scheme, use_kernel)
        if scheme == "seda":
            pools[key] = _pool_bytes(eng)
        del eng
        torch.cuda.empty_cache()
    main = runs["seda_kernel"]
    zero = [k for k in SINGLE_KEY if main["launches"][k] <= 0]
    if zero:
        raise AssertionError(f"{name}: kernels never launched: {zero}")
    if not (tokens["seda_kernel"] == tokens["seda_plain"] == tokens["off"]):
        raise AssertionError(f"{name}: tokens differ between seda+kernels, "
                             "seda plain and off")
    if not _same_pools([pools["seda_kernel"]], [pools["seda_plain"]]):
        raise AssertionError(f"{name}: pools differ with the kernels on "
                             "and off")
    if not all(r["deferred_mac_ok"] for r in runs.values()):
        raise AssertionError(f"{name}: deferred pool MAC failed")
    flat = [t for seq in tokens["seda_kernel"] for t in seq]
    if (any(len(t) != SERVE["new_tokens"] for t in tokens["seda_kernel"])
            or not all(0 <= t < cfg.vocab for t in flat)):
        raise AssertionError(f"{name}: wrong token counts or ids")
    if len(set(flat)) < MIN_DISTINCT_SHARE * len(flat):
        raise AssertionError(f"{name}: {len(set(flat))} distinct tokens of "
                             f"{len(flat)}: the tokens do not depend on the "
                             "KV pages")
    del pools
    profile = _profile_ticks(arch, cfg, params, prompts, "seda", True)[0]
    state_bytes = _state_bytes(cfg, SERVE["n_requests"],
                               PAGES_PER_SLOT * SERVE["page_tokens"])
    bound_ms = (weight_bytes + state_bytes) / HBM_BYTES_PER_S * 1e3
    out = {"config": cfg.name, "cut": cut, "n_layers": cfg.n_layers,
           "d_model": cfg.d_model, "init_s": init_s,
           "weight_read_gb": weight_bytes / 1e9,
           "state_read_write_gb": state_bytes / 1e9,
           "read_bound_ms": bound_ms,
           "distinct_tokens": len(set(flat)),
           "first_request_tokens": tokens["seda_kernel"][0],
           "launches": {k: main["launches"][k] for k in SINGLE_KEY},
           "stats": {k: main["stats"][k] for k in (
               "admitted", "decode_steps", "fused_write_ticks",
               "uniform_fast_ticks", "decode_page_reads")},
           "tok_per_s": {k: r["tok_per_s"] for k, r in runs.items()},
           "host_ms_per_tick": {k: r["wall_s"] / max(1, r["ticks"]) * 1e3
                                for k, r in runs.items()},
           "profile": profile,
           "device_busy_over_bound": profile["device_busy_ms"] / bound_ms}
    if name in ("deepseek-v3-671b", "jamba-v0.1-52b"):
        # deepseek: c_kv is leaf 0, k_pe leaf 1; jamba: k, v of its
        # attention layers.
        out["tamper"] = [phase_tamper(arch, cfg, params, leaf)
                         for leaf in (0, 1)]
        out["tenants"] = _arch_tenants(arch, cfg, params, prompts,
                                       tokens["seda_kernel"])
    del params
    gc.collect()
    torch.cuda.empty_cache()
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return out


def _launch_olmoe() -> dict:
    """olmoe through the launcher: the paged engine under seda, the
    deferred pool MAC OK."""
    import gc

    import torch

    from repro_torch.launch import serve as launch
    gc.collect()
    torch.cuda.empty_cache()
    argv = ["--arch", "olmoe-1b-7b", "--engine", "paged", "--scheme", "seda",
            "--batch", str(SERVE["n_requests"]),
            "--prompt-len", str(SERVE["prompt_len"]),
            "--gen-len", str(SERVE["new_tokens"]), "--quiet"]
    out = launch.main(argv)
    shape = tuple(out["tokens"].shape)
    if shape != (SERVE["n_requests"], SERVE["new_tokens"]) or \
            not out["deferred_mac_ok"] or \
            out["stats"]["fused_write_ticks"] <= 0:
        raise AssertionError(f"olmoe launcher run: shape {shape}, "
                             f"{out['stats']}, deferred MAC "
                             f"{out['deferred_mac_ok']}")
    return {"argv": argv, "tok_per_s": out["tok_per_s"],
            "deferred_mac_ok": True}


def phase_archs(results: dict) -> dict:
    """The attention-family configs at full width on the card, after
    every earlier model is freed."""
    import gc

    import torch
    results.pop("params", None)
    gc.collect()
    torch.cuda.empty_cache()
    out = {"allocated_gb_at_start": torch.cuda.memory_allocated() / 1e9,
           "f32_smoke": [_arch_smoke_f32(name) for name in ARCH_NAMES]}
    for name in ARCH_NAMES:
        out[name] = _arch_cell(name)
        print(f"[archs] {name}: peak {out[name]['peak_mem_gb']:.2f} GB, "
              f"host {out[name]['host_ms_per_tick']['seda_kernel']:.1f} "
              f"ms/tick, {out[name]['tok_per_s']['seda_kernel']:.1f} tok/s",
              flush=True)
        if name == "olmoe-1b-7b":
            out["olmoe_launcher"] = _launch_olmoe()
    results["archs_launches"] = {
        name: out[name]["launches"] for name in ARCH_NAMES}
    return out


def _ssd_f32() -> dict:
    """On the card, the chunked SSD scan (L = 200 over chunks of 64, 8
    heads over 2 groups) equals the sequential recurrence within atol
    1e-4, the reference's own oracle tolerance."""
    import numpy as np
    import torch

    from repro_torch.models import mamba2
    rng = np.random.default_rng(0)
    b, l, h, p, n, g = 2, 200, 8, 16, 32, 2

    def normal(*shape):
        return torch.tensor(rng.standard_normal(shape) * 0.5,
                            dtype=torch.float32, device="cuda")

    x, bb, cc = normal(b, l, h, p), normal(b, l, g, n), normal(b, l, g, n)
    dt = torch.nn.functional.softplus(normal(b, l, h) * 2)
    y, st = mamba2.ssd_chunked(x, bb, cc, dt, -dt * 0.3, chunk=64)
    ry, rs = mamba2.ssd_reference(x, bb, cc, dt, -dt * 0.3)
    err = max(float((y - ry).abs().max()), float((st - rs).abs().max()))
    if y.shape != ry.shape or not err <= 1e-4:
        raise AssertionError(f"ssd_chunked vs ssd_reference: max abs err "
                             f"{err} over atol 1e-4")
    return {"L": l, "chunk": 64, "max_abs_err": err, "atol": 1e-4}


def _mamba2_loops_f32() -> dict:
    """mamba2's smoke config (float32) on the card: the dense loop's
    tokens equal those of a loop that re-runs the prefill over prompt +
    generated at every step (the recurrence equals the chunked scan)."""
    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.models import lm
    from repro_torch.models.layers import init_params
    from repro_torch.serve.serve_step import (greedy_sample,
                                              make_decode_step,
                                              make_prefill_step)
    arch = get_arch("mamba2-780m")
    cfg = arch.make_smoke_config()
    params = init_params(lm.lm_specs(cfg),
                         torch.Generator("cuda").manual_seed(0),
                         device="cuda")
    seq = torch.tensor(np.random.default_rng(4).integers(1, cfg.vocab, (2, 6)),
                       device="cuda")
    with torch.no_grad():
        logits, caches = make_prefill_step(arch, cfg, 16)(
            params, {"tokens": seq})
        decode = make_decode_step(arch, cfg)
        loop = []
        for _ in range(8):
            tok = greedy_sample(logits)
            loop.append(tok)
            logits, caches = decode(params, tok.long(), caches)
        loop = torch.cat(loop, dim=1)
        again = []
        for i in range(loop.shape[1]):
            logits, _ = lm.lm_prefill(cfg, params, {"tokens": seq}, 16)
            again.append(greedy_sample(logits))
            seq = torch.cat([seq, loop[:, i: i + 1].long()], dim=1)
        again = torch.cat(again, dim=1)
    if not torch.equal(loop, again):
        raise AssertionError(f"mamba2 decode loop {loop.tolist()} != "
                             f"re-prefill loop {again.tolist()}")
    return {"config": cfg.name, "tokens": loop.tolist()}


def _jamba_f32() -> dict:
    """jamba's smoke config (float32) under seda with the kernels on the
    card, one slot (MoE capacity couples a tick's rows, ROADMAP C): the
    plain CPU run's tokens, and the same tokens with a contained bitflip
    on an attention page, from a pool small enough to preempt, and
    across a 2-shard cluster that migrates a slot with its recurrent
    state mid-decode.  The last two need 2 slots a pool: the smoke
    config's MoE capacity int(T * 2 / 4 * 2.0) = T never drops a row's
    expert slot, so its rows do not couple."""
    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.models import lm
    from repro_torch.models.layers import init_params, tree_map
    from repro_torch.serve.cluster import ClusterEngine
    from repro_torch.serve.engine import SecureServingEngine
    from repro_torch.serve.faults import Fault, FaultPlan
    arch = get_arch("jamba-v0.1-52b")
    cfg = arch.make_smoke_config()
    moe = cfg.moe
    if int(2 * moe.top_k / moe.n_experts * moe.capacity_factor) < 2:
        raise AssertionError("smoke MoE capacity drops slots: rows couple")
    params = init_params(lm.lm_specs(cfg),
                         torch.Generator("cuda").manual_seed(0),
                         device="cuda")
    cpu_params = tree_map(lambda t: t.cpu(), params)
    rng = np.random.default_rng(8)
    prompts = [list(map(int, rng.integers(1, cfg.vocab, n)))
               for n in (5, 7, 6)]
    kw = dict(scheme="seda", use_kernel=True, page_tokens=4)

    def serve(device, reqs, fault=None, **ekw):
        eng = SecureServingEngine(arch, cfg, cpu_params if device == "cpu"
                                  else params, device=device,
                                  **{"max_slots": 1, "pages_per_slot": 8,
                                     **kw, **ekw})
        if fault:
            FaultPlan([Fault(**fault)]).attach(eng)
        rids = [eng.submit(prompt=p, max_new_tokens=n) for p, n in reqs]
        eng.run()
        return eng, [list(eng.requests[r].generated) for r in rids]

    reqs = [(p, 6) for p in prompts]
    _, want = serve("cpu", reqs)
    eng, got = serve("cuda", reqs)
    out = {"config": cfg.name, "tokens": want}
    if got != want:
        raise AssertionError(f"jamba smoke on the card {got} != CPU {want}")
    eng, got = serve("cuda", reqs, fault=dict(tick=3, kind="bitflip", slot=0),
                     fault_tolerance=True)
    if got != want or not eng.quarantined:
        raise AssertionError(f"contained bitflip: {got} != {want} "
                             f"(quarantined {eng.quarantined})")
    out["contained_preemptions"] = eng.stats["preemptions"]
    eng, got = serve("cuda", reqs, max_slots=2, pages_per_slot=4, n_pages=5)
    if got != want or eng.stats["preemptions"] <= 0:
        raise AssertionError(f"preempting pool: {got} != {want} "
                             f"({eng.stats['preemptions']} preemptions)")
    out["preemptions"] = eng.stats["preemptions"]
    long = [(p, n) for p, n in zip(prompts, (20, 2, 20))]
    _, want_long = serve("cpu", long)
    cl = ClusterEngine(arch, cfg, params, device="cuda", shards=2,
                       max_slots=2, pages_per_slot=8, n_pages=8, **kw)
    rids = [cl.submit(prompt=p, max_new_tokens=n) for p, n in long]
    cl.run()
    got = [list(cl.requests[r].generated) for r in rids]
    if got != want_long or cl.stats["migrations"] <= 0 or \
            cl.engine_stats["admitted"] != len(long):
        raise AssertionError(f"2-shard cluster: {got} != {want_long} "
                             f"({cl.stats['migrations']} migrations, "
                             f"{cl.engine_stats['admitted']} admissions)")
    out["migrations"] = cl.stats["migrations"]
    return out


def _dense_ticks(decode, params, tok, caches, n: int) -> tuple:
    """``n`` steps of the dense loop from ``tok``: (last token, caches)."""
    from repro_torch.serve.serve_step import greedy_sample
    for _ in range(n):
        logits, caches = decode(params, tok.long(), caches)
        tok = greedy_sample(logits)
    return tok, caches


def _mamba2_cell(n_ticks: int = 3) -> dict:
    """mamba2-780m at full width through the dense loop on the serve
    cell's requests (no crypto kernel runs), its paged engine refused as
    the reference refuses it, a CUPTI trace of ``n_ticks`` steady decode
    steps and each decode stage's device ms."""
    import gc

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.serve.engine import SecureServingEngine
    from repro_torch.serve.serve_step import (greedy_sample,
                                              make_decode_step,
                                              make_prefill_step)
    arch, cfg, _ = _arch_config("mamba2-780m")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = _arch_params(cfg)
    weight_bytes = _weight_read_bytes(cfg, params)
    max_len = SERVE["prompt_len"] + SERVE["new_tokens"]
    state_bytes = _state_bytes(cfg, SERVE["n_requests"], max_len)
    try:
        SecureServingEngine(arch, cfg, params, scheme="seda", use_kernel=True,
                            max_slots=SERVE["n_requests"],
                            page_tokens=SERVE["page_tokens"],
                            pages_per_slot=PAGES_PER_SLOT)
    except ValueError as e:
        if str(e) != NO_PAGED_LEAVES:
            raise
    else:
        raise AssertionError("the paged engine took an arch with no paged "
                             "leaf")
    rng = np.random.default_rng(1)
    prompts = torch.tensor(rng.integers(
        1, cfg.vocab, (SERVE["n_requests"], SERVE["prompt_len"])),
        device="cuda")
    prefill = make_prefill_step(arch, cfg, max_len)
    decode = make_decode_step(arch, cfg)
    with torch.no_grad():
        torch.cuda.synchronize()
        reset_launches()                   # the dense loop starts here
        t0 = time.perf_counter()
        logits, caches = prefill(params, {"tokens": prompts})
        tok = greedy_sample(logits)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        finite = bool(torch.isfinite(logits.float()).all())
        out_toks = [tok]
        t0 = time.perf_counter()
        for _ in range(SERVE["new_tokens"] - 1):
            tok, caches = _dense_ticks(decode, params, tok, caches, 1)
            out_toks.append(tok)
        toks = torch.cat(out_toks, dim=1).cpu()     # syncs the card
        decode_s = time.perf_counter() - t0
        launches = dict(LAUNCHES)          # ... and ends here
        if any(launches.values()):
            raise AssertionError(f"the dense loop ran crypto kernels: "
                                 f"{launches}")
        flat = toks.reshape(-1).tolist()
        if not finite or toks.shape != (SERVE["n_requests"],
                                        SERVE["new_tokens"]) or \
                not all(0 <= t < cfg.vocab for t in flat):
            raise AssertionError(f"mamba2: tokens {tuple(toks.shape)}, "
                                 f"finite logits {finite}")
        # Steady ticks: 2 warm, n unprofiled, n traced, n with the stages.
        tok, caches = _dense_ticks(decode, params, tok, caches, 2)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tok, caches = _dense_ticks(decode, params, tok, caches, n_ticks)
        torch.cuda.synchronize()
        tick_ms = (time.perf_counter() - t0) / n_ticks * 1e3
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            tok, caches = _dense_ticks(decode, params, tok, caches, n_ticks)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / n_ticks * 1e3
        state = [tok, caches]

        def step():
            state[0], state[1] = _dense_ticks(decode, params, state[0],
                                              state[1], 1)

        prof_out = {"tick_ms": tick_ms,
                    **_device_breakdown(prof, wall, n_ticks, "tick"),
                    **_stage_ms(step, cfg, n_ticks)}
    del params, caches, state
    gc.collect()
    torch.cuda.empty_cache()
    bound_ms = (weight_bytes + state_bytes) / HBM_BYTES_PER_S * 1e3
    return {"config": cfg.name, "cut": None, "n_layers": cfg.n_layers,
            "d_model": cfg.d_model, "paged_engine_refused": NO_PAGED_LEAVES,
            "launches": launches, "weight_read_gb": weight_bytes / 1e9,
            "state_read_write_gb": state_bytes / 1e9,
            "read_bound_ms": bound_ms, "prefill_s": prefill_s,
            "host_ms_per_tick_run": decode_s / (SERVE["new_tokens"] - 1)
            * 1e3,
            "tok_per_s": toks.numel() / (prefill_s + decode_s),
            "distinct_tokens": len(set(flat)),
            "first_request_tokens": toks[0].tolist(), "profile": prof_out,
            "device_busy_over_bound": prof_out["device_busy_ms"] / bound_ms,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}


def phase_ssm(results: dict) -> dict:
    """The Mamba-2 mixer on the card: the float32 gates on the smoke
    configs, mamba2-780m through the dense loop and jamba-v0.1-52b (24
    of 32 layers) through the paged engine, at full width, each after
    every earlier model is freed."""
    import gc

    import torch
    results.pop("params", None)
    gc.collect()
    torch.cuda.empty_cache()
    out = {"allocated_gb_at_start": torch.cuda.memory_allocated() / 1e9,
           "f32": {"ssd": _ssd_f32(), "mamba2": _mamba2_loops_f32(),
                   "jamba": _jamba_f32()}}
    out["mamba2-780m"] = _mamba2_cell()
    out["jamba-v0.1-52b"] = _arch_cell("jamba-v0.1-52b")
    for name in ("mamba2-780m", "jamba-v0.1-52b"):
        print(f"[ssm] {name}: peak {out[name]['peak_mem_gb']:.2f} GB, "
              f"device {out[name]['profile']['device_busy_ms']:.2f} ms/tick",
              flush=True)
    results["ssm_launches"] = out["jamba-v0.1-52b"]["launches"]
    return out


# The train phase: seamless-m4t-large-v2 at its published width and depth
# through the training launcher at its own defaults (global batch 8,
# seq_len 256, src_len 128), then its decoder served at full width.
TRAIN_ARCH = "seamless-m4t-large-v2"
TRAIN_STEPS = 6
TRAIN_LOSS_RTOL = 1e-3       # steps after the first (atomics in backward)
TRAIN_SMOKE_ARCHS = ("smollm-135m", "pixtral-12b", "seamless-m4t-large-v2",
                     "deepseek-v3-671b", "jamba-v0.1-52b")
F32_RTOL = 1e-4
# One float32 AdamW step moves a param by at most lr x warmup(1/100) x
# (|step| <= ~1): where a tiny gradient's sign differs between the card
# and the CPU the two updates differ by at most twice that.
F32_STEP_ATOL = 1e-5
STEP_SPANS = ("protect", "unprotect")


class _TrainRecorder:
    """While open, the step factories the training launcher imported
    (``make_train_step``, ``make_secure_train_step``) return steps that
    record each call: its wall ms (the card synced before and after),
    loss, entry check and the crypto kernels' launches (counts set to 0
    just before the step, read just after); the last call's step, outputs,
    batch and index are kept to drive it once more."""

    NAMES = ("make_train_step", "make_secure_train_step")

    def __enter__(self):
        from repro_torch.launch import train as launcher
        self.launcher, self.steps, self.last = launcher, [], None
        self.saved = {n: getattr(launcher, n) for n in self.NAMES}
        for name, build in self.saved.items():
            setattr(launcher, name, self._wrap(build))
        return self

    def __exit__(self, *exc):
        for name, build in self.saved.items():
            setattr(self.launcher, name, build)
        return False

    def _wrap(self, build):
        import torch

        from repro_torch.kernels import LAUNCHES, reset_launches

        def make(*args, **kwargs):
            step = build(*args, **kwargs)

            def recorded(*inputs):
                torch.cuda.synchronize()
                reset_launches()             # one step's path starts here
                t0 = time.perf_counter()
                out = step(*inputs)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
                launches = {k: LAUNCHES[k] for k in WEIGHTS_KEY}  # ends
                metrics = out[-1]
                self.steps.append({
                    "ms": ms, "loss": float(metrics["loss"]),
                    "integrity_ok": bool(metrics.get("integrity_ok", True)),
                    "launches": launches})
                self.last = (step, out, inputs[2:])
                return out
            return recorded
        return make


def _drive(step, state, opt, batch, idx):
    """One call of a recorded train step (``idx`` None for ``off``)."""
    return step(state, opt, batch, *(() if idx is None else (idx,)))


def _train_step_profile(step, state, opt, batch, idx) -> tuple:
    """Two more steps, each under a CUPTI trace: the first gives device
    busy, idle share and launches; the second, with ``protect``,
    ``unprotect`` and the AdamW update annotated (the annotations would
    count as device time in the first), each one's device ms.  Returns
    ``(profile, (state, opt))``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.secure_exec import SecureExecutor
    from repro_torch.train import train_step
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        (state, opt, _), wall = _timed(
            lambda: _drive(step, state, opt, batch, idx))
    out = _device_breakdown(prof, wall, 1, "step")
    with _Spans(SecureExecutor, STEP_SPANS), \
            _Spans(train_step, ("adamw_update",)):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            state, opt, _ = _drive(step, state, opt, batch,
                                   None if idx is None else idx + 1)
    spans = {f"{tag}.{name}": 0.0 for tag, names in (
        ("SecureExecutor", STEP_SPANS), ("train_step", ("adamw_update",)))
        for name in names}
    for e in prof.events():
        if e.name in spans and e.device_type == DeviceType.CPU:
            spans[e.name] += e.device_time_total / 1e3
    out["span_device_ms"] = spans
    return out, (state, opt)


def _train_cell(scheme: str) -> dict:
    """seamless at full width through ``repro_torch.launch.train.main``
    under ``scheme`` for ``TRAIN_STEPS`` steps; then two steps traced
    and, for seda, one step from a state with a flipped ciphertext
    byte."""
    import gc
    import statistics

    import torch

    from repro_torch.core.layout import tree_flatten
    from repro_torch.launch import train as launcher
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    argv = ["--arch", TRAIN_ARCH, "--scheme", scheme, "--steps",
            str(TRAIN_STEPS), "--log-every", "1"]
    with _TrainRecorder() as rec:
        t0 = time.perf_counter()
        ret = launcher.main(argv)
        run_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    losses = [s["loss"] for s in rec.steps]
    if ret["steps"] != TRAIN_STEPS or ret["first_loss"] != losses[0] or \
            not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{scheme}: launcher returned {ret}, losses "
                             f"{losses}")
    step, (state, opt, _), (batch, *idx) = rec.last
    rec.last = None
    idx = idx[0] + 1 if idx else None
    profile_out, (state, opt) = _train_step_profile(step, state, opt, batch,
                                                    idx)
    out = {"argv": argv, "return": ret, "run_s": run_s, "losses": losses,
           "step_ms": [s["ms"] for s in rec.steps],
           "step_ms_median_2_6": statistics.median(
               s["ms"] for s in rec.steps[1:]),
           "launches_per_step": [s["launches"] for s in rec.steps],
           "integrity_ok": [s["integrity_ok"] for s in rec.steps],
           "profile": profile_out, "peak_mem_gb": peak}
    if scheme == "off":
        out["params_gb"] = sum(t.numel() * t.element_size()
                               for t in tree_flatten(state)[0]) / 1e9
    else:
        n_leaves = len(state.ciphertexts)
        want = {"aes_ctr_keystream": 4 * n_leaves, "otp_xor": 2 * n_leaves,
                "nh_hash_kernel_call": 2 * n_leaves}
        bad = [s["launches"] for s in rec.steps if s["launches"] != want]
        if bad or not all(out["integrity_ok"]):
            raise AssertionError(f"seda steps: launches {bad} (want "
                                 f"{want}), checks {out['integrity_ok']}")
        ct = state.ciphertexts[n_leaves // 2]
        ct[ct.numel() // 2] ^= 0x01
        _, _, metrics = step(state, opt, batch, idx + 2)
        out["tampered_step_integrity_ok"] = bool(metrics["integrity_ok"])
        if out["tampered_step_integrity_ok"]:
            raise AssertionError("a flipped ciphertext byte passed the "
                                 "secure step's entry check")
        out.update(leaves=n_leaves, launches_want=want,
                   ciphertext_gb=sum(c.numel() for c in state.ciphertexts)
                   / 1e9)
    del state, opt, batch, step
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _train_smoke_f32(name: str) -> dict:
    """The smoke config (float32) on the card against the CPU port on the
    same weights and batch: loss and every leaf's gradient within
    ``F32_RTOL`` (of the leaf's largest), then one train step each (the
    loss within ``F32_RTOL``, params within ``F32_STEP_ATOL``); seamless
    also decodes the CPU's greedy tokens."""
    import numpy as np
    import torch

    from repro_torch.core.layout import tree_flatten
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.launch.train import build
    from repro_torch.models.layers import init_params, tree_map
    from repro_torch.serve.serve_step import (greedy_sample,
                                              make_decode_step,
                                              make_prefill_step)
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.train_step import (make_loss_fn, make_train_step,
                                              value_and_grad)
    arch, cfg, specs = build(name, smoke=True)
    cpu = init_params(specs, 0, device="cpu")
    card = tree_map(lambda t: t.to("cuda"), cpu)
    n_patches = getattr(cfg, "n_image_patches", 0)
    data = DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=2,
                      kind=("encdec" if arch.kind == "encdec"
                            else "vlm" if n_patches else "lm"),
                      n_image_patches=n_patches,
                      d_vision=getattr(cfg, "d_vision", 0),
                      d_model=cfg.d_model, src_len=16)
    batches = {d: make_batch(data, 0, device=d) for d in ("cpu", "cuda")}
    loss_fn = make_loss_fn(arch, cfg)
    (loss_c, _), g_c = value_and_grad(loss_fn, cpu, batches["cpu"])
    (loss_g, _), g_g = value_and_grad(loss_fn, card, batches["cuda"])

    def worst(got, want, relative: bool) -> float:
        out = 0.0
        for a, b in zip(tree_flatten(got)[0], tree_flatten(want)[0],
                        strict=True):
            err = float((a.cpu().float() - b.float()).abs().max())
            scale = max(float(b.abs().max()), 1e-30) if relative else 1.0
            out = max(out, err / scale)
        return out

    loss_err = abs(float(loss_g) - float(loss_c)) / abs(float(loss_c))
    grad_err = worst(g_g, g_c, True)
    ocfg = AdamWConfig()
    step = make_train_step(arch, cfg, ocfg)
    p_c, _, m_c = step(cpu, init_opt_state(cpu, ocfg), batches["cpu"])
    p_g, _, m_g = step(card, init_opt_state(card, ocfg), batches["cuda"])
    step_loss_err = abs(float(m_g["loss"]) - float(m_c["loss"])) / abs(
        float(m_c["loss"]))
    param_err = worst(p_g, p_c, False)
    out = {"config": cfg.name, "loss": float(loss_g),
           "loss_rel_err": loss_err, "grad_rel_err": grad_err,
           "step_loss_rel_err": step_loss_err, "step_param_abs_err": param_err}
    if arch.kind == "encdec":
        rng = np.random.default_rng(2)
        src = rng.standard_normal((2, 12, cfg.d_model)).astype(np.float32)
        tgt = rng.integers(0, cfg.vocab, (2, 5)).astype(np.int32)
        prefill = make_prefill_step(arch, cfg, 12)
        decode = make_decode_step(arch, cfg)
        toks = {}
        with torch.no_grad():
            for d, params in (("cpu", cpu), ("cuda", card)):
                logits, caches = prefill(params, {
                    "src_embeds": torch.from_numpy(src).to(d),
                    "tgt_tokens": torch.from_numpy(tgt).to(d)})
                tok, seq = greedy_sample(logits), []
                for _ in range(6):
                    seq.append(tok.cpu())
                    logits, caches = decode(params, tok, caches)
                    tok = greedy_sample(logits)
                toks[d] = torch.cat(seq, dim=1).tolist()
        out["decode_tokens"] = toks["cuda"]
        if toks["cuda"] != toks["cpu"]:
            raise AssertionError(f"{cfg.name}: card tokens {toks['cuda']} != "
                                 f"CPU {toks['cpu']}")
    if max(loss_err, grad_err, step_loss_err) > F32_RTOL or \
            param_err > F32_STEP_ATOL:
        raise AssertionError(f"{cfg.name} card vs CPU: {out}")
    return out


def _encdec_serve() -> dict:
    """seamless's decoder at full width through the serve steps: 8
    requests over ``DECODE_SRC_LEN`` encoder frames, 64-token prompts, 16
    new tokens; weights drawn at one layer's fan-in (attn wq/wk at
    ``ATTN_QK_SCALE``), as the archs phase draws them."""
    import gc

    import numpy as np
    import torch

    from repro_torch.configs import DECODE_SRC_LEN
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.train import build
    from repro_torch.serve.serve_step import (greedy_sample,
                                              make_decode_step,
                                              make_prefill_step)
    arch, cfg, specs = build(TRAIN_ARCH, smoke=False)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = _arch_params(cfg, specs=specs)
    n, lp, new = SERVE["n_requests"], SERVE["prompt_len"], SERVE["new_tokens"]
    rng = np.random.default_rng(1)
    src = torch.from_numpy(rng.standard_normal(
        (n, DECODE_SRC_LEN, cfg.d_model)).astype(np.float32)).to("cuda")
    prompts = torch.tensor(rng.integers(1, cfg.vocab, (n, lp)),
                           dtype=torch.int32, device="cuda")
    prefill = make_prefill_step(arch, cfg, lp + new)
    decode = make_decode_step(arch, cfg)
    with torch.no_grad():
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        logits, caches = prefill(params, {"src_embeds": src,
                                          "tgt_tokens": prompts})
        tok = greedy_sample(logits)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        finite = bool(torch.isfinite(logits.float()).all())
        seq = [tok]
        t0 = time.perf_counter()
        for _ in range(new - 1):
            logits, caches = decode(params, tok, caches)
            tok = greedy_sample(logits)
            seq.append(tok)
        toks = torch.cat(seq, dim=1).cpu()          # syncs the card
        decode_s = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    flat = toks.reshape(-1).tolist()
    if not finite or toks.shape != (n, new) or any(launches.values()) or \
            not all(0 <= t < cfg.vocab for t in flat):
        raise AssertionError(f"seamless serving: tokens {tuple(toks.shape)}, "
                             f"finite {finite}, launches {launches}")
    out = {"config": cfg.name, "src_frames": DECODE_SRC_LEN,
           "requests": n, "prompt_len": lp, "new_tokens": new,
           "prefill_s": prefill_s,
           "host_ms_per_decode_step": decode_s / (new - 1) * 1e3,
           "tok_per_s": toks.numel() / (prefill_s + decode_s),
           "distinct_token_share": len(set(flat)) / len(flat),
           "first_request_tokens": toks[0].tolist(),
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    del params, caches, src
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_train(results: dict) -> dict:
    """Secure training on the card: the float32 smoke gates, seamless at
    full width under seda and off through the launcher, the first losses
    bitwise and the later ones within ``TRAIN_LOSS_RTOL``, a tampered
    state refused; then seamless's decoder served at full width."""
    import gc

    import torch
    results.pop("params", None)
    gc.collect()
    torch.cuda.empty_cache()
    out = {"allocated_gb_at_start": torch.cuda.memory_allocated() / 1e9,
           "f32": {name: _train_smoke_f32(name)
                   for name in TRAIN_SMOKE_ARCHS}}
    for scheme in ("seda", "off"):
        out[scheme] = _train_cell(scheme)
        print(f"[train] {scheme}: {out[scheme]['step_ms_median_2_6']:.1f} "
              f"ms/step, peak {out[scheme]['peak_mem_gb']:.2f} GB, losses "
              f"{out[scheme]['losses']}", flush=True)
    seda, off = out["seda"]["losses"], out["off"]["losses"]
    rel = [abs(a - b) / abs(b) for a, b in zip(seda, off)]
    out["loss_rel_diff_seda_vs_off"] = rel
    if seda[0] != off[0] or max(rel[1:]) > TRAIN_LOSS_RTOL:
        raise AssertionError(f"seda losses {seda} vs off {off}")
    out["serve"] = _encdec_serve()
    print(f"[train] seamless serving: {out['serve']['tok_per_s']:.1f} tok/s, "
          f"peak {out['serve']['peak_mem_gb']:.2f} GB", flush=True)
    return out


KERNEL_META = {
    "aes_ctr_keystream": ("src/repro_torch/kernels/csrc/aes_ctr.cu",
                          "src/repro/kernels/aes_ctr/kernel.py:178"),
    "fused_crypt_mac": ("src/repro_torch/kernels/csrc/fused_crypt_mac.cu",
                        "src/repro/kernels/fused_crypt_mac/kernel.py:274"),
    "fused_crypt_mac_write": (
        "src/repro_torch/kernels/csrc/fused_crypt_mac.cu",
        "src/repro/kernels/fused_crypt_mac/kernel.py:284"),
    "aes_ctr_keystream_multi": ("src/repro_torch/kernels/csrc/aes_ctr.cu",
                                "src/repro/kernels/aes_ctr/kernel.py:144"),
    "fused_crypt_mac_mixed": (
        "src/repro_torch/kernels/csrc/fused_crypt_mac.cu",
        "src/repro/kernels/fused_crypt_mac/kernel.py:207"),
    "fused_crypt_mac_write_mixed": (
        "src/repro_torch/kernels/csrc/fused_crypt_mac.cu",
        "src/repro/kernels/fused_crypt_mac/kernel.py:221"),
    "otp_xor": ("src/repro_torch/kernels/csrc/otp_xor.cu",
                "src/repro/kernels/otp_xor/kernel.py:45"),
    "nh_hash_kernel_call": ("src/repro_torch/kernels/csrc/xormac.cu",
                            "src/repro/kernels/xormac/kernel.py:61"),
}
# The path each kernel's launch count is read from.
LAUNCHES_FROM = {name: "tenant_launches" for name in MIXED_KEY}
LAUNCHES_FROM.update(otp_xor="weights_launches",
                     nh_hash_kernel_call="weights_launches")


def main() -> int:
    try:
        import torch
        from repro_torch.configs import get_arch
    except ImportError as e:
        emit({"phase": "setup", "ok": False,
              "error": f"cannot import the port: {e}"})
        return 2
    results: dict = {}
    arch = get_arch("minitron-4b")
    cfg = arch.make_config()
    phases = [
        ("setup", phase_setup),
        ("kernels", lambda: phase_kernels(cfg, results)),
        ("reference", phase_reference),
        ("serve", lambda: phase_serve(arch, cfg, results)),
        ("profile", lambda: phase_profile(arch, cfg, results)),
        ("tamper", lambda: phase_tamper(arch, cfg, results["params"])),
        ("tenants", lambda: phase_tenants(arch, cfg, results)),
        ("tenant_tamper",
         lambda: phase_tenant_tamper(arch, cfg, results["params"])),
        ("prefix", lambda: phase_prefix(arch, cfg, results)),
        ("faults", lambda: phase_faults(arch, cfg, results)),
        ("weights", lambda: phase_weights(results)),
        ("checkpoint", lambda: phase_checkpoint(arch, cfg, results)),
        ("shards", lambda: phase_shards(arch, cfg, results)),
        ("launch", lambda: phase_launch(results)),
        ("archs", lambda: phase_archs(results)),
        ("ssm", lambda: phase_ssm(results)),
        ("train", lambda: phase_train(results)),
    ]
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            info = fn()
        except Exception as e:  # report the failing phase, then stop
            emit({"phase": name, "ok": False, "error": repr(e),
                  "traceback": traceback.format_exc()[-4000:]})
            return 1
        emit({"phase": name, "ok": True,
              "seconds": round(time.perf_counter() - t0, 3), **info})
    kernels = []
    for name, (source, replaces) in KERNEL_META.items():
        k = results[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": results[LAUNCHES_FROM.get(name, "launches")][name],
            "max_abs_err": k["max_abs_err"], "ms": k["ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"], "library_ms": None})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
