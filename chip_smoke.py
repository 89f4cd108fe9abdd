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
9. weights — the serve phase's full-width params through
             ``SecureExecutor("seda")``: protect, then unprotect with the
             layer check, bit-equal and verified (median of 3 each, and
             one of each under a CUPTI trace); a flipped ciphertext byte
             and a stale VN (replay) fail the check; the protect runs
             the AES-CTR, otp_xor and NH kernels.  Then ``seda512`` once
             (plain wide B-AES, the NH kernel at L = 136).
10. checkpoint — minitron-4b at full width and 2 layers saved as a
             secure checkpoint, found by ``latest_step``, loaded and
             verified bit-equal; the engine serves the same tokens from
             the restored and the original weights; a flipped byte of a
             leaf file raises ``CheckpointError``.
11. launch — the port's launcher (``repro_torch.launch.serve.main``) at
             full width with 4 tenants and a rotation every tick, after
             the earlier model is freed: 8 x 16 tokens, mixed-key ticks,
             the deferred pool MAC OK.

Each path whose launches are reported (serve, tenants, weights) is
driven with the counts set to 0 just before it and read just after.  Then a
``{"kernels": [...]}`` line and, last, the device line.

Run from the root of a checkout: ``python3 chip_smoke.py``.
"""

from __future__ import annotations

import os

# Deterministic cuBLAS (set before CUDA initializes), so the three serve
# runs differ only in their crypto.
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import json  # noqa: E402
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
# bound a lower bound on time.
HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12
AES_OPS_PER_BLOCK = 1056   # 9 rounds x 16 B x 7 + final 16 x 2 + first ARK 16

SERVE = dict(n_requests=8, prompt_len=64, new_tokens=16, page_tokens=8)
PAGES_PER_SLOT = 10        # 64 + 16 tokens = 10 pages of 8
N_TENANTS = 4              # the tenants phase: K = 4 x (retain 2 + 1) rows
CKPT_LAYERS = 2            # the checkpoint phase's depth (full width)
SINGLE_KEY = ("aes_ctr_keystream", "fused_crypt_mac", "fused_crypt_mac_write")
WEIGHTS_KEY = ("aes_ctr_keystream", "otp_xor", "nh_hash_kernel_call")
MIXED_KEY = ("aes_ctr_keystream_multi", "fused_crypt_mac_mixed",
             "fused_crypt_mac_write_mixed")


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
    # Counters in, lanes out; the schedule and the 1 KB T-table once.
    b_ms, b_by = bound(n * 32 + 176 + 1024, n * AES_OPS_PER_BLOCK)
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
        moved = n * (16 * s + 16 + 32 + 16 * s + 8) + 16 * s + 4 * (4 * s + 8)
        b_ms, b_by = bound(moved, n * (16 * s + 16))
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
    b_ms, b_by = bound(n * 32 + 176 + 1024, n * AES_OPS_PER_BLOCK)
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
    # Counters in, a row per block, lanes out; the bank and the 1 KB
    # T-table once.
    b_ms, b_by = bound(n * 36 + 176 * k + 1024, n * AES_OPS_PER_BLOCK)
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
        # ct + base + bind + row in, out + nh out, per block; both banks once.
        moved = (n * (16 * s + 16 + 32 + 4 + 16 * s + 8)
                 + fused_k.mixed_shared_bytes(k, s))
        b_ms, b_by = bound(moved, n * (16 * s + 16))
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
    # data + base in, out; the diversifiers once.  Two XORs per lane.
    b_ms, b_by = bound(n * (16 * s + 16 + 16 * s) + 16 * s, n * 4 * s * 2)
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
    # payload in, (hi, lo) out; the key once.  Per pair two adds, a
    # 64-bit multiply and an accumulate.
    b_ms, b_by = bound(n * (4 * lanes + 8) + 4 * lanes, n * lanes // 2 * 4)
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


def _dense_tokens(cfg, params, prompt: list, n_new: int, max_len: int):
    """Plain prefill + decode loop (no pool, no crypto)."""
    import torch

    from repro_torch.models import lm
    from repro_torch.serve.serve_step import greedy_sample
    tokens = torch.tensor([prompt], device="cuda")
    logits, caches = lm.lm_prefill(cfg, params, {"tokens": tokens}, max_len)
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
            tenants: bool = False):
    """The serve phase's engine with ``prompts`` submitted; with
    ``tenants``, over a 4-tenant registry (sessions round-robin) that
    rotates one tenant every tick."""
    from repro_torch.serve.engine import SecureServingEngine
    registry = _tenant_registry("cuda") if tenants else None
    eng = SecureServingEngine(
        arch, cfg, params, scheme=scheme, use_kernel=use_kernel,
        max_slots=SERVE["n_requests"], page_tokens=SERVE["page_tokens"],
        pages_per_slot=PAGES_PER_SLOT, registry=registry,
        rotate_every=1 if tenants else 0)
    sessions = ([registry.open_session(f"tenant-{t}")
                 for t in range(N_TENANTS)] if tenants else [None])
    rids = [eng.submit(prompt=p, max_new_tokens=SERVE["new_tokens"],
                       session=sessions[i % len(sessions)])
            for i, p in enumerate(prompts)]
    return eng, rids


def _serve_once(arch, cfg, params, prompts, scheme, use_kernel,
                tenants: bool = False):
    import torch

    from repro_torch.kernels import LAUNCHES, reset_launches
    eng, rids = _engine(arch, cfg, params, prompts, scheme, use_kernel,
                        tenants)
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
                   tenants: bool = False, n_ticks: int = 3) -> dict:
    """Device busy time and the top kernels over ``n_ticks`` steady
    decode ticks (all 8 requests running), from a CUPTI trace.  With
    ``tenants`` each tick also rotates a tenant and reseals its pages."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    eng, _ = _engine(arch, cfg, params, prompts, scheme, use_kernel, tenants)
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
            **_device_breakdown(prof, wall * 1e3, n_ticks, "tick")}


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


def phase_profile(arch, cfg, results: dict) -> dict:
    out = {}
    for key, scheme, use_kernel, tenants in (
            ("seda_kernel", "seda", True, False), ("off", "off", False, False),
            ("seda_kernel_4_tenants", "seda", True, True)):
        out[key] = _profile_ticks(arch, cfg, results["params"],
                                  results["prompts"], scheme, use_kernel,
                                  tenants)
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


def phase_tamper(arch, cfg, params) -> dict:
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
    eng.pool.cts[0][page, 123] ^= 0x10
    try:
        eng.step()
    except IntegrityError as e:
        return {"page": int(page), "raised": type(e).__name__,
                "message": str(e)}
    raise AssertionError("a flipped ciphertext byte was not detected")


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


def phase_launch(results: dict) -> dict:
    import gc

    import torch

    from repro_torch.launch import serve as launch
    results.pop("params", None)            # free the earlier model
    gc.collect()
    torch.cuda.empty_cache()
    argv = ["--arch", "minitron-4b", "--engine", "paged", "--scheme", "seda",
            "--batch", str(SERVE["n_requests"]),
            "--prompt-len", str(SERVE["prompt_len"]),
            "--gen-len", str(SERVE["new_tokens"]),
            "--tenants", str(N_TENANTS), "--rotate-every", "1"]
    out = launch.main(argv)
    shape = tuple(out["tokens"].shape)
    if shape != (SERVE["n_requests"], SERVE["new_tokens"]):
        raise AssertionError(f"launcher served tokens of shape {shape}")
    if out["stats"]["fused_mixed_ticks"] <= 0 or not out["deferred_mac_ok"]:
        raise AssertionError(f"launcher run: {out['stats']}, deferred MAC "
                             f"{out['deferred_mac_ok']}")
    return {"argv": argv, "tokens_shape": shape,
            "tok_per_s": out["tok_per_s"], "stats": out["stats"],
            "latency": out["latency"]}


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
        ("weights", lambda: phase_weights(results)),
        ("checkpoint", lambda: phase_checkpoint(arch, cfg, results)),
        ("launch", lambda: phase_launch(results)),
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
