"""Serving driver of the port: the paged secure engine on random or
checkpointed weights.

Mirrors the paged path of the reference launcher (``repro.launch.serve
--engine paged``): the KV cache lives as a paged, MAC-protected pool,
decode ticks verify only touched pages and re-MAC only dirty ones::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch minitron-4b \\
        --smoke --device cpu --engine paged --scheme seda --batch 4 \\
        --gen-len 8

``--tenants N`` registers N tenants and serves the batch round-robin
across their sessions, each tenant's pages under its own (tenant,
epoch) keys; ``--rotate-every K`` rotates one tenant's keys every K
ticks (round-robin)::

    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \\
        --engine paged --tenants 2 --rotate-every 2

``--ckpt-dir D`` serves the newest checkpoint published in ``D``
(:mod:`repro_torch.checkpoint.secure_ckpt`), loaded and verified with
the ``--seed`` session keys; without one it serves the fresh init::

    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \\
        --ckpt-dir /path/to/ckpts

Runs on the card unless ``--device cpu``.  Unlike the reference
launcher, the engine is built with ``use_kernel=True``: on the card the
``seda`` crossings run the CUDA kernels (on the CPU, their plain
versions).  Fresh weights are random, from a ``torch.Generator`` seeded
with ``--seed`` (not the reference's JAX draw).  Not accepted yet,
because their modules are not ported: ``--engine simple``, ``--shards``,
``--fault-tolerance``, and the logging, observability, SLO and audit
flags.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.checkpoint.secure_ckpt import latest_step, load_checkpoint
from repro_torch.configs import get_arch
from repro_torch.core.secure_memory import SecureKeys
from repro_torch.models import lm as lm_mod
from repro_torch.models.layers import init_params

__all__ = ["main"]


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", default="minitron-4b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--engine", choices=("paged",), default="paged",
                    help="the paged secure engine (the only one ported)")
    ap.add_argument("--scheme", default="seda",
                    help="protection scheme for --engine paged")
    ap.add_argument("--page-tokens", type=int, default=8)
    ap.add_argument("--pages-per-slot", type=int, default=0,
                    help="0 = sized from prompt+gen length")
    ap.add_argument("--n-pages", type=int, default=0,
                    help="0 = batch * pages_per_slot")
    ap.add_argument("--tenants", type=int, default=0,
                    help="serve through N per-tenant key domains "
                         "(0 = single-tenant)")
    ap.add_argument("--rotate-every", type=int, default=0,
                    help="rotate one tenant's keys every K ticks "
                         "(round-robin; needs --tenants)")
    ap.add_argument("--ckpt-dir", default=None,
                    help="serve the newest secure checkpoint in this "
                         "directory (verified with the --seed keys)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    return ap


def main(argv=None) -> dict:
    args = _parser().parse_args(argv)
    if args.rotate_every and not args.tenants:
        raise SystemExit("--rotate-every needs --tenants (there are no "
                         "tenant keys to rotate otherwise)")
    device = resolve_device(args.device)
    arch = get_arch(args.arch)
    cfg = arch.make_smoke_config() if args.smoke else arch.make_config()
    specs = lm_mod.lm_specs(cfg)
    step = latest_step(args.ckpt_dir) if args.ckpt_dir else None
    if step is not None:
        path = os.path.join(args.ckpt_dir, f"step_{step:08d}")
        keys = SecureKeys.derive(args.seed, device=device)
        params, _ = load_checkpoint(path, specs, keys, device=device)
        print(f"[serve] loaded + verified checkpoint {path}", flush=True)
    else:
        params = init_params(specs, args.seed, device=device)
        print("[serve] no checkpoint: serving fresh init", flush=True)
    return _serve_paged(arch, cfg, params, args, device)


def _serve_paged(arch, cfg, params, args, device) -> dict:
    """Continuous-batching path: paged, MAC-protected KV pool."""
    from repro_torch.serve.engine import SecureServingEngine

    pages_per_slot = args.pages_per_slot or -(
        -(args.prompt_len + args.gen_len) // args.page_tokens)
    n_pages = args.n_pages or args.batch * pages_per_slot
    registry = None
    sessions = []
    if args.tenants:
        from repro_torch.tenancy import KeyHierarchy, TenantRegistry
        registry = TenantRegistry(KeyHierarchy(args.seed, device=device),
                                  max_tenants=args.tenants)
        for t in range(args.tenants):
            registry.register(f"tenant-{t}")
            sessions.append(registry.open_session(f"tenant-{t}"))
    eng = SecureServingEngine(
        arch, cfg, params, scheme=args.scheme, max_slots=args.batch,
        page_tokens=args.page_tokens, pages_per_slot=pages_per_slot,
        n_pages=n_pages, keys=SecureKeys.derive(args.seed, device=device),
        use_kernel=True, registry=registry, rotate_every=args.rotate_every,
        device=device)

    rng = np.random.default_rng(args.seed)
    rids = []
    for i in range(args.batch):
        prompt = list(map(int, rng.integers(1, cfg.vocab, args.prompt_len)))
        session = sessions[i % len(sessions)] if sessions else None
        rids.append(eng.submit(prompt=prompt, max_new_tokens=args.gen_len,
                               session=session))
    t0 = time.perf_counter()
    done = eng.run()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    n_tokens = sum(len(eng.requests[r].generated) for r in rids)
    rate = n_tokens / max(dt, 1e-9)
    stats = dict(eng.stats)
    mode = f"paged/{args.scheme}" + (
        f"/{args.tenants} tenants" if args.tenants else "")
    mac_ok = eng.deferred_check()
    print(f"[serve] {mode}: {n_tokens} tokens over {args.batch} requests "
          f"({rate:.1f} tok/s on {device}), {stats['preemptions']} "
          f"preemptions, {stats['rotations']} key rotations, deferred pool "
          f"MAC {'OK' if mac_ok else 'FAIL'}", flush=True)
    if done.latency:
        print(f"[serve] latency (ticks): "
              f"ttft p50={done.latency['p50_ttft_ticks']:.1f} "
              f"p95={done.latency['p95_ttft_ticks']:.1f} "
              f"p99={done.latency['p99_ttft_ticks']:.1f}", flush=True)
    toks = np.asarray([done[r].generated for r in rids], np.int32)
    return {"tokens": toks, "tok_per_s": rate, "stats": stats,
            "latency": done.latency, "deferred_mac_ok": bool(mac_ok)}


if __name__ == "__main__":
    main(sys.argv[1:])
