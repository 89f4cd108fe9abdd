"""Serving launcher of the port: random or checkpointed weights, served by
the dense loop or the paged secure engine.

Mirrors the reference launcher (``repro.launch.serve``).  ``--engine
paged`` (the port's default) serves through the continuous-batching
secure engine: the KV cache lives as a paged, MAC-protected pool, decode
ticks verify only touched pages and re-MAC only dirty ones::

    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \\
        --engine paged --scheme seda --batch 4 --gen-len 8

``--engine simple`` (the reference's default) runs an unprotected
prefill over the batch, then one token per step against the dense KV
cache::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch minitron-4b \\
        --smoke --device cpu --engine simple --batch 4 --gen-len 8

``--arch`` takes every decoder-only LM of the reference: the dense
minitron-4b/-8b and smollm-135m, granite-34b (GELU MLP, MQA),
olmoe-1b-7b (MoE), deepseek-v3-671b (MLA + MoE) and jamba-v0.1-52b
(Mamba + attention + MoE, its recurrent state beside the paged pool),
with either engine::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmoe-1b-7b \\
        --smoke --device cpu --engine paged --scheme seda

mamba2-780m (attention-free) serves through ``--engine simple``; with
``--engine paged`` it raises the reference's ``ValueError``: it has no
KV cache to page.  seamless-m4t-large-v2 exits, as in the reference
(its decoder serves through :mod:`repro_torch.serve.serve_step`), and so
does pixtral-12b: neither engine passes image embeddings to the prefill
(the reference fails inside its prefill instead).

``--tenants N`` registers N tenants and serves the batch round-robin
across their sessions, each tenant's pages under its own (tenant,
epoch) keys; ``--rotate-every K`` rotates one tenant's keys every K
ticks (round-robin)::

    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \\
        --engine paged --tenants 2 --rotate-every 2

``--shards N`` (``--engine paged`` only) serves through the cluster
engine instead: N shard engines, each with its own pool bound to its
shard id, logical shards on the one device; ``--batch`` and
``--n-pages`` are split evenly across the shards.  Requests route to the
least loaded shard (tenant affinity breaks ties), a starved shard's
youngest slot migrates securely to one with room, and the summary
reports the migrations and the deferred cluster root MAC::

    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \\
        --engine paged --scheme seda --shards 2 --tenants 2 \\
        --rotate-every 4

``--fault-tolerance`` contains integrity faults instead of aborting
(quarantine, secure-recompute recovery; with ``--shards``, shard
failover too). The observability flags (``--engine paged`` only):
``--trace-out`` (Chrome trace of the ticks, their phases and the
program's spans: page crossings and their stages, model, kernel
launches, each request's wait in the queue, the collector's passes),
``--metrics-json`` / ``--metrics-prom`` (a metrics snapshot, Prometheus
text), ``--audit-out`` (the hash-chained audit log as JSON lines),
``--slo-ttft-ms`` / ``--slo-p99-ticks`` (SLO targets; a hard breach
exits with code 3; one monitor per shard) and ``--http-port``
(``/healthz``, the worst shard's health, and ``/metrics`` on 127.0.0.1
during the run) and ``--profile-json`` (the protection-vs-model
device-cost profile of the all-resident decode variant, after the run;
with ``--shards``, every shard's and the cluster rollup). ``--quiet``
keeps warnings only, ``--json-logs`` writes one JSON record a line.

``--ckpt-dir D`` serves the newest checkpoint published in ``D``
(:mod:`repro_torch.checkpoint.secure_ckpt`), loaded and verified with
the ``--seed`` session keys; without one it serves the fresh init.
``--audit-proof-out F`` admits the batch with one tick, takes one Merkle
membership proof per session (per tenant; one for the whole pool
single-tenant; with ``--shards``, one per shard holding the session,
each chained to the cluster root), verifies each as a tenant would, and
after the run writes them with the final Merkle root (with ``--shards``,
the final cluster root and shard roots) to ``F`` as JSON.

Runs on the card unless ``--device cpu``.  Unlike the reference
launcher, the paged engine is built with ``use_kernel=True``: on the
card the ``seda`` crossings run the CUDA kernels (on the CPU, their
plain versions).  Fresh weights are random, from a ``torch.Generator``
seeded with ``--seed`` (not the reference's JAX draw).  The
reference's ``XLA_FLAGS`` device forcing for ``--shards`` has no torch
counterpart: the shards share the one device.
"""

from __future__ import annotations

import argparse
import json
import logging
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
from repro_torch.obs import trace as trace_mod
from repro_torch.serve.serve_step import (greedy_sample, make_decode_step,
                                          make_prefill_step)

__all__ = ["main"]

log = logging.getLogger("repro_torch.serve")


class _JsonFormatter(logging.Formatter):
    """One JSON object per record: ts/level/event/msg + extra fields."""

    def format(self, record: logging.LogRecord) -> str:
        doc = {"ts": round(record.created, 3),
               "level": record.levelname.lower(),
               "event": getattr(record, "event", "message"),
               "msg": record.getMessage()}
        doc.update(getattr(record, "fields", None) or {})
        return json.dumps(doc, sort_keys=True, default=str)


def _setup_logging(args) -> None:
    """Route the launcher's output through the ``repro_torch.serve``
    logger: plain messages on stdout, one JSON record a line with
    ``--json-logs``, warnings only with ``--quiet``."""
    log.handlers.clear()
    handler = logging.StreamHandler(sys.stdout)
    handler.setFormatter(_JsonFormatter() if args.json_logs
                         else logging.Formatter("%(message)s"))
    log.addHandler(handler)
    log.setLevel(logging.WARNING if args.quiet else logging.INFO)
    log.propagate = False


def _log(event: str, msg: str, **fields) -> None:
    log.info(msg, extra={"event": event, "fields": fields})


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", default="minitron-4b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--engine", choices=("simple", "paged"), default="paged",
                    help="the paged secure engine, or the unprotected "
                         "dense loop")
    ap.add_argument("--scheme", default="seda",
                    help="protection scheme for --engine paged")
    ap.add_argument("--page-tokens", type=int, default=8)
    ap.add_argument("--pages-per-slot", type=int, default=0,
                    help="0 = sized from prompt+gen length")
    ap.add_argument("--n-pages", type=int, default=0,
                    help="0 = batch * pages_per_slot")
    ap.add_argument("--tenants", type=int, default=0,
                    help="serve through N per-tenant key domains "
                         "(--engine paged only; 0 = single-tenant)")
    ap.add_argument("--rotate-every", type=int, default=0,
                    help="rotate one tenant's keys every K ticks "
                         "(round-robin; needs --tenants)")
    ap.add_argument("--shards", type=int, default=0,
                    help="serve through an N-shard cluster engine, the "
                         "batch and the pool split across the shards "
                         "(--engine paged only; 0 = one engine)")
    ap.add_argument("--fault-tolerance", action="store_true",
                    help="contain integrity faults instead of aborting: "
                         "quarantine failing pages, recover sessions by "
                         "secure recompute, fail over a compromised shard "
                         "(--engine paged only)")
    ap.add_argument("--quiet", action="store_true",
                    help="suppress informational output")
    ap.add_argument("--json-logs", action="store_true",
                    help="one structured JSON record per log line")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="trace the ticks and the program's spans; write "
                         "Chrome trace-event JSON here (--engine paged "
                         "only)")
    ap.add_argument("--metrics-json", default=None, metavar="PATH",
                    help="write a metrics snapshot (JSON) after the run")
    ap.add_argument("--metrics-prom", default=None, metavar="PATH",
                    help="write Prometheus text exposition after the run")
    ap.add_argument("--audit-proof-out", default=None, metavar="PATH",
                    help="after the first tick, take and verify one Merkle "
                         "membership proof per session; write them and "
                         "the final root here as JSON (--engine paged "
                         "only)")
    ap.add_argument("--audit-out", default=None, metavar="PATH",
                    help="enable the hash-chained audit log; dump it "
                         "here as JSON lines (--engine paged only)")
    ap.add_argument("--slo-ttft-ms", type=float, default=0.0,
                    help="per-tenant wall-clock ttft SLO target in ms; "
                         "breaches are counted + audited "
                         "(--engine paged only)")
    ap.add_argument("--slo-p99-ticks", type=float, default=0.0,
                    help="rolling p99 tick-latency SLO target in ms "
                         "(--engine paged only)")
    ap.add_argument("--http-port", type=int, default=0,
                    help="serve /healthz (SLO health JSON) and /metrics "
                         "(Prometheus text) on 127.0.0.1:PORT during "
                         "the run (--engine paged only)")
    ap.add_argument("--profile-json", default=None, metavar="PATH",
                    help="write the protection-vs-model device-cost "
                         "profile (obs/profiler.py) here after the run "
                         "(--engine paged only; runs one decode call per "
                         "bucket on scratch copies of the pool)")
    ap.add_argument("--ckpt-dir", default=None,
                    help="serve the newest secure checkpoint in this "
                         "directory (verified with the --seed keys)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    return ap


def main(argv=None) -> dict:
    args = _parser().parse_args(argv)
    _setup_logging(args)
    if args.tenants and args.engine != "paged":
        raise SystemExit("--tenants needs --engine paged")
    if args.shards and args.engine != "paged":
        raise SystemExit("--shards needs --engine paged")
    if args.rotate_every and not args.tenants:
        raise SystemExit("--rotate-every needs --tenants (there are no "
                         "tenant keys to rotate otherwise)")
    if args.engine != "paged" and (args.trace_out or args.metrics_json
                                   or args.metrics_prom or args.audit_out
                                   or args.audit_proof_out
                                   or args.slo_ttft_ms or args.slo_p99_ticks
                                   or args.http_port or args.profile_json
                                   or args.fault_tolerance):
        raise SystemExit("--trace-out/--metrics-json/--metrics-prom/"
                         "--audit-out/--audit-proof-out/--slo-*/"
                         "--http-port/--profile-json/--fault-tolerance "
                         "need --engine paged (the simple loop has no "
                         "observability surface)")
    arch = get_arch(args.arch)
    if arch.kind == "encdec":
        raise SystemExit("use the decoder demo in examples/ for enc-dec")
    if arch.family == "vlm":
        raise SystemExit(f"{args.arch}: the serving engines pass no image "
                         "embeddings, so they serve no images (train it "
                         "with repro_torch.launch.train)")
    device = resolve_device(args.device)
    cfg = arch.make_smoke_config() if args.smoke else arch.make_config()
    specs = lm_mod.lm_specs(cfg)
    step = latest_step(args.ckpt_dir) if args.ckpt_dir else None
    if step is not None:
        path = os.path.join(args.ckpt_dir, f"step_{step:08d}")
        keys = SecureKeys.derive(args.seed, device=device)
        params, _ = load_checkpoint(path, specs, keys, device=device)
        _log("checkpoint", f"[serve] loaded + verified checkpoint {path}",
             path=path)
    else:
        params = init_params(specs, args.seed, device=device)
        _log("checkpoint", "[serve] no checkpoint: serving fresh init")
    if args.engine == "paged":
        return _serve_paged(arch, cfg, params, args, device)
    return _serve_simple(arch, cfg, params, args, device)


@torch.no_grad()
def _serve_simple(arch, cfg, params, args, device) -> dict:
    """The dense loop: one batched prefill, then one token per step
    against the dense KV cache (no pool, no protection)."""
    max_len = args.prompt_len + args.gen_len
    prefill = make_prefill_step(arch, cfg, max_len)
    decode = make_decode_step(arch, cfg)
    rng = np.random.default_rng(args.seed)
    prompts = torch.as_tensor(rng.integers(
        1, cfg.vocab, (args.batch, args.prompt_len), dtype=np.int64),
        device=device)
    logits, caches = prefill(params, {"tokens": prompts})
    tok = greedy_sample(logits)
    out = [tok]
    t0 = time.perf_counter()
    for _ in range(args.gen_len - 1):
        logits, caches = decode(params, tok, caches)
        tok = greedy_sample(logits)
        out.append(tok)
    toks = torch.cat(out, dim=1).cpu().numpy()        # syncs the card
    dt = time.perf_counter() - t0
    rate = args.batch * args.gen_len / max(dt, 1e-9)
    _log("summary", f"[serve] {args.gen_len} tokens x {args.batch} requests "
         f"({rate:.1f} tok/s on {device})",
         gen_len=args.gen_len, batch=args.batch, tok_per_s=rate)
    return {"tokens": toks, "tok_per_s": rate}


def _serve_paged(arch, cfg, params, args, device) -> dict:
    """Continuous-batching path: paged, MAC-protected KV pool, served by
    one engine or, with ``--shards``, by a cluster of shard engines."""
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
    common = dict(
        scheme=args.scheme, page_tokens=args.page_tokens,
        pages_per_slot=pages_per_slot,
        keys=SecureKeys.derive(args.seed, device=device), use_kernel=True,
        registry=registry, rotate_every=args.rotate_every,
        fault_tolerance=True if args.fault_tolerance else None,
        trace=bool(args.trace_out), audit=bool(args.audit_out),
        device=device)
    if args.shards:
        from repro_torch.serve.cluster import ClusterEngine
        eng = ClusterEngine(arch, cfg, params, shards=args.shards,
                            max_slots=-(-args.batch // args.shards),
                            n_pages=-(-n_pages // args.shards), **common)
    else:
        eng = SecureServingEngine(arch, cfg, params, max_slots=args.batch,
                                  n_pages=n_pages, **common)

    # SLO watchdogs, one per shard engine, attach only with a target or
    # the endpoint, so the tick stays untouched otherwise.
    monitors = []
    if args.slo_ttft_ms or args.slo_p99_ticks or args.http_port:
        from repro_torch.obs.slo import SLOMonitor
        for shard_eng in (eng.engines if args.shards else [eng]):
            monitors.append(SLOMonitor(
                ttft_ms=args.slo_ttft_ms or None,
                p99_tick_ms=args.slo_p99_ticks or None,
                min_stall_s=1.0).attach(shard_eng))
    server = None
    if args.http_port:
        server = _start_http(args.http_port, monitors, eng)
        _log("http", f"[serve] /healthz + /metrics on "
             f"127.0.0.1:{args.http_port}", port=args.http_port)
    if args.trace_out:
        # The program's spans go to the engine's (or cluster's) tracer,
        # inside the ticks and between them.
        trace_mod.enable(eng.tracer)
    try:
        return _drive_paged(eng, cfg, args, device, sessions, monitors)
    finally:
        if args.trace_out:
            trace_mod.disable()
        if server is not None:
            server.shutdown()
            server.server_close()


def _drive_paged(eng, cfg, args, device, sessions, monitors) -> dict:
    is_cluster = bool(args.shards)
    rng = np.random.default_rng(args.seed)
    rids = []
    for i in range(args.batch):
        prompt = list(map(int, rng.integers(1, cfg.vocab, args.prompt_len)))
        session = sessions[i % len(sessions)] if sessions else None
        rids.append(eng.submit(prompt=prompt, max_new_tokens=args.gen_len,
                               session=session))
    proofs = None
    if args.audit_proof_out:
        # One tick admits the batch; every session is then resident and
        # proves membership against the live root, checked here exactly
        # as a tenant would, keyless.
        eng.step()
        proofs = _capture_audit_proofs(eng, sessions, is_cluster)
        _log("audit-proof", f"[serve] {proofs['verified']} session proofs "
             f"captured + verified at tick {proofs['tick']}",
             tick=proofs["tick"], proofs=proofs["verified"])
    t0 = time.perf_counter()
    done, sig = _run_graceful(eng, is_cluster=is_cluster)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    if sig is not None:
        n_done = sum(1 for r in rids if eng.requests[r].state == "finished")
        _log("shutdown", f"[serve] signal {sig}: graceful shutdown after "
             f"tick {eng.tick} ({n_done}/{args.batch} requests finished); "
             f"flushing observability artifacts",
             signal=int(sig), tick=eng.tick, finished=n_done,
             requests=args.batch)
    n_tokens = sum(len(eng.requests[r].generated) for r in rids)
    rate = n_tokens / max(dt, 1e-9)
    stats = (dict(eng.engine_stats, **eng.stats) if is_cluster
             else dict(eng.stats))
    mode = f"paged/{args.scheme}" + (
        f"/{args.tenants} tenants" if args.tenants else "") + (
        f"/{args.shards} shards" if is_cluster else "")
    extra = f", {stats['migrations']} migrations" if is_cluster else ""
    mac_ok = eng.deferred_check()
    _log("summary", f"[serve] {mode}: {n_tokens} tokens over {args.batch} "
         f"requests ({rate:.1f} tok/s on {device}), "
         f"{stats['preemptions']} preemptions, {stats['rotations']} key "
         f"rotations{extra}, deferred {'root' if is_cluster else 'pool'} "
         f"MAC {'OK' if mac_ok else 'FAIL'}",
         mode=mode, tokens=n_tokens, requests=args.batch, tok_per_s=rate,
         ticks=eng.tick, stats=stats, deferred_mac_ok=bool(mac_ok))
    if done.latency:
        _log("latency", f"[serve] latency (ticks): "
             f"ttft p50={done.latency['p50_ttft_ticks']:.1f} "
             f"p95={done.latency['p95_ttft_ticks']:.1f} "
             f"p99={done.latency['p99_ttft_ticks']:.1f}", **done.latency)
    # The last stall poll comes now: idle time after the run is no stall.
    for m in monitors:
        m.check_stalled()
    _dump_obs(eng, args)
    if sig is None and all(eng.requests[r].state == "finished"
                           for r in rids):
        toks = np.asarray([done[r].generated for r in rids], np.int32)
    else:
        # Interrupted, or a session lost under fault tolerance: the
        # per-request emission lengths are ragged.
        toks = [list(map(int, eng.requests[r].generated)) for r in rids]
    out = {"tokens": toks, "tok_per_s": rate, "stats": stats,
           "latency": done.latency, "deferred_mac_ok": bool(mac_ok)}
    if args.audit_proof_out:
        if is_cluster:
            from repro_torch.serve import merkle_pool as mkp
            pairs = eng.sharded.merkle_roots()
            proofs["final"] = {
                "cluster_root": mkp.compress_roots(pairs).hex(),
                "shard_roots": [[s, r.hex()] for s, r in pairs]}
        else:
            proofs["final"] = {"root": eng.merkle.root_hex()}
        with open(args.audit_proof_out, "w") as f:
            json.dump(proofs, f, indent=1)
        _log("audit-proof", f"[serve] audit-proof bundle "
             f"({len(proofs['proofs'])} proofs) -> {args.audit_proof_out}",
             path=args.audit_proof_out, proofs=len(proofs["proofs"]))
        out["audit_proofs"] = proofs
    if monitors:
        from repro_torch.obs.slo import merge_health
        health = merge_health([m.health() for m in monitors])
        _log("slo", f"[serve] SLO health: {health['status']}", health=health)
        if any(m.hard_breach for m in monitors):
            _log("slo", "[serve] hard SLO breach (integrity alarm, stuck "
                 "tick or a session lost) — exiting non-zero")
            raise SystemExit(3)
    return out


def _run_graceful(eng, *, is_cluster: bool):
    """Drive the engine (or cluster) tick by tick so SIGINT/SIGTERM drain
    cleanly.

    A signal only sets a flag: the tick in flight finishes (no torn
    pool state, the audit chain stays whole) and the loop stops before
    the next.  Returns ``(result, signum or None)``; the previous
    handlers are restored."""
    import signal

    from repro_torch.serve.engine import RunResult, latency_percentiles

    got: list = []
    prev = {}
    for s in (signal.SIGINT, signal.SIGTERM):
        try:
            prev[s] = signal.signal(s, lambda signum, frame:
                                    got.append(signum))
        except ValueError:  # not the main thread
            pass

    def busy() -> bool:
        if is_cluster:
            return eng._busy()
        return bool(eng._n_waiting()
                    or any(s is not None for s in eng.slots))

    try:
        for _ in range(100_000):
            if got or not busy():
                break
            eng.step()
        else:
            raise RuntimeError("serve loop exceeded max_ticks")
        if got:
            result = RunResult({rid: req for rid, req in eng.requests.items()
                                if req.state == "finished"})
            result.latency = latency_percentiles(eng.requests.values())
            return result, got[0]
        # Drained: run() makes the end-of-run checks (and under fault
        # tolerance keeps ticking if containment requeued work).
        return eng.run(), None
    finally:
        for s, h in prev.items():
            signal.signal(s, h)


def _start_http(port: int, monitors: list, eng):
    """Stdlib ``/healthz`` + ``/metrics`` on 127.0.0.1, in a daemon
    thread.  ``/healthz`` is the merged health of the monitors (the
    worst shard wins) and answers 503 once one is failing (integrity
    alarm, stuck tick or a lost session), so a probe can pull the
    instance; ``/metrics`` is the engine's Prometheus text (a cluster's
    carries every shard's, labeled ``shard=``)."""
    import threading
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    from repro_torch.obs.slo import merge_health

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802 - http.server API
            route = self.path.split("?")[0]
            if route == "/healthz":
                for m in monitors:
                    m.check_stalled()
                doc = merge_health([m.health() for m in monitors])
                code = 503 if doc["status"] == "failing" else 200
                body = json.dumps(doc, indent=2, sort_keys=True).encode()
                ctype = "application/json"
            elif route == "/metrics":
                body = eng.prometheus().encode()
                code, ctype = 200, "text/plain; version=0.0.4"
            else:
                body, code, ctype = b"not found\n", 404, "text/plain"
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):  # quiet by default
            pass

    server = ThreadingHTTPServer(("127.0.0.1", port), Handler)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server


def _capture_audit_proofs(eng, sessions, is_cluster: bool) -> dict:
    """One audit proof per session (the whole pool single-tenant; a
    cluster gives one per shard holding the session, each chained to
    the cluster root), each verified in place; raises on the first that
    fails."""
    from repro_torch.serve import merkle_pool as mkp
    proofs = []
    for session in (sessions or [None]):
        got = eng.audit_proof(session)
        proofs.extend(got if is_cluster else [got])
    for p in proofs:
        mkp.verify_proof(p, expected_root=p.root, tenant=p.tenant)
    return {"tick": eng.tick, "verified": len(proofs),
            "proofs": [p.to_dict() for p in proofs]}


def _dump_obs(eng, args) -> None:
    """Write the requested observability artifacts after a paged run."""
    if args.metrics_json:
        with open(args.metrics_json, "w") as f:
            json.dump(eng.snapshot(), f, indent=2, sort_keys=True)
        _log("metrics", f"[serve] metrics snapshot -> {args.metrics_json}",
             path=args.metrics_json)
    if args.metrics_prom:
        with open(args.metrics_prom, "w") as f:
            f.write(eng.prometheus())
        _log("metrics", f"[serve] prometheus text -> {args.metrics_prom}",
             path=args.metrics_prom)
    if args.trace_out:
        doc = eng.export_trace(args.trace_out)
        _log("trace", f"[serve] {len(doc['traceEvents'])} trace events -> "
             f"{args.trace_out}",
             path=args.trace_out, events=len(doc["traceEvents"]))
    if args.profile_json:
        doc = eng.profile()
        with open(args.profile_json, "w") as f:
            json.dump(doc, f, indent=2, sort_keys=True)
        _log("profile", f"[serve] device-cost profile -> "
             f"{args.profile_json}", path=args.profile_json)
    if args.audit_out:
        eng.audit.dump(args.audit_out)
        chain_ok = eng.audit.verify_chain()
        _log("audit", f"[serve] {len(eng.audit)} audit records "
             f"(chain {'OK' if chain_ok else 'BROKEN'}) -> {args.audit_out}",
             path=args.audit_out, records=len(eng.audit), chain_ok=chain_ok)


if __name__ == "__main__":
    main(sys.argv[1:])
