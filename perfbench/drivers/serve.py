"""Serving cells: the paged secure engine under a closed or an open loop.

The entry is ``SecureServingEngine.submit`` and ``.step``, driven from
here as a client would: a request's tokens are stamped with the host
clock at the end of the tick that produced them (each tick syncs on its
tokens), a request's arrival with its scheduled time.

Set-up builds the kernels, draws the weights on the card, builds the
engine as the configuration's deployment states it, and runs the cell's
own traffic for ``warmup_ticks`` ticks (closed loop) or ``warmup_s``
seconds of its schedule (open loop), which exercises the prefill and
decode shapes the window uses.  The window follows on the same engine
and stream.  With ``--trace 1`` two profiled segments follow the window:
the card alone, then the card and the host with the layers' ranges.

``correct``: once the window has closed and the peak memory is read,
the deferred pool MAC and the Merkle root are checked, the engine is
freed, and a sample of the requests the window finished (drawn from the
seed, the longest always in it) is replayed through the plain float32
reference: the widest gap by which a served token's reference logit
lies below the reference's best must stay under the cell's limit.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import math
import time

import numpy as np
import torch

from perfbench import costs, stats, tracing, traffic, weights
from perfbench.harness import Collections, check, chunk_rates, device_info
from perfbench.readings import Readings

# The layers' ranges of a traced run: (layer, "module:attribute").
TARGETS = [
    ("pageio", "repro_torch.serve.kv_pages:PageIO.read"),
    ("pageio", "repro_torch.serve.kv_pages:PageIO.write"),
    ("pageio", "repro_torch.serve.kv_pages:PageIO.write_dirty"),
    ("pageio", "repro_torch.serve.kv_pages:PageIO.write_prefill"),
    ("pageio", "repro_torch.serve.kv_pages:PageIO.reseal"),
    ("pageio", "repro_torch.serve.kv_pages:PageIO.read_raw"),
    ("pageio", "repro_torch.serve.engine:SecureServingEngine._reseal_slot"),
    ("model", "repro_torch.models.lm:lm_prefill"),
    ("model", "repro_torch.models.lm:lm_decode"),
    ("engine", "repro_torch.serve.engine:SecureServingEngine._tick_begin"),
    ("engine",
     "repro_torch.serve.engine:SecureServingEngine._decode_dispatch"),
    ("engine", "repro_torch.serve.engine:SecureServingEngine._decode_collect"),
    ("engine", "repro_torch.serve.engine:SecureServingEngine._tick_end"),
]
SPANS = ("tick_begin", "decode_dispatch", "decode_collect", "tick_end")


def program_config(c: dict):
    """``(arch, LMConfig)`` of the port with the file's sizes."""
    from repro_torch.configs import get_arch
    arch = get_arch(c["port_arch"])
    cfg = dataclasses.replace(
        arch.make_config(), n_layers=c["num_hidden_layers"],
        d_model=c["hidden_size"], n_heads=c["num_attention_heads"],
        n_kv=c["num_key_value_heads"], head_dim=c["head_dim"],
        d_ff=c["intermediate_size"], vocab=c["vocab_size"],
        dtype=c["torch_dtype"], tie_embeddings=c["tie_word_embeddings"],
        gated_ffn=c["hidden_act"] == "silu")
    return arch, cfg


class Traffic:
    """Requests in flight and what the clock saw of them."""

    def __init__(self, eng, wl: dict, c: dict, seed: int, sessions,
                 work: dict):
        self.eng = eng
        self.work = work              # pages counted in a traced segment
        self.closed = wl["kind"] == "closed_loop"
        self.schedule = ([] if self.closed else traffic.arrivals(
            wl, seed, wl["warmup_s"] + wl["stream_s"]))
        n = (wl["stream_requests"] if self.closed
             else len(self.schedule) + 1)
        self.stream = traffic.Requests(wl, c["vocab_size"], seed, n)
        self.sessions = sessions
        self.recs: dict = {}          # rid -> record
        self.active: set = set()
        self.idle_clients = wl.get("clients", 0)
        self.next_due = 0
        self.origin = None
        self.ticks: list = []         # host time at each tick's end

    def _submit(self, due: float, now: float) -> None:
        prompt, n_new, tenant = self.stream.next()
        rec = {"prompt": prompt, "n_new": n_new, "tenant": tenant,
               "due": due, "submit": now, "first": None, "times": [],
               "done": None, "failed": False, "rid": None}
        try:
            rec["rid"] = self.eng.submit(
                prompt=prompt, max_new_tokens=n_new,
                session=None if self.sessions is None
                else self.sessions[tenant])
        except (ValueError, PermissionError) as err:
            rec["failed"] = True
            rec["error"] = repr(err)
            self.recs[f"refused-{len(self.recs)}"] = rec
            return
        self.recs[rec["rid"]] = rec
        self.active.add(rec["rid"])

    def tick(self) -> None:
        """Submit what is due, run one engine tick, stamp its tokens."""
        now = time.perf_counter()
        if self.origin is None:
            self.origin = now
        if self.closed:
            while self.idle_clients:
                self.idle_clients -= 1
                self._submit(now, now)
        else:
            while (self.next_due < len(self.schedule)
                   and self.origin + self.schedule[self.next_due] <= now):
                self._submit(self.origin + self.schedule[self.next_due], now)
                self.next_due += 1
            if not self.active:
                if self.next_due >= len(self.schedule):
                    raise RuntimeError("the arrival schedule ran out: "
                                       "raise the cell's stream_s")
                time.sleep(max(0.0, self.origin
                               + self.schedule[self.next_due]
                               - time.perf_counter()))
                return
        finished = self.eng.step()
        t = time.perf_counter()
        self.ticks.append(t)
        reqs = self.eng.requests
        for rid in self.active:
            rec = self.recs[rid]
            new = len(reqs[rid].generated) - len(rec["times"])
            if new > 0:
                rec["times"].extend([t] * new)
                if rec["first"] is None:
                    rec["first"] = t
        for req in finished:
            rec = self.recs[req.rid]
            rec["done"] = t
            rec["generated"] = list(req.generated)
            self.active.discard(req.rid)
            if self.closed:
                self.idle_clients += 1

    def run_until(self, t_end: float) -> float:
        while time.perf_counter() < t_end:
            self.tick()
        return self.ticks[-1] if self.ticks else time.perf_counter()

    def run_ticks(self, n: int) -> None:
        start = len(self.ticks)
        while len(self.ticks) - start < n:
            self.tick()


def _end_to_end(tr: Traffic, t0: float, t1: float) -> tuple:
    """``(metrics, attempted, failed, extra)`` of the window."""
    recs = list(tr.recs.values())
    tokens = sum(1 for r in recs for t in r["times"] if t0 < t <= t1)
    gaps = [g for r in recs for g in stats.token_gaps(r["times"], t0, t1)]
    window = t1 - t0
    out = {"decode_tok_s": tokens / window} if window > 0 else {}
    if gaps:
        out["itl_p95_ms"] = stats.percentile(gaps, 95) * 1e3
    extra = {"window_s": window, "ticks": sum(1 for t in tr.ticks
                                              if t0 < t <= t1),
             "tokens": tokens, "gaps": len(gaps)}
    if tr.closed:
        counted = [r for r in recs if t0 <= r["submit"] < t1]
    else:
        counted = [r for r in recs if t0 <= r["due"] < t1]
        ttft = stats.ttft_values(counted, t1)
        if ttft:
            out["ttft_p90_ms"] = stats.percentile(ttft, 90) * 1e3
            extra["ttft_p50_ms"] = stats.percentile(ttft, 50) * 1e3
        late = [r["submit"] - r["due"] for r in counted]
        if late:
            extra["generator_lateness_ms"] = {
                "p50": stats.percentile(late, 50) * 1e3,
                "p95": stats.percentile(late, 95) * 1e3,
                "max": max(late) * 1e3}
        def backlog(t):
            return sum(1 for r in recs if r["due"] <= t and not r["failed"]
                       and (r["first"] is None or r["first"] > t))

        extra["backlog"] = [backlog(t0 + k * window / 4) for k in range(5)]
    extra["finished"] = sum(1 for r in recs
                            if r["done"] is not None and t0 < r["done"] <= t1)
    failed = sum(1 for r in counted if r["failed"])
    return out, len(counted), failed, extra


def _model_flops(c: dict, tr: Traffic, t0: float, t1: float) -> float:
    """The window's model FLOPs: each prefill whose first token landed
    in the window (its prompt, pads excluded), each decoded token at its
    context."""
    total = 0.0
    for r in tr.recs.values():
        lp = len(r["prompt"])
        for k, t in enumerate(r["times"]):
            if not t0 < t <= t1:
                continue
            total += (costs.lm_prefill_flops(c, lp) if k == 0
                      else costs.lm_decode_flops(c, lp + k))
    return total


def sample_requests(tr: Traffic, t0: float, t1: float, k: int,
                    seed: int) -> list:
    """Up to ``k`` requests the window finished, drawn from the seed,
    the longest (prompt + served tokens) always among them."""
    done = sorted((r for r in tr.recs.values()
                   if r["done"] is not None and t0 < r["done"] <= t1),
                  key=lambda r: r["rid"])
    if not done:
        return []
    longest = max(done, key=lambda r: (len(r["prompt"]) + len(r["generated"]),
                                       -r["rid"]))
    rest = [r for r in done if r is not longest]
    rng = np.random.default_rng([int(seed), 4])
    pick = rng.permutation(len(rest))[: k - 1]
    return [longest] + [rest[i] for i in sorted(pick)]


def logit_gaps(c: dict, w: dict, sample: list, device,
               precisions=("float32",)) -> dict:
    """Per precision, the widest gap over the sample's served tokens.

    ``float32``: the reference's best logit minus its logit of the
    served token.  Any other precision (the control): the same gap of
    the token that precision puts first at each position."""
    ref = importlib.import_module(f"perfbench.reference.{c['reference']}")
    widest = {p: 0.0 for p in precisions}
    for r in sample:
        gen = r["generated"]
        toks = torch.tensor(r["prompt"] + gen[:-1], dtype=torch.int64,
                            device=device)
        pos = torch.arange(len(r["prompt"]) - 1, toks.shape[0],
                           device=device)
        served = torch.tensor(gen, dtype=torch.int64, device=device)
        base = ref.logits(c, w, toks, pos, "float32")
        best = base.max(-1).values
        for p in precisions:
            if p == "float32":
                pick = served
            else:
                pick = ref.logits(c, w, toks, pos, p).argmax(-1)
            gap = (best - base.gather(1, pick[:, None])[:, 0]).max().item()
            widest[p] = max(widest[p], gap)
    return widest


def build(cell, seed: int, device, trace: bool):
    """Set-up shared by the runs and the calibration: ``(engine,
    traffic, weights, ranges)``."""
    from repro_torch.core.secure_memory import SecureKeys
    from repro_torch.serve.engine import SecureServingEngine
    c, wl = cell.config, cell.workload
    d = c["deployment"]
    if device.type == "cuda":
        from repro_torch.kernels import build as kbuild
        kbuild.build()
    work = {"read": 0, "written": 0}
    ranges = (tracing.Ranges(TARGETS, on_call=_work_hooks(work)) if trace
              else None)
    w = weights.make(weights.lm_shapes(c), seed, device)
    arch, pcfg = program_config(c)
    registry = sessions = None
    if wl.get("tenant_shares"):
        from repro_torch.tenancy import KeyHierarchy, TenantRegistry
        n = len(wl["tenant_shares"])
        registry = TenantRegistry(KeyHierarchy(seed % (1 << 32),
                                               device=device),
                                  max_tenants=n)
        for t in range(n):
            registry.register(f"tenant-{t}")
        sessions = [registry.open_session(f"tenant-{t}") for t in range(n)]
    eng = SecureServingEngine(
        arch, pcfg, weights.lm_program_tree(w), scheme=d["scheme"],
        use_kernel=d["use_kernel"], max_slots=wl["max_slots"],
        page_tokens=d["page_tokens"], pages_per_slot=wl["pages_per_slot"],
        n_pages=wl["n_pages"],
        keys=SecureKeys.derive(seed % (1 << 32), device=device),
        defer_interval=d["defer_interval"],
        verify_every_step=d["verify_every_step"], registry=registry,
        rotate_every=wl.get("rotate_every", 0), merkle=d["merkle"],
        trace=trace, device=device)
    return eng, Traffic(eng, wl, c, seed, sessions, work), w, ranges


def _work_hooks(work: dict) -> dict:
    """Count into ``work`` the pages each crossing of a traced segment
    requires: the window read, each active slot's dirty page, each
    prefilled page, each resealed page read and written."""
    def read(io, pool, page_table, *a, **kw):
        work["read"] += int(page_table.numel())

    def dispatch(eng, active_idx, *a, **kw):
        work["written"] += len(active_idx)

    def prefill(io, pool, page_ids, dense_leaves, n_write_pages, *a, **kw):
        work["written"] += int(n_write_pages)

    def reseal(eng, slot_idx, page_pos, *a, **kw):
        work["read"] += len(page_pos)
        work["written"] += len(page_pos)

    return {
        "repro_torch.serve.kv_pages:PageIO.read": read,
        "repro_torch.serve.engine:SecureServingEngine._decode_dispatch":
            dispatch,
        "repro_torch.serve.kv_pages:PageIO.write_prefill": prefill,
        "repro_torch.serve.engine:SecureServingEngine._reseal_slot": reseal,
    }


def run(cell, *, seed, seconds, trace, device, t_process, log,
        controls=()) -> dict:
    """One run; ``controls`` (precisions of the reference put in the
    program's place) adds their widest gaps on the same sample."""
    c, wl = cell.config, cell.workload
    eng, tr, w, ranges = build(cell, seed, device, trace)
    failed_err = None
    try:
        if tr.closed:
            tr.run_ticks(wl["warmup_ticks"])
        else:
            tr.tick()
            tr.run_until(tr.origin + wl["warmup_s"])
        if device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter() if tr.closed else tr.origin + wl["warmup_s"]
        setup_s = time.perf_counter() - t_process
        with Collections() as collections:
            t1 = tr.run_until(t0 + seconds)
    except Exception as err:      # an IntegrityError or a crash: not correct
        failed_err = err
        t0 = t1 = time.perf_counter()
        setup_s = t0 - t_process
    e2e, attempted, failed, extra = _end_to_end(tr, t0, t1)
    e2e["setup_s"] = setup_s
    if failed_err is None:
        extra["gc"] = collections.reading()
        extra["chunk_tok_s"] = chunk_rates(
            [t for r in tr.recs.values() for t in r["times"]], t0, t1)
    readings = None
    breakdown = None
    dev_extra = {}
    if trace and failed_err is None:
        readings = _trace(cell, eng, tr, ranges, t0, t1)
        seg = readings.device
        dev_extra = {"busy_s": seg.busy_s(), "window_s": seg.wall_s}
        breakdown = {"device_ops": seg.top_ops(),
                     "idle_gaps": readings.layers.idle_gaps()}
        extra["unattributed_kernels"] = readings.layers.unattributed
    if ranges is not None:
        ranges.close()
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    checks = []
    deferred_ok = merkle_ok = False
    if failed_err is None:
        from repro_torch.serve import kv_pages as kvp
        deferred_ok = bool(eng.deferred_check())
        merkle_ok = bool(eng.merkle.verify_against(
            kvp.merkle_leaf_macs(eng.pool, eng.spec)))
    else:
        log(f"the window failed: {failed_err!r}")
    limit = wl["correct"]["max_logit_gap"]
    sample = sample_requests(tr, t0, t1, wl["correct"]["sample_requests"],
                             seed)
    del eng
    tr.eng = None
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    gaps = (logit_gaps(c, w, sample, device, ("float32",) + tuple(controls))
            if sample else {})
    gap = gaps.get("float32", math.inf)
    if controls:
        extra["control_gaps"] = {p: gaps.get(p) for p in controls}
    served = sum(len(r["generated"]) for r in sample)
    checks.append(check("failed_requests", failed + (failed_err is not None),
                        0, failed == 0 and failed_err is None))
    checks.append(check("deferred_pool_mac_ok", int(deferred_ok), 1,
                        deferred_ok))
    checks.append(check("merkle_root_ok", int(merkle_ok), 1, merkle_ok))
    checks.append(check("sampled_served_tokens", served, 1, served >= 1))
    checks.append(check("max_logit_gap", gap, limit, gap <= limit))
    extra["sample"] = [{"prompt": len(r["prompt"]),
                        "served": len(r["generated"])} for r in sample]
    out = {"correct": all(ch["ok"] for ch in checks),
           "attempted": attempted, "failed": failed, "end_to_end": e2e,
           "readings": readings, "breakdown": breakdown, "checks": checks,
           "device": {**device_info(device, peak), **dev_extra},
           "extra": extra}
    return out


def _trace(cell, eng, tr: Traffic, ranges, t0: float, t1: float) -> Readings:
    """The traced segments after the window, and the readings."""
    c, wl = cell.config, cell.workload
    spans: dict = {}
    # The engine counts its ticks with Traffic's, one each.
    window_ticks = {i + 1 for i, t in enumerate(tr.ticks) if t0 < t <= t1}
    for e in eng.tracer.events():
        if e["name"] in SPANS and e.get("args", {}).get("tick") in \
                window_ticks:
            spans[e["name"]] = spans.get(e["name"], 0.0) + e["dur"] / 1e6
    t = wl["trace"]
    device = tracing.profile(tr.run_ticks, t["device_ticks"], host=False)
    tr.work.update(read=0, written=0)
    layers = tracing.profile(tr.run_ticks, t["layer_ticks"], host=True,
                             layers=set(ranges.layers), ranges=ranges)
    work = {"pageio": costs.page_crossing_work(
        c, c["deployment"], tr.work["read"], tr.work["written"])}
    return Readings(window_s=t1 - t0,
                    units=len(window_ticks), spans=spans,
                    device=device, layers=layers, ranges=ranges,
                    targets=TARGETS, work=work,
                    model_flops=_model_flops(c, tr, t0, t1))

