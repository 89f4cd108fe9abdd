"""The training cell: the port's secure train step on seeded batches.

Set-up builds one object, the secure train step with its model, its
protected weights and its AdamW state (``make_secure_train_step`` under
``SecureExecutor``), and drives it through its first ``checked_steps``
steps on the window's own feed; those steps are also the warm-up.  The
window then runs the same object on for ``--seconds``; each step's entry
check must pass.  ``train_step_ms`` is the window's seconds over the
steps it completed.  With ``--trace 1`` two profiled segments follow:
the card alone, then the card and the host with the layers' ranges.

``correct``: once the window has closed and the peak memory is read,
the program's state is freed and the plain float32 reference that the
configuration names (``perfbench/reference/<reference>.py``; the
weights' layout and the FLOPs are its ``family``'s) runs the same
checked steps from the same weights on the same batches.  Compared,
each against its limit: each step's loss; the norm of each leaf's first
gradient as the optimizer took it (worked out from the first moment
after one step); the norm of each leaf's change over the checked steps,
as the protected weights hold it after the round trip through
unprotect.  A norm's gap is taken by the worst leaf, against the
reference's norm of that leaf or of the median leaf, whichever is
larger.
"""

from __future__ import annotations

import gc
import importlib
import math
import statistics
import time

import torch

from perfbench import costs, tracing, traffic, weights
from perfbench.harness import Collections, check, chunk_rates, device_info
from perfbench.readings import Readings

TARGETS = [
    ("train", "repro_torch.train.train_step:value_and_grad"),
    ("optimizer", "repro_torch.train.train_step:adamw_update"),
    ("crossing", "repro_torch.core.secure_exec:SecureExecutor.protect"),
    ("crossing", "repro_torch.core.secure_exec:SecureExecutor.unprotect"),
]


def worst_leaf_gap(prog: dict, ref: dict, keep=None) -> tuple:
    """``(gap, leaf)``: the largest ``|prog - ref|`` of a leaf's norm
    over the larger of the reference's norm of that leaf and of the
    median leaf, over the leaves in ``keep`` (all by default)."""
    names = [k for k in ref if keep is None or k in keep]
    floor = statistics.median(ref[k] for k in ref)
    worst = (0.0, None)
    for k in names:
        gap = abs(prog[k] - ref[k]) / max(ref[k], floor, 1e-30)
        if gap > worst[0]:
            worst = (gap, k)
    return worst


def moving_leaves(grad_norms: dict) -> set:
    """Leaves whose reference gradient is more than a thousandth of the
    median leaf's: the others move under Adam by round-off alone."""
    floor = statistics.median(grad_norms.values()) * 1e-3
    return {k for k, g in grad_norms.items() if g > floor}


class Program:
    """The secure train step and its state, built once from the seed."""

    def __init__(self, cell, seed: int, device):
        from repro_torch.core.secure_exec import SecureExecutor
        from repro_torch.core.secure_memory import SecureKeys
        from repro_torch.train.optimizer import AdamWConfig, init_opt_state
        from repro_torch.train.train_step import make_secure_train_step
        c, d = cell.config, cell.config["deployment"]
        self.c, self.wl, self.seed, self.device = c, cell.workload, seed, device
        self.family = fam = cell.family
        arch, pcfg = fam.program_config(c)
        o = {k: v for k, v in c["optimizer"].items() if k != "kind"}
        self.opt_cfg = AdamWConfig(**o)
        params = fam.program_tree(weights.make(fam.shapes(c), seed, device))
        self.opt = init_opt_state(params, self.opt_cfg)
        self.executor = SecureExecutor(
            scheme=d["scheme"], keys=SecureKeys.derive(seed % (1 << 32),
                                                       device=device))
        self.region = self.executor.region_spec(params)
        self.step_fn = make_secure_train_step(arch, pcfg, self.opt_cfg,
                                              self.executor, self.region)
        self.state = self.executor.protect(params, self.region, step=0)
        self.steps = 0
        self.failed = 0

    def step(self) -> float:
        batch = traffic.train_batch(self.wl, self.c, self.seed, self.steps,
                                    self.device)
        self.state, self.opt, m = self.step_fn(self.state, self.opt, batch,
                                               self.steps)
        self.steps += 1
        if not bool(m["integrity_ok"]):
            self.failed += 1
            raise RuntimeError(f"INTEGRITY FAILURE at step {self.steps - 1}")
        return float(m["loss"])

    def run_steps(self, n: int) -> None:
        for _ in range(n):
            self.step()

    def first_grad_norms(self) -> dict:
        """Each leaf's clipped first gradient, from the first moment."""
        mu = self.family.from_program_tree(self.opt.mu)
        return {k: float(v.float().norm()) / (1 - self.opt_cfg.b1)
                for k, v in mu.items()}

    def change_norms(self) -> dict:
        """Each leaf's change since the seed's weights, as the protected
        state holds it (one unprotect, outside the window)."""
        params, ok = self.executor.unprotect(self.state, self.region)
        if not bool(ok):
            raise RuntimeError("the protected weights failed their check")
        now = self.family.from_program_tree(params)
        start = weights.make(self.family.shapes(self.c), self.seed,
                             self.device)
        out = {k: float((now[k].float() - start[k].float()).norm())
               for k in start}
        return out


def run(cell, *, seed, seconds, trace, device, t_process, log) -> dict:
    wl = cell.workload
    if device.type == "cuda":
        from repro_torch.kernels import build as kbuild
        kbuild.build()
    ranges = tracing.Ranges(TARGETS) if trace else None
    prog = Program(cell, seed, device)
    n_check = wl["checked_steps"]
    losses, grads, change, err = [], {}, {}, None
    t0 = t1 = None
    try:
        for i in range(n_check):
            losses.append(prog.step())
            if i == 0:
                grads = prog.first_grad_norms()
        change = prog.change_norms()
        if device.type == "cuda":
            torch.cuda.synchronize()
        setup_s = time.perf_counter() - t_process
        t0 = time.perf_counter()
        start_steps = prog.steps
        ends = []
        with Collections() as collections:
            while time.perf_counter() - t0 < seconds:
                prog.step()
                ends.append(time.perf_counter())
            if device.type == "cuda":
                torch.cuda.synchronize()
            t1 = time.perf_counter()
        n_window = prog.steps - start_steps
    except RuntimeError as e:
        err = e
        log(f"the run failed: {e!r}")
        setup_s = time.perf_counter() - t_process
        n_window = 0
    e2e = {"setup_s": setup_s}
    if n_window:
        e2e["train_step_ms"] = (t1 - t0) / n_window * 1e3
    readings = breakdown = None
    dev_extra = {}
    if trace and err is None:
        readings = _trace(prog, ranges, t1 - t0, n_window)
        seg = readings.device
        dev_extra = {"busy_s": seg.busy_s(), "window_s": seg.wall_s}
        breakdown = {"device_ops": seg.top_ops(),
                     "idle_gaps": readings.layers.idle_gaps()}
    if ranges is not None:
        ranges.close()
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    attempted, failed = prog.steps, prog.failed + (err is not None)
    del prog
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks = [check("failed_steps", failed, 0, failed == 0)]
    if err is None:
        ref = reference_readings(cell, seed, device, n_check)
        checks += compare(wl["correct"], losses, grads, change, ref)
    return {"correct": all(ch["ok"] for ch in checks) and err is None,
            "attempted": attempted, "failed": failed, "end_to_end": e2e,
            "readings": readings, "breakdown": breakdown, "checks": checks,
            "device": {**device_info(device, peak), **dev_extra},
            "extra": {"window_steps": n_window, "losses": losses,
                      **({} if err else {
                          "gc": collections.reading(),
                          "chunk_steps_s": chunk_rates(ends, t0, t1)})}}


def reference_readings(cell, seed, device, n_steps, precision="float32",
                       rows_used=None) -> dict:
    """The reference's checked steps from the seed's weights and
    batches."""
    c, wl = cell.config, cell.workload
    ref = importlib.import_module(f"perfbench.reference.{c['reference']}")
    stored = weights.make(cell.family.shapes(c), seed, device)
    batches = [traffic.train_batch(wl, c, seed, i, device)
               for i in range(n_steps)]
    return ref.train_steps(c, stored, batches, precision,
                           rows=wl["reference_rows"], rows_used=rows_used)


def readings_of(losses, grads, change, ref) -> dict:
    """The numbers compared: the worst step's loss gap (relative), the
    worst leaf's first-gradient gap, the worst moving leaf's change
    gap."""
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(losses,
                                                       ref["losses"]))
    grad_gap, grad_leaf = worst_leaf_gap(grads, ref["grad_norms"])
    change_gap, change_leaf = worst_leaf_gap(
        change, ref["change_norms"], moving_leaves(ref["grad_norms"]))
    return {"loss_gap": loss_gap, "grad_norm_gap": grad_gap,
            "grad_norm_leaf": grad_leaf, "change_norm_gap": change_gap,
            "change_norm_leaf": change_leaf}


def compare(limits, losses, grads, change, ref) -> list:
    r = readings_of(losses, grads, change, ref)
    return [check(name, r[name], limits[name], r[name] <= limits[name])
            for name in ("loss_gap", "grad_norm_gap", "change_norm_gap")]


def _trace(prog: Program, ranges, window_s: float, n_window: int) -> Readings:
    t = prog.wl["trace"]
    device = tracing.profile(prog.run_steps, t["device_steps"], host=False)
    layers = tracing.profile(prog.run_steps, t["layer_steps"], host=True,
                             layers=set(ranges.layers), ranges=ranges)
    c, wl, d = prog.c, prog.wl, prog.c["deployment"]
    sizes = [(math.prod(shape), 4 if dtype == "float32" else 2)
             for shape, _, dtype in prog.family.shapes(c).values()]
    units = t["layer_steps"]
    moment = 4 if c["optimizer"]["state_dtype"] == "float32" else 2
    work = {
        "optimizer": (units * sum(costs.adamw_bytes(n, b, b, moment)
                                  for n, b in sizes), 0.0),
        "crossing": tuple(units * x for x in costs.weights_crossing_work(
            sum(n * b for n, b in sizes), d["block_bytes"])),
    }
    flops = n_window * prog.family.train_flops(
        c, wl["batch"], wl["src_frames"], wl["tgt_tokens"])
    return Readings(window_s=window_s, units=n_window,
                    device=device, layers=layers, ranges=ranges,
                    targets=TARGETS, work=work, model_flops=flops)

