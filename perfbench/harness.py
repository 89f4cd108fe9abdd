"""The benchmark's core: find a cell by name, run it, print its line.

Everything that belongs to one configuration, one traffic mix or one
per-layer metric sits in a file of its own, found by the name that
``BENCHMARK.json`` gives:

* ``configs[].file``: the configuration's sizes and its deployment, with
  the plain reference it is checked against (``reference`` names a
  module of ``perfbench/reference/``);
* ``perfbench/workloads/<cell>.json``: the traffic mix and the cell's
  limits; its ``kind`` picks the driver (``perfbench/drivers/``);
* ``perfbench/metrics/<metric>.py``: a ``read(r)`` that takes the metric
  from the run's readings (:class:`perfbench.readings.Readings`) and
  returns a number, or None when there is nothing to read.

A cell is added with data files alone; a metric with its reader.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import math
import sys
import time
from pathlib import Path

PERFBENCH = Path(__file__).resolve().parent
FORBIDDEN_TOP = ("jax", "jaxlib", "flax", "repro")
DRIVERS = {"closed_loop": "serve", "open_loop": "serve", "train": "train"}


class Cell:
    """One cell of ``BENCHMARK.json`` with its files loaded."""

    def __init__(self, bench: dict, name: str, root: Path = PERFBENCH.parent,
                 workloads_dir: Path | None = None,
                 config_file: Path | None = None):
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json; "
                           f"cells: {sorted(cells)}")
        self.name = name
        self.entry = cells[name]
        configs = {c["name"]: c for c in bench["configs"]}
        self.config_entry = configs[self.entry["config"]]
        self.config = json.loads(Path(
            config_file or root / self.config_entry["file"]).read_text())
        wdir = workloads_dir or PERFBENCH / "workloads"
        self.workload = json.loads((wdir / f"{name}.json").read_text())
        self.chips = self.entry["chips"]
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in bench["per_layer"]
                          if name in m["workloads"]]


def load_bench(root: Path = PERFBENCH.parent) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def metric_reader(name: str, metrics_dir: Path | None = None):
    """The ``read`` of ``perfbench/metrics/<name>.py``."""
    path = (metrics_dir or PERFBENCH / "metrics") / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"perfbench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, its libraries' or
    the JAX package's, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN_TOP))


def device_info(device, peak_bytes) -> dict:
    import torch
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": int(peak_bytes)}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": torch.cuda.device_count(),
            "memory_peak_bytes": int(peak_bytes)}


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_process: float, log=print) -> dict:
    """Run one cell once: set-up from the seed, the measured window, the
    readings, the comparison with the plain reference.  Returns the
    result object (without printing it)."""
    driver = importlib.import_module(
        f"perfbench.drivers.{DRIVERS[cell.workload['kind']]}")
    out = driver.run(cell, seed=seed, seconds=seconds, trace=trace,
                     device=device, t_process=t_process, log=log)
    metrics, unjudged = {}, {}
    if trace:
        r = out["readings"]
        for m in cell.per_layer:
            try:
                value = metric_reader(m["name"])(r)
            except Exception as err:       # a reader's fault names itself
                log(f"metric {m['name']}: reader failed: {err!r}")
                value = None
            if value is None or not math.isfinite(value):
                why = r.why_missing(m["name"]) if hasattr(r, "why_missing") \
                    else ""
                log(f"metric {m['name']}: nothing to read {why}".rstrip())
                continue
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            value = out["end_to_end"].get(m["name"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        # The window's other readings (a tail that spreads too widely to
        # judge) are printed for the record, not judged.
        unjudged = {k: v for k, v in out["end_to_end"].items()
                    if k not in metrics}
    checks = out["checks"]
    result = {
        "correct": bool(out["correct"]),
        "attempted": int(out["attempted"]),
        "failed": int(out["failed"]),
        "metrics": metrics,
        "device": out["device"],
    }
    if trace and out.get("breakdown"):
        result["breakdown"] = out["breakdown"]
    if trace and out["readings"] is not None and out["readings"].bounds:
        result["roofline_bound"] = out["readings"].bounds
    if unjudged:
        result["unjudged"] = unjudged
    for k, v in out.get("extra", {}).items():
        result[k] = v
    result["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                        for c in checks}
    return result


class Collections:
    """While open, the cyclic collector's passes: ``count`` and
    ``seconds`` per generation (host time the window lost to it)."""

    def __init__(self):
        self.count, self.seconds, self._t = [0, 0, 0], [0.0, 0.0, 0.0], 0.0

    def _cb(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._t = time.perf_counter()
        else:
            g = info["generation"]
            self.count[g] += 1
            self.seconds[g] += time.perf_counter() - self._t

    def __enter__(self):
        gc.callbacks.append(self._cb)
        return self

    def __exit__(self, *exc) -> None:
        gc.callbacks.remove(self._cb)

    def reading(self) -> dict:
        return {"count": self.count, "seconds": self.seconds}


def chunk_rates(times, t0: float, t1: float, chunk_s: float = 5.0) -> list:
    """Events per second in consecutive ``chunk_s`` slices of the window
    ``(t0, t1]``, the last slice taking the remainder: how steady a run
    was inside its window, beside how far runs differ."""
    n = max(1, int((t1 - t0) // chunk_s))
    counts = [0] * n
    for t in times:
        if t0 < t <= t1:
            counts[min(n - 1, int((t - t0) / chunk_s))] += 1
    last = (t1 - t0) - (n - 1) * chunk_s
    return [k / (chunk_s if i < n - 1 else last)
            for i, k in enumerate(counts)]


def check(name: str, value, limit, ok: bool) -> dict:
    return {"name": name, "value": value, "limit": limit, "ok": bool(ok)}
