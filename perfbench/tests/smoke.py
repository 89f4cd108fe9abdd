"""Smoke-size cells for the CPU tests: the real harness over the files
of ``perfbench/tests/data``."""

from __future__ import annotations

import copy
import time
from pathlib import Path

import torch

from perfbench import harness

DATA = Path(__file__).resolve().parent / "data"
CELLS = {
    "smoke.batch": ("minitron-4b", "minitron-4b-smoke.json"),
    "smoke.chat": ("minitron-4b", "minitron-4b-smoke.json"),
    "smoke.train": ("seamless-m4t-large-v2", "seamless-smoke.json"),
}


def cell(name: str) -> harness.Cell:
    bench = copy.deepcopy(harness.load_bench())
    config, file = CELLS[name]
    bench["workloads"].append({"name": name, "config": config,
                               "traffic": name.split(".")[1], "chips": 1,
                               "why": "smoke"})
    c = harness.Cell(bench, name, workloads_dir=DATA, config_file=DATA / file)
    kind = c.workload["kind"]
    wanted = {"closed_loop": ("decode_tok_s",),
              "open_loop": ("decode_tok_s", "ttft_p90_ms"),
              "train": ("train_step_ms",)}[kind] + ("setup_s",)
    c.end_to_end = [m for m in bench["end_to_end"] if m["name"] in wanted]
    # Both serving kinds read the tenant-chat cell's readers.
    sfx = ".train" if kind == "train" else ".chat"
    c.per_layer = [m for m in bench["per_layer"] if m["name"].endswith(sfx)]
    return c


def run(name: str, seed: int = 2_200_000_003, seconds: float = 3.0,
        trace: bool = False) -> dict:
    return harness.run_cell(cell(name), seed, seconds, trace,
                            torch.device("cpu"), time.perf_counter(),
                            log=lambda m: None)
