"""The readings a cell's limits are set from, many seeds in one process.

    python3 perfbench/calibrate.py --workload <cell> --seeds 11,12,13 \\
        --seconds 8 [--controls 3]

For every seed, one run of the cell as ``run.py`` makes it (set-up, a
short window at the cell's own load, the comparison with the plain
reference), and its compared numbers.  For the first ``--controls``
seeds also the control: the reference put in the program's place and
computed in float8 (``perfbench/reference/precision.py``), read by the
same numbers; for a training cell also the fault of a step that leaves
half of its batch out, planted in the reference put in the program's
place.  The benchmark's own runs never run these.

Each line written is one JSON object per seed.  Needs the card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def serve_seed(cell, seed, seconds, device, controls: bool) -> dict:
    from perfbench.drivers import serve
    out = serve.run(cell, seed=seed, seconds=seconds, trace=False,
                    device=device, t_process=time.perf_counter(),
                    log=lambda m: print(m, file=sys.stderr),
                    controls=("fp8",) if controls else ())
    row = {"correct": out["correct"],
           "checks": {c["name"]: c["value"] for c in out["checks"]},
           "sample": out["extra"]["sample"],
           "peak_bytes": out["device"]["memory_peak_bytes"],
           "end_to_end": out["end_to_end"]}
    if controls:
        row["control_gap"] = out["extra"]["control_gaps"]["fp8"]
    return row


def train_seed(cell, seed, seconds, device, controls: bool) -> dict:
    from perfbench.drivers import train
    out = train.run(cell, seed=seed, seconds=seconds, trace=False,
                    device=device, t_process=time.perf_counter(),
                    log=lambda m: print(m, file=sys.stderr))
    row = {"correct": out["correct"],
           "checks": {c["name"]: c["value"] for c in out["checks"]},
           "peak_bytes": out["device"]["memory_peak_bytes"],
           "end_to_end": out["end_to_end"]}
    if controls:
        wl = cell.workload
        n = wl["checked_steps"]
        ref = train.reference_readings(cell, seed, device, n)
        for name, kw in (("control_fp8", {"precision": "fp8"}),
                         ("fault_half_batch",
                          {"rows_used": wl["batch"] // 2})):
            other = train.reference_readings(cell, seed, device, n, **kw)
            row[name] = train.readings_of(other["losses"],
                                          other["grad_norms"],
                                          other["change_norms"], ref)
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--controls", type=int, default=0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    os.environ["OMP_NUM_THREADS"] = os.environ["MKL_NUM_THREADS"] = "1"
    import torch
    torch.set_num_threads(1)

    from perfbench import harness
    if not torch.cuda.is_available():
        print("calibration needs the card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = harness.Cell(harness.load_bench(ROOT), args.workload, ROOT)
    fn = train_seed if cell.workload["kind"] == "train" else serve_seed
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        row = fn(cell, seed, args.seconds, device, i < args.controls)
        row["seed"] = seed
        print(json.dumps(row), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
