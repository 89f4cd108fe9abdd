"""Find an open-loop cell's knee: the same cell at several fixed rates.

    python3 perfbench/sweep.py --workload minitron-4b.tenant-chat \\
        --rates 2,3,4,5 --seconds 30 --seed 2147483711

One process; for every rate one run of the cell as ``run.py`` makes it
with ``mean_rate`` replaced, and a line with its end-to-end metrics and
the backlog (requests due and still without a first token) at each
quarter of the window.  The knee is the highest rate whose backlog does
not grow over the window.  The cell keeps the rate it states; this
script only measures.  Needs the card.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    os.environ["OMP_NUM_THREADS"] = os.environ["MKL_NUM_THREADS"] = "1"
    import torch
    torch.set_num_threads(1)

    from perfbench import harness
    from perfbench.drivers import serve
    if not torch.cuda.is_available():
        print("the sweep needs the card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    base = harness.Cell(harness.load_bench(ROOT), args.workload, ROOT)
    for rate in (float(r) for r in args.rates.split(",")):
        cell = copy.copy(base)
        cell.workload = dict(copy.deepcopy(base.workload), mean_rate=rate)
        out = serve.run(cell, seed=args.seed, seconds=args.seconds,
                        trace=False, device=device,
                        t_process=time.perf_counter(),
                        log=lambda m: print(m, file=sys.stderr))
        print(json.dumps({"rate": rate, "correct": out["correct"],
                          "attempted": out["attempted"],
                          "end_to_end": out["end_to_end"],
                          "extra": out["extra"]}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
