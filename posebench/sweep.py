"""Find the open-loop cell's knee: the highest mean rate (crops/s) at which
the backlog does not grow over a run. Serves the cell's schedule at each
given rate in one process and prints, a rate, what was offered and served,
the latency tail, and the queue wait of the first and the last third of the
requests (a growing backlog shows as a last third that waits far longer).

    python3 posebench/sweep.py --workload hr18_lmo.serve_open --seconds 30 \
        --rates 800 1000 1200
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path


def main(argv=None):
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import numpy as np
    import torch
    from posebench import harness
    from posebench.loops import serve_open
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=30.0)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--rates", type=float, nargs="+", required=True)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("the sweep needs a CUDA device", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    ctx = harness.Context(cell, args.seed, args.seconds, False, torch.device("cuda", 0),
                          time.perf_counter())
    d = serve_open.Loop(ctx)
    d.setup()
    for rate in args.rates:
        d.t["mean_crops_per_s"] = rate
        lat, waits, per_call, n, served, elapsed = d._open_loop(args.seconds)
        waits = np.asarray(waits)
        third = max(len(waits) // 3, 1)
        done = np.isfinite(lat)
        print(json.dumps({
            "rate": rate, "requests": n, "unserved": int(n - done.sum()),
            "served_crops_per_s": served / elapsed, "elapsed_s": elapsed,
            "p50_ms": float(np.percentile(lat[done], 50) * 1e3),
            "p95_ms": float(np.percentile(np.where(done, lat, np.inf), 95) * 1e3),
            "wait_first_third_ms": float(waits[:third].mean() * 1e3),
            "wait_last_third_ms": float(waits[-third:].mean() * 1e3),
            "mean_batch": float(np.mean(per_call))}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
