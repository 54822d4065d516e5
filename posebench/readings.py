"""Readings for a cell's comparison limits: the program's compared numbers
on many seeds and the control's on the same kept batches, in one process
(so that the set-up's build and warm-up are paid once a seed, not a
process start). Prints one JSON line a seed.

    python3 posebench/readings.py --workload <name> --seconds 3 --seeds 11 12 13 [--control]
        [--fault <name>] [--witness]

`--fault` plants one of posebench/faults.py's faults under the timed path.
`--witness` (training cells) looks into the worst leaf of the parameters'
change: see `change_witness`.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path


def change_witness(d) -> dict:
    """Why a training cell's worst leaf of the change (d.diag's
    `change_worst`, after d.check()) differs from the reference: the
    float32 reference trained twice and the reference in bfloat16, each
    from the program's weights, batches, draws and gathers. Gives each
    run's change gaps to the first float32 run (worst and median leaf,
    the worst leaf's name) and, on the program's worst leaf, its size, its
    first gradient's norm over the median leaf's, the share of its
    gradient under Adam's epsilon, and the bfloat16 gradient's and
    change's departure from float32's there and on the median leaf."""
    import statistics

    import torch
    from posebench.loops import common
    from posebench.loops import train as tl
    steps = d.t["checked_steps"]
    served = [d._forced(i) for i in range(steps)]

    def run(quant):
        tr_ = d._trainer(quant)
        for i in range(steps):
            tr_.step(d.pool[i], d.graph(i), forced=served[i])
            if i == 0:
                g1 = {k: v.detach().float().clone() for k, v in tr_.grads().items()}
        ch = {k: (p.detach() - d.state0[k]).float() for k, p in tr_.net.named_parameters()}
        del tr_
        common.free(d.ctx.device)
        return g1, ch

    g32, c32 = run(None)
    _, c32b = run(None)
    g16, c16 = run("bf16")
    gn, cn = tl._norms(g32), tl._norms(c32)
    med = statistics.median(gn.values())
    moved = {k for k, v in gn.items() if v >= 1e-3 * med}
    worst = d.diag["change_worst"]

    def gaps(norms):
        g = tl.leaf_gaps(norms, cn, moved)
        top = max(g, key=g.get)
        return {"max": g[top], "median": statistics.median(g.values()), "worst": top,
                "on_program_worst": g[worst]}

    def rel(a, b, k):
        return float((a[k] - b[k]).double().norm() / b[k].double().norm().clamp_min(1e-30))

    def sign_off(a, b, k):
        return float((torch.sign(a[k]) != torch.sign(b[k])).double().mean())
    grad_err = {k: rel(g16, g32, k) for k in moved}
    sign_g = {k: sign_off(g16, g32, k) for k in moved}
    sign_c = {k: sign_off(c16, c32, k) for k in moved}
    return {
        "program": gaps(d.change), "f32_again": gaps(tl._norms(c32b)),
        "bf16_reference": gaps(tl._norms(c16)),
        "leaf": worst, "numel": int(g32[worst].numel()),
        "program_over_reference": d.change[worst] / cn[worst],
        "grad_over_median_leaf": gn[worst] / med,
        "grad_under_adam_eps": float((g32[worst].abs() < 1e-8).double().mean()),
        "bf16_grad_rel_err": {"leaf": grad_err[worst],
                              "median_leaf": statistics.median(grad_err.values())},
        "bf16_grad_sign_off": {"leaf": sign_g[worst],
                               "median_leaf": statistics.median(sign_g.values())},
        "bf16_change_sign_off": {"leaf": sign_c[worst],
                                 "median_leaf": statistics.median(sign_c.values())}}


def main(argv=None):
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import torch
    from posebench import harness
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", action="store_true")
    p.add_argument("--fault", default=None, help="a fault of posebench/faults.py to plant")
    p.add_argument("--witness", action="store_true",
                   help="training cells: look into the worst leaf of the change")
    p.add_argument("--dtype", default=None, help="run the program in this dtype instead")
    p.add_argument("--batch", type=int, default=None, help="run at this batch instead")
    args = p.parse_args(argv)
    cell = harness.load_cell(args.workload)
    if args.dtype:
        cell.config["dtype"] = args.dtype
    if args.batch:
        cell.traffic["batch"] = args.batch
    if not torch.cuda.is_available():
        print("readings need a CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    import contextlib
    import importlib
    from posebench import faults
    mod = importlib.import_module(f"posebench.loops.{cell.traffic['loop']}")
    for seed in args.seeds:
        t0 = time.perf_counter()
        ctx = harness.Context(cell, seed, args.seconds, False, device, t0)
        d = mod.Loop(ctx)
        with faults.FAULTS[args.fault]() if args.fault else contextlib.nullcontext():
            d.setup()
            e2e, attempted, failed = d.window(args.seconds)
        d.check()
        program = d.numbers
        line = {"seed": seed, "fault": args.fault, "program": program, "e2e": e2e,
                "attempted": attempted}
        line.update(getattr(d, "diag", {}))
        if args.witness:
            line["witness"] = change_witness(d)
        if args.control:
            line["control"] = d.control()
            line["control_diag"] = dict(getattr(d, "diag", {}))
        d.close()
        line["s"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
