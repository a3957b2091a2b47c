"""Readings that the limits of ``limits/<cell>.json`` are set from.

    python3 h100_bench/control.py --workloads <cell> [<cell> ...] --seeds <n> [<n> ...]
        [--control-seeds <k>] [--device cuda]

For each cell and seed, in one process: the seed's graph and the cell's
traffic, a warm-up solve, then the program's solve of the first window
graph through the timed path (``harness.solve``), compared with the
reference in float64 (the lower readings: sound runs of the program).  On
the first ``--control-seeds`` seeds the control follows: the reference in
float32, the nearest precision below the configuration's float64, in the
program's place (the upper readings).  One JSON line a reading.  The
benchmark's own runs never run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]


def readings(root, workload: str, seed: int, control: bool, device: str) -> dict:
    import torch

    import check
    import harness
    import reference
    import traffic

    dev = torch.device(device)
    cell = harness.load_cell(root, workload, trace=False)
    cfg = cell.config
    mix = traffic.Mix(harness.base_problem(cfg, seed), cell.traffic, seed)
    opt, _ = harness.solve(mix.problem(-1), cfg, dev)
    del opt
    problem = mix.problem(0)
    opt, rec = harness.solve(problem, cfg, dev)
    answer = harness.answer(opt)
    del opt
    init = (problem.pose_q, problem.pose_t, problem.landmarks)
    t0 = time.perf_counter()
    ref = reference.ReferenceLM(problem, torch.float64, dev)
    ref_trace = ref.optimize(cfg["iterations"])
    ref_state = ref.state()
    del ref
    out = {"workload": workload, "seed": seed, "solve_s": rec["solve_s"],
           "reference_s": time.perf_counter() - t0, "iterations": rec["iterations"],
           "trials": rec["trials"], "reference_iterations": len(ref_trace),
           "program": check.gaps(rec["chi2"], answer, ref_trace, ref_state, init)}
    if control:
        low = reference.ReferenceLM(problem, torch.float32, dev)
        low_trace = low.optimize(cfg["iterations"])
        out["control"] = check.gaps(low_trace, low.state(), ref_trace, ref_state, init)
        out["control_iterations"] = len(low_trace)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workloads", nargs="+", required=True)
    ap.add_argument("--seeds", nargs="+", type=int, required=True)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--root", default=str(HERE.parent))
    args = ap.parse_args(argv)
    for w in args.workloads:
        for i, seed in enumerate(args.seeds):
            r = readings(Path(args.root), w, seed, i < args.control_seeds, args.device)
            print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
