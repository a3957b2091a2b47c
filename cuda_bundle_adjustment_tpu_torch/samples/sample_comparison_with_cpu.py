"""The port's engine against a dense CPU implementation of the same math.

Runs the LM optimisation of one graph twice: through the object API on the
CUDA card (unless another device is asked for), and through the dense f64
numpy implementation of the same g2o-convention math
(``utils/dense_reference.DenseLM``).  Prints both chi2 traces side by side
and the RMSE between the two solutions, then ``PARITY: OK`` where the
traces agree within 0.1 (scaled to the graph's chi2) and the translations
within 1e-6, else ``PARITY: DIVERGED``; the exit code is 0 only on parity.

Usage:
    python -m cuda_bundle_adjustment_tpu_torch.samples.sample_comparison_with_cpu [GRAPH.json] [N]
    (no graph: a synthetic 60-pose mono graph; add --device cpu to run the
    engine's plain twins on the CPU)
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from ..io import opencv_json, synthetic
from ..utils.dense_reference import DenseLM
from .sample_ba_from_file import bulk_graph, graph_source, optimizer, synchronize


def quat_canon(q):
    return q * np.where(q[..., 3:4] < 0, -1.0, 1.0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(usage=__doc__.split("Usage:")[1])
    ap.add_argument("graph", nargs="?", help="graph file (OpenCV JSON); default: synthetic")
    ap.add_argument("niterations", nargs="?", type=int, default=10)
    ap.add_argument("--device", default="cuda", help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    niter = args.niterations

    if args.graph is not None:
        problem = opencv_json.read_problem(args.graph)
        make = graph_source(args.graph)
    else:
        problem = synthetic.make_ba_problem(
            num_poses=60, num_landmarks=900, mean_obs_per_landmark=4.2, kind="mono", seed=0)

        def make():
            return bulk_graph(problem)

    print("Running CPU (dense f64 reference, g2o-equivalent math)...")
    cpu = DenseLM(problem)
    t0 = time.perf_counter()
    cpu.optimize(niter)
    t_cpu = time.perf_counter() - t0

    print(f"Running the engine on {args.device}...")
    opt = optimizer(make, args.device)  # warm-up: kernel builds, structure cache
    opt.initialize()
    opt.optimize(niter)
    opt = optimizer(make, args.device)
    synchronize(args.device)
    t0 = time.perf_counter()
    opt.initialize()
    opt.optimize(niter)
    synchronize(args.device)
    t_dev = time.perf_counter() - t0
    trace = [s.chi2 for s in opt.batch_statistics().get()]

    print(f"\n=== {niter} iterations:  CPU {t_cpu:.2f}s   {opt.device} {t_dev:.2f}s ===\n")
    print("iteration        chi2(CPU)     chi2(engine)")
    n = min(len(cpu.chi_trace), len(trace))
    for i in range(n):
        print(f"{i + 1:9d} {cpu.chi_trace[i]:16.1f} {trace[i]:16.1f}")

    # both in the problem's order: the object graph's global index is the
    # problem's active-first order
    q, t = opt.solver.result_poses()
    X = opt.solver.result_landmarks()
    rmse_r = np.sqrt(np.mean((quat_canon(cpu.q) - quat_canon(q)) ** 2))
    rmse_t = np.sqrt(np.mean((cpu.t - t) ** 2))
    rmse_l = np.sqrt(np.mean((cpu.Xw - X) ** 2))
    print("\nRMSE between CPU and engine estimates")
    print(f"rotation    : {rmse_r:.2e}")
    print(f"translation : {rmse_t:.2e}")
    print(f"landmark    : {rmse_l:.2e}")

    drift = max(abs(a - b) for a, b in zip(cpu.chi_trace[:n], trace[:n]))
    print(f"\nmax |chi2 CPU - chi2 engine| over trace: {drift:.3g}")
    ok = drift <= 0.1 * max(1.0, cpu.chi_trace[0] / 334210.0) and rmse_t < 1e-6
    print("PARITY:", "OK" if ok else "DIVERGED")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
