"""Distributed Schur-complement BA over ``torch.distributed`` ranks (the
counterpart of the JAX package's ``samples/sample_distributed_schur.py``).

Deals a graph's landmarks, and the edges with them, to ``num_devices``
ranks (``parallel/distributed.py``), spawns the ranks with gloo, runs the
LM loop (the fused loop, its steps eager under gloo) and prints the chi2
trace beside the loop's captures, replays and host reads::

    python -m cuda_bundle_adjustment_tpu_torch.samples.sample_distributed_schur \
        [num_devices] [niterations] [--city SCALE] [--scaling] [--band] [--cpu]

* ``--city SCALE``: the city-scale graph (10k poses, 1M landmarks at 1.0)
  scaled down, instead of a 400-pose graph;
* ``--scaling``: runs at 1, 2, 4, 8 ranks (up to ``num_devices``) and
  prints a rank's edges and landmarks, the seconds an iteration and the
  MB all-reduced an iteration;
* ``--band``: the band pose solve where the band fits (the one-card rule);
  PCG otherwise, the JAX sample's default;
* ``--cpu``: the ranks on the CPU; otherwise on the CUDA cards, rank ``r``
  on card ``r % cards`` (several ranks share a card where there are fewer
  cards than ranks).
"""

from __future__ import annotations

import os
import pickle
import sys
import tempfile
import time


def _rank(rank: int, world: int, init: str, sp, niter: int, device: str, runs: int,
          out_dir: str) -> None:
    """One gloo rank: ``runs`` runs of the LM loop, then a pickle of the
    last run's trace and statistics."""
    import torch
    import torch.distributed as dist

    from cuda_bundle_adjustment_tpu_torch.parallel import RankSolver

    torch.set_num_threads(1)
    if device == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world)
    try:
        rs = RankSolver(None, sp, device=device)
        for _ in range(runs):
            trace, _ = rs.optimize(niter)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(dict(trace=trace, stats=rs.stats), f)


def run(sp, niter: int, device: str, runs: int = 1) -> list:
    """Spawn ``sp.num_shards`` ranks over ``sp``; returns each rank's
    ``{"trace", "stats"}`` (``RankSolver.stats`` of its last run)."""
    import torch.multiprocessing as mp

    D = sp.num_shards
    with tempfile.TemporaryDirectory() as out_dir:
        mp.spawn(_rank, args=(D, "file://" + os.path.join(out_dir, "store"), sp, niter, device,
                              runs, out_dir), nprocs=D, join=True)
        out = []
        for r in range(D):
            with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
    return out


def main(argv: list[str]) -> int:
    from cuda_bundle_adjustment_tpu_torch.io.synthetic import city_scale_problem, make_ba_problem
    from cuda_bundle_adjustment_tpu_torch.parallel import shard_problem

    argv = list(argv)
    scale = None
    if "--city" in argv:
        at = argv.index("--city")
        scale = float(argv[at + 1])
        del argv[at:at + 2]
    args = [a for a in argv if not a.startswith("--")]
    want = int(args[0]) if args else 2
    niter = int(args[1]) if len(args) > 1 else 5
    device = "cpu" if "--cpu" in argv else "cuda"
    if scale is not None:
        problem = city_scale_problem(scale=scale)
    else:
        problem = make_ba_problem(num_poses=400, num_landmarks=20_000, mean_obs_per_landmark=4.2,
                                  kind="mono", seed=0)
    pose_solver = "auto" if "--band" in argv else "pcg"
    P, L, E = problem.pose_q.shape[0], problem.landmarks.shape[0], problem.meas.shape[0]

    if "--scaling" in argv:
        print(f"the sharded program at D = 1, 2, 4, 8 ({niter} LM iterations a run, the second "
              f"run timed; pose_solver={pose_solver}; ranks on the {device}).  Ranks that share "
              f"one card or the host's cores measure the program's total work and its "
              f"collectives, not a speedup.")
        print(f"{'D':>3s} {'E/shard':>9s} {'L/shard':>9s} {'s/iter':>8s} {'MB/iter':>9s} "
              f"{'solve':>5s}")
        for D in (1, 2, 4, 8):
            if D > want:
                break
            sp = shard_problem(problem, D, pose_solver=pose_solver)
            out = run(sp, niter, device, runs=2)
            st = out[0]["stats"]
            per_iter = max(o["stats"]["seconds"] for o in out) / max(st["iterations"], 1)
            mb = st["all_reduce"]["bytes"] / max(st["iterations"], 1) / 1e6
            print(f"{D:3d} {max(sp.edges_per_shard):9d} {max(sp.lms_per_shard):9d} "
                  f"{per_iter:8.3f} {mb:9.2f} {sp.route:>5s}")
            assert out[0]["trace"][-1] < out[0]["trace"][0]
        print("SCALING OK")
        return 0

    sp = shard_problem(problem, want, pose_solver=pose_solver)
    print(f"ranks: {want} on the {device} (gloo) | P={P} L={L} E={E} | a rank's E "
          f"{list(sp.edges_per_shard)} | reduced route {sp.route}")
    t0 = time.perf_counter()
    rank0 = run(sp, niter, device)[0]
    trace, st = rank0["trace"], rank0["stats"]
    print(f"\n{niter} LM iterations in {time.perf_counter() - t0:.2f}s (spawn included)")
    print(f"the loop, rank 0: {st['trials']} trials, {st['captures']} captures, "
          f"{st['replays']} replays, {st['reads']} host reads "
          f"({'captured' if st['capture'] else 'eager steps'})")
    for i, c in enumerate(trace, 1):
        print(f"iter= {i:2d}   chi2= {c:.1f}")
    assert trace[-1] < trace[0], "chi2 did not decrease"
    print("DISTRIBUTED OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
