"""The cases of ``tests/test_torch_distributed.py``, run in spawned processes.

``run_ranks`` spawns ``D`` gloo ranks on the CPU; every rank runs the
port's distributed path on each case's problem (``rank_main``) and writes
what it holds to a pickle.  ``jax_case`` runs the JAX package's
``parallel/distributed.py`` on the same case in a process of its own (JAX
configured there: a virtual 8-device CPU mesh in f64), so that the JAX
programs compile side by side with the ranks' work.  At the top this module
imports numpy and torch only: a rank never imports JAX.
"""

from __future__ import annotations

import os
import pickle
import sys
import time

import numpy as np
import torch

# the cases of tests/test_distributed.py: (generator arguments, iterations)
LOOPS = {
    "mono": dict(num_poses=8, num_landmarks=48, mean_obs_per_landmark=4.0, kind="mono", seed=37),
    "depth": dict(num_poses=8, num_landmarks=48, mean_obs_per_landmark=4.0, kind="depth",
                  seed=47),
    "mixed": dict(num_poses=8, num_landmarks=56, mean_obs_per_landmark=4.0, seed=51),
}
STEP = dict(num_poses=10, num_landmarks=64, mean_obs_per_landmark=4.0, kind="mono", seed=31)
OUTLIERS = dict(num_poses=8, num_landmarks=48, mean_obs_per_landmark=4.0, kind="mono", seed=57,
                noise_px=0.5)
OUTLIER_THRESHOLD = 500.0
STEP_LAM = 0.1
NITER = 4


def problem(case: str, synthetic):
    """A case's problem from ``synthetic`` (either package's
    ``io/synthetic.py``, the same generator)."""
    if case == "step":
        return synthetic.make_ba_problem(**STEP)
    if case == "outliers":
        p = synthetic.make_ba_problem(**OUTLIERS)
        meas = p.meas.copy()
        meas[np.arange(0, meas.shape[0], 37)] += 120.0  # every 37th measurement moved
        return p._replace(meas=meas)
    if case == "mixed":
        return synthetic.make_mixed_ba_problem(**LOOPS["mixed"])
    return synthetic.make_ba_problem(**LOOPS[case])


# -- the port's ranks ------------------------------------------------------------


class _Counted:
    """``torch.distributed.all_reduce`` wrapped to list its calls in order:
    the op and the size, as ``"SUM[43]"``."""

    def __init__(self, dist):
        self.dist, self.orig, self.calls = dist, dist.all_reduce, []

    def __enter__(self):
        def counted(tensor, op=self.dist.ReduceOp.SUM, group=None, async_op=False):
            self.calls.append(str(op).rsplit(".", 1)[-1] + f"[{tensor.numel()}]")
            return self.orig(tensor, op=op, group=group, async_op=async_op)

        self.dist.all_reduce = counted
        return self

    def __exit__(self, *exc):
        self.dist.all_reduce = self.orig

    def count(self, op: str) -> int:
        return sum(c.startswith(op + "[") for c in self.calls)


def _np(x):
    return x.detach().cpu().numpy().copy()


def _rank_case(case: str, D: int, device: str) -> dict:
    import torch.distributed as dist

    from cuda_bundle_adjustment_tpu_torch.io import synthetic
    from cuda_bundle_adjustment_tpu_torch.parallel import distributed as pd

    if case == "step":
        sp = pd.shard_problem(problem("step", synthetic), D)
        step = pd.make_distributed_lm_step(None, sp, device=device)
        with _Counted(dist) as c:
            q2, t2, Xw2, chi0, chi1, scale, ok = step(sp.pose_q, sp.pose_t, None, STEP_LAM)
        return dict(q=_np(q2), t=_np(t2), Xw=_np(Xw2), chi0=float(chi0), chi1=float(chi1),
                    scale=float(scale), success=bool(ok), sums=c.count("SUM"),
                    maxes=c.count("MAX"), route=sp.route)
    if case == "band_pcg":
        p = problem("step", synthetic)
        out = {}
        for solver in ("band", "pcg"):
            sp = pd.shard_problem(p, D, pose_solver=solver)
            rs = pd.RankSolver(None, sp, device=device)
            runs = {}
            for fused in (True, False):
                rs.use_fused_loop = fused
                trace, graph = rs.optimize(NITER)
                runs[fused] = dict(trace=trace, state=[_np(a) for a in graph],
                                   cg=rs.stats["cg_iterations"], stats=dict(rs.stats))
            out[solver] = dict(runs[True], route=rs.plan.route, host=runs[False])
        return out
    if case == "outliers":
        sp = pd.shard_problem(problem("outliers", synthetic), D,
                              outlier_threshold=OUTLIER_THRESHOLD)
        rs = pd.RankSolver(None, sp, device=device)
        update = pd.make_distributed_update_edges(None, sp, solver=rs)
        out = {}
        for fused in (True, False):
            # as the JAX case: the loop, the thresholding, the loop on the inliers
            rs.use_fused_loop = fused
            opt = pd.make_distributed_optimize_fused(None, sp, NITER, solver=rs)
            with _Counted(dist) as c:
                q, t, Xw, trace, n = opt(sp.pose_q, sp.pose_t, None, rs.packed.active)
                active, n_new = update(q, t, Xw, rs.packed.active)
                q2, t2, Xw2, trace2, n2 = opt(q, t, Xw, active=active)
            out[fused] = dict(trace=trace[:n].tolist(), trace2=trace2[:n2].tolist(),
                              n_done=(n, n2), active=_np(active), n_new=n_new,
                              state=[_np(a) for a in (q2, t2, Xw2)], calls=c.calls,
                              stats=dict(rs.stats))
        try:  # a solver is bound to the ShardedProblem it was made for
            pd.distributed_optimize(None, pd.shard_problem(problem("outliers", synthetic), D),
                                    NITER, solver=rs)
            refused = False
        except ValueError:
            refused = True
        return dict(out[True], host=out[False], edge_ids=sp.shards[dist.get_rank()].edge_ids,
                    refused=refused)
    # the loop cases: the fused loop through make_distributed_optimize_fused,
    # then the host loop on the same RankSolver
    sp = pd.shard_problem(problem(case, synthetic), D)
    rs = pd.RankSolver(None, sp, device=device)
    out = {}
    for fused in (True, False):
        rs.use_fused_loop = fused
        with _Counted(dist) as c:
            q, t, Xw, trace, n_done = pd.make_distributed_optimize_fused(None, sp, NITER,
                                                                         solver=rs)(
                sp.pose_q, sp.pose_t, None)
        out[fused] = dict(trace=trace[:n_done].tolist(), n_done=n_done,
                          padded=trace[n_done:].tolist(), q=_np(q), t=_np(t), Xw=_np(Xw),
                          trials=rs.stats["trials"], sums=c.count("SUM"), maxes=c.count("MAX"),
                          calls=c.calls, comm=rs.stats["all_reduce"], stats=dict(rs.stats))
    return dict(out[True], host=out[False])


def rank_main(rank: int, world: int, init_method: str, cases, out_dir: str,
              device: str = "cpu") -> None:
    """One gloo rank: every case of ``cases`` in order on ``device``, then a
    pickle of ``{case: what the rank holds}`` and whether JAX was ever
    imported."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init_method, rank=rank, world_size=world)
    try:
        out = {case: _rank_case(case, world, device) for case in cases}
    finally:
        dist.destroy_process_group()
    out["jax_imported"] = "jax" in sys.modules
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def run_ranks(D: int, cases, out_dir: str, device: str = "cpu"):
    """Spawn ``D`` gloo ranks running ``cases`` on ``device`` (returns the
    process context: :func:`join` it, then :func:`read_ranks`)."""
    import torch.multiprocessing as mp

    os.makedirs(out_dir, exist_ok=True)
    init = "file://" + os.path.join(out_dir, "store")
    return mp.spawn(rank_main, args=(D, init, tuple(cases), out_dir, device), nprocs=D,
                    join=False)


def join(context, timeout: float) -> None:
    """Wait for every rank (a rank that raised raises here); ranks not done
    within ``timeout`` seconds are killed and ``TimeoutError`` raised."""
    deadline = time.monotonic() + timeout
    while not context.join(timeout=max(deadline - time.monotonic(), 0.0)):
        if time.monotonic() >= deadline:
            for proc in context.processes:
                proc.kill()
            raise TimeoutError(f"ranks still running after {timeout} s")


def read_ranks(D: int, out_dir: str) -> list:
    out = []
    for r in range(D):
        with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


# -- the JAX package, in a process of its own -------------------------------------


def _jax(cache_dir=None):
    """JAX as the suite's conftest configures it: the CPU, x64, a virtual
    8-device mesh (its ``XLA_FLAGS`` reach this process through the
    environment) and the conftest's compilation cache (``cache_dir``, the
    parent's; None: none)."""
    if "--xla_force_host_platform_device_count" not in os.environ.get("XLA_FLAGS", ""):
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                                   + " --xla_force_host_platform_device_count=8")
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    if cache_dir:
        jax.config.update("jax_compilation_cache_dir", cache_dir)
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return jax


def jax_case(case: str, D: int, cache_dir=None) -> dict:
    """The JAX package's distributed path on a case at ``D`` devices:
    numpy results only.  ``cache_dir``: the JAX compilation cache to use."""
    jax = _jax(cache_dir)
    from jax.sharding import Mesh

    from cuda_bundle_adjustment_tpu.io import synthetic
    from cuda_bundle_adjustment_tpu.parallel import distributed as jd

    mesh = Mesh(np.array(jax.devices()[:D]), ("d",))
    p = problem("step" if case in ("step", "band") else case, synthetic)
    if case == "step":
        sp = jd.shard_problem(p, D)
        q2, t2, Xw2, chi0, chi1, scale, ok = jd.make_distributed_lm_step(mesh, sp)(
            sp.pose_q, sp.pose_t, sp.Xw, STEP_LAM)
        return dict(q=np.asarray(q2), t=np.asarray(t2), Xw=jd.gather_landmarks(sp, Xw2),
                    chi0=float(chi0), chi1=float(chi1), scale=float(scale), success=bool(ok))
    if case == "band":
        # the band kernels in interpret mode on the CPU, as the JAX package's
        # own test runs them
        import cuda_bundle_adjustment_tpu.pallas.bandchol as bc

        for name in ("band_factor", "band_factor2", "band_solve"):
            orig = getattr(bc, name)
            setattr(bc, name, (lambda o: lambda *a, **k: o(*a, **{**k, "interpret": True}))(orig))
        sp = jd.shard_problem(p, D, pose_solver="band")
        trace, _ = jd.distributed_optimize(mesh, sp, NITER)
        return dict(trace=trace)
    if case == "outliers":
        sp = jd.shard_problem(p, D, outlier_threshold=OUTLIER_THRESHOLD)
        opt = jd.make_distributed_optimize_fused(mesh, sp, NITER)
        # the mask passed both times: one program for both runs
        q, t, Xw, trace, n = opt(sp.pose_q, sp.pose_t, sp.Xw, active=sp.active)
        active, n_new = jd.make_distributed_update_edges(mesh, sp)(q, t, Xw, sp.active)
        _, _, _, trace2, n2 = opt(q, t, Xw, active=active)
        # each edge's mask in the caller's order: the padded slots back to edges
        E = p.meas.shape[0]
        Es = sp.edges_per_shard
        shard = (p.lm_idx % D).astype(np.int64)
        order = np.argsort(shard, kind="stable")
        starts = np.concatenate([[0], np.cumsum(np.bincount(shard, minlength=D))[:-1]])
        slot = shard[order] * Es + np.arange(E) - starts[shard[order]]
        mask = np.empty(E)
        mask[order] = np.asarray(active)[slot]
        return dict(trace=[float(x) for x in np.asarray(trace)[: int(n)]],
                    trace2=[float(x) for x in np.asarray(trace2)[: int(n2)]], active=mask,
                    n_new=int(n_new))
    sp = jd.shard_problem(p, D)
    q, t, Xw, trace, n_done = jd.make_distributed_optimize_fused(mesh, sp, NITER)(
        sp.pose_q, sp.pose_t, sp.Xw)
    n = int(n_done)
    return dict(trace=[float(x) for x in np.asarray(trace)[:n]], n_done=n, q=np.asarray(q),
                t=np.asarray(t), Xw=jd.gather_landmarks(sp, Xw))
