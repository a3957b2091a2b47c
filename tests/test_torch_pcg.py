"""The port's PCG route (``solver/pcg.py``, ``block_solver.solve_reduced_pcg``)
on the CPU against the JAX package's ``solve_blocks_pcg`` and PCG path
(``tests/test_pcg.py``'s cases), the numpy ``DenseLM`` oracle and the stored
1000-pose dense oracle: a solve at 1e-9 with the same verdict, traces at
rtol 1e-9 (the JAX package) and 1e-6 (the dense oracles), an unconverged CG
rejected and re-damped, the blocks of CG iterations the same as one loop,
the fused loop bit for bit the host loop, and the structure cache keyed on
the CG settings.  The JAX package's CPU path never bands, so
``PCG_MIN_POSES`` is set to 0 in both packages where a small graph must take
PCG, as ``tests/test_pcg.py`` does."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cuda_bundle_adjustment_tpu.solver.block_solver as JBS
import cuda_bundle_adjustment_tpu.solver.pcg as jpcg
from cuda_bundle_adjustment_tpu.io.arrays import optimizer_from_problem as jax_optimizer
from cuda_bundle_adjustment_tpu_torch.io.arrays import optimizer_from_problem
from cuda_bundle_adjustment_tpu_torch.io.synthetic import make_ba_problem, make_loop_closure_problem
from cuda_bundle_adjustment_tpu_torch.solver import block_solver as tbs
from cuda_bundle_adjustment_tpu_torch.solver import pcg as tpcg
from cuda_bundle_adjustment_tpu_torch.solver.segments import make_segments
from cuda_bundle_adjustment_tpu_torch.utils.dense_reference import DenseLM

torch.set_num_threads(1)

ORACLE = os.path.join(os.path.dirname(__file__), "data", "pcg_1000pose_oracle.json")


def _trace(opt):
    return [s.chi2 for s in opt.batch_statistics().get()]


def _random_block_system(Pa, extra_offdiag, seed):
    """The random SPD block system of ``tests/test_pcg.py``: upper-triangle
    flat 6x6 blocks on the nonzero block pattern of ``A A^T``."""
    rng = np.random.default_rng(seed)
    pairs = {(i, i) for i in range(Pa)} | {(i, i + 1) for i in range(Pa - 1)}
    while len(pairs) < Pa * 2 + extra_offdiag:
        a, b = sorted(rng.integers(0, Pa, 2))
        pairs.add((a, b))
    n = Pa * 6
    A = np.zeros((n, n))
    for i, j in sorted(pairs):
        blk = rng.standard_normal((6, 6)) * 0.3
        A[i * 6:i * 6 + 6, j * 6:j * 6 + 6] += blk
        if i != j:
            A[j * 6:j * 6 + 6, i * 6:i * 6 + 6] += blk.T
    A = A @ A.T + np.eye(n) * (1.0 + 0.1 * Pa)
    blocks, rows, cols = [], [], []
    for i in range(Pa):
        for j in range(i, Pa):
            blk = A[i * 6:i * 6 + 6, j * 6:j * 6 + 6]
            if np.any(blk != 0.0):
                blocks.append(blk.reshape(36))
                rows.append(i)
                cols.append(j)
    blocks, rows, cols = np.array(blocks), np.array(rows), np.array(cols)
    keys = rows * Pa + cols
    diag_pos = np.searchsorted(keys, np.arange(Pa) * (Pa + 1))
    return A, blocks, rows, cols, diag_pos, rng.standard_normal((Pa, 6))


def _pcg_plan(rows, cols, diag_pos, Pa, maxiter=None):
    """A plan of the PCG route for a block pattern given as arrays."""
    pc = tpcg.build_pcg_plan(rows, cols, Pa, "cpu")
    if maxiter is not None:
        pc = pc._replace(maxiter=maxiter)
    fields = dict.fromkeys(tbs.SchurPlan._fields)
    fields.update(
        blk_row=torch.as_tensor(rows), blk_col=torch.as_tensor(cols),
        diag_pos=torch.as_tensor(diag_pos), row_seg=make_segments(rows, Pa, "cpu"),
        col_seg=make_segments(cols, Pa, "cpu"), route="pcg", target=torch.float32, pcg=pc,
        set_segs=(),
    )
    return tbs.SchurPlan(**fields)


@pytest.mark.parametrize("case", ["spd", "indefinite"])
def test_solve_matches_the_jax_pcg(case):
    """``tests/test_pcg.py``'s random block systems through both packages'
    PCG: ``xp`` at 1e-9 of the JAX function's largest entry and the same
    verdict; the SPD solve also at 1e-7 of a dense solve, the indefinite
    one (diagonal blocks negated, ``maxiter`` 50) refused."""
    Pa, extra, seed, maxiter = (40, 30, 0, None) if case == "spd" else (16, 10, 1, 50)
    A, blocks, rows, cols, diag_pos, b = _random_block_system(Pa, extra, seed)
    if case == "indefinite":
        blocks = blocks.copy()
        blocks[diag_pos] *= -1.0
    i32 = np.int32
    jxp, jok = jpcg.solve_blocks_pcg(
        jnp.asarray(blocks), jnp.asarray(b), Pa, jnp.asarray(rows.astype(i32)),
        jnp.asarray(cols.astype(i32)), jnp.asarray(diag_pos.astype(i32)),
        jpcg.build_pcg_plan(rows, cols, Pa), maxiter=maxiter)
    plan = _pcg_plan(rows, cols, diag_pos, Pa, maxiter)
    runner = tpcg.CgRunner()
    xp, ok = tbs.solve_reduced_pcg(torch.as_tensor(blocks), torch.as_tensor(b), plan, runner)
    assert bool(ok) == bool(jok) == (case == "spd")
    assert len(runner.iterations) == 1 and runner.reads == -(-max(runner.iterations[0], 1)
                                                             // tpcg.CG_BLOCK)
    if case == "spd":
        jxp = np.asarray(jxp)
        np.testing.assert_allclose(xp.numpy(), jxp, rtol=0, atol=1e-9 * np.abs(jxp).max())
        want = np.linalg.solve(A, b.reshape(-1)).reshape(Pa, 6)
        np.testing.assert_allclose(xp.numpy(), want, rtol=1e-7, atol=1e-9)


def test_blocks_of_iterations_stop_where_one_loop_stops(monkeypatch):
    """An iteration past convergence changes nothing: the solve is the same
    bit for bit whatever the block length (1, 7 or 16 iterations a block),
    and it stops at the same iteration."""
    Pa = 40
    _, blocks, rows, cols, diag_pos, b = _random_block_system(Pa, 30, 0)
    plan = _pcg_plan(rows, cols, diag_pos, Pa)
    out = []
    for n in (1, 7, 16):
        monkeypatch.setattr(tpcg, "CG_BLOCK", n)
        runner = tpcg.CgRunner()
        xp, ok = tbs.solve_reduced_pcg(torch.as_tensor(blocks), torch.as_tensor(b), plan, runner)
        assert bool(ok) and runner.reads == -(-runner.iterations[0] // n)
        out.append((xp, runner.iterations[0]))
    assert all(torch.equal(xp, out[0][0]) and it == out[0][1] for xp, it in out)
    assert 1 < out[0][1] < plan.pcg.maxiter


def _loop_closure(seed=21, num_poses=160):
    """``tests/test_pcg.py``'s loop-closure graph: more poses than one
    preconditioner chunk (64), so CG really iterates."""
    return make_loop_closure_problem(num_poses=num_poses, num_landmarks=500,
                                     mean_obs_per_landmark=4.0, long_range_fraction=0.3, seed=seed)


@pytest.fixture
def pcg_everywhere(monkeypatch):
    monkeypatch.setattr(tbs, "PCG_MIN_POSES", 0)
    monkeypatch.setattr(JBS, "PCG_MIN_POSES", 0)


def test_pcg_trace_matches_jax_and_the_dense_oracle(pcg_everywhere):
    """The 160-pose loop-closure graph on the PCG route over 6 iterations:
    the trace at rtol 1e-9 of the JAX package's PCG path (both stop CG at
    ``1e-10 ||b||``; their iteration counts agree on this graph) and at
    1e-6 of ``DenseLM``; the fused loop bit for bit the host loop, each
    trial's CG iterations counted in both."""
    p = _loop_closure()
    runs = {}
    for fused in (True, False):
        opt = optimizer_from_problem(p, device="cpu")
        opt.use_fused_loop = fused
        opt.optimize(6)
        runs[fused] = opt
    opt = runs[True]
    assert opt.solver.plan.route == "pcg" and opt.solver.plan.band.bw + 1 > tbs.MAX_BAND
    assert _trace(opt) == _trace(runs[False])
    assert all(torch.equal(a, b) for a, b in zip(opt.solver.graph, runs[False].solver.graph))
    assert opt.cg_iterations == runs[False].cg_iterations == opt.loop_stats["cg_iterations"]
    assert len(opt.cg_iterations) == opt.loop_stats["trials"]
    assert opt.loop_stats["reads"] == opt.loop_stats["trials"] + 1 + opt.loop_stats["cg_reads"]
    assert all(1 < n < tpcg.CG_MAXITER for n in opt.cg_iterations)
    jopt = jax_optimizer(p)
    jopt.optimize(6)
    assert len(_trace(opt)) == len(_trace(jopt)) == 6
    np.testing.assert_allclose(_trace(opt), _trace(jopt), rtol=1e-9)
    np.testing.assert_allclose(_trace(opt), DenseLM(p).optimize(6), rtol=1e-6)


def test_unconverged_cg_is_rejected_and_lm_redamps(pcg_everywhere, monkeypatch):
    """``CG_MAXITER`` 2 cannot converge at a small lambda: the trial's
    verdict is False, as the JAX package's; re-damped tenfold at a time, a
    trial converges within its two iterations and is accepted."""
    monkeypatch.setattr(tpcg, "CG_MAXITER", 2)
    solver = optimizer_from_problem(_loop_closure(seed=22), device="cpu").solver
    solver.build_structure()
    assert solver.plan.route == "pcg" and solver.plan.pcg.maxiter == 2
    chi, sys_ = solver.head()
    F = float(chi)
    lam = 1e-5 * solver.max_diagonal(sys_)
    _, _, _, success = solver.trial(sys_, lam)
    assert not bool(success) and solver.cg.iterations[-1] == 2
    for _ in range(40):
        _, Fhat, scale, success = solver.trial(sys_, lam)
        if bool(success) and (F - float(Fhat)) / (float(scale) + 1e-3) > 0:
            break
        lam *= 10.0
    else:
        pytest.fail("no re-damped trial converged and was accepted")


def test_band_trace_matches_the_jax_pcg_trace_across_the_boundary(pcg_everywhere):
    """The port's band rule keeps a graph on the band (B7/B8's twins)
    where the JAX package solves by PCG (on the CPU it never bands, and at
    ``PCG_MIN_POSES`` 0 it takes PCG): the two traces at rtol 1e-6, the bar
    the JAX package holds PCG to against a direct solve."""
    p = make_ba_problem(num_poses=80, num_landmarks=600, mean_obs_per_landmark=4.0, kind="mono",
                        seed=3)
    opt = optimizer_from_problem(p, device="cpu")
    opt.optimize(8)
    assert opt.solver.plan.route == "band"
    jopt = jax_optimizer(p)
    jopt.solver.build_structure()
    assert jopt.solver.plan.pcg is not None and jopt.solver.plan.band is None
    jopt.optimize(8)
    assert len(_trace(opt)) == len(_trace(jopt)) == 8
    np.testing.assert_allclose(_trace(opt), _trace(jopt), rtol=1e-6)


def test_the_1000_pose_graph_matches_the_stored_dense_oracle(pcg_everywhere, monkeypatch):
    """``tests/data/pcg_1000pose_oracle.json``: the 1000-pose loop-closure
    graph on the PCG route with ``CG_MAXITER`` at the oracle's value, the
    trace at rtol 1e-6 of its dense f64 trace, as the JAX package's
    ``tests/test_pcg.py`` holds it."""
    with open(ORACLE) as f:
        gold = json.load(f)
    monkeypatch.setattr(tpcg, "CG_MAXITER", int(gold["cg_maxiter"]))
    p = make_loop_closure_problem(
        num_poses=gold["num_poses"], num_landmarks=gold["num_landmarks"],
        mean_obs_per_landmark=gold["mean_obs_per_landmark"],
        long_range_fraction=gold["long_range_fraction"], seed=gold["seed"])
    opt = optimizer_from_problem(p, device="cpu")
    opt.optimize(gold["niterations"])
    assert opt.solver.plan.route == "pcg" and opt.solver.plan.pcg.maxiter == gold["cg_maxiter"]
    assert len(_trace(opt)) == len(gold["oracle_trace"])
    np.testing.assert_allclose(_trace(opt), gold["oracle_trace"], rtol=1e-6)


def test_structure_cache_keys_on_the_cg_settings(pcg_everywhere, monkeypatch):
    """A plan captures ``CG_TOL`` and ``CG_MAXITER`` when it is made: a
    solver under other settings misses the structure cache and gets a plan
    with its own, one under the same settings hits it."""
    p = _loop_closure()
    tbs.clear_structure_cache()

    def plan():
        s = optimizer_from_problem(p, device="cpu").solver
        s.build_structure()
        return s.plan.pcg, (tbs.structure_cache_info()["hits"],
                            tbs.structure_cache_info()["misses"])

    assert plan()[1] == (0, 1)
    pc, counts = plan()
    assert counts == (1, 1) and (pc.tol, pc.maxiter) == (tpcg.CG_TOL, tpcg.CG_MAXITER)
    monkeypatch.setattr(tpcg, "CG_MAXITER", 17)
    monkeypatch.setattr(tpcg, "CG_TOL", 1e-7)
    pc, counts = plan()
    assert counts == (1, 2) and (pc.tol, pc.maxiter) == (1e-7, 17)
    assert plan()[1] == (2, 2)
