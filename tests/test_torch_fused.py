"""The port's device-resident LM loop (``solver/fused.py``) on the CPU, where
its step functions run eagerly and nothing is captured: its trace and final
state against the port's host loop bit for bit, as ``tests/test_fused.py``
requires of the JAX loops; iteration counts against the host loop and the
JAX package under early termination and under forced rejections; the
device-scalar LM update against the host loop's float rule bit for bit;
which loop ``optimize`` takes; and the loop a structure keeps for its next
solves: a re-sent graph replayed through it bit for bit a new loop and the
host loop, under which keys it is reused, the results it leaves to earlier
optimisers, and its eviction with the structure.
(``tests/test_torch_slice.py`` holds the default loop, this one, against
the JAX package's fused loop.)"""

import gc
import itertools
import math
import weakref

import numpy as np
import pytest
import torch

from cuda_bundle_adjustment_tpu.io.arrays import optimizer_from_problem as jax_optimizer
from cuda_bundle_adjustment_tpu_torch import GraphOptimisationOptions, TorchGraphOptimisation
from cuda_bundle_adjustment_tpu_torch import optimizer as topt
from cuda_bundle_adjustment_tpu_torch.io.arrays import optimizer_from_problem
from cuda_bundle_adjustment_tpu_torch.io.synthetic import (
    MixedBAProblem,
    make_ba_problem,
    make_mixed_ba_problem,
)
from cuda_bundle_adjustment_tpu_torch.solver import block_solver as bs
from cuda_bundle_adjustment_tpu_torch.solver import fused, host_loop
from cuda_bundle_adjustment_tpu_torch.solver.block_solver import BlockSolver
from cuda_bundle_adjustment_tpu_torch.utils import profiling as prof

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def empty_cache():
    """Each test starts from an empty structure cache: a structure solved
    before keeps its loop there."""
    bs.clear_structure_cache()
    yield
    bs.clear_structure_cache()


def _trace(opt):
    return [s.chi2 for s in opt.batch_statistics().get()]


def _run(problem, fused_loop: bool, niter: int = 10, **kw):
    opt = optimizer_from_problem(problem, device="cpu", **kw)
    opt.use_fused_loop = fused_loop
    opt.optimize(niter)
    return _trace(opt), opt


def _same_state(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a.solver.graph, b.solver.graph))


def _resent(problem, seed: int):
    """The graph again over the same edges (one structure): new measurement
    noise, new per-edge weights and a new initial state, as a window of the
    same keyframes and points is sent again."""
    rng = np.random.default_rng(seed)

    def edges(meas, omega):
        return dict(meas=meas + rng.normal(0.0, 0.5, np.shape(meas)),
                    omega=rng.uniform(0.5, 2.0, np.shape(omega)))

    state = dict(pose_t=problem.pose_t + rng.normal(0.0, 0.01, problem.pose_t.shape),
                 landmarks=problem.landmarks + rng.normal(0.0, 0.05, problem.landmarks.shape))
    if isinstance(problem, MixedBAProblem):
        return problem._replace(
            specs=tuple(dict(sp, **edges(sp["meas"], sp["omega"])) for sp in problem.specs),
            **state)
    return problem._replace(**edges(problem.meas, problem.omega), **state)


def _reused(problem, niter: int = 4, **kw) -> int:
    return _run(problem, True, niter, **kw)[1].loop_stats["reused"]


@pytest.mark.parametrize("kept", [False, True], ids=["new", "kept"])
@pytest.mark.parametrize("kind,rk", [("mono", 0), ("stereo", 0), ("mixed", 0), ("mono", 2)],
                         ids=["mono", "stereo", "mixed", "mono-cauchy"])
def test_fused_trace_and_state_equal_the_host_loop_bit_for_bit(kind, rk, kept):
    """Both loops run the same stages on the same values, and the fused
    loop's carried F is the chi of the state it accepted: the traces and the
    final states are equal, not close.  One flag read a trial and one for
    the trace; nothing is captured on the CPU.  ``kept``: the graph is
    re-sent (the same edges, new measurements, weights and initial state)
    after two solves of its structure, and replays the loop the second one
    kept: trace and state are a new loop's and the host loop's bit for
    bit."""
    kw = dict(num_poses=10, num_landmarks=60, mean_obs_per_landmark=4.0, seed=6)
    problem = make_mixed_ba_problem(**kw) if kind == "mixed" else make_ba_problem(kind=kind, **kw)
    robust = dict(rk=rk, delta=3.0) if rk else {}
    if kept:
        for _ in range(2):  # a miss, then the first hit, which keeps its loop
            _run(_resent(problem, 1), True, **robust)
        problem = _resent(problem, 2)
    tf, of = _run(problem, True, **robust)
    assert of.loop_stats["reused"] == int(kept)
    if kept:  # a new loop of the same graph
        bs.clear_structure_cache()
        tn, on = _run(problem, True, **robust)
        assert on.loop_stats["reused"] == 0 and tn == tf and _same_state(on, of)
    th, oh = _run(problem, False, **robust)
    assert len(tf) >= 5 and tf == th
    assert _same_state(of, oh)
    st = of.loop_stats
    assert st["reads"] == st["trials"] + 1 and st["captures"] == st["replays"] == 0
    assert oh.loop_stats is None


def test_fused_termination_parity():
    """The noise-free 8-pose problem of ``tests/test_fused.py``: whether or
    not early termination triggers, the port's two loops and the JAX
    package's fused loop run the same number of iterations; the port's two
    agree bit for bit, the JAX trace as that test holds it at the noise
    floor."""
    kw = dict(num_poses=8, num_landmarks=40, mean_obs_per_landmark=4.0, kind="mono", seed=53,
              noise_px=0.0, landmark_noise=0.02, pose_noise=0.001, num_fixed_poses=2)
    problem = make_ba_problem(**kw)
    tf, _ = _run(problem, True, 25)
    th, _ = _run(problem, False, 25)
    jopt = jax_optimizer(problem)
    jopt.optimize(25)
    tj = _trace(jopt)
    assert len(tf) == len(th) == len(tj)
    assert tf == th
    np.testing.assert_allclose(tf, tj, rtol=1e-6, atol=1e-12)


def test_fused_carry_invariant_under_rejections(monkeypatch):
    """A rejected trial's candidate never reaches the next linearisation:
    with the rho termination off (``RHO_DONE -> -2`` in both loops) and the
    solve's verdict forced to a failure whenever lambda is below 1000, the
    run alternates bails (chi2 unchanged, the candidate far from the kept
    state) and accepted steps; the fused loop equals the host loop bit for
    bit."""
    problem = make_ba_problem(num_poses=9, num_landmarks=55, mean_obs_per_landmark=4.0,
                              kind="mono", seed=91, noise_px=1.0, landmark_noise=0.3,
                              pose_noise=0.05, num_fixed_poses=2)
    monkeypatch.setattr(fused, "RHO_DONE", -2.0)
    monkeypatch.setattr(host_loop, "RHO_DONE", -2.0)
    real_trial = BlockSolver.trial

    def failing_trial(self, sys, lam):
        new_graph, Fhat, scale, success = real_trial(self, sys, lam)
        return new_graph, Fhat, scale, success & (lam > 1000.0)

    monkeypatch.setattr(BlockSolver, "trial", failing_trial)
    th, oh = _run(problem, False, 20)
    tf, of = _run(problem, True, 20)
    # witness: a bail (chi2 unchanged) followed by an accepted iteration
    rejects = [i for i in range(1, len(th)) if th[i] == th[i - 1]]
    assert rejects and any(th[j] != th[j - 1] for j in range(rejects[0] + 1, len(th))), th
    assert len(th) == 20 and tf == th
    assert _same_state(of, oh)


def test_retry_trials_equal_the_host_loop():
    """Iterations of several trials (the ``retry`` step): a large initial
    lambda factor makes the first iterations reject before they accept.
    Trace and state bit for bit, and more trials than iterations."""
    problem = make_ba_problem(num_poses=10, num_landmarks=60, mean_obs_per_landmark=4.0,
                              seed=7, pose_noise=0.05, landmark_noise=0.3)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fused, "TAU", 1e-12)
        mp.setattr(host_loop, "TAU", 1e-12)
        tf, of = _run(problem, True)
        th, oh = _run(problem, False)
    assert tf == th and _same_state(of, oh)
    assert of.loop_stats["trials"] > len(tf), of.loop_stats


def _lm_grid():
    """(F, Fhat, scale, success, lam, nu, q) over rho near 0, 0.5 and 1,
    negative and large rho, a step that bails (Fhat - F < 1e-4), a worse
    step that does not, NaN Fhat, a zero-sized scale, and lambda that
    overflows to inf on a reject."""
    rows = []
    for F, scale in itertools.product((100.0, 3.5e-7), (2.0, 1e-9)):
        s = scale + 1e-3
        fhats = [F - r * s for r in (-0.3, 1e-12, 1e-7, 0.4999999, 0.5, 0.5000001, 0.9999999,
                                     1.0, 1.5, 1e6)]
        fhats += [F, F + 1e-5, F + 1.0, math.nan]
        for Fhat, success, (lam, nu), q in itertools.product(
                fhats, (True, False), ((1e-4, 2.0), (0.37, 16.0), (1e300, 1e20)), (0, 8, 9)):
            rows.append((F, Fhat, scale, success, lam, nu, q))
    return rows


def test_device_lm_update_equals_the_host_float_rule():
    """``solver/fused.py lm_update`` on f64 device scalars against
    ``solver/host_loop.py lm_update`` / ``lm_done`` in Python floats, bit for bit
    at every point of the grid (NaN where the host has NaN)."""
    rows = _lm_grid()
    cols = list(zip(*rows))
    f64 = dict(dtype=torch.float64)
    accept, F, lam, nu, rho, q, more, done = fused.lm_update(
        torch.tensor(cols[0], **f64), torch.tensor(cols[1], **f64), torch.tensor(cols[2], **f64),
        torch.tensor(cols[3]), torch.tensor(cols[4], **f64), torch.tensor(cols[5], **f64),
        torch.tensor(cols[6], dtype=torch.int32))

    def same(a, b):
        return a == b or (math.isnan(a) and math.isnan(b))

    moved = set()
    for i, (F0, Fhat, scale, success, lam0, nu0, q0) in enumerate(rows):
        h_acc, h_stop, h_rho, h_lam, h_nu, h_q = host_loop.lm_update(
            F0, Fhat, scale, success, lam0, nu0, q0)
        h_more = not h_stop and h_q < fused.MAXQ and h_rho < 0
        h_done = host_loop.lm_done(h_q, h_rho, h_lam)
        got = (bool(accept[i]), F[i].item(), lam[i].item(), nu[i].item(), rho[i].item(),
               int(q[i]), bool(more[i]), bool(done[i]))
        want = (h_acc, Fhat if h_acc else F0, h_lam, h_nu, h_rho, h_q, h_more, h_done)
        assert all(same(g, w) for g, w in zip(got, want)), (rows[i], got, want)
        moved.add((h_acc, h_stop, h_more, h_done, math.isfinite(h_lam)))
    # the grid reaches every branch: accept, bail, retry, stop at MAXQ, overflow
    assert {m[:2] for m in moved} == {(True, True), (False, True), (False, False)}
    assert any(m[2] for m in moved) and any(not m[4] for m in moved)
    assert any(not m[0] and not m[1] and not m[2] for m in moved)


def test_fused_is_the_default_and_verbose_or_profile_take_the_host_loop(monkeypatch, capsys):
    """``use_fused_loop`` defaults to True; ``verbose`` and
    ``set_profile(True)`` take the host loop (its per-iteration lines and
    stage times), as in the JAX package; on the CPU the fused loop captures
    nothing: with CUDA graphs made to raise it still runs."""
    assert TorchGraphOptimisation(device="cpu").use_fused_loop is True
    problem = make_ba_problem(num_poses=6, num_landmarks=40, seed=1)

    def no_graphs(*a, **k):
        raise AssertionError("a CUDA graph was made on the CPU")

    monkeypatch.setattr(torch.cuda, "CUDAGraph", no_graphs)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", no_graphs)
    opt = optimizer_from_problem(problem, device="cpu")
    opt.optimize(3)
    assert opt.loop_stats["captures"] == 0 and opt.loop_stats["trials"] >= 3
    fused_trace = _trace(opt)

    class NoFusedLoop:
        def __init__(self, *a, **k):
            raise AssertionError("the fused loop ran under verbose or profile")

    monkeypatch.setattr(topt, "FusedLoop", NoFusedLoop)
    for flag in ("verbose", "profile"):
        opt = optimizer_from_problem(problem, device="cpu")
        getattr(opt, f"set_{flag}")(True)
        opt.optimize(3)
        assert opt.loop_stats is None and _trace(opt) == fused_trace
    assert "levenberg iterations" in capsys.readouterr().out
    opt = optimizer_from_problem(problem, device="cpu")
    opt.use_fused_loop = False
    opt.optimize(3)
    assert opt.loop_stats is None and _trace(opt) == fused_trace


def test_a_structure_keeps_its_loop_at_its_first_hit_and_replays_it_from_the_second():
    """``reused`` is 0 on a structure-cache miss, which keeps nothing, and
    on the first hit, which keeps its loop, and 1 from the second hit on.
    A reused run's copies in and out are the span ``loop/bind``, counted in
    ``eager_ms``; the solve history carries ``reused``."""
    problem = make_ba_problem(num_poses=8, num_landmarks=40, seed=5)
    got = []
    for _ in range(4):
        _, opt = _run(problem, True, 4)
        got.append(opt.loop_stats["reused"])
        if len(got) == 1:
            assert not opt.solver._struct_bundle.get("loops")
        assert prof.solve_history()[-1]["loop"]["reused"] == got[-1]
    assert got == [0, 0, 1, 1]
    sp, ls = opt.span_profile(), opt.loop_stats
    assert sp["loop/bind"] > 0 and ls["eager_ms"] == sp["loop/eager"] + sp["loop/bind"]
    assert ls["captures"] == ls["replays"] == 0


def test_a_profiled_solve_replays_the_loop_its_structure_kept():
    """A solve under a running torch profiler replays the loop that the
    unprofiled solves of its structure kept (the profiler is no part of a
    kept loop's key), and its trace and final state are an unprofiled
    replay's bit for bit."""
    from torch.profiler import ProfilerActivity, profile

    problem = make_ba_problem(num_poses=8, num_landmarks=40, seed=5)
    runs = [_run(problem, True, 4) for _ in range(3)]  # a miss, the keeping hit, a replay
    with profile(activities=[ProfilerActivity.CPU]):
        traced = _run(problem, True, 4)
    assert [o.loop_stats["reused"] for _, o in runs] == [0, 0, 1]
    assert traced[1].loop_stats["reused"] == 1 and traced[1].loop_stats["captures"] == 0
    assert traced[0] == runs[2][0] and _same_state(traced[1], runs[2][1])


def test_no_loop_is_reused_across_iterations_knobs_robust_kernels_or_weight_layouts():
    """A kept loop serves only its key: another iteration count, another
    plan knob (``solver_precision``: the structure misses its plan), another
    robust kernel or a uniform weight where the kept loop's is per edge
    each run a loop of their own; the kept one is reused between them."""
    problem = _resent(make_ba_problem(num_poses=8, num_landmarks=40, seed=5), 1)
    for _ in range(2):
        _run(problem, True, 4)
    others = [dict(niter=5), dict(rk=2, delta=3.0),
              dict(options=GraphOptimisationOptions(solver_precision="exact")),
              dict(problem=problem._replace(omega=np.full_like(problem.omega, 2.0)))]
    for other in others:
        assert _reused(**dict(dict(problem=problem), **other)) == 0, other
        assert _reused(problem) == 1, other


def test_an_earlier_result_is_not_written_by_a_later_solve_of_its_loop():
    """The optimiser whose solve kept a loop, and the one that replayed it,
    keep their results when a later solve replays the loop again: each gets
    its final state in tensors of its own."""
    problem = _resent(make_ba_problem(num_poses=8, num_landmarks=40, seed=5), 2)
    _run(problem, True, 4)
    earlier = [_run(problem, True, 4)[1]]  # the first hit, which keeps the loop
    earlier.append(_run(_resent(problem, 3), True, 4)[1])
    kept = [[a.clone() for a in o.solver.graph] for o in earlier]
    later = _run(_resent(problem, 4), True, 4)[1]
    assert [o.loop_stats["reused"] for o in earlier + [later]] == [0, 1, 1]
    for o, state in zip(earlier, kept):
        assert all(torch.equal(a, b) for a, b in zip(o.solver.graph, state))
        assert not any(torch.equal(a, b) for a, b in zip(o.solver.graph, later.solver.graph))


def test_evicting_a_structure_drops_its_kept_loop():
    """A kept loop goes with its structure's cache entry, though the
    optimiser that kept it lives on; the structure then misses again."""
    problem = make_ba_problem(num_poses=8, num_landmarks=40, seed=5)
    _run(problem, True, 3)
    opt = _run(problem, True, 3)[1]
    loop = weakref.ref(next(iter(opt.solver._struct_bundle["loops"].values())))
    assert isinstance(loop(), fused.FusedLoop)
    for seed in range(bs._STRUCT_CACHE_MAX):  # packing makes a structure's entry
        optimizer_from_problem(make_ba_problem(num_poses=6, num_landmarks=20, seed=100 + seed),
                               device="cpu")
    gc.collect()
    assert loop() is None and "loops" not in opt.solver._struct_bundle
    assert _reused(problem, 3) == 0 and bs.structure_cache_info()["misses"] == 2
