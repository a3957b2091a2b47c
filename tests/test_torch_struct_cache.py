"""The port's structure cache (``solver/block_solver.py _STRUCT_CACHE``): a
second optimiser over the same topology reuses the RCM order, the symbolic
structure and the plan, and solves bit for bit as the first; any change of
the index arrays or of a plan knob misses; the ninth structure evicts the
first; a structure keeps a plan for each set of knobs, up to four;
cached arrays are read-only."""

import numpy as np
import pytest
import torch

from cuda_bundle_adjustment_tpu_torch import GraphOptimisationOptions
from cuda_bundle_adjustment_tpu_torch.io.arrays import optimizer_from_problem
from cuda_bundle_adjustment_tpu_torch.io.synthetic import (
    make_ba_problem,
    make_loop_closure_problem,
    make_mixed_ba_problem,
)
from cuda_bundle_adjustment_tpu_torch.kernels import pairprod, terms
from cuda_bundle_adjustment_tpu_torch.solver import block_solver as bs
from cuda_bundle_adjustment_tpu_torch.solver import ordering
from cuda_bundle_adjustment_tpu_torch.utils import profiling as prof

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def empty_cache():
    bs.clear_structure_cache()
    yield
    bs.clear_structure_cache()


def _problem(seed=3):
    return make_ba_problem(num_poses=12, num_landmarks=120, seed=seed)


def _solver(problem, **kw):
    s = optimizer_from_problem(problem, device="cpu", **kw).solver
    s.build_structure()
    return s


def _hits_misses():
    info = bs.structure_cache_info()
    return info["hits"], info["misses"]


def _refuse(*a, **k):
    raise AssertionError("a cache hit ran the host analysis")


def test_second_optimiser_hits_and_shares_the_plan(monkeypatch):
    problem = _problem()
    a = _solver(problem)
    assert _hits_misses() == (0, 1) and a.symbolic_ms > 0
    # a hit plans no pose order, runs no symbolic pass and makes no segment plan
    monkeypatch.setattr(ordering, "plan_pose_order", _refuse)
    monkeypatch.setattr(bs, "build_schur_structure", _refuse)
    monkeypatch.setattr(bs, "make_segments", _refuse)
    opt = optimizer_from_problem(problem, device="cpu")
    opt.optimize(1)
    b = opt.solver
    assert _hits_misses() == (1, 1) and bs.structure_cache_info()["size"] == 1
    assert b.symbolic_ms == 0.0 and opt.time_profile()[prof.PROF_SYMBOLIC_DECOMP] == 0.0
    assert b.schur is a.schur
    for name in ("blk_row", "blk_col", "diag_pos", "tri_ei", "tri_ej", "tri_offsets",
                 "pose_seg", "lm_seg", "row_seg", "col_seg", "band"):
        assert getattr(b.plan, name) is getattr(a.plan, name), name
    # the edge index tensors are the solver's own
    assert b.plan.ba_pose_idx is b.packed.pose_idx and b.plan.ba_lm_idx is b.packed.lm_idx
    assert b.plan.ba_lm_idx is not a.plan.ba_lm_idx
    assert b.plan.tri_ei.dtype == torch.int32 and b.plan.tri_offsets.dtype == torch.int64


def _changed_lm_idx(problem):
    lm = problem.lm_idx.copy()
    lm[7] = (lm[7] + 1) % problem.num_active_landmarks
    return problem._replace(lm_idx=lm)


def _changed_pose_idx(problem):
    pi = problem.pose_idx.copy()
    pi[5] = (pi[5] + 1) % problem.num_active_poses
    return problem._replace(pose_idx=pi)


@pytest.mark.parametrize(
    "change",
    [
        ("lm_idx", _changed_lm_idx, None),
        ("pose_idx", _changed_pose_idx, None),
        ("max_band", None, (bs, "MAX_BAND", 40)),
        ("pair_item", None, (pairprod, "ITEM", 64)),
        ("tile", None, (terms, "TILE", 64)),
    ],
    ids=lambda c: c[0],
)
def test_changed_structure_or_knob_misses(change, monkeypatch):
    """One changed index entry at equal sizes, or another plan knob, misses
    and gets a plan of its own."""
    _, edit, knob = change
    problem = _problem()
    a = _solver(problem)
    if knob is not None:
        monkeypatch.setattr(*knob)
    else:
        problem = edit(problem)
        assert problem.pose_idx.shape == problem.lm_idx.shape == a.packed.pose_idx.shape
    b = _solver(problem)
    assert _hits_misses() == (0, 2) and b.symbolic_ms > 0
    assert b.plan.blk_row is not a.plan.blk_row and b.schur is not a.schur


def test_ninth_structure_evicts_the_first():
    problems = [_problem(seed) for seed in range(9)]
    for p in problems:
        _solver(p)
    assert _hits_misses() == (0, 9) and bs.structure_cache_info()["size"] == 8
    _solver(problems[8])
    assert _hits_misses() == (1, 9)
    _solver(problems[0])
    assert _hits_misses() == (1, 10)


def test_solvers_of_other_knobs_keep_their_plans_side_by_side():
    """Solvers of one graph under other knobs (here f64 and f32, as a CPU
    and a card solver are), interleaved: one miss each, then hits, each
    solver's plan its own; a fifth set of knobs evicts the least recently
    used plan of the structure and nothing else."""
    problem = _problem()
    f32 = GraphOptimisationOptions(dtype="float32")
    exact = GraphOptimisationOptions(solver_precision="exact")
    a, b = _solver(problem), _solver(problem, options=f32)
    assert _hits_misses() == (0, 2)
    for _ in range(2):
        a2, b2 = _solver(problem), _solver(problem, options=f32)
    assert _hits_misses() == (4, 2) and bs.structure_cache_info()["size"] == 1
    assert a2.schur is a.schur and b2.schur is b.schur and a.schur is not b.schur
    assert a2.plan.route == a.plan.route and b2.plan.target == torch.float32
    # two more sets of knobs fill the structure's four plans; a fifth evicts
    # the least recently used (f64 "mixed"), which then misses again
    _solver(problem, options=exact)
    _solver(problem, options=GraphOptimisationOptions(dtype="float32", solver_precision="exact"))
    _solver(problem, options=f32)
    with pytest.MonkeyPatch.context() as m:
        m.setattr(bs, "MAX_BAND", 40)
        _solver(problem)
    assert _hits_misses() == (5, 5)
    _solver(problem, options=f32)
    _solver(problem)
    assert _hits_misses() == (6, 6)


def test_cached_arrays_are_read_only():
    problem = make_loop_closure_problem(
        num_poses=60, num_landmarks=600, long_range_fraction=0.02, seed=5
    )
    s = _solver(problem)
    assert s.pose_perm is not None  # RCM reordered this graph
    arrays = [s.pose_perm] + [a for a in s.schur if isinstance(a, np.ndarray)]
    assert len(arrays) == 9
    for a in arrays:
        assert not a.flags.writeable
        with pytest.raises(ValueError):
            a[:1] = 0
    assert _solver(problem).pose_perm is s.pose_perm


@pytest.mark.parametrize(
    "make,robust",
    [
        (lambda: make_ba_problem(num_poses=12, num_landmarks=150, seed=2), {}),
        (lambda: make_mixed_ba_problem(num_poses=10, num_landmarks=60,
                                       mean_obs_per_landmark=4.0, seed=6), dict(rk=1, delta=3.0)),
        (lambda: make_loop_closure_problem(num_poses=60, num_landmarks=600,
                                           long_range_fraction=0.02, seed=5), {}),
    ],
    ids=["mono", "mixed_tukey", "rcm_reordered"],
)
def test_hit_solves_bit_for_bit_as_the_miss(make, robust):
    problem = make()
    runs = []
    for expect in ((0, 1), (1, 1)):
        opt = optimizer_from_problem(problem, device="cpu", **robust)
        opt.optimize(8)
        assert _hits_misses() == expect
        runs.append(opt)
    miss, hit = runs
    assert [s.chi2 for s in hit.batch_statistics().get()] == [
        s.chi2 for s in miss.batch_statistics().get()]
    for got, want in [*zip(hit.solver.result_poses(), miss.solver.result_poses()),
                      (hit.solver.result_landmarks(), miss.solver.result_landmarks())]:
        np.testing.assert_array_equal(got, want)
