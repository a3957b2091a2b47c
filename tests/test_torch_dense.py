"""The dense route of the port's reduced solve (``solve_reduced_dense``:
``solver_precision="exact"``, and Hsc bands wider than ``MAX_BAND`` on fewer
than ``PCG_MIN_POSES`` poses) against the JAX package's dense branch on the
CPU and the numpy ``DenseLM`` oracle, and the route each input takes.

The JAX package's CPU path solves these graphs densely, so under ``"exact"`` the
two run the same algorithm (an f64 Cholesky of the Jacobi-scaled matrix and
two triangular solves): a step is held at 1e-12 of its largest entry and a
10-iteration trace at rtol 1e-10.  Under ``"mixed"`` both factor in f32 and
refine twice in f64: 1e-9, as the port's band route is held.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_bundle_adjustment_tpu.graph import GraphOptimisationOptions as JaxOptions
from cuda_bundle_adjustment_tpu.io.arrays import optimizer_from_problem as jax_optimizer
from cuda_bundle_adjustment_tpu.solver import block_solver as jbs
from cuda_bundle_adjustment_tpu_torch import GraphOptimisationOptions
from cuda_bundle_adjustment_tpu_torch.io.arrays import optimizer_from_problem
from cuda_bundle_adjustment_tpu_torch.io.synthetic import make_ba_problem, make_loop_closure_problem
from cuda_bundle_adjustment_tpu_torch.solver import block_solver as tbs
from cuda_bundle_adjustment_tpu_torch.solver.fused import TAU
from cuda_bundle_adjustment_tpu_torch.utils.dense_reference import DenseLM

torch.set_num_threads(1)

EXACT = dict(solver_precision="exact")


def _trace(opt):
    return [s.chi2 for s in opt.batch_statistics().get()]


def _close(got, want, tol):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=tol * np.abs(want).max())


def _loop_closure():
    """A global BA with loop closures: long-range co-visibility everywhere,
    so no pose order gives a band of 48 blocks (RCM leaves 91)."""
    return make_loop_closure_problem(num_poses=120, num_landmarks=1200,
                                     long_range_fraction=0.3, seed=2)


@pytest.mark.parametrize("kind", ["mono", "stereo"])
def test_exact_step_matches_the_jax_dense_step(kind):
    """One ``"exact"`` step on the same reduced system: the port's dense
    route (f64 Cholesky, one solve) against the JAX package's
    ``_solve_reduced_blocks`` with ``mixed=False`` at 1e-12."""
    problem = make_ba_problem(num_poses=14, num_landmarks=100, mean_obs_per_landmark=4.0,
                              kind=kind, seed=21)
    js = jax_optimizer(problem, options=JaxOptions(**EXACT)).solver
    js.build_structure()
    ts = optimizer_from_problem(problem, options=GraphOptimisationOptions(**EXACT),
                                device="cpu").solver
    ts.build_structure()
    assert ts.plan.route == "dense" and ts.plan.target == torch.float64
    _, jsys = js.head()
    p = js.plan
    # the first trial's damping: TAU x the max diagonal
    jb, jbsc, _ = jbs.schur_reduce(jsys, jnp.asarray(1e-5 * float(jbs.max_diagonal(jsys))), p,
                                   js.Pa, js.La, js.schur.nnz_blocks)
    jxp, jok = jbs._solve_reduced_blocks(jb, p.blk_row, p.blk_col, p.diag_pos, jbsc, js.Pa, False,
                                         p.blk_row_plan, p.blk_col_plan, p.band, p.pcg)
    xp, ok = tbs.solve_reduced(torch.as_tensor(np.array(jb)), torch.as_tensor(np.array(jbsc)),
                               ts.plan)
    assert bool(ok) and bool(jok) and xp.dtype == torch.float64
    _close(xp.numpy(), jxp, 1e-12)


@pytest.mark.parametrize("fused_loop", [True, False], ids=["fused", "host"])
@pytest.mark.parametrize("kind,rk", [("mono", 0), ("stereo", 0), ("mono", 3)],
                         ids=["mono", "stereo", "mono-huber"])
def test_exact_trace_matches_jax(kind, rk, fused_loop):
    """``optimize(10)`` under ``"exact"`` on a banded graph: the port takes
    the dense route, as the JAX package does where the factor's type is
    f64, and its trace matches the JAX package's ``"exact"`` trace at rtol
    1e-10 through either loop, and ``DenseLM`` at 1e-6."""
    robust = dict(rk=rk, delta=3.0) if rk else {}
    problem = make_ba_problem(num_poses=10, num_landmarks=50, mean_obs_per_landmark=4.0,
                              kind=kind, seed=5)
    opt = optimizer_from_problem(problem, options=GraphOptimisationOptions(**EXACT),
                                 device="cpu", **robust)
    opt.use_fused_loop = fused_loop
    opt.optimize(10)
    assert opt.solver.plan.route == "dense" and opt.solver.plan.band.bw + 1 <= tbs.MAX_BAND
    jopt = jax_optimizer(problem, options=JaxOptions(**EXACT), **robust)
    jopt.optimize(10)
    got = _trace(opt)
    assert len(got) == len(_trace(jopt)) == 10
    np.testing.assert_allclose(got, _trace(jopt), rtol=1e-10)
    np.testing.assert_allclose(got, DenseLM(problem, **robust).optimize(10), rtol=1e-6)


def test_exact_fused_loop_equals_the_host_loop_bit_for_bit():
    """The dense route inside the fused loop's steps (on the card, inside
    its captured graphs): trace and final state bit for bit the host
    loop's, as on the band route."""
    problem = make_ba_problem(num_poses=10, num_landmarks=60, mean_obs_per_landmark=4.0,
                              kind="stereo", seed=6)
    runs = []
    for fused_loop in (True, False):
        opt = optimizer_from_problem(problem, options=GraphOptimisationOptions(**EXACT),
                                     device="cpu")
        opt.use_fused_loop = fused_loop
        opt.optimize(10)
        runs.append(opt)
    assert _trace(runs[0]) == _trace(runs[1])
    assert all(torch.equal(a, b) for a, b in zip(runs[0].solver.graph, runs[1].solver.graph))


def test_loop_closure_graph_takes_the_dense_route_and_matches_jax_and_dense_oracle():
    """A band wider than 48 on fewer than 1024 poses solves on the dense
    route under ``"mixed"`` (f32 factor, two f64 refinement rounds, the
    1e-8 residual test), as the JAX package's CPU path does: trace at rtol
    1e-9 against it over 10 iterations, final state at 1e-9 of its scale,
    and ``DenseLM`` at 1e-6 over the same 10."""
    problem = _loop_closure()
    opt = optimizer_from_problem(problem, device="cpu")
    opt.optimize(10)
    plan = opt.solver.plan
    assert plan.route == "dense" and plan.band.bw + 1 > tbs.MAX_BAND
    assert plan.target == torch.float32 and opt.solver.mixed
    jopt = jax_optimizer(problem)
    jopt.optimize(10)
    got = _trace(opt)
    assert len(got) == len(_trace(jopt)) == 10
    np.testing.assert_allclose(got, _trace(jopt), rtol=1e-9)
    La = opt.solver.La
    for a, b in [(opt.solver.result_landmarks()[:La], jopt.solver.result_landmarks()[:La]),
                 *zip(opt.solver.result_poses(), jopt.solver.result_poses())]:
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-9 * np.abs(b).max())
    np.testing.assert_allclose(got, DenseLM(problem).optimize(10), rtol=1e-6)


@pytest.mark.parametrize("mode", ["f32", "exact"])
def test_loop_closure_graph_in_f32_and_exact(mode):
    """The same graph on the dense route in f32 (an f32 factor, one solve,
    success = finite) against the JAX package's f32 trace at rtol 1e-3 and
    the port's f64 trace at rtol 1e-3; under ``"exact"`` at f64 (an f64
    factor, one solve) against the JAX package's ``"exact"`` at 1e-10."""
    problem = _loop_closure()
    if mode == "f32":
        opt = optimizer_from_problem(
            problem, options=GraphOptimisationOptions(dtype="float32"), device="cpu")
        jopt = jax_optimizer(problem, options=JaxOptions(dtype="float32"))
        tol = 1e-3
    else:
        opt = optimizer_from_problem(problem, options=GraphOptimisationOptions(**EXACT),
                                     device="cpu")
        jopt = jax_optimizer(problem, options=JaxOptions(**EXACT))
        tol = 1e-10
    opt.optimize(10)
    jopt.optimize(10)
    assert opt.solver.plan.route == "dense" and opt.solver.plan.target == opt.solver.dtype
    got = _trace(opt)
    assert len(got) == len(_trace(jopt)) == 10
    np.testing.assert_allclose(got, _trace(jopt), rtol=tol)
    if mode == "f32":
        o64 = optimizer_from_problem(problem, device="cpu")
        o64.optimize(10)
        np.testing.assert_allclose(got, _trace(o64), rtol=1e-3)


def _no_host_read(monkeypatch):
    """Make every read of a tensor's value on the host raise."""
    def refuse(*a, **k):
        raise AssertionError("a tensor was read on the host")

    for name in ("__bool__", "item", "tolist", "__float__", "__int__", "numpy"):
        monkeypatch.setattr(torch.Tensor, name, refuse)


@pytest.mark.parametrize("dtype,precision", [("float64", "exact"), ("float64", "mixed"),
                                             ("float32", "mixed")],
                         ids=["f64-exact", "f64-mixed", "f32"])
def test_indefinite_system_fails_on_the_device(monkeypatch, dtype, precision):
    """An indefinite reduced system (positive diagonal, one off-diagonal
    block scaled far past it) on the dense route: ``cholesky_ex`` reports
    ``info > 0`` and the verdict is False, folded on the device; nothing is
    read on the host and nothing raises.  A positive definite system of the
    same plan succeeds."""
    opts = GraphOptimisationOptions(dtype=dtype, solver_precision=precision)
    s = optimizer_from_problem(_loop_closure(), options=opts, device="cpu").solver
    s.build_structure()
    assert s.plan.route == "dense"
    _, sys_ = s.head()
    blocks, bsc, _ = tbs.schur_reduce(sys_, TAU * tbs.max_diagonal(sys_), s.plan)
    off = int(torch.nonzero(s.plan.blk_row != s.plan.blk_col)[0, 0])
    bad = blocks.clone()
    bad[off] = bad[off] * 1e4
    with monkeypatch.context() as m:
        _no_host_read(m)
        xp_bad, ok_bad = tbs.solve_reduced(bad, bsc, s.plan)
        xp_good, ok_good = tbs.solve_reduced(blocks, bsc, s.plan)
    assert ok_bad.dim() == 0 and ok_bad.dtype == torch.bool
    assert not bool(ok_bad) and bool(ok_good)
    bl_s, _, _ = tbs.scaled_blocks(bad, bsc, s.plan)
    _, info = torch.linalg.cholesky_ex(tbs.dense_scaled(bl_s, s.plan, s.plan.target))
    assert int(info) > 0


def test_the_route_table():
    """Which route each input takes, decided once a structure: the band
    (B7/B8) only where the factor is f32 and the band fits; the dense route
    below 1024 poses at any band, and under ``"exact"`` at f64 from there
    only on a band that passes the JAX package's VMEM test; a wider band on
    1024 poses takes PCG (ROADMAP A6), on both sides of the limit."""
    banded = make_ba_problem(num_poses=10, num_landmarks=50, seed=5)
    cases = [
        (banded, "float64", "mixed", "band", torch.float32),
        (banded, "float64", "exact", "dense", torch.float64),
        (banded, "float32", "mixed", "band", torch.float32),
        (banded, "float32", "exact", "band", torch.float32),
        (_loop_closure(), "float64", "mixed", "dense", torch.float32),
        (_loop_closure(), "float64", "exact", "dense", torch.float64),
        (_loop_closure(), "float32", "mixed", "dense", torch.float32),
    ]
    for problem, dtype, precision, route, target in cases:
        opts = GraphOptimisationOptions(dtype=dtype, solver_precision=precision)
        s = optimizer_from_problem(problem, options=opts, device="cpu").solver
        s.build_structure()
        assert (s.plan.route, s.plan.target) == (route, target), (dtype, precision)
        assert s.plan.pcg is None
    # 1023 free poses (one fixed): dense; 1024: PCG, with its plan
    for num_poses, route in ((1024, "dense"), (1025, "pcg")):
        problem = make_loop_closure_problem(num_poses=num_poses, num_landmarks=3000,
                                            long_range_fraction=0.3, seed=2)
        s = optimizer_from_problem(problem, device="cpu").solver
        assert s.Pa == num_poses - 1
        s.build_structure()
        assert s.plan.route == route and s.plan.band.bw + 1 > tbs.MAX_BAND
        assert (s.plan.pcg is not None) == (route == "pcg")


@pytest.mark.parametrize("height", [48, 49])
@pytest.mark.parametrize("Pa", [1023, 1024])
@pytest.mark.parametrize("target", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_the_band_rule_on_both_sides_of_each_boundary(height, Pa, target):
    """``reduced_route`` at band height 48 and 49, on 1023 and 1024 poses,
    for an f32 factor (f64 ``"mixed"``, f32) and an f64 one (``"exact"``):
    the band where it fits and the factor is f32, dense below 1024 poses,
    else PCG.  An f64 factor at height 48 on 1024 poses is past the JAX
    package's VMEM test (``(1024 + 48) 48 512 B`` over 11 MiB), so it takes
    PCG there as in the JAX package."""
    fits = height <= tbs.MAX_BAND
    if fits and target == torch.float32:
        want = "band"
    else:
        want = "dense" if Pa < tbs.PCG_MIN_POSES else "pcg"
    assert tbs.reduced_route(height - 1, Pa, target) == want


@pytest.mark.parametrize("Pa, want", [(1321, "dense"), (1392, "dense"), (1393, "pcg"),
                                      (9999, "pcg")])
def test_the_exact_route_at_the_jax_vmem_test(Pa, want):
    """An f64 factor on a band of height 12 (SB 16) from 1024 poses: dense
    where ``(Pa + 16) 16 512 B`` is within 11 MiB (``kitti00_mono_exact``'s
    1321 poses; 1392 the last), PCG past it (1393, and the city-scale
    graph's 9999, whose two dense ``[6 Pa, 6 Pa]`` f64 matrices would take
    ~58 GB), as the JAX package's dense branch runs; an f32 factor keeps the
    band."""
    bw = 11
    assert tbs.band_meta(np.array([0]), np.array([bw])).sb == 16
    assert ((Pa + 16) * 16 * 512 <= 11 * 2**20) == (want == "dense")
    assert tbs.reduced_route(bw, Pa, torch.float64) == want
    assert tbs.reduced_route(bw, Pa, torch.float32) == "band"


def test_a_graph_past_the_jax_vmem_limit_keeps_the_band():
    """1400 free poses at band height 16: past the JAX package's VMEM test
    (``(Pa + SB) SB 512 B`` over 11 MiB, which sends it to PCG there), the
    port keeps the band, whose kernels stream it."""
    problem = make_ba_problem(num_poses=1401, num_landmarks=3000, mean_obs_per_landmark=4.0,
                              seed=5)
    s = optimizer_from_problem(problem, device="cpu").solver
    s.build_structure()
    Pa, sb = s.Pa, s.plan.band.sb
    assert Pa >= tbs.PCG_MIN_POSES and sb == 16
    assert (Pa + sb) * sb * 512 > 11 * 2**20
    assert s.plan.route == "band" and s.plan.pcg is None


def test_exact_past_the_jax_vmem_limit_takes_pcg_as_the_jax_package():
    """The same 1401-pose graph under ``"exact"``: past the VMEM test an f64
    factor takes PCG, as in the JAX package (whose CPU path takes PCG from
    1024 poses); the 3-iteration trace at rtol 1e-6 of the JAX package's,
    the bar ``tests/test_torch_pcg.py`` holds PCG to."""
    problem = make_ba_problem(num_poses=1401, num_landmarks=3000, mean_obs_per_landmark=4.0,
                              seed=5)
    opt = optimizer_from_problem(problem, options=GraphOptimisationOptions(**EXACT),
                                 device="cpu")
    opt.optimize(3)
    assert opt.solver.plan.route == "pcg" and opt.solver.plan.pcg is not None
    assert opt.solver.plan.target == torch.float64
    jopt = jax_optimizer(problem, options=JaxOptions(**EXACT))
    jopt.optimize(3)
    assert jopt.solver.plan.pcg is not None and jopt.solver.plan.band is None
    assert len(_trace(opt)) == len(_trace(jopt)) == 3
    np.testing.assert_allclose(_trace(opt), _trace(jopt), rtol=1e-6)
