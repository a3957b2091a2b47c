"""The PyTorch port's copied modules and pipeline stages against the JAX
package on the CPU (real f64), on the same inputs.

Stage tolerances are 1e-12 relative to the largest magnitude of the
compared array (the two sum the same terms in different orders), except
1e-9 where the f32 band factor enters (the refined pose step).
"""

import ast
import functools
import inspect

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from chip_smoke import borderline_population, reverse_pose_blocks
from cuda_bundle_adjustment_tpu.io import synthetic as jsyn
from cuda_bundle_adjustment_tpu.io.arrays import optimizer_from_problem as jax_optimizer
from cuda_bundle_adjustment_tpu.solver import block_solver as jbs
from cuda_bundle_adjustment_tpu.solver import ordering as jord
from cuda_bundle_adjustment_tpu.solver import symbolic as jsym
from cuda_bundle_adjustment_tpu.types import GraphArrays as JaxGraph
from cuda_bundle_adjustment_tpu.utils import dense_reference as jdense
from cuda_bundle_adjustment_tpu.utils import stats as jstats
import cuda_bundle_adjustment_tpu as jba
import cuda_bundle_adjustment_tpu_torch as tbt
from cuda_bundle_adjustment_tpu_torch import TorchGraphOptimisation
from cuda_bundle_adjustment_tpu_torch.io import synthetic as tsyn
from cuda_bundle_adjustment_tpu_torch.io.arrays import optimizer_from_problem
from cuda_bundle_adjustment_tpu_torch.solver import block_solver as tbs
from cuda_bundle_adjustment_tpu_torch.solver import ordering as tord
from cuda_bundle_adjustment_tpu_torch.solver import symbolic as tsym
from cuda_bundle_adjustment_tpu_torch.types import GraphArrays, SystemBlocks
from cuda_bundle_adjustment_tpu_torch.utils import dense_reference as tdense
from cuda_bundle_adjustment_tpu_torch.utils import stats as tstats

torch.set_num_threads(1)


def _t(a):
    return torch.as_tensor(np.array(a))


def _close(got, want, rtol):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=rtol * np.abs(want).max())


# -- copies --------------------------------------------------------------------


@pytest.mark.parametrize(
    "orig,copy", [(jsyn, tsyn), (jdense, tdense), (jstats, tstats)],
    ids=["synthetic", "dense_reference", "stats"],
)
def test_numpy_modules_are_verbatim_copies(orig, copy):
    """Same code statement for statement (module docstrings may differ)."""

    def body(mod):
        tree = ast.parse(inspect.getsource(mod))
        stmts = tree.body
        if stmts and isinstance(stmts[0], ast.Expr) and isinstance(stmts[0].value, ast.Constant):
            stmts = stmts[1:]
        return [ast.dump(s) for s in stmts]

    assert body(copy) == body(orig)


@pytest.mark.parametrize("seed,kind", [(0, "mono"), (3, "stereo"), (7, "depth")])
def test_synthetic_copy_gives_identical_arrays(seed, kind):
    kw = dict(num_poses=30, num_landmarks=400, kind=kind, seed=seed)
    for a, b in zip(jsyn.make_ba_problem(**kw), tsyn.make_ba_problem(**kw)):
        np.testing.assert_array_equal(a, b)


def test_kitti00_problem_copy_gives_identical_arrays():
    a = jsyn.kitti00_scale_problem(kind="mono", seed=0)
    b = tsyn.kitti00_scale_problem(kind="mono", seed=0)
    assert b.pose_q.shape == (1322, 4) and b.landmarks.shape == (133383, 3)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_dense_reference_copy_gives_identical_trace():
    p = jsyn.make_ba_problem(num_poses=8, num_landmarks=40, seed=4)
    a, b = jdense.DenseLM(p), tdense.DenseLM(p)
    assert a.optimize(4) == b.optimize(4)
    for x, y in [(a.q, b.q), (a.t, b.t), (a.Xw, b.Xw)]:
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("long_range", [0.0, 0.02])
def test_ordering_copy_gives_identical_permutation(long_range):
    p = jsyn.make_loop_closure_problem(
        num_poses=150, num_landmarks=1500, long_range_fraction=long_range, seed=5
    )
    Pa, La = p.num_active_poses, p.num_active_landmarks
    want = jord.plan_pose_order(p.pose_idx, p.lm_idx, Pa, La)
    got = tord.plan_pose_order(p.pose_idx, p.lm_idx, Pa, La)
    assert got[1:] == want[1:]
    if want[0] is None:
        assert got[0] is None
    else:
        np.testing.assert_array_equal(got[0], want[0])
    keys = jord.pose_pairs(p.pose_idx, p.lm_idx, Pa, La)
    np.testing.assert_array_equal(tord.pose_pairs(p.pose_idx, p.lm_idx, Pa, La), keys)
    np.testing.assert_array_equal(tord.rcm_order(keys, Pa), jord.rcm_order(keys, Pa))


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_symbolic_copy_gives_identical_structure(seed):
    p = jsyn.make_ba_problem(num_poses=12, num_landmarks=150, seed=seed)
    args = (p.pose_idx, p.lm_idx, p.num_active_poses, p.num_active_landmarks)
    want = jsym.build_schur_structure(*args, use_native=False)
    got = tsym.build_schur_structure(*args, use_native=False)
    for name in want._fields:
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
    # triples in target-block order, each block's run in enumeration order
    ei, ej, off = tsym.sort_triples(got)
    k = np.repeat(np.arange(got.nnz_blocks), np.diff(off))
    order = np.lexsort((np.arange(got.tri_k.size), got.tri_k))
    np.testing.assert_array_equal(k, got.tri_k[order])
    np.testing.assert_array_equal(ei, got.tri_ei[order])
    np.testing.assert_array_equal(ej, got.tri_ej[order])


# -- stages ---------------------------------------------------------------------


def _both_systems(problem, jproblem=None, **robust):
    """Both solvers on one problem, their first linearisation, and the JAX
    system in the port's order (``jproblem``: the JAX package's own problem
    class, where it differs; ``robust``: ``rk`` and ``delta`` for both)."""
    js = jax_optimizer(problem if jproblem is None else jproblem, **robust).solver
    js.build_structure()
    jchi, jsys = js.head()
    ts = optimizer_from_problem(problem, device="cpu", **robust).solver
    ts.build_structure()
    tchi, tsys = ts.head()
    lay = js.group_layout
    perm = lay.edge_perm
    rows = perm >= 0
    Hpl = np.zeros((ts.packed.pose_idx.shape[0], 18))
    Hpl[perm[rows]] = np.asarray(jsys.Hpl)[rows]
    ren = lay.lm_renumber[: js.La_real]
    psys = SystemBlocks(
        Hpp=_t(jsys.Hpp), bp=_t(jsys.bp), Hll=_t(np.asarray(jsys.Hll)[ren]),
        bl=_t(np.asarray(jsys.bl)[ren]), Hpl=_t(Hpl),
    )
    # the first LM trial's damping (TAU x max diagonal): the refined step is
    # compared at 1e-9, which needs the conditioning LM damping gives
    lam = 1e-5 * float(jbs.max_diagonal(jsys))
    return dict(js=js, jsys=jsys, jchi=jchi, ts=ts, tsys=tsys, tchi=tchi,
                psys=psys, ren=ren, lam=lam)


@pytest.fixture(scope="module")
def systems():
    """Both solvers on one problem (duplicate pose observations included)."""
    return _both_systems(jsyn.make_ba_problem(
        num_poses=14, num_landmarks=100, mean_obs_per_landmark=4.0, seed=21
    ))


def test_build_system_matches_jax(systems):
    s = systems
    _close(float(s["tchi"]), float(s["jchi"]), 1e-12)
    for name in ("Hpp", "bp", "Hll", "bl", "Hpl"):
        _close(getattr(s["tsys"], name).numpy(), getattr(s["psys"], name).numpy(), 1e-12)


@pytest.mark.parametrize("kind", ["stereo", "mixed"])
def test_build_system_matches_jax_stereo_and_mixed(kind):
    """chi and the system of a stereo set and of a merged mono+stereo pair."""
    kw = dict(num_poses=12, num_landmarks=90, mean_obs_per_landmark=4.0, seed=22)
    if kind == "mixed":
        s = _both_systems(tsyn.make_mixed_ba_problem(**kw), jsyn.make_mixed_ba_problem(**kw))
        assert s["ts"].packed.mask3 is not None
    else:
        s = _both_systems(jsyn.make_ba_problem(kind=kind, **kw))
    _close(float(s["tchi"]), float(s["jchi"]), 1e-12)
    for name in ("Hpp", "bp", "Hll", "bl", "Hpl"):
        _close(getattr(s["tsys"], name).numpy(), getattr(s["psys"], name).numpy(), 1e-12)


@pytest.mark.parametrize("rk", [1, 2, 3], ids=["tukey", "cauchy", "huber"])
@pytest.mark.parametrize("kind", ["mono", "stereo", "mixed"])
def test_robust_chi_and_system_match_jax(kind, rk):
    """chi (rho on kernel B1's per-edge x) and the system (kernel B3 with the
    weight rescaled by rho') under Tukey, Cauchy and Huber against the JAX
    package, with edges on both sides of delta."""
    kw = dict(num_poses=12, num_landmarks=90, mean_obs_per_landmark=4.0, seed=22)
    robust = dict(rk=rk, delta=3.0)
    if kind == "mixed":
        s = _both_systems(
            tsyn.make_mixed_ba_problem(**kw), jsyn.make_mixed_ba_problem(**kw), **robust
        )
    else:
        s = _both_systems(jsyn.make_ba_problem(kind=kind, **kw), **robust)
    ts = s["ts"]
    assert ts.meta.rk == rk and ts.meta.delta == 3.0
    from cuda_bundle_adjustment_tpu_torch.kernels import chi_edges
    from cuda_bundle_adjustment_tpu_torch.models.ba import edge_state

    x = chi_edges(*edge_state(ts.graph, ts.packed), ts.packed)
    assert bool((x > 9.0).any()) and bool(((x > 0) & (x <= 9.0)).any())
    _close(float(s["tchi"]), float(s["jchi"]), 1e-12)
    for name in ("Hpp", "bp", "Hll", "bl", "Hpl"):
        _close(getattr(s["tsys"], name).numpy(), getattr(s["psys"], name).numpy(), 1e-12)


def test_merge_ba_specs_matches_jax():
    """The mono+stereo merge against the JAX package's on the same specs:
    per-edge weights, masks, inactive rows and outlier thresholds included;
    unmergeable sets pass through."""
    mp = tsyn.make_mixed_ba_problem(num_poses=8, num_landmarks=60, seed=4)
    rng = np.random.default_rng(0)
    mono, stereo = (dict(s) for s in mp.specs)
    mono["omega"] = rng.uniform(0.5, 2.0, mono["meas"].shape[0])
    stereo["active"] = (rng.uniform(size=stereo["meas"].shape[0]) > 0.2).astype(np.float64)
    stereo["outlier_threshold"] = 5.0
    for specs in ([mono, stereo], [stereo, mono], [mono, dict(stereo, rk=2)], [mono]):
        want = jbs._merge_ba_specs(specs)
        got = tbs._merge_ba_specs(specs)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            # the un-merge map (merged_sizes) included: update_edges splits
            # a merged set's mask back by it
            assert g.keys() == w.keys()
            for k in g:
                np.testing.assert_array_equal(np.asarray(g[k]), np.asarray(w[k]), err_msg=k)


def test_schur_reduce_matches_jax(systems):
    s = systems
    js = s["js"]
    jb, jbsc, jinv = jbs.schur_reduce(
        s["jsys"], jnp.asarray(s["lam"]), js.plan, js.Pa, js.La, js.schur.nnz_blocks
    )
    blocks, bsc, inv = tbs.schur_reduce(s["psys"], s["lam"], s["ts"].plan)
    _close(blocks.numpy(), jb, 1e-12)
    # the port forms bsc as Hpl (inv(Hll) bl), as the JAX kernel path does;
    # the CPU path here forms (Hpl inv(Hll)) bl.  The rounding differs
    # relative to the terms bp - sum(...) cancels, so measure it against bp
    bscale = np.abs(np.asarray(s["jsys"].bp)).max()
    np.testing.assert_allclose(bsc.numpy(), np.asarray(jbsc), rtol=0, atol=1e-12 * bscale)
    _close(inv.numpy(), np.asarray(jinv)[s["ren"]], 1e-12)


def _jax_step(s):
    js = s["js"]
    p = js.plan
    jb, jbsc, jinv = jbs.schur_reduce(
        s["jsys"], jnp.asarray(s["lam"]), p, js.Pa, js.La, js.schur.nnz_blocks
    )
    xp, ok = jbs._solve_reduced_blocks(
        jb, p.blk_row, p.blk_col, p.diag_pos, jbsc, js.Pa, True,
        p.blk_row_plan, p.blk_col_plan, p.band, p.pcg,
    )
    return jb, jbsc, jinv, xp, ok


def test_refined_pose_step_matches_jax(systems):
    """Band twins (B7/B8) + two f64 refinement rounds against the JAX
    package's mixed solve (dense f32 factor + refinement on the CPU)."""
    s = systems
    jb, jbsc, _, jxp, jok = _jax_step(s)
    xp, ok = tbs.solve_reduced_band(_t(jb), _t(jbsc), s["ts"].plan)
    assert bool(ok) and bool(jok)
    _close(xp.numpy(), jxp, 1e-9)


def test_refined_pose_step_matches_jax_on_the_wide_band():
    """The same step at band height 32 (the range of the JAX package's v1
    factor): the renamed 80-pose graph's first trial through the port's band
    twins against the JAX package's mixed solve of the same numpy problem."""
    wide_problem, _ = reverse_pose_blocks(
        jsyn.make_ba_problem(num_poses=80, num_landmarks=1500, seed=2)
    )
    s = _both_systems(wide_problem)
    assert s["ts"].plan.band == (31, 32) and s["ts"].pose_perm is None
    for name in ("Hpp", "bp", "Hll", "bl", "Hpl"):
        _close(getattr(s["tsys"], name).numpy(), getattr(s["psys"], name).numpy(), 1e-12)
    jb, jbsc, _, jxp, jok = _jax_step(s)
    blocks, bsc, _ = tbs.schur_reduce(s["tsys"], s["lam"], s["ts"].plan)
    _close(blocks.numpy(), jb, 1e-12)
    xp, ok = tbs.solve_reduced_band(blocks, bsc, s["ts"].plan)
    assert bool(ok) and bool(jok)
    _close(xp.numpy(), jxp, 1e-9)


def test_borderline_step_is_taken_and_equals_the_jax_dense_step(monkeypatch):
    """The tenth Cauchy iteration of the 16-pose mono graph reaches a reduced
    system (scaled condition ~3e6) on which two refinement rounds of an f32
    band factor end near the 1e-8 residual limit.  With the factor's window
    accumulated in f64 the port's band twins take all ten steps, as the JAX
    package's band kernels (interpret mode, the accelerator's route: v2
    factor, two rounds) and its dense CPU route (three rounds) take the
    tenth; the port's step equals the JAX dense step to 1e-6 of its largest
    entry.  tests/test_torch_population.py holds the same over 320 systems."""
    from cuda_bundle_adjustment_tpu.pallas import bandchol as jband

    systems = borderline_population(2, [13])
    assert [s["ok"] for s in systems] == [True] * 10
    last = systems[-1]
    blocks, bsc, p = last["blocks"], last["bsc"], last["plan"]

    for name in ("band_factor2", "band_solve"):
        monkeypatch.setattr(jband, name, functools.partial(getattr(jband, name), interpret=True))
    args = (jnp.asarray(blocks.numpy()), jnp.asarray(p.blk_row.numpy()),
            jnp.asarray(p.blk_col.numpy()), jnp.asarray(p.diag_pos.numpy()),
            jnp.asarray(bsc.numpy()), bsc.shape[0], True)
    assert p.band.sb * 6 <= 128  # the v2 factor
    jxp_band, jok_band = jbs._solve_reduced_blocks(*args, band=jbs.BandMeta(*p.band))
    jxp_dense, jok_dense = jbs._solve_reduced_blocks(*args)
    assert bool(jok_band) and bool(jok_dense)
    _close(np.asarray(jxp_band), np.asarray(jxp_dense), 1e-6)
    _close(last["xp"].numpy(), np.asarray(jxp_dense), 1e-6)


def test_back_substitute_matches_jax(systems):
    s = systems
    js = s["js"]
    _, _, jinv, jxp, _ = _jax_step(s)
    jxl = jbs.schur_back_substitute(s["jsys"], jinv, jxp, js.plan, js.Pa)
    ren = s["ren"]
    xl = tbs.schur_back_substitute(
        s["psys"], _t(np.asarray(jinv)[ren]), _t(jxp), s["ts"].plan
    )
    _close(xl.numpy(), np.asarray(jxl)[ren], 1e-12)


def test_apply_update_matches_jax():
    """SE3-exp update, both Rodrigues branches (rows 0-1 below the
    theta < 1e-5 Taylor threshold), and the landmark update."""
    rng = np.random.default_rng(9)
    P, Pa, L, La = 12, 10, 30, 25
    q = rng.normal(size=(P, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    t, Xw = rng.normal(size=(P, 3)), rng.normal(size=(L, 3))
    xp = rng.normal(scale=0.05, size=(Pa, 6))
    xp[:2, :3] *= 1e-5
    xl = rng.normal(scale=0.1, size=(La, 3))
    want = jbs.apply_update(
        JaxGraph(jnp.asarray(q), jnp.asarray(t), jnp.asarray(Xw)),
        jnp.asarray(xp), jnp.asarray(xl), Pa, La,
    )
    got = tbs.apply_update(GraphArrays(_t(q), _t(t), _t(Xw)), _t(xp), _t(xl))
    for g, w in zip(got, want):
        _close(g.numpy(), w, 1e-12)


# -- what runs since ROADMAP A7's rest ---------------------------------------------


def _mono(**kw):
    return tsyn.make_ba_problem(num_poses=6, num_landmarks=30, seed=1, **kw)


def _cpu(problem, **kw):
    return optimizer_from_problem(problem, device="cpu", **kw)


def _array_opt(pkg, problem, **kw):
    """The optimiser of ``pkg`` ("jax" or "torch") packed from ``problem``."""
    return jax_optimizer(problem, **kw) if pkg == "jax" else _cpu(problem, **kw)


def _unmerged_mixed(pkg):
    """A mono and a stereo set whose robust kernels differ: they stay two
    edge sets (one landmark pack on the port)."""
    mp = tsyn.make_mixed_ba_problem(num_poses=6, num_landmarks=30, seed=1)
    opt = jba.TpuGraphOptimisation.create() if pkg == "jax" else \
        TorchGraphOptimisation(device="cpu")
    opt.solver.initialize_from_arrays(
        mp.pose_q, mp.pose_t, mp.num_active_poses, mp.landmarks,
        mp.num_active_landmarks, [dict(mp.specs[0], rk=0), dict(mp.specs[1], rk=2)],
    )
    return opt


def _object_graph_per_edge_camera(pkg):
    """An object graph whose one object edge carries its own camera beside
    bulk edges, which take the set's: a ``[5, E]`` camera."""
    m = jba if pkg == "jax" else tbt
    p = _mono()
    P = p.pose_q.shape[0]
    poses, landmarks = m.PoseVertexSet(), m.LandmarkVertexSet()
    poses.add_vertices_bulk(np.arange(P), p.pose_q, p.pose_t, np.arange(P) >= p.num_active_poses)
    landmarks.add_vertices_bulk(P + np.arange(p.landmarks.shape[0]), p.landmarks)
    edges = m.MonoEdgeSet()
    edges.set_information(1.0)
    edges.set_camera(m.Camera(*p.cam.tolist()))
    edges.add_edges_bulk(p.meas, p.pose_idx, P + p.lm_idx)
    pose = m.PoseVertex(P, m.Se3(p.pose_q[0], p.pose_t[0]))
    landmark = m.LandmarkVertex(P + p.landmarks.shape[0], p.landmarks[0])
    poses.add_vertex(pose)
    landmarks.add_vertex(landmark)
    e = m.MonoEdge()
    e.set_vertex(pose, 0)
    e.set_vertex(landmark, 1)
    e.set_measurement(p.meas[0])
    e.set_camera(m.Camera(*(p.cam * [1.01, 1.01, 1.0, 1.0, 1.0]).tolist()))
    edges.add_edge(e)
    options = m.GraphOptimisationOptions(per_edge_camera=True)
    if pkg == "jax":
        opt = jba.TpuGraphOptimisation.create(options)
    else:
        opt = TorchGraphOptimisation(options, device="cpu")
    for vs in (poses, landmarks):
        opt.add_vertex_set(vs)
    opt.add_edge_set(edges)
    opt.initialize()
    return opt


def _per_edge_camera(kind="mono"):
    p = _mono(kind=kind)
    cam = np.tile(np.asarray(p.cam, dtype=np.float64).reshape(1, 5), (p.meas.shape[0], 1))
    cam[1::2, 0] *= 1.01
    return p._replace(cam=cam)


@pytest.mark.parametrize(
    "make",
    [
        lambda pkg: _array_opt(pkg, _per_edge_camera("stereo")),
        lambda pkg: _array_opt(pkg, _mono(kind="depth")),
        _unmerged_mixed,
        lambda pkg: _array_opt(pkg, _per_edge_camera(), rk=3, delta=1.0, outlier_threshold=5.0),
        _object_graph_per_edge_camera,
    ],
    ids=["stereo", "depth", "mixed", "outliers", "object-api"],
)
def test_outside_the_slice_raises(make):
    """A per-edge camera (array and object graphs, and beside outlier
    thresholds), depth edges and landmark sets that do not merge, refused
    by name before ROADMAP A7's rest, run: the trace at rtol 1e-9 of the JAX
    package's, the outlier counts equal."""
    runs = {}
    for pkg in ("jax", "torch"):
        opt = make(pkg)
        opt.optimize(5)
        runs[pkg] = opt
    trace, jtrace = ([s.chi2 for s in runs[k].batch_statistics().get()] for k in ("torch", "jax"))
    assert len(trace) == len(jtrace)
    np.testing.assert_allclose(trace, jtrace, rtol=1e-9)
    assert runs["torch"].solver._outlier_counts == runs["jax"].solver._outlier_counts


def test_unknown_robust_kernel_raises():
    with pytest.raises(ValueError, match="unknown robust kernel"):
        _cpu(_mono(), rk=7)


def test_fused_loop_and_wide_band_raise():
    """The fused loop is in the slice (the default, ROADMAP A3 done): it
    runs.  A band wider than the kernels take solves on the dense route
    below 1024 poses (ROADMAP A6's first part, done), through either loop,
    as ``tests/test_torch_dense.py`` holds against the JAX package; on 1024
    free poses it takes the PCG route (A6's rest, done) through either loop,
    with the same trace and the same CG iterations."""
    opt = _cpu(_mono())
    assert opt.use_fused_loop
    opt.optimize(1)
    assert opt.loop_stats["trials"] >= 1
    # long-range co-visibility everywhere: no banded order exists
    p = tsyn.make_loop_closure_problem(
        num_poses=120, num_landmarks=1200, long_range_fraction=0.3, seed=2
    )
    big = tsyn.make_loop_closure_problem(
        num_poses=1025, num_landmarks=3000, long_range_fraction=0.3, seed=2
    )
    runs = []
    for fused_loop in (True, False):
        opt = _cpu(p)
        opt.use_fused_loop = fused_loop
        opt.optimize(1)
        assert opt.solver.plan.route == "dense"
        assert opt.solver.plan.band.bw + 1 > tbs.MAX_BAND
        opt = _cpu(big)
        opt.use_fused_loop = fused_loop
        opt.optimize(1)
        assert opt.solver.plan.route == "pcg" and opt.solver.Pa == 1024
        assert opt.solver.plan.band.bw + 1 > tbs.MAX_BAND and opt.cg_iterations
        runs.append((opt.batch_statistics().get()[0].chi2, opt.cg_iterations))
    assert runs[0] == runs[1]
