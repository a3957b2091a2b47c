"""f32 mode (``GraphOptimisationOptions(dtype="float32")``) of the PyTorch
port on the CPU, against the JAX package in f32 on the CPU and against the
port's own f64 path.

The port's kernels and their twins compute f32 mode in f64 and round each
output once (``kernels/_types.py``); the JAX package's CPU path computes it
in f32 throughout.  So stage outputs are held at the JAX package's own f32
tolerance (``tests/test_terms_integration.py``: atol 1e-4 of the largest
magnitude, rtol 1e-4), and traces as ``tests/test_lm.py`` holds its f32
mode against f64 (rtol 1e-3, landmarks atol 5e-3).  The twins in f32 are
held to be exactly the f64 twins on upcast inputs, rounded once.
"""

import itertools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_bundle_adjustment_tpu.graph import GraphOptimisationOptions as JaxOptions
from cuda_bundle_adjustment_tpu.io.arrays import optimizer_from_problem as jax_optimizer
from cuda_bundle_adjustment_tpu.solver import block_solver as jbs
from cuda_bundle_adjustment_tpu.types import GraphArrays as JaxGraph
from cuda_bundle_adjustment_tpu_torch import GraphOptimisationOptions
from cuda_bundle_adjustment_tpu_torch.io.arrays import optimizer_from_problem
from cuda_bundle_adjustment_tpu_torch.io.synthetic import make_ba_problem
from cuda_bundle_adjustment_tpu_torch.kernels import gather, lminv, pairprod, schurvec, terms
from cuda_bundle_adjustment_tpu_torch.models.ba import edge_state
from cuda_bundle_adjustment_tpu_torch.solver import block_solver as tbs
from cuda_bundle_adjustment_tpu_torch.solver import fused
from cuda_bundle_adjustment_tpu_torch.types import SystemBlocks

torch.set_num_threads(1)

F32 = GraphOptimisationOptions(dtype="float32")
# the JAX package's f32 check of its kernel path against XLA
STAGE_TOL = 1e-4


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.array(a), dtype=dtype)


def _close(got, want, tol=STAGE_TOL):
    want = np.asarray(want, dtype=np.float64)
    got = np.asarray(got, dtype=np.float64)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * (np.abs(want).max() or 1.0))


def _trace(opt):
    return [s.chi2 for s in opt.batch_statistics().get()]


def _problem(kind="mono", seed=1, **kw):
    return make_ba_problem(num_poses=8, num_landmarks=40, mean_obs_per_landmark=4.0,
                           kind=kind, seed=seed, **kw)


def _f32_systems(problem, **robust):
    """The port's and the JAX package's f32 solvers at their first
    linearisation, and the JAX system in the port's edge and landmark order
    (the JAX package's co-visibility layout renumbers both)."""
    js = jax_optimizer(problem, options=JaxOptions(dtype="float32"), **robust).solver
    js.build_structure()
    jchi, jsys = js.head()
    ts = optimizer_from_problem(problem, options=F32, device="cpu", **robust).solver
    ts.build_structure()
    tchi, tsys = ts.head()
    lay = js.group_layout
    perm = lay.edge_perm
    rows = perm >= 0
    Hpl = np.zeros((ts.packed.pose_idx.shape[0], 18), np.float32)
    Hpl[perm[rows]] = np.asarray(jsys.Hpl)[rows]
    ren = lay.lm_renumber[: js.La_real]
    psys = SystemBlocks(
        Hpp=_t(jsys.Hpp), bp=_t(jsys.bp), Hll=_t(np.asarray(jsys.Hll)[ren]),
        bl=_t(np.asarray(jsys.bl)[ren]), Hpl=_t(Hpl),
    )
    lam = 1e-5 * float(jbs.max_diagonal(jsys))
    return dict(js=js, jsys=jsys, jchi=jchi, ts=ts, tsys=tsys, tchi=tchi, psys=psys,
                ren=ren, lam=lam)


CASES = [("mono", 0), ("mono", 3), ("stereo", 0), ("stereo", 3)]
CASE_IDS = ["mono", "mono-huber", "stereo", "stereo-huber"]


@pytest.fixture(scope="module", params=CASES, ids=CASE_IDS)
def f32_systems(request):
    kind, rk = request.param
    robust = dict(rk=rk, delta=3.0) if rk else {}
    problem = make_ba_problem(num_poses=12, num_landmarks=90, mean_obs_per_landmark=4.0,
                              kind=kind, seed=22)
    return _f32_systems(problem, **robust)


# -- options, packing and results ------------------------------------------------


def test_f32_options_pack_and_return_as_the_jax_package():
    """``dtype`` and ``solver_precision`` as the JAX package reads them:
    f32 packs every float operand and the state in f32, ``mixed`` holds
    only at f64 ``"mixed"``; an unknown string raises ``ValueError``; the
    results come back as f64 arrays in either type."""
    p = _problem()
    s32 = optimizer_from_problem(p, options=F32, device="cpu").solver
    assert s32.dtype == torch.float32 and not s32.mixed
    floats = [*s32.graph, s32.packed.meas, s32.packed.omega, s32.packed.cam,
              s32.packed.active, s32.packed.both_free]
    assert all(t.dtype == torch.float32 for t in floats)
    np.testing.assert_array_equal(s32.graph.Xw.numpy(), p.landmarks.astype(np.float32))
    s64 = optimizer_from_problem(p, device="cpu").solver
    assert s64.dtype == torch.float64 and s64.mixed
    exact = optimizer_from_problem(
        p, options=GraphOptimisationOptions(solver_precision="exact"), device="cpu").solver
    assert not exact.mixed
    for bad in (dict(dtype="float16"), dict(solver_precision="fast")):
        with pytest.raises(ValueError, match="unknown"):
            optimizer_from_problem(p, options=GraphOptimisationOptions(**bad), device="cpu")
    q, t = s32.result_poses()
    assert q.dtype == t.dtype == s32.result_landmarks().dtype == np.float64
    jq, _ = jax_optimizer(p, options=JaxOptions(dtype="float32")).solver.result_poses()
    assert jq.dtype == np.float64
    np.testing.assert_array_equal(q, jq)


# -- stages against the JAX package ----------------------------------------------


def test_f32_build_system_matches_jax(f32_systems):
    """chi (B1, rho outside) and the linearisation (B3, the weight rescaled
    by rho') in f32 against the JAX package's f32 head."""
    s = f32_systems
    assert s["tchi"].dtype == torch.float32
    _close(float(s["tchi"]), float(s["jchi"]))
    for name in ("Hpp", "bp", "Hll", "bl", "Hpl"):
        got = getattr(s["tsys"], name)
        assert got.dtype == torch.float32, name
        _close(got.numpy(), getattr(s["psys"], name).numpy())


def test_f32_schur_reduce_matches_jax(f32_systems):
    """B4, B5 and B6 in f32 on the JAX package's f32 system, with ``lam`` an
    f32 0-d tensor as the loops hand it over."""
    s = f32_systems
    js = s["js"]
    jb, jbsc, jinv = jbs.schur_reduce(
        s["jsys"], jnp.asarray(s["lam"], jnp.float32), js.plan, js.Pa, js.La,
        js.schur.nnz_blocks)
    lam = torch.tensor(s["lam"], dtype=torch.float32)
    blocks, bsc, inv = tbs.schur_reduce(s["psys"], lam, s["ts"].plan)
    assert blocks.dtype == bsc.dtype == inv.dtype == torch.float32
    _close(blocks.numpy(), jb)
    # bsc cancels much of bp: measured against bp, as the f64 test does
    bscale = np.abs(np.asarray(s["jsys"].bp)).max()
    np.testing.assert_allclose(bsc.numpy(), np.asarray(jbsc), rtol=0, atol=STAGE_TOL * bscale)
    _close(inv.numpy(), np.asarray(jinv)[s["ren"]])


def test_f32_back_substitute_and_update_match_jax(f32_systems):
    """B9 and B10 on one f32 pose step, then the SE3 update, against the
    JAX package's f32 functions on the same inputs."""
    s = f32_systems
    js, ren = s["js"], s["ren"]
    jb, jbsc, jinv = jbs.schur_reduce(
        s["jsys"], jnp.asarray(s["lam"], jnp.float32), js.plan, js.Pa, js.La,
        js.schur.nnz_blocks)
    rng = np.random.default_rng(3)
    xp = (rng.normal(size=(js.Pa, 6)) * 1e-2).astype(np.float32)
    jxl = jbs.schur_back_substitute(s["jsys"], jinv, jnp.asarray(xp), js.plan, js.Pa)
    xl = tbs.schur_back_substitute(s["psys"], _t(np.asarray(jinv)[ren]), _t(xp), s["ts"].plan)
    assert xl.dtype == torch.float32
    _close(xl.numpy(), np.asarray(jxl)[ren])
    g = s["ts"].graph
    jg = JaxGraph(jnp.asarray(g.q.numpy()), jnp.asarray(g.t.numpy()), jnp.asarray(g.Xw.numpy()))
    want = jbs.apply_update(jg, jnp.asarray(xp), jnp.asarray(xl.numpy()), js.Pa, js.La)
    got = tbs.apply_update(g, _t(xp), xl)
    for a, b in zip(got, want):
        assert a.dtype == torch.float32
        _close(a.numpy(), np.asarray(b), 1e-6)


def test_f32_reduced_solve_against_the_f64_dense_solve():
    """The f32 band route (B7 and one B8 solve, no refinement) on an f32
    reduced system against the f64 dense solve of the same f32 system.  The
    error of a backward-stable f32 factor and solve is bounded by about
    kappa x 2^-24 relative, kappa the 2-norm condition of the Jacobi-scaled
    system; held at 50 x kappa x 2^-24 (kappa ~1e2-1e3 here), and the
    verdict is the finiteness of the step."""
    s = optimizer_from_problem(_problem(seed=2), options=F32, device="cpu").solver
    s.build_structure()
    assert s.plan.route == "band"
    _, sys_ = s.head()
    lam = fused.TAU * tbs.max_diagonal(sys_)
    blocks, bsc, _ = tbs.schur_reduce(sys_, lam, s.plan)
    xp, ok = tbs.solve_reduced(blocks, bsc, s.plan)
    assert xp.dtype == torch.float32 and bool(ok)
    bl_s, bv, scale = tbs.scaled_blocks(blocks.double(), bsc.double(), s.plan)
    A = tbs.dense_scaled(bl_s, s.plan, torch.float64).numpy()
    x_scaled = np.linalg.solve(A, bv.numpy().reshape(-1))
    want = x_scaled.reshape(-1, 6) * scale.numpy()
    kappa = np.linalg.cond(A)
    err = np.linalg.norm(xp.numpy() - want) / np.linalg.norm(want)
    assert 1.0 < kappa < 1e5
    assert err <= 50 * kappa * 2.0**-24, (err, kappa)


# -- the twins -------------------------------------------------------------------


def test_f32_twins_are_the_f64_twins_rounded_once():
    """Each retyped kernel's twin in f32 equals its f64 twin on the upcast
    operands, rounded to f32 once: what the kernels compute, so that the
    card holds an f32 kernel against its twin as tightly as an f64 one."""
    s = optimizer_from_problem(_problem(kind="stereo", seed=4), options=F32, rk=3, delta=3.0,
                               device="cpu").solver
    s.build_structure()
    plan, data = s.plan, s.packed
    qt, xw = edge_state(s.graph, data)
    wide = data._replace(**{k: getattr(data, k).double() for k in
                            ("meas", "omega", "cam", "both_free", "active")})

    def same(got, want):
        got, want = (got,) if torch.is_tensor(got) else got, (want,) if torch.is_tensor(want) else want
        for g, w in zip(got, want):
            assert g.dtype == torch.float32
            assert torch.equal(g, w.to(torch.float32))

    same(gather.gather_rows_plain(s.graph.Xw, data.lm_idx),
         gather.gather_rows_plain(s.graph.Xw.double(), data.lm_idx))
    same(terms.chi_edges_plain(qt, xw, data), terms.chi_edges_plain(qt.double(), xw.double(), wide))
    segs = (plan.pose_seg, plan.lm_seg)
    lin = terms.linearise_plain(qt, xw, data, *segs)
    same(lin, terms.linearise_plain(qt.double(), xw.double(), wide, *segs))
    Hll, bl, Hpl = lin[1][:, :9], lin[1][:, 9:], lin[2]
    lam = torch.tensor(0.37, dtype=torch.float32)
    inv, y = lminv.damped_inverse_plain(Hll, bl, lam)
    same((inv, y), lminv.damped_inverse_plain(Hll.double(), bl.double(), lam.double()))
    same(lminv.sym3x3_mv_plain(inv, y), lminv.sym3x3_mv_plain(inv.double(), y.double()))
    bp = lin[0][:, 36:]
    mv = (plan.ba_lm_idx, bp, plan.pose_seg)
    same(schurvec.hpl_mv_segment_sum_plain(Hpl, y, *mv),
         schurvec.hpl_mv_segment_sum_plain(Hpl.double(), y.double(), mv[0], bp.double(), mv[2]))
    xp = bp * 1e-3
    same(schurvec.hpl_mtv_segment_sum_plain(Hpl, xp, plan.ba_pose_idx, bl, plan.lm_seg),
         schurvec.hpl_mtv_segment_sum_plain(Hpl.double(), xp.double(), plan.ba_pose_idx,
                                            bl.double(), plan.lm_seg))
    tri = (plan.ba_lm_idx, plan.tri_ei, plan.tri_ej, plan.tri_offsets)
    same(pairprod.schur_pair_products_plain(Hpl, inv, *tri),
         pairprod.schur_pair_products_plain(Hpl.double(), inv.double(), *tri))
    # B4 takes lam in the operands' type only
    with pytest.raises(TypeError, match="lam"):
        lminv.damped_inverse(Hll, bl, lam.double())


# -- end to end --------------------------------------------------------------------


@pytest.mark.parametrize("fused_loop", [True, False], ids=["fused", "host"])
@pytest.mark.parametrize("kind,rk", CASES, ids=CASE_IDS)
def test_f32_trace_matches_jax_and_f64(kind, rk, fused_loop):
    """``tests/test_lm.py``'s f32 check on both packages: the port's f32
    trace against the JAX package's f32 trace and against the port's f64
    trace at rtol 1e-3 (the same accepted steps), landmarks against the f64
    run at atol 5e-3.  The mono graph (a scale gauge held by two fixed
    poses) is held over 3 iterations, as there; the stereo graph over 10."""
    niter = 3 if kind == "mono" else 10
    robust = dict(rk=rk, delta=3.0) if rk else {}
    problem = _problem(kind=kind)
    o32 = optimizer_from_problem(problem, options=F32, device="cpu", **robust)
    o32.use_fused_loop = fused_loop
    o32.optimize(niter)
    t32 = _trace(o32)
    assert o32.solver.graph.Xw.dtype == torch.float32
    assert np.all(np.isfinite(t32)) and t32[-1] <= t32[0]
    jopt = jax_optimizer(problem, options=JaxOptions(dtype="float32"), **robust)
    jopt.optimize(niter)
    o64 = optimizer_from_problem(problem, device="cpu", **robust)
    o64.optimize(niter)
    assert len(t32) == len(_trace(jopt)) == len(_trace(o64)) == niter
    np.testing.assert_allclose(t32, _trace(jopt), rtol=1e-3)
    np.testing.assert_allclose(t32, _trace(o64), rtol=1e-3)
    La = o64.solver.La
    np.testing.assert_allclose(o32.solver.result_landmarks()[:La],
                               o64.solver.result_landmarks()[:La], atol=5e-3)


def test_f32_huber_accuracy_against_f64():
    """``tests/test_lm.py``'s Huber f32 check at a sample size (60 poses,
    3000 landmarks, 1-pixel noise): f32 and f64 take the same accepted
    steps, their traces agree at rtol 1e-3 over 5 iterations, and the run
    converges: chi2 falls monotonically to under a quarter of its start,
    which at this size is the noise floor (at the JAX test's 300 poses it is
    under a twentieth)."""
    problem = make_ba_problem(num_poses=60, num_landmarks=3000, mean_obs_per_landmark=3.5,
                              kind="mono", seed=77, noise_px=1.0)
    robust = dict(rk=3, delta=3.0)
    o64 = optimizer_from_problem(problem, device="cpu", **robust)
    o64.optimize(5)
    o32 = optimizer_from_problem(problem, options=F32, device="cpu", **robust)
    o32.optimize(5)
    t64, t32 = _trace(o64), _trace(o32)
    assert len(t32) == len(t64) == 5
    np.testing.assert_allclose(t32, t64, rtol=1e-3)
    assert all(b < a for a, b in zip(t32, t32[1:])) and t64[-1] < 0.25 * t64[0]


def _jax_fused_update(F, Fhat, scale_raw, success, lam, nu, q):
    """The JAX package's fused trial verdict, as its ``inner_damping`` body
    computes it (``solver/fused.py``), on f32 arrays."""
    dtype = F.dtype
    scale = scale_raw + 1e-3
    Fdiff = Fhat - F
    rho = jnp.where(success, (F - Fhat) / scale, jnp.asarray(-1.0, dtype))
    accept = rho > 0
    x = 2.0 * rho - 1.0
    att = jnp.clip(1.0 - x * x * x, 1.0 / 3.0, 2.0 / 3.0)
    lam_n = jnp.where(accept, lam * att, lam * nu)
    nu_n = jnp.where(accept, 2.0, nu * 2.0)
    F_n = jnp.where(accept, Fhat, F)
    stop = accept | (~jnp.isfinite(lam_n)) | (Fdiff < 1e-4)
    q_n = jnp.where(stop, q, q + 1)
    return accept, F_n, lam_n, nu_n, rho, q_n


def test_f32_fused_update_equals_the_jax_fused_update():
    """The port's device-scalar LM update on f32 tensors against the JAX
    package's fused update on f32 arrays, bit for bit over a grid of rho
    near 0, 0.5 and 1, bails, NaN and overflow: the LM state is f32 and
    ``1e-3``, ``1e-4``, ``2.0`` stay weak constants on both sides."""
    rows = []
    for F, scale in itertools.product((100.0, 3.5e-2), (2.0, 1e-6)):
        s = scale + 1e-3
        fhats = [F - r * s for r in (-0.3, 1e-7, 0.4999, 0.5, 0.5001, 0.9999, 1.0, 1.5, 1e6)]
        fhats += [F, F + 1e-5, F + 1.0, math.nan]
        for Fhat, success, (lam, nu), q in itertools.product(
                fhats, (True, False), ((1e-4, 2.0), (0.37, 16.0), (1e30, 1e10)), (0, 8, 9)):
            rows.append((F, Fhat, scale, success, lam, nu, q))
    cols = list(zip(*rows))
    f32 = dict(dtype=torch.float32)
    got = fused.lm_update(
        torch.tensor(cols[0], **f32), torch.tensor(cols[1], **f32), torch.tensor(cols[2], **f32),
        torch.tensor(cols[3]), torch.tensor(cols[4], **f32), torch.tensor(cols[5], **f32),
        torch.tensor(cols[6], dtype=torch.int32))
    accept, F, lam, nu, rho, q = got[:6]
    assert all(t.dtype == torch.float32 for t in (F, lam, nu, rho))
    a = [jnp.asarray(np.array(c, np.float32)) for c in cols[:3]]
    want = _jax_fused_update(a[0], a[1], a[2], jnp.asarray(np.array(cols[3])),
                             jnp.asarray(np.array(cols[4], np.float32)),
                             jnp.asarray(np.array(cols[5], np.float32)),
                             jnp.asarray(np.array(cols[6], np.int32)))
    assert all(np.asarray(w).dtype in (np.float32, np.bool_, np.int32) for w in want)
    for g, w in zip((accept, F, lam, nu, rho, q), want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert bool(accept.any()) and bool((~accept).any()) and bool(torch.isinf(lam).any())


def test_f32_fused_state_is_f32_and_repeats():
    """The fused loop's LM state follows the working type, and two f32 runs
    of the fused loop give the same trace and state bit for bit."""
    problem = _problem(kind="stereo")
    runs = []
    for _ in range(2):
        opt = optimizer_from_problem(problem, options=F32, device="cpu")
        opt.optimize(5)
        runs.append((_trace(opt), [t.clone() for t in opt.solver.graph]))
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))
    opt = optimizer_from_problem(problem, options=F32, device="cpu")
    opt.solver.build_structure()
    loop = fused.FusedLoop(opt.solver, 3)
    assert all(t.dtype == torch.float32 for t in (loop.F, loop.lam, loop.nu, loop.trace))
    assert len(loop.run()) == 3


@pytest.mark.parametrize("first", ["float64", "float32"])
def test_f64_and_f32_solvers_of_one_topology_share_the_cache(first):
    """A cached f64 structure followed by an f32 solver of the same
    topology, and the other way round: the dtype is a plan knob (it fixes
    the reduced route and its factor's type), so the second solver misses
    and makes its own plan; the kernels' workspaces are f64 in either type.
    Each solver's trace equals a run of its type on an empty cache, bit for
    bit; the cache keeps a plan for each set of knobs of a topology, so a
    third solver of the first type hits the first one's plan and still
    solves bit for bit."""
    problem = _problem(kind="stereo", seed=3)
    order = [first, "float32" if first == "float64" else "float64"]

    def run(dtype):
        opt = optimizer_from_problem(
            problem, options=GraphOptimisationOptions(dtype=dtype), device="cpu")
        opt.optimize(4)
        return _trace(opt), opt.solver

    alone = {}
    for dtype in order:
        tbs.clear_structure_cache()
        alone[dtype] = run(dtype)[0]
    tbs.clear_structure_cache()
    for dtype in order:
        trace, solver = run(dtype)
        assert trace == alone[dtype], dtype
        assert solver.plan.lin_plan is None or solver.plan.lin_plan.scratch.dtype == torch.float64
    assert tbs.structure_cache_info()["misses"] == 2
    trace, _ = run(order[0])
    assert trace == alone[order[0]]
    assert tbs.structure_cache_info()["misses"] == 2 and tbs.structure_cache_info()["hits"] == 1
    tbs.clear_structure_cache()
