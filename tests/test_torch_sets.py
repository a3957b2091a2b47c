"""Edge sets beyond one mono or stereo set, on the CPU, held against the JAX
package on the same seeded inputs: depth edges (the reference's depth
model, its flipped residual sign and stereo Jacobian kept), a camera an
edge, and landmark edge sets that do not merge, which the port packs as one
landmark pack (its sets concatenated in order, each with its own kind,
robust kernel and bounds).

Stages at 1e-12 of the largest magnitude, traces at rtol 1e-9 (f32 at
1e-3), the fused loop bit for bit the host loop, outlier masks and counts
equal, and the structure cache keyed on each set's kind and bounds.  The
kernels' instantiations are held against these twins on the card by
``tests/test_torch_gpu.py`` and ``chip_smoke.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cuda_bundle_adjustment_tpu as jba
import cuda_bundle_adjustment_tpu_torch as tba
from chip_smoke import (
    ORBSLAM_CHI2,
    mono_depth_problem,
    orbslam_problem,
    strided_camera,
    two_camera_problem,
)
from cuda_bundle_adjustment_tpu.models import ba as jmodels
from cuda_bundle_adjustment_tpu.types import GraphArrays as JGraph
from cuda_bundle_adjustment_tpu.types import PackedEdges as JPacked
from cuda_bundle_adjustment_tpu_torch.io.synthetic import make_ba_problem, make_mixed_ba_problem
from cuda_bundle_adjustment_tpu_torch.models import ba as tmodels
from cuda_bundle_adjustment_tpu_torch.solver import block_solver as tbs
from cuda_bundle_adjustment_tpu_torch.types import KIND_CODES, GraphArrays, PackedEdges

torch.set_num_threads(1)

CAM = np.array([718.856, 718.856, 607.1928, 185.2157, 386.1448])
HUBER = 3


def _trace(opt):
    return [s.chi2 for s in opt.batch_statistics().get()]


def _spec(p, **kw):
    return dict(dict(kind=p.kind, meas=p.meas, pose_idx=p.pose_idx, lm_idx=p.lm_idx,
                     omega=p.omega, cam=p.cam), **kw)


def _opt(pkg, base, specs, fused=True, **options):
    """An optimiser of ``pkg`` ("jax" or "torch", on the CPU) packed from
    ``specs`` over ``base``'s vertices."""
    m = jba if pkg == "jax" else tba
    opts = m.GraphOptimisationOptions(**options) if options else None
    opt = jba.TpuGraphOptimisation.create(opts) if pkg == "jax" else \
        tba.TorchGraphOptimisation.create(opts, device="cpu")
    opt.use_fused_loop = fused
    opt.solver.initialize_from_arrays(base.pose_q, base.pose_t, base.num_active_poses,
                                      base.landmarks, base.num_active_landmarks, specs)
    return opt


def _held(base, specs, niter, rtol=1e-9, **options):
    """The JAX package's and the port's fused and host loops: the port's
    trace at ``rtol`` of the JAX package's (the same length), the fused loop
    bit for bit the host loop (f64).  Returns the port's fused optimiser."""
    runs = {}
    for key in (("jax", True), ("torch", True), ("torch", False)):
        runs[key] = _opt(*key[:1], base, specs, fused=key[1], **options)
        runs[key].optimize(niter)
    opt, trace, jtrace = runs["torch", True], _trace(runs["torch", True]), _trace(runs["jax", True])
    assert len(trace) == len(jtrace)
    np.testing.assert_allclose(trace, jtrace, rtol=rtol)
    if options.get("dtype", "float64") == "float64":
        assert trace == _trace(runs["torch", False])
        assert all(torch.equal(a, b) for a, b in zip(opt.solver.graph, runs["torch", False].solver.graph))
    return opt


# -- the depth and mixed models against the JAX package's XLA models ---------------


def _edges(rng, kinds, E=600, P=10, L=120, cams=1):
    """Seeded per-edge inputs for a model: poses near the identity, points in
    front of them, measurements near the projections; ``kinds`` per edge;
    ``cams`` cameras (one, or a camera an edge drawn around ``CAM``)."""
    q = rng.normal(0, 0.05, (P, 4)) + [0, 0, 0, 1.0]
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    t = rng.normal(0, 0.5, (P, 3))
    Xw = rng.normal(0, 3.0, (L, 3)) + [0, 0, 20.0]
    pose_idx, lm_idx = rng.integers(0, P, E), rng.integers(0, L, E)
    meas = np.stack([rng.normal(600, 40, E), rng.normal(180, 30, E), rng.normal(0.05, 0.01, E)])
    stereo = kinds == KIND_CODES["stereo"]
    meas[2, stereo] = meas[0, stereo] - rng.normal(20, 3, stereo.sum())
    meas[2, kinds == KIND_CODES["mono"]] = 0.0
    cam = CAM[:, None] if cams == 1 else CAM[:, None] * rng.uniform(0.95, 1.05, (5, E))
    active = (rng.uniform(size=E) > 0.1).astype(np.float64)
    both_free = ((pose_idx < P - 1) & (lm_idx < L - 3)).astype(np.float64)
    return dict(q=q, t=t, Xw=Xw, meas=meas, cam=cam, pose_idx=pose_idx, lm_idx=lm_idx,
                omega=np.abs(rng.normal(1.0, 0.2, E)), active=active, both_free=both_free)


def _jax_side(d, rows, mdim):
    graph = JGraph(jnp.asarray(d["q"]), jnp.asarray(d["t"]), jnp.asarray(d["Xw"]))
    cam = d["cam"] if d["cam"].shape[1] == 1 else d["cam"][:, rows]
    data = JPacked(
        meas=jnp.asarray(d["meas"][:mdim, rows]), omega=jnp.asarray(d["omega"][rows]),
        cam=jnp.asarray(cam), pose_idx=jnp.asarray(d["pose_idx"][rows], jnp.int32),
        lm_idx=jnp.asarray(d["lm_idx"][rows], jnp.int32),
        both_free=jnp.asarray(d["both_free"][rows]), active=jnp.asarray(d["active"][rows]),
    )
    return graph, data


def _port_side(d, kind, code=None):
    T = torch.as_tensor
    graph = GraphArrays(T(d["q"]), T(d["t"]), T(d["Xw"]))
    data = PackedEdges(
        meas=T(d["meas"]), omega=T(d["omega"]), cam=T(d["cam"]), pose_idx=T(d["pose_idx"]),
        lm_idx=T(d["lm_idx"]), both_free=T(d["both_free"]), active=T(d["active"]), kind=kind,
        code=None if code is None else T(code.astype(np.uint8)),
    )
    return graph, data


def _close(got, want, rtol=1e-12):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=rtol * np.abs(want).max())


@pytest.mark.parametrize("cams", [1, 2], ids=["one-camera", "per-edge-camera"])
@pytest.mark.parametrize("rk", [0, HUBER], ids=["plain", "huber"])
def test_depth_model_matches_jax(rk, cams):
    """``DepthModel.chi``/``terms`` (the twin of B1/B3's depth
    instantiation) within 1e-12 of the JAX package's ``DepthModel`` on its
    XLA path, with one camera and with a camera an edge."""
    E = 600
    d = _edges(np.random.default_rng(3 + rk + cams), np.full(E, KIND_CODES["depth"]), E,
               cams=cams)
    jg, jd = _jax_side(d, np.arange(E), 3)
    graph, data = _port_side(d, "depth")
    _close(tmodels.DepthModel.chi(graph, data, rk, 2.0).numpy(),
           jmodels.DepthModel.chi(jg, jd, rk, 2.0))
    for got, want in zip(tmodels.DepthModel.terms(graph, data, rk, 2.0),
                         jmodels.DepthModel.terms(jg, jd, rk, 2.0)):
        _close(got.numpy(), want)


def test_mixed_model_matches_the_jax_models_row_by_row():
    """``MixedModel`` (the twin of B1/B3's mixed instantiation, each edge's
    kind from its code) on every row within 1e-12 of the JAX package's model
    of that row's kind: mono rows (the stereo model with the third row
    masked) against ``MonoModel``, stereo against ``StereoModel``, depth
    against ``DepthModel``."""
    E = 900
    rng = np.random.default_rng(17)
    kinds = rng.integers(0, 3, E)
    d = _edges(rng, kinds, E, cams=2)
    graph, data = _port_side(d, "mixed", kinds)
    chi = tmodels.MixedModel.chi(graph, data, HUBER, 2.0).numpy()
    stacks = [a.numpy() for a in tmodels.MixedModel.terms(graph, data, HUBER, 2.0)]
    for name, code in KIND_CODES.items():
        rows = np.flatnonzero(kinds == code)
        jmodel = {"mono": jmodels.MonoModel, "stereo": jmodels.StereoModel,
                  "depth": jmodels.DepthModel}[name]
        jg, jd = _jax_side(d, rows, 2 if name == "mono" else 3)
        _close(chi[rows], jmodel.chi(jg, jd, HUBER, 2.0))
        for got, want in zip(stacks, jmodel.terms(jg, jd, HUBER, 2.0)):
            _close(got[rows], want)


# -- depth graphs ----------------------------------------------------------------


def test_depth_graph_trace_matches_jax():
    """A 10-pose depth graph: the trace at rtol 1e-9 of the JAX package's.
    The reference's depth residual has the opposite sign to its Jacobian's
    convention, so its step climbs and every trial of the first iteration is
    rejected in both packages: the trace is one value."""
    p = make_ba_problem(num_poses=10, num_landmarks=150, mean_obs_per_landmark=3.0, kind="depth",
                        seed=5)
    opt = _held(p, [_spec(p)], 6)
    assert opt.solver.packed.kind == "depth" and opt.solver.packed.meas.shape[0] == 3
    assert len(_trace(opt)) == 1


def test_depth_graph_f32_matches_jax_f32():
    """The same depth graph in f32 mode: within 1e-3 of the JAX package's
    f32 trace."""
    p = make_ba_problem(num_poses=10, num_landmarks=150, mean_obs_per_landmark=3.0, kind="depth",
                        seed=5)
    opt = _held(p, [_spec(p)], 6, rtol=1e-3, dtype="float32")
    assert opt.solver.packed.meas.dtype == torch.float32


def test_mono_plus_depth_matches_jax_and_the_host_loop():
    """The graph of JAX ``tests/test_mixed_edge_sets.py``'s mono + depth
    case: one landmark pack of kind "mixed" (a kind code an edge), the trace
    at rtol 1e-9 of the JAX package's, fused bit for bit the host loop."""
    mono, depth = (make_ba_problem(num_poses=10, num_landmarks=150, mean_obs_per_landmark=3.0,
                                   kind=k, seed=5) for k in ("mono", "depth"))
    opt = _held(mono, [_spec(mono), _spec(depth)], 6)
    s = opt.solver
    assert len(s.packs) == 1 and s.packed.kind == "mixed" and s.packed.mask3 is None
    assert s.packed.code.dtype == torch.uint8
    E0 = mono.meas.shape[0]
    assert [(m.kind, a, b) for m, a, b in s.meta.parts] == [
        ("mono", 0, E0), ("depth", E0, E0 + depth.meas.shape[0])]
    assert _trace(opt)[-1] < _trace(opt)[0]


def test_mono_depth_split_matches_jax():
    """A depth problem split into a mono and a depth set (``chip_smoke``'s
    ``kitti00_mono_depth`` at sample size): rtol 1e-9 of the JAX package."""
    p = mono_depth_problem(make_ba_problem(num_poses=12, num_landmarks=150, kind="depth", seed=2))
    _held(p, list(p.specs), 6)


def test_pose_only_depth_set_matches_jax():
    """Motion-only BA with a depth set beside a mono set against fixed
    landmarks: the pose-only solve through one landmark pack (B1-B3 alone),
    the trace at rtol 1e-9 of the JAX package's."""
    p = make_ba_problem(num_poses=8, num_landmarks=100, kind="depth", seed=4)
    p = mono_depth_problem(p._replace(num_active_landmarks=0))
    opt = _held(p, list(p.specs), 5)
    assert opt.solver.plan.route == "pose_only" and opt.solver.packed.kind == "mixed"


# -- landmark sets that do not merge -------------------------------------------------


def test_orbslam_pair_matches_jax():
    """ORB-SLAM2's mono and stereo sets: Huber at sqrt(5.991) and
    sqrt(7.815), so they do not merge; one landmark pack of kind "stereo"
    (the mono rows' third row masked) with each set's rho and rho', the
    trace at rtol 1e-9 of the JAX package's."""
    mp = orbslam_problem(make_mixed_ba_problem(num_poses=16, num_landmarks=180,
                                               mean_obs_per_landmark=3.5, seed=11))
    specs = [dict(s, outlier_threshold=0.0) for s in mp.specs]
    opt = _held(mp, specs, 6)
    s = opt.solver
    assert len(s.packs) == 1 and s.packed.kind == "stereo" and s.packed.mask3 is not None
    assert [(m.rk, m.delta) for m, _, _ in s.meta.parts] == [
        (HUBER, 5.991 ** 0.5), (HUBER, 7.815 ** 0.5)]
    assert _trace(opt)[-1] < _trace(opt)[0]


def test_two_set_path_matches_the_merged_set(monkeypatch):
    """The merge turned off (``_merges`` false; JAX
    ``tests/test_mixed_edge_sets.py`` makes its ``_merge_ba_specs`` the
    identity): the mono and stereo sets stay two sets of one landmark pack,
    within 1e-9 of the merged set's trace."""
    mp = make_mixed_ba_problem(num_poses=16, num_landmarks=180, mean_obs_per_landmark=3.5, seed=11)
    merged = _opt("torch", mp, list(mp.specs))
    assert merged.solver.meta.parts == ()
    merged.optimize(6)
    monkeypatch.setattr(tbs, "_merges", lambda specs: False)
    two = _opt("torch", mp, list(mp.specs))
    assert len(two.solver.meta.parts) == 2 and two.solver.packed.mask3 is not None
    two.optimize(6)
    np.testing.assert_allclose(_trace(two), _trace(merged), rtol=1e-9)


# -- a camera an edge ------------------------------------------------------------------


def test_two_camera_graph_matches_jax():
    """A mono graph whose odd poses' edges see through a second camera
    (``chip_smoke.two_camera_problem``, ``kitti07_two_cams`` at sample
    size): a ``[5, E]`` camera, the trace at rtol 1e-9 of the JAX package's,
    falling."""
    p = two_camera_problem(make_ba_problem(num_poses=10, num_landmarks=120, seed=6))
    opt = _held(p, [_spec(p)], 6)
    assert opt.solver.packed.cam.shape == (5, p.meas.shape[0])
    assert _trace(opt)[-1] < _trace(opt)[0]


def test_mono_and_stereo_with_two_cameras_match_jax():
    """A mono set and a stereo set with different global cameras: merged into
    one masked stereo set with a camera an edge, as in the JAX package, the
    trace at rtol 1e-9 of its."""
    mp = make_mixed_ba_problem(num_poses=12, num_landmarks=150, mean_obs_per_landmark=3.5, seed=8)
    mono = dict(mp.specs[0], cam=mp.cam * [1.02, 1.02, 1.0, 1.0, 1.0])
    opt = _held(mp, [mono, mp.specs[1]], 6)
    assert opt.solver.meta.parts == () and opt.solver.packed.cam.shape[1] > 1


def test_per_edge_camera_object_graph_matches_jax():
    """JAX ``tests/test_api.py``'s per-edge information and camera graph,
    with every other edge's camera moved so that a camera an edge is
    packed: the trace at rtol 1e-9 of the JAX package's."""
    p = make_ba_problem(num_poses=6, num_landmarks=30, kind="mono", seed=23)
    P = p.pose_q.shape[0]
    traces = {}
    for m in (jba, tba):
        poses, landmarks = m.PoseVertexSet(), m.LandmarkVertexSet()
        for i in range(P):
            poses.add_vertex(m.PoseVertex(i, m.Se3(p.pose_q[i], p.pose_t[i]),
                                          i >= p.num_active_poses))
        for j in range(p.landmarks.shape[0]):
            landmarks.add_vertex(m.LandmarkVertex(P + j, p.landmarks[j]))
        es = m.MonoEdgeSet()
        es.set_camera(m.Camera(*p.cam.tolist()))
        for i in range(p.meas.shape[0]):
            e = m.MonoEdge()
            e.set_vertex(poses.get_vertex(int(p.pose_idx[i])), 0)
            e.set_vertex(landmarks.get_vertex(P + int(p.lm_idx[i])), 1)
            e.set_measurement(p.meas[i])
            e.set_information(1.0 + 0.01 * (i % 5))
            if i % 2:
                e.set_camera(m.Camera(*(p.cam * [1.01, 1.01, 1.0, 1.0, 1.0]).tolist()))
            es.add_edge(e)
        opts = m.GraphOptimisationOptions(per_edge_information=True, per_edge_camera=True)
        opt = tba.TorchGraphOptimisation.create(opts, device="cpu") if m is tba else \
            jba.TpuGraphOptimisation.create(opts)
        for vs in (poses, landmarks):
            opt.add_vertex_set(vs)
        opt.add_edge_set(es)
        opt.initialize()
        opt.optimize(3)
        traces[m] = _trace(opt)
    assert opt.solver.packed.cam.shape == (5, p.meas.shape[0])
    np.testing.assert_allclose(traces[tba], traces[jba], rtol=1e-9)


def test_uniform_per_edge_camera_is_the_global_camera_bit_for_bit():
    """An ``[E, 5]`` camera whose rows are all the global camera packs as
    ``[5, 1]``; the same camera repacked as ``[5, E]`` (the strided read of
    B1/B3's per-edge-camera instantiation) gives the same trace and state bit
    for bit."""
    p = make_ba_problem(num_poses=10, num_landmarks=120, seed=6)
    runs = []
    for cam, stride in ((p.cam, False), (np.tile(p.cam, (p.meas.shape[0], 1)), False),
                        (p.cam, True)):
        opt = _opt("torch", p, [_spec(p, cam=cam)])
        if stride:
            strided_camera(opt.solver)
        assert opt.solver.packed.cam.shape == ((5, p.meas.shape[0]) if stride else (5, 1))
        opt.optimize(6)
        runs.append((_trace(opt), opt.solver.graph))
    for trace, graph in runs[1:]:
        assert trace == runs[0][0]
        assert all(torch.equal(a, b) for a, b in zip(graph, runs[0][1]))


# -- outliers -------------------------------------------------------------------------


def _object_and_bulk_sets(m, problem, kinds, thresholds, robust):
    """An object graph of a ``MixedBAProblem``: bulk vertices, and each set
    its first 5 edges as objects and the rest in bulk, with its robust
    kernel and outlier threshold."""
    P, L = problem.pose_q.shape[0], problem.landmarks.shape[0]
    poses, landmarks = m.PoseVertexSet(), m.LandmarkVertexSet()
    poses.add_vertices_bulk(np.arange(P), problem.pose_q, problem.pose_t,
                            np.arange(P) >= problem.num_active_poses)
    landmarks.add_vertices_bulk(P + np.arange(L), problem.landmarks)
    # object vertices for the object edges' ends, at the bulk ids' estimates
    sets = []
    for spec, kind, thr, (rk, delta) in zip(problem.specs, kinds, thresholds, robust):
        es = {"mono": m.MonoEdgeSet, "stereo": m.StereoEdgeSet, "depth": m.DepthEdgeSet}[kind]()
        es.set_information(1.0)
        es.set_camera(m.Camera(*problem.cam.tolist()))
        es.set_robust_kernel(m.RobustKernelType(rk), delta)
        es.set_outlier_threshold(thr)
        es.add_edges_bulk(spec["meas"], spec["pose_idx"], P + spec["lm_idx"])
        sets.append(es)
    return (poses, landmarks), sets


@pytest.mark.parametrize("case", ["mono-depth", "orbslam"])
def test_outliers_of_unmerged_sets_match_jax(case):
    """Outlier thresholds on a mono + depth pair and on ORB-SLAM2's pair,
    through the object API's bulk edges: each set's outlier count and its
    bulk ``active`` mask equal the JAX package's after ``optimize``, and the
    port's per-set counts too."""
    if case == "mono-depth":
        p = make_ba_problem(num_poses=8, num_landmarks=100, kind="depth", seed=9)
        meas = p.meas.copy()
        meas[::7, :2] += 40.0
        mp = mono_depth_problem(p._replace(meas=meas))
        kinds, thresholds, robust = ("mono", "depth"), (30.0, 40.0), ((HUBER, 3.0), (0, 1.0))
    else:
        mp = make_mixed_ba_problem(num_poses=10, num_landmarks=120, seed=9)
        specs = [dict(s, meas=s["meas"] + np.where(np.arange(len(s["meas"]))[:, None] % 9 == 0,
                                                   25.0, 0.0)) for s in mp.specs]
        mp = mp._replace(specs=tuple(specs))
        kinds = ("mono", "stereo")
        thresholds = tuple(ORBSLAM_CHI2[k] for k in kinds)
        robust = tuple((HUBER, ORBSLAM_CHI2[k] ** 0.5) for k in kinds)
    out = {}
    for m in (jba, tba):
        vertex_sets, edge_sets = _object_and_bulk_sets(m, mp, kinds, thresholds, robust)
        opt = tba.TorchGraphOptimisation.create(device="cpu") if m is tba else \
            jba.TpuGraphOptimisation.create()
        for vs in vertex_sets:
            opt.add_vertex_set(vs)
        for es in edge_sets:
            opt.add_edge_set(es)
        opt.initialize()
        opt.optimize(4)
        out[m] = (_trace(opt), [es.get_outlier_count() for es in edge_sets],
                  [np.asarray(es._bulk["active"]).copy() for es in edge_sets],
                  list(opt.solver._outlier_counts))
    (trace, counts, masks, per_set), (jtrace, jcounts, jmasks, _) = out[tba], out[jba]
    np.testing.assert_allclose(trace, jtrace, rtol=1e-9)
    assert counts == jcounts and all(c > 0 for c in counts)
    assert all(np.array_equal(a, b) for a, b in zip(masks, jmasks))
    assert per_set == counts



def test_outlier_masks_write_back_into_edge_objects():
    """Object edges of a mono + depth pair: the edges the port masks are
    the JAX package's, edge by edge, and each set's count."""
    p = make_ba_problem(num_poses=6, num_landmarks=40, kind="depth", seed=12)
    meas = p.meas.copy()
    meas[::5, :2] += 50.0
    mp = mono_depth_problem(p._replace(meas=meas))
    P = p.pose_q.shape[0]
    out = {}
    for m in (jba, tba):
        poses, landmarks = m.PoseVertexSet(), m.LandmarkVertexSet()
        for i in range(P):
            poses.add_vertex(m.PoseVertex(i, m.Se3(p.pose_q[i], p.pose_t[i]),
                                          i >= p.num_active_poses))
        for j in range(p.landmarks.shape[0]):
            landmarks.add_vertex(m.LandmarkVertex(P + j, p.landmarks[j]))
        sets = []
        for spec, cls, edge_cls in zip(mp.specs, (m.MonoEdgeSet, m.DepthEdgeSet),
                                       (m.MonoEdge, m.DepthEdge)):
            es = cls()
            es.set_information(1.0)
            es.set_camera(m.Camera(*p.cam.tolist()))
            es.set_robust_kernel(m.RobustKernelType.HUBER, 3.0)
            es.set_outlier_threshold(60.0)
            for i in range(spec["meas"].shape[0]):
                e = edge_cls()
                e.set_vertex(poses.get_vertex(int(spec["pose_idx"][i])), 0)
                e.set_vertex(landmarks.get_vertex(P + int(spec["lm_idx"][i])), 1)
                e.set_measurement(spec["meas"][i])
                es.add_edge(e)
            sets.append(es)
        opt = tba.TorchGraphOptimisation.create(device="cpu") if m is tba else \
            jba.TpuGraphOptimisation.create()
        for vs in (poses, landmarks):
            opt.add_vertex_set(vs)
        for es in sets:
            opt.add_edge_set(es)
        opt.initialize()
        opt.optimize(3)
        out[m] = ([[e.is_active for e in es.edges] for es in sets],
                  [es.get_outlier_count() for es in sets])
    assert out[tba] == out[jba] and sum(out[tba][1]) > 0


# -- the structure cache --------------------------------------------------------------


def test_a_different_set_split_misses_the_structure_cache():
    """Two graphs of the same concatenated edges, split into a mono and a
    depth set at other edges: the second misses the structure cache, and a
    repeat of the first hits it."""
    p = make_ba_problem(num_poses=8, num_landmarks=80, kind="depth", seed=3)
    tbs.clear_structure_cache()
    E = p.meas.shape[0]
    for cut, want in ((E // 2, (0, 1)), (E // 3, (0, 1)), (E // 2, (1, 0))):
        specs = [dict(_spec(p), kind="mono", meas=p.meas[:cut, :2], pose_idx=p.pose_idx[:cut],
                      lm_idx=p.lm_idx[:cut], omega=p.omega[:cut]),
                 dict(_spec(p), meas=p.meas[cut:], pose_idx=p.pose_idx[cut:],
                      lm_idx=p.lm_idx[cut:], omega=p.omega[cut:])]
        before = tbs.structure_cache_info()
        _opt("torch", p, specs).solver.build_structure()
        after = tbs.structure_cache_info()
        assert (after["hits"] - before["hits"], after["misses"] - before["misses"]) == want
