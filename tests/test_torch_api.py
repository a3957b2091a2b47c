"""The port's object-graph API on the CPU: the cases of ``tests/test_api.py``
run on twin graphs, one made of the JAX package's classes and one of the
port's, built from the same seeded numpy problem, each result held against
the JAX package (traces at rtol 1e-9, written-back estimates at atol 1e-9)
and, where the packed arrays are the same, against the port's array path
bit for bit.  Depth edges, a per-edge camera and landmark sets that do not
merge run too, also beside ICP sets (``tests/test_torch_sets.py`` has their
other cases)."""

import time

import numpy as np
import pytest
import torch

import cuda_bundle_adjustment_tpu as jba
import cuda_bundle_adjustment_tpu_torch as tba
from cuda_bundle_adjustment_tpu_torch.io.arrays import optimizer_from_problem
from cuda_bundle_adjustment_tpu_torch.io.synthetic import make_ba_problem

torch.set_num_threads(1)

PKGS = (jba, tba)


def _trace(opt):
    return [s.chi2 for s in opt.batch_statistics().get()]


def _create(m, **options):
    opts = m.GraphOptimisationOptions(**options) if options else None
    if m is tba:
        return tba.TorchGraphOptimisation.create(opts, device="cpu")
    return jba.TpuGraphOptimisation.create(opts)


def _optimize(m, vertex_sets, edge_sets, niter, **options):
    opt = _create(m, **options)
    for vs in vertex_sets:
        opt.add_vertex_set(vs)
    for es in edge_sets:
        opt.add_edge_set(es)
    opt.initialize()
    opt.optimize(niter)
    return opt, _trace(opt)


def _twins(build, *args, **kw):
    """``build(m, *args)`` for the JAX package and the port: the same graph
    from the same numpy state, of each package's classes."""
    return {m: build(m, *args, **kw) for m in PKGS}


def _object_graph(m, problem, fixed_lm=()):
    """Object graph of a problem (vertex ids: poses ``i``, landmarks
    ``P + j``), per-edge information 1 and the set's global 1."""
    P = problem.pose_q.shape[0]
    poses, landmarks = m.PoseVertexSet(), m.LandmarkVertexSet()
    for i in range(P):
        poses.add_vertex(m.PoseVertex(
            i, m.Se3(problem.pose_q[i], problem.pose_t[i]), i >= problem.num_active_poses))
    for j in range(problem.landmarks.shape[0]):
        landmarks.add_vertex(m.LandmarkVertex(P + j, problem.landmarks[j], j in fixed_lm))
    es = (m.MonoEdgeSet if problem.kind == "mono" else m.StereoEdgeSet)()
    es.set_camera(m.Camera(*problem.cam.tolist()))
    es.set_information(1.0)
    Edge = m.MonoEdge if problem.kind == "mono" else m.StereoEdge
    for e in range(len(problem.pose_idx)):
        edge = Edge()
        edge.set_vertex(poses.get_vertex(int(problem.pose_idx[e])), 0)
        edge.set_vertex(landmarks.get_vertex(P + int(problem.lm_idx[e])), 1)
        edge.set_measurement(problem.meas[e])
        edge.set_information(1.0)
        es.add_edge(edge)
    return poses, landmarks, es


def _bulk_graph(m, problem):
    """The same graph through the bulk constructors."""
    P, L = problem.pose_q.shape[0], problem.landmarks.shape[0]
    poses, landmarks = m.PoseVertexSet(), m.LandmarkVertexSet()
    poses.add_vertices_bulk(np.arange(P), problem.pose_q, problem.pose_t,
                            np.arange(P) >= problem.num_active_poses)
    landmarks.add_vertices_bulk(P + np.arange(L), problem.landmarks)
    es = (m.MonoEdgeSet if problem.kind == "mono" else m.StereoEdgeSet)()
    es.set_information(1.0)
    es.set_camera(m.Camera(*problem.cam.tolist()))
    es.add_edges_bulk(problem.meas, problem.pose_idx, P + problem.lm_idx)
    return poses, landmarks, es


def _object_estimates(poses, landmarks, P, L):
    q = np.stack([poses.get_vertex(i).estimate.q for i in range(P)])
    t = np.stack([poses.get_vertex(i).estimate.t for i in range(P)])
    X = np.stack([landmarks.get_vertex(P + j).estimate for j in range(L)])
    return q, t, X


def _held(got, want, atol=1e-9):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=atol)


def _problem(P, L, seed, kind="mono"):
    return make_ba_problem(num_poses=P, num_landmarks=L, mean_obs_per_landmark=4.0,
                           kind=kind, seed=seed)


def test_object_api_matches_array_api():
    problem = _problem(10, 60, 13)
    P, L = problem.pose_q.shape[0], problem.landmarks.shape[0]
    graphs = _twins(_object_graph, problem)
    runs = {m: _optimize(m, g[:2], g[2:], 4) for m, g in graphs.items()}
    (opt, trace), (_, jtrace) = runs[tba], runs[jba]
    np.testing.assert_allclose(trace, jtrace, rtol=1e-9)

    # the same packed arrays as the array path: bit for bit
    arr = optimizer_from_problem(problem, device="cpu")
    arr.optimize(4)
    assert trace == _trace(arr)
    assert all(torch.equal(a, b) for a, b in zip(opt.solver.graph, arr.solver.graph))

    # written back into the vertex objects, as the JAX package does
    got = _object_estimates(*graphs[tba][:2], P, L)
    _held(got, _object_estimates(*graphs[jba][:2], P, L))
    q, t = arr.solver.result_poses()
    _held(got, (q, t, arr.solver.result_landmarks()), atol=0)
    np.testing.assert_array_equal(got[0][P - 1], problem.pose_q[P - 1])  # fixed pose


def test_mixed_edge_sets():
    """Mono + stereo edge sets over the same vertices merge into one masked
    stereo set."""
    pm = make_ba_problem(num_poses=8, num_landmarks=40, kind="mono", seed=17)
    ps = make_ba_problem(num_poses=8, num_landmarks=40, kind="stereo", seed=17)
    P = pm.pose_q.shape[0]

    def build(m):
        poses, landmarks, mono_set = _object_graph(m, pm)
        stereo_set = m.StereoEdgeSet()
        stereo_set.set_camera(m.Camera(*ps.cam.tolist()))
        stereo_set.set_information(1.0)
        for e in range(0, len(ps.pose_idx), 2):  # a subset of the stereo observations
            edge = m.StereoEdge()
            edge.set_vertex(poses.get_vertex(int(ps.pose_idx[e])), 0)
            edge.set_vertex(landmarks.get_vertex(P + int(ps.lm_idx[e])), 1)
            edge.set_measurement(ps.meas[e])
            edge.set_information(1.0)
            stereo_set.add_edge(edge)
        return poses, landmarks, mono_set, stereo_set

    graphs = _twins(build)
    runs = {m: _optimize(m, g[:2], g[2:], 5) for m, g in graphs.items()}
    (opt, trace), (_, jtrace) = runs[tba], runs[jba]
    assert trace[-1] < trace[0]
    np.testing.assert_allclose(trace, jtrace, rtol=1e-9)
    mono_set, stereo_set = graphs[tba][2:]
    assert opt.solver.packed.mask3 is not None
    assert opt.solver.nedges() == mono_set.nactive_edges() + stereo_set.nactive_edges()
    L = pm.landmarks.shape[0]
    _held(_object_estimates(*graphs[tba][:2], P, L), _object_estimates(*graphs[jba][:2], P, L))


def _outlier_graph(m):
    problem = make_ba_problem(num_poses=8, num_landmarks=40, kind="mono", seed=19, noise_px=0.5)
    poses, landmarks, edge_set = _object_graph(m, problem)
    for edge in edge_set.edges[::10]:
        edge.measurement = np.asarray(edge.measurement) + 500.0
    edge_set.set_outlier_threshold(100.0)
    return poses, landmarks, edge_set


def test_outlier_threshold_deactivates_edges():
    """Every tenth measurement moved by 500 px and a threshold of 100: after
    ``optimize(3)`` the same edges are inactivated and counted as in the JAX
    package, and a second ``initialize()`` + ``optimize(5)`` without them
    gives its trace at rtol 1e-9."""
    graphs = {m: _outlier_graph(m) for m in PKGS}
    runs = {}
    for m, (poses, landmarks, edge_set) in graphs.items():
        opt = _create(m)
        for s in (poses, landmarks):
            opt.add_vertex_set(s)
        opt.add_edge_set(edge_set)
        opt.initialize()
        opt.optimize(3)
        runs[m] = opt
    es, jes = graphs[tba][2], graphs[jba][2]
    flagged = [i for i, e in enumerate(es.edges) if not e.is_active]
    assert es.get_outlier_count() == jes.get_outlier_count() == len(flagged) > 0
    assert flagged == [i for i, e in enumerate(jes.edges) if not e.is_active]
    assert set(range(0, len(es.edges), 10)) <= set(flagged)
    traces = {}
    for m, opt in runs.items():
        opt.initialize()
        opt.optimize(5)
        traces[m] = _trace(opt)
    assert runs[tba].solver.nedges() == len(es.edges) - len(flagged)
    assert np.isfinite(traces[tba][-1])
    np.testing.assert_allclose(traces[tba], traces[jba], rtol=1e-9)


def test_outlier_threshold_array_path():
    """The array path's twin of the case above: the same counts as the JAX
    package, the masked edges out of the packed ``active`` mask, and a second
    ``optimize(5)`` (no new packing) at rtol 1e-9 of the JAX package's."""
    from cuda_bundle_adjustment_tpu.io.arrays import optimizer_from_problem as jax_optimizer

    problem = make_ba_problem(num_poses=8, num_landmarks=40, kind="mono", seed=19, noise_px=0.5)
    meas = problem.meas.copy()
    meas[::10] += 500.0
    problem = problem._replace(meas=meas)
    opt = optimizer_from_problem(problem, outlier_threshold=100.0, device="cpu")
    jopt = jax_optimizer(problem, outlier_threshold=100.0)
    for o in (opt, jopt):
        o.optimize(3)
    counts = opt.solver._outlier_counts
    assert counts == jopt.solver._outlier_counts and sum(counts) > 0
    assert int(opt.solver.packed.active.sum()) == problem.meas.shape[0] - sum(counts)
    assert not bool(opt.solver.packed.active[::10].any())
    for o in (opt, jopt):
        o.optimize(5)
    np.testing.assert_allclose(_trace(opt), _trace(jopt), rtol=1e-9)


def test_per_edge_information_and_camera():
    """Per-edge information runs (omega ``[E]`` into kernels B1 and B3) and
    agrees with the JAX package; so does ``per_edge_camera=True`` with every
    edge carrying the set's camera (``tests/test_api.py``'s case), bit for
    bit the run without it."""
    problem = make_ba_problem(num_poses=6, num_landmarks=30, kind="mono", seed=23)
    P, L = problem.pose_q.shape[0], problem.landmarks.shape[0]

    def build(m, camera):
        poses, landmarks, edge_set = _object_graph(m, problem)
        cam = m.Camera(*problem.cam.tolist())
        for i, edge in enumerate(edge_set.edges):
            edge.set_information(1.0 + 0.01 * (i % 5))
            if camera:
                edge.set_camera(cam)
        return poses, landmarks, edge_set

    graphs = _twins(build, camera=False)
    runs = {m: _optimize(m, g[:2], g[2:], 3, per_edge_information=True)
            for m, g in graphs.items()}
    (opt, trace), (_, jtrace) = runs[tba], runs[jba]
    assert trace[-1] < trace[0]
    assert opt.solver.packed.omega.shape == (problem.meas.shape[0],)
    np.testing.assert_allclose(trace, jtrace, rtol=1e-9)
    _held(_object_estimates(*graphs[tba][:2], P, L), _object_estimates(*graphs[jba][:2], P, L))

    # every edge carrying the set's camera: one camera packed, as there
    graphs = _twins(build, camera=True)
    runs = {m: _optimize(m, g[:2], g[2:], 3, per_edge_information=True, per_edge_camera=True)
            for m, g in graphs.items()}
    (opt, ctrace), (_, jctrace) = runs[tba], runs[jba]
    assert opt.solver.packed.cam.shape == (5, 1)
    np.testing.assert_allclose(ctrace, jctrace, rtol=1e-9)
    assert ctrace == trace


def test_pose_only_plane_graph():
    """Point-to-plane ICP graph: one free pose, no landmarks; the trace at
    rtol 1e-9 of the JAX package's and the pose recovered as there."""
    def build(m):
        rng = np.random.default_rng(29)
        poses = m.PoseVertexSet()
        q0 = np.array([0.02, -0.01, 0.015, 1.0])
        poses.add_vertex(m.PoseVertex(0, m.Se3(q0 / np.linalg.norm(q0), [0.1, -0.05, 0.2]),
                                      False))
        plane_set = m.PlaneEdgeSet()
        plane_set.set_information(1.0)
        for _ in range(60):
            n = rng.normal(size=3)
            n /= np.linalg.norm(n)
            d = rng.normal()
            edge = m.PlaneEdge()
            edge.set_vertex(poses.get_vertex(0), 0)
            edge.set_measurement(
                m.PointToPlaneMatch(n, d, n * d + np.cross(n, rng.normal(size=3))))
            edge.set_information(1.0)
            plane_set.add_edge(edge)
        return poses, plane_set

    graphs = _twins(build)
    runs = {m: _optimize(m, g[:1], g[1:], 10) for m, g in graphs.items()}
    (opt, trace), (_, jtrace) = runs[tba], runs[jba]
    assert graphs[tba][1].nedges() == 60 and opt.solver.plan.route == "pose_only"
    assert trace[-1] < 1e-12
    np.testing.assert_allclose(trace, jtrace, rtol=1e-9, atol=1e-20)
    est = graphs[tba][0].get_vertex(0).estimate
    np.testing.assert_allclose(est.t, 0.0, atol=1e-6)
    np.testing.assert_allclose(np.abs(est.q[3]), 1.0, atol=1e-6)


def test_forgotten_per_edge_information_raises():
    problem = make_ba_problem(num_poses=4, num_landmarks=20, kind="mono", seed=31)
    poses, landmarks, edge_set = _object_graph(tba, problem)
    edge_set.set_information(0.0)
    for edge in edge_set.edges:
        edge.set_information(2.0)
    with pytest.raises(ValueError, match="per_edge_information"):
        _optimize(tba, (poses, landmarks), (edge_set,), 1)


def test_multiple_vertex_sets():
    """Poses and landmarks split over several vertex sets optimise as one set
    does (global active-first indexing across the sets)."""
    problem = _problem(8, 50, 7)
    Pa = problem.num_active_poses

    def build(m, split):
        n = 2 if split else 1
        pose_sets = [m.PoseVertexSet() for _ in range(n)]
        lm_sets = [m.LandmarkVertexSet() for _ in range(n)]
        pverts, lverts = {}, {}
        for i in range(problem.pose_q.shape[0]):
            v = m.PoseVertex(i, m.Se3(problem.pose_q[i], problem.pose_t[i]), i >= Pa)
            pose_sets[i % n].add_vertex(v)
            pverts[i] = v
        for j in range(problem.landmarks.shape[0]):
            v = m.LandmarkVertex(1000 + j, problem.landmarks[j])
            lm_sets[j % n].add_vertex(v)
            lverts[j] = v
        es = m.MonoEdgeSet()
        es.set_camera(m.Camera(*problem.cam.tolist()))
        es.set_information(1.0)
        for e in range(len(problem.pose_idx)):
            edge = m.MonoEdge()
            edge.set_vertex(pverts[int(problem.pose_idx[e])], 0)
            edge.set_vertex(lverts[int(problem.lm_idx[e])], 1)
            edge.set_measurement(problem.meas[e])
            es.add_edge(edge)
        _, trace = _optimize(m, pose_sets + lm_sets, (es,), 4)
        return trace, pverts, lverts

    one = build(tba, split=False)
    for m in PKGS:
        trace, pv, lv = build(m, split=True)
        np.testing.assert_allclose(trace, one[0], rtol=1e-9)
        for i in pv:
            np.testing.assert_allclose(pv[i].estimate.q, one[1][i].estimate.q, rtol=0, atol=1e-9)
            np.testing.assert_allclose(pv[i].estimate.t, one[1][i].estimate.t, rtol=0, atol=1e-9)
        for j in lv:
            np.testing.assert_allclose(lv[j].estimate, one[2][j].estimate, rtol=0, atol=1e-9)


def test_no_pose_set_raises():
    opt = _create(tba)
    opt.add_vertex_set(tba.LandmarkVertexSet())
    opt.add_edge_set(tba.MonoEdgeSet())
    with pytest.raises(ValueError, match="pose vertex set"):
        opt.initialize()


def test_bulk_vertices_match_object_vertices():
    """Bulk vertices and edges give the object graph's packed arrays: the
    same trace and written-back estimates bit for bit, and the JAX
    package's within the stated tolerances."""
    p = _problem(14, 90, 11)
    P, L = p.pose_q.shape[0], p.landmarks.shape[0]

    def run(m, bulk):
        ps, ls, es = (_bulk_graph if bulk else _object_graph)(m, p)
        _, trace = _optimize(m, (ps, ls), (es,), 4)
        if bulk:
            return trace, (*ps.bulk_estimates(), ls.bulk_estimates())
        return trace, _object_estimates(ps, ls, P, L)

    tr_o, est_o = run(tba, bulk=False)
    tr_b, est_b = run(tba, bulk=True)
    assert tr_b == tr_o
    _held(est_b, est_o, atol=0)
    tr_j, est_j = run(jba, bulk=True)
    np.testing.assert_allclose(tr_b, tr_j, rtol=1e-9)
    _held(est_b, est_j)


def test_bulk_vertices_mixed_with_objects():
    """Bulk and object vertices in one set: active first across both, and the
    write-back reaches both."""
    p = _problem(10, 60, 12)
    P = p.pose_q.shape[0]
    h = P // 2

    def build(m):
        ps = m.PoseVertexSet()
        for i in range(h):
            ps.add_vertex(m.PoseVertex(i, m.Se3(p.pose_q[i], p.pose_t[i]),
                                       i >= p.num_active_poses))
        ps.add_vertices_bulk(np.arange(h, P), p.pose_q[h:], p.pose_t[h:],
                             np.arange(h, P) >= p.num_active_poses)
        _, ls, es = _bulk_graph(m, p)
        _, trace = _optimize(m, (ps, ls), (es,), 4)
        objs = np.stack([ps.get_vertex(i).estimate.q for i in range(h)])
        return trace, (objs, *ps.bulk_estimates(), ls.bulk_estimates())

    (trace, est), (jtrace, jest) = build(tba), build(jba)
    assert trace[-1] < trace[0]
    assert est[1].shape == (P - h, 4)
    np.testing.assert_allclose(trace, jtrace, rtol=1e-9)
    _held(est, jest)


def test_all_fixed_edge_not_flagged_as_outlier():
    """An edge whose vertices are all fixed is masked at packing: it adds
    nothing and is not counted, and outlier thresholding neither
    inactivates nor counts it, as in the JAX package."""
    p = _problem(8, 40, 21)
    P = p.pose_q.shape[0]

    def build(m):
        ps, ls, es = _object_graph(m, p, fixed_lm=(0,))
        e = m.MonoEdge()  # fixed pose, fixed landmark, a gross measurement
        e.set_vertex(ps.get_vertex(P - 1), 0)
        e.set_vertex(ls.get_vertex(P), 1)
        e.set_measurement(np.array([1e6, 1e6]))
        es.add_edge(e)
        return ps, ls, es

    graphs = _twins(build)
    runs = {m: _optimize(m, g[:2], g[2:], 3) for m, g in graphs.items()}
    (opt, trace), (jopt, jtrace) = runs[tba], runs[jba]
    np.testing.assert_allclose(trace, jtrace, rtol=1e-9)
    es, jes = graphs[tba][2], graphs[jba][2]
    E = p.meas.shape[0]  # the added edge is row E
    fixed_rows = (p.pose_idx >= p.num_active_poses) & (p.lm_idx == 0)
    assert es.nactive_edges() == jes.nactive_edges() == E - fixed_rows.sum()
    assert opt.solver.nedges() == jopt.solver.nedges() == es.nactive_edges()
    assert opt.solver.packed.active[E].item() == 0.0
    assert es.edges[E].is_active and es.get_outlier_count() == 0

    # under a threshold the gross all-fixed edge is neither inactivated nor
    # counted, in either package
    for m in PKGS:
        ps, ls, es = build(m)
        es.set_outlier_threshold(1e3)
        _optimize(m, (ps, ls), (es,), 3)
        assert es.edges[E].is_active and es.get_outlier_count() == 0


def test_bulk_info_batches_take_pack_time_global():
    """A bulk batch added without information takes the edge set's global
    information at packing (a later set_information reaches it)."""
    p = _problem(8, 40, 22)
    P, E = p.pose_q.shape[0], p.meas.shape[0]
    h = E // 2

    def run(m, set_info_last):
        ps, ls, _ = _bulk_graph(m, p)
        es = m.MonoEdgeSet()
        es.set_camera(m.Camera(*p.cam.tolist()))
        if not set_info_last:
            es.set_information(2.0)
        es.add_edges_bulk(p.meas[:h], p.pose_idx[:h], P + p.lm_idx[:h])
        es.add_edges_bulk(p.meas[h:], p.pose_idx[h:], P + p.lm_idx[h:],
                          information=np.full(E - h, 2.0))
        if set_info_last:
            es.set_information(2.0)
        return _optimize(m, (ps, ls), (es,), 3, per_edge_information=True)[1]

    trace = run(tba, True)
    assert trace == run(tba, False)
    np.testing.assert_allclose(trace, run(jba, True), rtol=1e-9)


def test_object_pack_speed_100k():
    """Spec extraction for 100k per-edge objects stays batch-vectorised
    (< 1 s, the JAX package's bar)."""
    rng = np.random.default_rng(0)
    E, P, L = 100_000, 300, 20_000
    poses = tba.PoseVertexSet()
    q = np.tile([0.0, 0.0, 0.0, 1.0], (P, 1))
    t = rng.normal(size=(P, 3))
    for i in range(P):
        poses.add_vertex(tba.PoseVertex(i, tba.Se3(q[i], t[i]), i >= P - 2))
    landmarks = tba.LandmarkVertexSet()
    for j in range(L):
        landmarks.add_vertex(tba.LandmarkVertex(P + j, rng.normal(size=3)))
    es = tba.MonoEdgeSet()
    es.set_camera(tba.Camera(500.0, 500.0, 320.0, 240.0, 0.1))
    es.set_information(1.0)
    pi, li = rng.integers(0, P, E), rng.integers(0, L, E)
    meas = rng.normal(size=(E, 2))
    for k in range(E):
        e = tba.MonoEdge()
        e.set_vertex(poses.get_vertex(int(pi[k])), 0)
        e.set_vertex(landmarks.get_vertex(P + int(li[k])), 1)
        e.set_measurement(meas[k])
        e.set_information(1.0)
        es.add_edge(e)
    opt = _create(tba)
    opt.add_vertex_set(poses)
    opt.add_vertex_set(landmarks)
    opt.add_edge_set(es)
    opt.initialize()  # assigns the vertex indices, packs once

    t0 = time.perf_counter()
    spec = opt.solver._spec_from_edge_set(es)
    dt = time.perf_counter() - t0
    assert spec["meas"].shape == (E, 2)
    np.testing.assert_array_equal(spec["meas"], meas)
    np.testing.assert_array_equal(spec["pose_idx"], pi)
    np.testing.assert_array_equal(spec["lm_idx"], li)
    assert dt < 1.0, f"object spec extraction took {dt:.2f}s for {E} edges"


def _shuffled_trajectory():
    """A trajectory graph with its free poses shuffled: far from banded in
    its own order, so the solver's RCM order is not the identity."""
    p = make_ba_problem(num_poses=70, num_landmarks=500, mean_obs_per_landmark=4.0,
                        kind="mono", seed=3)
    Pa = p.num_active_poses
    perm = np.random.default_rng(3).permutation(Pa)  # new name of old pose i: perm[i]
    old_of_new = np.argsort(perm)
    pose_idx = np.where(p.pose_idx < Pa, perm[np.minimum(p.pose_idx, Pa - 1)], p.pose_idx)
    return p._replace(
        pose_q=np.concatenate([p.pose_q[old_of_new], p.pose_q[Pa:]]),
        pose_t=np.concatenate([p.pose_t[old_of_new], p.pose_t[Pa:]]),
        pose_idx=pose_idx.astype(p.pose_idx.dtype),
    )


def test_write_back_under_a_pose_permutation():
    """finalize() writes every vertex, object and bulk, through its global
    index and the inverse of the solver's pose order: on a graph whose RCM
    order is not the identity, the estimates equal the array path's
    ``result_poses()`` exactly and the JAX package's within 1e-9."""
    p = _shuffled_trajectory()
    P, L = p.pose_q.shape[0], p.landmarks.shape[0]
    arr = optimizer_from_problem(p, device="cpu")
    assert arr.solver.pose_perm is not None
    arr.optimize(4)
    want = (*arr.solver.result_poses(), arr.solver.result_landmarks())

    graphs = {"objects": _object_graph(tba, p), "bulk": _bulk_graph(tba, p)}
    for name, (ps, ls, es) in graphs.items():
        opt, trace = _optimize(tba, (ps, ls), (es,), 4)
        assert opt.solver.pose_perm is not None
        assert trace == _trace(arr)
        got = ((*ps.bulk_estimates(), ls.bulk_estimates()) if name == "bulk"
               else _object_estimates(ps, ls, P, L))
        _held(got, want, atol=0)

    jps, jls, jes = _object_graph(jba, p)
    _, jtrace = _optimize(jba, (jps, jls), (jes,), 4)
    np.testing.assert_allclose(trace, jtrace, rtol=1e-9)
    _held(want, _object_estimates(jps, jls, P, L))


def test_reinitialize_hits_the_structure_cache_and_repeats_the_trace():
    """A second initialize() + optimize() of the same object graph, its
    estimates reset through write_back, reuses the cached structure (no
    symbolic pass) and repeats the first trace bit for bit."""
    from cuda_bundle_adjustment_tpu_torch.solver import block_solver as bs

    p = _problem(10, 60, 5)
    ps, ls, es = _bulk_graph(tba, p)
    opt = _create(tba)
    for s in (ps, ls):
        opt.add_vertex_set(s)
    opt.add_edge_set(es)
    bs.clear_structure_cache()
    opt.initialize()
    opt.optimize(5)
    first = _trace(opt)
    ps.write_back(p.pose_q, p.pose_t)
    ls.write_back(p.landmarks)
    opt.initialize()
    assert opt.batch_statistics().get() == []
    opt.optimize(5)
    assert opt.solver.symbolic_ms == 0.0
    assert bs.structure_cache_info()["hits"] == 1
    assert _trace(opt) == first


def _depth_graph(m):
    """A depth set: the stereo graph's observations as ``[u, v, 1/z]``."""
    p = _problem(6, 30, 1, kind="depth")
    ps, ls, _ = _bulk_graph(m, p)
    depth = m.DepthEdgeSet()
    depth.set_information(1.0)
    depth.set_camera(m.Camera(*p.cam.tolist()))
    depth.add_edges_bulk(p.meas, p.pose_idx, p.pose_q.shape[0] + p.lm_idx)
    return (ps, ls), (depth,)


def _line_graph(m):
    """A line set beside a mono set and a stereo set under another robust
    kernel (landmark sets that do not merge)."""
    (ps, ls), (mono, stereo) = _unmerged_graph(m)
    lines = m.LineEdgeSet()
    lines.set_information(1.0)
    lines.add_edges_bulk(np.tile([0, 0, 0, 1.0, 0, 0, 1.0, 0.5, 0.1, 0], (3, 1)), np.zeros(3))
    return (ps, ls), (mono, stereo, lines)


def _unmerged_graph(m):
    p = _problem(6, 30, 1)
    ps, ls, mono = _bulk_graph(m, p)
    _, _, stereo = _bulk_graph(m, _problem(6, 30, 1, kind="stereo"))
    stereo.set_robust_kernel(m.RobustKernelType.CAUCHY, 1.0)
    return (ps, ls), (mono, stereo)


def _pose_only_mono_graph(m):
    """A pose-only plane set beside a depth set."""
    (ps, ls), (depth,) = _depth_graph(m)
    planes = m.PlaneEdgeSet()
    planes.set_information(1.0)
    planes.add_edges_bulk(np.tile([0, 0, 1.0, 1.0, 0, 0, 1.0], (3, 1)), np.zeros(3))
    return (ps, ls), (planes, depth)


@pytest.mark.parametrize(
    "make,packs",
    [
        (_depth_graph, ["depth"]),
        (_line_graph, ["stereo", "line"]),
        (_unmerged_graph, ["stereo"]),
        (_pose_only_mono_graph, ["plane", "depth"]),
    ],
    ids=["depth", "line", "unmerged", "pose-only"],
)
def test_object_graphs_outside_the_slice_raise(make, packs):
    """Depth edges and landmark sets that do not merge, refused by name
    before ROADMAP A7's rest, run through the object API, also beside an
    ICP set: the trace at rtol 1e-9 of the JAX package's, the estimates
    written back within 1e-9, the landmark sets in one pack and each ICP
    set in one of its own."""
    graphs = _twins(make)
    runs = {m: _optimize(m, *g, 3) for m, g in graphs.items()}
    (opt, trace), (_, jtrace) = runs[tba], runs[jba]
    assert [m.kind for m in opt.solver.metas] == packs
    assert len(trace) == len(jtrace)
    np.testing.assert_allclose(trace, jtrace, rtol=1e-9)
    (ps, ls), (jps, jls) = graphs[tba][0], graphs[jba][0]
    _held((*ps.bulk_estimates(), ls.bulk_estimates()),
          (*jps.bulk_estimates(), jls.bulk_estimates()))


def test_verbose_host_loop_counts_outliers_and_writes_back():
    """set_verbose runs the host loop: its line reports the edge sets'
    outlier count, and it ends in the same write-back as the fused loop."""
    p = _problem(8, 40, 9)
    fused = _bulk_graph(tba, p)
    _optimize(tba, fused[:2], fused[2:], 3)
    ps, ls, es = _bulk_graph(tba, p)
    opt = _create(tba)
    opt.set_verbose(True)
    for s in (ps, ls):
        opt.add_vertex_set(s)
    opt.add_edge_set(es)
    opt.initialize()
    opt.optimize(3)
    assert opt.loop_stats is None
    assert opt.nVertices(0) == p.pose_q.shape[0] and opt.getEdgeSets() == [es]
    _held((*ps.bulk_estimates(), ls.bulk_estimates()),
          (*fused[0].bulk_estimates(), fused[1].bulk_estimates()), atol=0)


@pytest.mark.parametrize("ids", ["dense", "sparse"])
def test_bulk_edge_ids_are_looked_up_across_sets(ids):
    """Bulk edges find their vertices by id across several sets of one role,
    whether the ids fill their range or are spaced apart, as the JAX
    package's lookup does; ``index_of_ids`` of each set gives the JAX
    package's global indices; an unknown id raises KeyError."""
    p = _problem(8, 40, 4)
    P, L = p.pose_q.shape[0], p.landmarks.shape[0]
    step = 1 if ids == "dense" else 1000
    pose_ids, lm_ids = np.arange(P) * step, (P + np.arange(L)) * step

    def build(m, edge_pose_ids):
        pose_sets = [m.PoseVertexSet(), m.PoseVertexSet()]
        for k, vs in enumerate(pose_sets):
            sel = np.arange(P) % 2 == k
            vs.add_vertices_bulk(pose_ids[sel], p.pose_q[sel], p.pose_t[sel],
                                 (np.arange(P) >= p.num_active_poses)[sel])
        ls = m.LandmarkVertexSet()
        ls.add_vertices_bulk(lm_ids, p.landmarks)
        es = m.MonoEdgeSet()
        es.set_information(1.0)
        es.set_camera(m.Camera(*p.cam.tolist()))
        es.add_edges_bulk(p.meas, edge_pose_ids, lm_ids[p.lm_idx])
        return pose_sets + [ls], [es]

    graphs = {m: build(m, pose_ids[p.pose_idx]) for m in PKGS}
    runs = {m: _optimize(m, *g, 3)[1] for m, g in graphs.items()}
    np.testing.assert_allclose(runs[tba], runs[jba], rtol=1e-9)
    for vs, jvs in zip(graphs[tba][0], graphs[jba][0]):
        ids_of_set = jvs._bulk_ids[::-1]
        np.testing.assert_array_equal(vs.index_of_ids(ids_of_set), jvs.index_of_ids(ids_of_set))
    bad = pose_ids[p.pose_idx].copy()
    bad[5] = pose_ids.max() + 1
    with pytest.raises(KeyError):
        _optimize(tba, *build(tba, bad), 1)
