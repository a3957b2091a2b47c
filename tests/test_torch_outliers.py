"""Outlier thresholding in the port (``BlockSolver.update_edges``, called at
the end of both LM loops) on the CPU, held against the JAX package: the same
edges masked and counted, in the caller's edge order, for one set, a merged
mono+stereo set with a threshold per set, a robust kernel (ORB-SLAM2's local
BA: Huber at sqrt(5.991), threshold 5.991) and an ICP set beside another;
the second ``optimize()`` on the inliers hits the structure cache and its
trace is the JAX package's at rtol 1e-9; both loops mask the same edges
bit for bit."""

import numpy as np
import pytest
import torch

import cuda_bundle_adjustment_tpu as jba
import cuda_bundle_adjustment_tpu_torch as tba
from cuda_bundle_adjustment_tpu.io.arrays import optimizer_from_problem as jax_optimizer
from cuda_bundle_adjustment_tpu_torch.io.arrays import optimizer_from_problem
from cuda_bundle_adjustment_tpu_torch.io.synthetic import make_ba_problem
from cuda_bundle_adjustment_tpu_torch.models.ba import MonoModel
from cuda_bundle_adjustment_tpu_torch.solver import block_solver as tbs

torch.set_num_threads(1)

HUBER = 3  # RobustKernelType.HUBER
CHI2_2DOF = 5.991  # the 95% chi2 quantile of a 2-d residual, ORB-SLAM2's threshold


def _trace(opt):
    return [s.chi2 for s in opt.batch_statistics().get()]


def _corrupted(kind="mono", seed=19, every=10, shift=30.0, P=10, L=60):
    p = make_ba_problem(num_poses=P, num_landmarks=L, mean_obs_per_landmark=4.0, kind=kind,
                        seed=seed, noise_px=0.5)
    meas = p.meas.copy()
    meas[::every, :2] += shift
    return p._replace(meas=meas)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "host"])
def test_robust_threshold_masks_and_reoptimises_as_jax(fused):
    """ORB-SLAM2's local BA on a small mono graph with every tenth
    measurement moved by 30 px: ``optimize(5)`` under Huber (delta
    sqrt(5.991)) with threshold 5.991, then ``optimize(10)`` on the
    inliers.  The mask is the robustified per-edge chi2 (the model's chi at
    the first run's final state) thresholded; masks, counts and both traces
    are the JAX package's (traces at rtol 1e-9); the second run hits the
    structure cache and excludes the masked edges."""
    p = _corrupted()
    robust = dict(rk=HUBER, delta=float(np.sqrt(CHI2_2DOF)), outlier_threshold=CHI2_2DOF)
    opt = optimizer_from_problem(p, device="cpu", **robust)
    opt.use_fused_loop = fused
    jopt = jax_optimizer(p, **robust)
    jopt.use_fused_loop = fused
    opt.optimize(5)
    jopt.optimize(5)
    np.testing.assert_allclose(_trace(opt), _trace(jopt), rtol=1e-9)
    s = opt.solver
    chi = MonoModel.chi(s.graph, s.packed._replace(active=torch.ones_like(s.packed.active)),
                        HUBER, robust["delta"])
    keep = s.packed.active.numpy() > 0
    np.testing.assert_array_equal(keep, chi.numpy() <= CHI2_2DOF)
    assert s._outlier_counts == jopt.solver._outlier_counts == [int((~keep).sum())]
    assert not keep[::10].any() and keep.sum() > 0.8 * keep.size
    first, info = _trace(opt), tbs.structure_cache_info()
    opt.optimize(10)
    jopt.optimize(10)
    assert tbs.structure_cache_info()["hits"] == info["hits"] + 1 and s.symbolic_ms == 0.0
    np.testing.assert_allclose(_trace(opt), _trace(jopt), rtol=1e-9)
    second = _trace(opt)[len(first):]  # the statistics run on until initialize()
    assert second[-1] < second[0] < first[-1]  # the inliers' chi2, falling
    # an edge masked by the first call is not counted again
    assert s._outlier_counts == jopt.solver._outlier_counts
    assert not (s.packed.active.numpy() > 0)[~keep].any()


def test_both_loops_mask_the_same_edges_bit_for_bit():
    """The fused loop and the host loop give the same masks, counts, state
    and traces bit for bit across the two runs."""
    p = _corrupted(seed=3)
    out = []
    for fused in (True, False):
        opt = optimizer_from_problem(p, device="cpu", outlier_threshold=20.0)
        opt.use_fused_loop = fused
        opt.optimize(4)
        first = (_trace(opt), opt.solver.packed.active.clone(), list(opt.solver._outlier_counts))
        opt.optimize(4)
        out.append((first, _trace(opt), opt.solver.graph))
    (f1, t1, g1), (f2, t2, g2) = out
    assert f1[0] == f2[0] and torch.equal(f1[1], f2[1]) and f1[2] == f2[2] and t1 == t2
    assert all(torch.equal(a, b) for a, b in zip(g1, g2))


def _vertex_sets(m, problem, P):
    """The pose and landmark vertex sets of ``problem`` (of package ``m``;
    landmark ids ``P + j``)."""
    poses, landmarks = m.PoseVertexSet(), m.LandmarkVertexSet()
    for i in range(P):
        poses.add_vertex(m.PoseVertex(i, m.Se3(problem.pose_q[i], problem.pose_t[i]),
                                      i >= problem.num_active_poses))
    for j in range(problem.landmarks.shape[0]):
        landmarks.add_vertex(m.LandmarkVertex(P + j, problem.landmarks[j]))
    return poses, landmarks


def test_merged_mono_and_stereo_sets_keep_a_threshold_each():
    """A mono set (threshold 5.991) and a stereo set (threshold 7.815) merge
    into one masked stereo set whose threshold is per edge; the masks come
    back split by the sets' sizes: the same edges inactivated and counted in
    each set as by the JAX package, on a shuffled edge order."""
    ps = make_ba_problem(num_poses=8, num_landmarks=50, mean_obs_per_landmark=4.0, kind="stereo",
                         seed=9, noise_px=0.5)
    P = ps.pose_q.shape[0]
    E = ps.meas.shape[0]
    rng = np.random.default_rng(9)
    is_mono = rng.random(E) < 0.5
    order = rng.permutation(E)
    bad = set(order[::7].tolist())  # gross matches, spread over both sets

    def build(m):
        poses, landmarks = _vertex_sets(m, ps, P)
        mono, stereo = m.MonoEdgeSet(), m.StereoEdgeSet()
        for es, thr in ((mono, CHI2_2DOF), (stereo, 7.815)):
            es.set_camera(m.Camera(*ps.cam.tolist()))
            es.set_information(1.0)
            es.set_robust_kernel(m.RobustKernelType.HUBER, 2.0)
            es.set_outlier_threshold(thr)
        for e in order:
            meas = ps.meas[e].copy()
            if e in bad:
                meas[:2] += 40.0
            edge = m.MonoEdge() if is_mono[e] else m.StereoEdge()
            edge.set_vertex(poses.get_vertex(int(ps.pose_idx[e])), 0)
            edge.set_vertex(landmarks.get_vertex(P + int(ps.lm_idx[e])), 1)
            edge.set_measurement(meas[:2] if is_mono[e] else meas)
            edge.set_information(1.0)
            (mono if is_mono[e] else stereo).add_edge(edge)
        opt = (tba.TorchGraphOptimisation.create(device="cpu") if m is tba
               else jba.TpuGraphOptimisation.create())
        for s in (poses, landmarks):
            opt.add_vertex_set(s)
        for s in (mono, stereo):
            opt.add_edge_set(s)
        opt.initialize()
        opt.optimize(8)
        return opt, mono, stereo

    (opt, mono, stereo), (jopt, jmono, jstereo) = build(tba), build(jba)
    assert opt.solver.packed.mask3 is not None and len(opt.solver.packs) == 1
    assert np.asarray(opt.solver._spec_thresholds[0]).shape == (E,)
    for es, jes in ((mono, jmono), (stereo, jstereo)):
        flagged = [i for i, e in enumerate(es.edges) if not e.is_active]
        assert flagged == [i for i, e in enumerate(jes.edges) if not e.is_active]
        assert es.get_outlier_count() == jes.get_outlier_count() == len(flagged) > 0
    np.testing.assert_allclose(_trace(opt), _trace(jopt), rtol=1e-9)


def test_packed_order_is_the_callers_edge_order():
    """Edges are packed in the order the caller added them (object edges,
    then bulk edges): on a shuffled mono graph with bulk edges after the
    objects, the packed mask read in that order is the one written back
    to the edge objects and the bulk ``active`` rows, and the JAX package
    flags the same edges."""
    p = make_ba_problem(num_poses=8, num_landmarks=50, mean_obs_per_landmark=4.0, kind="mono",
                        seed=13, noise_px=0.5)
    P, E = p.pose_q.shape[0], p.meas.shape[0]
    rng = np.random.default_rng(13)
    order = rng.permutation(E)
    meas = p.meas.copy()
    bad = np.zeros(E, bool)
    bad[rng.choice(E, E // 12, replace=False)] = True
    meas[bad] += 200.0
    n_obj = E // 2

    def build(m):
        poses, landmarks = _vertex_sets(m, p, P)
        es = m.MonoEdgeSet()
        es.set_camera(m.Camera(*p.cam.tolist()))
        es.set_information(1.0)
        es.set_robust_kernel(m.RobustKernelType.HUBER, 2.0)
        es.set_outlier_threshold(50.0)
        for e in order[:n_obj]:
            edge = m.MonoEdge()
            edge.set_vertex(poses.get_vertex(int(p.pose_idx[e])), 0)
            edge.set_vertex(landmarks.get_vertex(P + int(p.lm_idx[e])), 1)
            edge.set_measurement(meas[e])
            edge.set_information(1.0)
            es.add_edge(edge)
        rest = order[n_obj:]
        es.add_edges_bulk(meas[rest], p.pose_idx[rest], P + p.lm_idx[rest])
        opt = (tba.TorchGraphOptimisation.create(device="cpu") if m is tba
               else jba.TpuGraphOptimisation.create())
        for s in (poses, landmarks):
            opt.add_vertex_set(s)
        opt.add_edge_set(es)
        opt.initialize()
        opt.optimize(8)
        flags = np.concatenate([[not e.is_active for e in es.edges], ~es._bulk["active"]])
        active = np.asarray(opt.solver.packed.active) if m is tba else None
        return flags, es.get_outlier_count(), active

    (flags, n, active), (jflags, jn, _) = build(tba), build(jba)
    np.testing.assert_array_equal(flags, jflags)
    assert n == jn == flags.sum()
    # the packed mask, in the caller's order, is the write-back's
    np.testing.assert_array_equal(active == 0, flags)
    assert 0 < flags.sum() < flags.size // 4


def test_a_threshold_on_one_icp_set_beside_another():
    """A plane set with a threshold beside a line set without one: only
    the plane set's gross matches are masked and counted; the line set is
    left as it was."""
    rng = np.random.default_rng(2)
    poses = tba.PoseVertexSet()
    poses.add_vertex(tba.PoseVertex(0, tba.Se3([0, 0, 0, 1.0], [0.02, 0, 0]), False))
    planes, lines = tba.PlaneEdgeSet(), tba.LineEdgeSet()
    for es in (planes, lines):
        es.set_information(1.0)
    planes.set_outlier_threshold(0.01)
    for k in range(40):
        n = rng.normal(size=3)
        n /= np.linalg.norm(n)
        d = rng.normal()
        e = tba.PlaneEdge()
        e.set_vertex(poses.get_vertex(0), 0)
        e.set_measurement(tba.PointToPlaneMatch(n, d + (1.0 if k % 8 == 0 else 0.0),
                                                n * d + np.cross(n, rng.normal(size=3))))
        e.set_information(1.0)
        planes.add_edge(e)
        a = rng.normal(size=3)
        e = tba.LineEdge()
        e.set_vertex(poses.get_vertex(0), 0)
        e.set_measurement(tba.PointToLineMatch(a, a + [1.0, 0, 0], a + [0.5, 0, 0]))
        e.set_information(1.0)
        lines.add_edge(e)
    opt = tba.TorchGraphOptimisation.create(device="cpu")
    opt.add_vertex_set(poses)
    opt.add_edge_set(planes)
    opt.add_edge_set(lines)
    opt.initialize()
    opt.optimize(5)
    assert [i for i, e in enumerate(planes.edges) if not e.is_active] == list(range(0, 40, 8))
    assert planes.get_outlier_count() == 5 and opt.solver._outlier_counts == [5, 0]
    assert all(e.is_active for e in lines.edges) and lines.get_outlier_count() == 0
