"""The port's ICP models and pose-only solve on the CPU, held against the
JAX package: ``LineModel``/``PlaneModel`` chi and terms at 1e-12 on seeded
inputs; a line + plane graph (LOAM's edge and planar features), a mono +
plane graph and motion-only BA (a mono graph whose landmarks are all fixed)
through both packages' object API or array path, traces at rtol 1e-9; the
fused loop bit for bit the host loop; depth edges, landmark sets that do
not merge and a per-edge camera beside an ICP set.  The plane-only graph of ``tests/test_api.py`` is
``tests/test_torch_api.py::test_pose_only_plane_graph``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cuda_bundle_adjustment_tpu as jba
import cuda_bundle_adjustment_tpu_torch as tba
from cuda_bundle_adjustment_tpu.io.arrays import optimizer_from_problem as jax_optimizer
from cuda_bundle_adjustment_tpu.models import icp as jicp
from cuda_bundle_adjustment_tpu.types import GraphArrays as JGraph
from cuda_bundle_adjustment_tpu.types import PackedEdges as JPacked
from cuda_bundle_adjustment_tpu_torch.io.arrays import optimizer_from_problem
from cuda_bundle_adjustment_tpu_torch.io.synthetic import make_ba_problem
from cuda_bundle_adjustment_tpu_torch.models import icp as ticp
from cuda_bundle_adjustment_tpu_torch.solver import block_solver as tbs
from cuda_bundle_adjustment_tpu_torch.types import GraphArrays, PackedEdges

torch.set_num_threads(1)


def _trace(opt):
    return [s.chi2 for s in opt.batch_statistics().get()]


def _create(m):
    if m is tba:
        return tba.TorchGraphOptimisation.create(device="cpu")
    return jba.TpuGraphOptimisation.create()


def _run(m, vertex_sets, edge_sets, niter, fused=True):
    opt = _create(m)
    opt.use_fused_loop = fused
    for vs in vertex_sets:
        opt.add_vertex_set(vs)
    for es in edge_sets:
        opt.add_edge_set(es)
    opt.initialize()
    opt.optimize(niter)
    return opt, _trace(opt)


def _random_quat(rng, scale):
    q = np.concatenate([rng.normal(scale=scale, size=3), [1.0]])
    return q / np.linalg.norm(q)


def _matches(rng, kind, n, noise=0.0):
    """``n`` seeded ICP matches against the identity pose: a plane ``n.x =
    d`` with a point on it, or a line through ``a``-``b`` with a point on
    it, each point moved by ``noise``."""
    out = []
    for _ in range(n):
        if kind == "plane":
            nrm = rng.normal(size=3)
            nrm /= np.linalg.norm(nrm)
            d = rng.normal()
            p = nrm * d + np.cross(nrm, rng.normal(size=3)) + rng.normal(scale=noise, size=3)
            out.append(("plane", nrm, d, p))
        else:
            a, u = rng.normal(size=3), rng.normal(size=3)
            b = a + u / np.linalg.norm(u)
            p = a + rng.uniform(-2, 2) * (b - a) + rng.normal(scale=noise, size=3)
            out.append(("line", a, b, p))
    return out


def _icp_graph(m, matches, q0, t0):
    """One free pose at ``(q0, t0)`` and a line and/or plane edge set of
    ``matches`` (of each package's classes; a set only where it has edges)."""
    poses = m.PoseVertexSet()
    poses.add_vertex(m.PoseVertex(0, m.Se3(q0, t0), False))
    sets = {"line": m.LineEdgeSet(), "plane": m.PlaneEdgeSet()}
    for es in sets.values():
        es.set_information(1.0)
    for kind, u, v, p in matches:
        if kind == "plane":
            edge, meas = m.PlaneEdge(), m.PointToPlaneMatch(u, v, p)
        else:
            edge, meas = m.LineEdge(), m.PointToLineMatch(u, v, p)
        edge.set_vertex(poses.get_vertex(0), 0)
        edge.set_measurement(meas)
        edge.set_information(1.0)
        sets[kind].add_edge(edge)
    return (poses,), tuple(es for es in sets.values() if es.nedges())


@pytest.mark.parametrize("kind", ["line", "plane"])
def test_icp_models_match_jax(kind):
    """Per-edge chi and the ``[E, 42]`` pose stacks of both models at 1e-12
    of the JAX models' on the same seeded poses, matches and masks."""
    rng = np.random.default_rng(3)
    P, E = 5, 64
    q = np.stack([_random_quat(rng, 0.3) for _ in range(P)])
    t = rng.normal(size=(P, 3))
    meas = np.stack([np.concatenate(
        [u, [v], p] if k == "plane" else [u, v, [np.linalg.norm(u - v)], p])
        for k, u, v, p in _matches(rng, kind, E, noise=0.1)]).T
    omega = rng.uniform(0.5, 2.0, E)
    active = (rng.uniform(size=E) > 0.2).astype(np.float64)
    pose_idx = rng.integers(0, P, E)
    jm = {"line": jicp.LineModel, "plane": jicp.PlaneModel}[kind]
    tm = {"line": ticp.LineModel, "plane": ticp.PlaneModel}[kind]
    jg = JGraph(q=jnp.asarray(q), t=jnp.asarray(t), Xw=jnp.zeros((1, 3)))
    jd = JPacked(meas=jnp.asarray(meas), omega=jnp.asarray(omega), cam=jnp.zeros((5, 1)),
                 pose_idx=jnp.asarray(pose_idx.astype(np.int32)), lm_idx=jnp.zeros(E, jnp.int32),
                 both_free=jnp.zeros(E), active=jnp.asarray(active))
    tg = GraphArrays(q=torch.as_tensor(q), t=torch.as_tensor(t), Xw=torch.zeros(1, 3,
                                                                                dtype=torch.float64))
    td = PackedEdges(meas=torch.as_tensor(meas), omega=torch.as_tensor(omega),
                     cam=torch.zeros(5, 1, dtype=torch.float64), pose_idx=torch.as_tensor(pose_idx),
                     lm_idx=torch.zeros(E, dtype=torch.int64),
                     both_free=torch.zeros(E, dtype=torch.float64), active=torch.as_tensor(active),
                     kind=kind)
    for got, want in ((tm.chi(tg, td, 0, 1.0), jm.chi(jg, jd, 0, 1.0)),
                      (tm.terms(tg, td, 0, 1.0)[0], jm.terms(jg, jd, 0, 1.0)[0])):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12 * np.abs(want).max())
    assert tm.terms(tg, td, 0, 1.0)[1:] == (None, None)
    assert tba.models.MODEL_REGISTRY[kind] is tm and not tm.HAS_LANDMARK


def test_line_and_plane_sets_in_one_solve_match_jax():
    """Point-to-line and point-to-plane sets in one pose-only solve (their
    per-pose stacks summed in set order), as LOAM registers a scan: the
    trace at rtol 1e-9 of the JAX package's through both loops, the two
    loops bit for bit, and the pose recovered to the noise."""
    rng = np.random.default_rng(41)
    matches = _matches(rng, "plane", 80, noise=1e-3) + _matches(rng, "line", 40, noise=1e-3)
    q0, t0 = _random_quat(rng, 0.02), [0.05, -0.04, 0.03]
    runs = {}
    for fused in (True, False):
        runs[fused] = _run(tba, *_icp_graph(tba, matches, q0, t0), 10, fused)
    (opt, trace), (hopt, htrace) = runs[True], runs[False]
    assert len(opt.solver.packs) == 2 and [m.kind for m in opt.solver.metas] == ["line", "plane"]
    assert trace == htrace
    assert all(torch.equal(a, b) for a, b in zip(opt.solver.graph, hopt.solver.graph))
    _, jtrace = _run(jba, *_icp_graph(jba, matches, q0, t0), 10)
    np.testing.assert_allclose(trace, jtrace, rtol=1e-9)
    # the line chi sums raw distances (the reference's quirk): it ends at
    # the noise's scale, not near 0
    assert trace[-1] < trace[0]
    est = opt.vertex_sets[0].get_vertex(0).estimate
    np.testing.assert_allclose(est.t, 0.0, atol=1e-3)
    np.testing.assert_allclose(abs(est.q[3]), 1.0, atol=1e-6)


def _motion_only(seed=7):
    """A mono graph whose landmarks are all fixed: motion-only BA."""
    p = make_ba_problem(num_poses=12, num_landmarks=120, mean_obs_per_landmark=5.0, kind="mono",
                        seed=seed, noise_px=0.5)
    return p._replace(num_active_landmarks=0)


def test_motion_only_ba_matches_jax_and_the_host_loop():
    """Motion-only BA (``num_active_landmarks = 0``): the mono set still
    runs kernel B3's twin with an empty landmark side (every ``both_free``
    0); the pose-only solve takes the damped 6x6 blocks; the trace at rtol
    1e-9 of the JAX package's, the fused loop bit for bit the host loop,
    the landmarks unmoved."""
    p = _motion_only()
    runs = {}
    for fused in (True, False):
        opt = optimizer_from_problem(p, device="cpu")
        opt.use_fused_loop = fused
        opt.optimize(10)
        runs[fused] = opt
    opt = runs[True]
    assert opt.solver.plan.route == "pose_only" and opt.solver.plan.lm_seg.order.numel() == 0
    assert not bool(opt.solver.packed.both_free.any())
    assert _trace(opt) == _trace(runs[False])
    assert all(torch.equal(a, b) for a, b in zip(opt.solver.graph, runs[False].solver.graph))
    jopt = jax_optimizer(p)
    jopt.optimize(10)
    assert len(_trace(opt)) == len(_trace(jopt))
    np.testing.assert_allclose(_trace(opt), _trace(jopt), rtol=1e-9)
    assert _trace(opt)[-1] < _trace(opt)[0]
    np.testing.assert_array_equal(opt.solver.result_landmarks(), p.landmarks)


def test_mono_and_plane_sets_in_one_solve_match_jax():
    """A mono set with free landmarks beside a point-to-plane set on its
    poses: the Schur route on the mono set with the plane set's stacks on
    the pose side, no RCM, the trace at rtol 1e-9 of the JAX package's."""
    p = make_ba_problem(num_poses=8, num_landmarks=60, mean_obs_per_landmark=4.0, kind="mono",
                        seed=11)
    rng = np.random.default_rng(5)
    E2 = 50
    planes = _matches(rng, "plane", E2, noise=0.01)
    meas = np.stack([np.concatenate([u, [v], q]) for _, u, v, q in planes])
    specs = [
        dict(kind="mono", meas=p.meas, pose_idx=p.pose_idx, lm_idx=p.lm_idx, omega=p.omega,
             cam=p.cam),
        dict(kind="plane", meas=meas, pose_idx=rng.integers(0, p.num_active_poses, E2),
             lm_idx=np.zeros(E2, np.int64), omega=np.full(E2, 100.0), cam=np.zeros(5)),
    ]
    traces = []
    for pkg in ("jax", "torch"):
        if pkg == "jax":
            opt = jba.TpuGraphOptimisation.create()
        else:
            opt = tba.TorchGraphOptimisation.create(device="cpu")
        opt.solver.initialize_from_arrays(p.pose_q, p.pose_t, p.num_active_poses, p.landmarks,
                                          p.num_active_landmarks, specs)
        opt.optimize(8)
        traces.append(_trace(opt))
    assert opt.solver.ba == 0 and opt.solver.pose_perm is None
    assert opt.solver.plan.route in ("band", "dense")
    np.testing.assert_allclose(traces[1], traces[0], rtol=1e-9)
    assert traces[1][-1] < traces[1][0]


def test_pose_only_solve_refuses_an_indefinite_block_on_the_device(monkeypatch):
    """A damped ``Hpp`` block that is not positive definite: ``cholesky_ex``
    reports it and the verdict is False on the device, nothing read on the
    host; the same system undamaged succeeds."""
    opt = optimizer_from_problem(_motion_only(), device="cpu")
    opt.solver.build_structure()
    _, sys_ = opt.solver.head()
    bad = sys_._replace(Hpp=sys_.Hpp.clone())
    bad.Hpp[1] = -bad.Hpp[1]

    def refuse(*a, **k):
        raise AssertionError("a tensor was read on the host")

    with monkeypatch.context() as m:
        for name in ("__bool__", "item", "tolist", "__float__", "numpy"):
            m.setattr(torch.Tensor, name, refuse)
        _, ok_bad = tbs.solve_pose_only(bad, 1e-3)
        xp, ok = tbs.solve_pose_only(sys_, 1e-3)
    assert not bool(ok_bad) and bool(ok)
    want = torch.linalg.solve(sys_.Hpp + 1e-3 * torch.eye(6, dtype=torch.float64), sys_.bp)
    np.testing.assert_allclose(xp.numpy(), want.numpy(), rtol=1e-10, atol=1e-14)


def _depth_beside_plane():
    p = make_ba_problem(num_poses=6, num_landmarks=30, kind="depth", seed=1)
    return [dict(kind="depth", meas=p.meas, pose_idx=p.pose_idx, lm_idx=p.lm_idx,
                 omega=p.omega, cam=p.cam),
            dict(kind="plane", meas=np.tile([0, 0, 1.0, 1.0, 0, 0, 1.0], (4, 1)),
                 pose_idx=np.zeros(4, np.int64), omega=np.ones(4), cam=np.zeros(5))], p


def _unmerged_beside_line():
    p = make_ba_problem(num_poses=6, num_landmarks=30, kind="mono", seed=1)
    s = make_ba_problem(num_poses=6, num_landmarks=30, kind="stereo", seed=1)
    mono = dict(kind="mono", meas=p.meas, pose_idx=p.pose_idx, lm_idx=p.lm_idx, omega=p.omega,
                cam=p.cam)
    stereo = dict(kind="stereo", meas=s.meas, pose_idx=s.pose_idx, lm_idx=s.lm_idx,
                  omega=s.omega, cam=s.cam, rk=2, delta=1.0)
    line = dict(kind="line", meas=np.tile([0, 0, 0, 1.0, 0, 0, 1.0, 0, 1.0, 0], (3, 1)),
                pose_idx=np.zeros(3, np.int64), omega=np.ones(3), cam=np.zeros(5))
    return [mono, stereo, line], p


def _per_edge_camera_beside_plane():
    specs, p = _depth_beside_plane()
    q = make_ba_problem(num_poses=6, num_landmarks=30, kind="mono", seed=1)
    cam = np.tile(np.asarray(q.cam, dtype=np.float64), (q.meas.shape[0], 1))
    cam[::2, 0] *= 1.01
    specs[0] = dict(kind="mono", meas=q.meas, pose_idx=q.pose_idx, lm_idx=q.lm_idx,
                    omega=q.omega, cam=cam)
    return specs, q


@pytest.mark.parametrize("make", [
    _depth_beside_plane, _unmerged_beside_line, _per_edge_camera_beside_plane,
], ids=["depth", "unmerged", "per-edge-camera"])
def test_what_stays_outside_the_port_raises_beside_icp_sets(make):
    """Depth edges, landmark sets that do not merge and a per-edge camera,
    refused by name before ROADMAP A7's rest, run beside an ICP set: the
    trace at rtol 1e-9 of the JAX package's, no RCM beside the ICP set, the
    fused loop bit for bit the host loop."""
    specs, p = make()
    runs = {}
    for pkg, fused in (("jax", True), ("torch", True), ("torch", False)):
        opt = jba.TpuGraphOptimisation.create() if pkg == "jax" else \
            tba.TorchGraphOptimisation.create(device="cpu")
        opt.use_fused_loop = fused
        opt.solver.initialize_from_arrays(p.pose_q, p.pose_t, p.num_active_poses, p.landmarks,
                                          p.num_active_landmarks, specs)
        opt.optimize(6)
        runs[pkg, fused] = opt
    opt = runs["torch", True]
    assert opt.solver.pose_perm is None and opt.solver.metas[-1].kind in ("line", "plane")
    trace = _trace(opt)
    assert len(trace) == len(_trace(runs["jax", True]))
    np.testing.assert_allclose(trace, _trace(runs["jax", True]), rtol=1e-9)
    assert trace == _trace(runs["torch", False])
    assert all(torch.equal(a, b) for a, b in zip(opt.solver.graph, runs["torch", False].solver.graph))
