"""The packing layer on the CPU: every ``PackedEdges`` field, the
``GraphArrays`` state, the metas and the host indices a structure miss reads,
held bit for bit against a NumPy oracle that keeps the host packing's
semantics (the mono and stereo sets merged, rows padded, poses renamed by
the RCM order, weights and cameras one row where uniform, all on the host);
the structure digest; and the caller's arrays, which packing copies once and
never reads again.  The card's pack is held against the CPU's by
``tests/test_torch_gpu.py``."""

import numpy as np
import pytest
import torch

from cuda_bundle_adjustment_tpu_torch import GraphOptimisationOptions
from cuda_bundle_adjustment_tpu_torch.io.arrays import optimizer_from_problem
from cuda_bundle_adjustment_tpu_torch.io.synthetic import make_ba_problem, make_mixed_ba_problem
from cuda_bundle_adjustment_tpu_torch.models.ba import MODEL_REGISTRY
from cuda_bundle_adjustment_tpu_torch.solver import block_solver as bs
from cuda_bundle_adjustment_tpu_torch.solver.ordering import plan_pose_order
from cuda_bundle_adjustment_tpu_torch.types import KIND_CODES

torch.set_num_threads(1)

CAM = np.array([718.856, 718.856, 607.1928, 185.2157, 386.1448])


# -- the oracle: host packing in NumPy ---------------------------------------------


def _oracle_merge(specs):
    """Mono and stereo sets under one robust kernel as one masked stereo set."""
    if len(specs) < 2 or not all(s["kind"] in ("mono", "stereo") for s in specs) or len(
            {(s.get("rk", 0), s.get("delta", 1.0)) for s in specs}) != 1:
        return specs
    meas, mask, omega, cam, act = [], [], [], [], []
    for s in specs:
        m = np.asarray(s["meas"], np.float64)
        E = m.shape[0]
        if s["kind"] == "mono":
            m = np.concatenate([m, np.zeros((E, 1))], axis=1)
        meas.append(m)
        mask.append(np.full(E, float(s["kind"] == "stereo")))
        omega.append(np.broadcast_to(np.asarray(s["omega"], np.float64).reshape(-1), (E,)))
        cam.append(np.broadcast_to(np.asarray(s.get("cam", np.zeros(5)), np.float64)
                                   .reshape(-1, 5), (E, 5)))
        act.append(np.broadcast_to(np.asarray(s.get("active", 1.0), np.float64), (E,)))
    return [dict(kind="stereo", meas=np.concatenate(meas), mask3=np.concatenate(mask),
                 pose_idx=np.concatenate([np.asarray(s["pose_idx"], np.int64) for s in specs]),
                 lm_idx=np.concatenate([np.asarray(s["lm_idx"], np.int64) for s in specs]),
                 omega=np.concatenate(omega), cam=np.concatenate(cam), active=np.concatenate(act),
                 rk=specs[0].get("rk", 0), delta=specs[0].get("delta", 1.0))]


def _one_row(parts, sizes):
    """The rows of several sets' ``[1 or E, K]`` arrays: one where all are equal."""
    if all(p.shape[0] == 1 for p in parts) and all(np.array_equal(p, parts[0]) for p in parts[1:]):
        return parts[0]
    rows = np.concatenate([np.broadcast_to(p, (E, p.shape[1])) for p, E in zip(parts, sizes)])
    return rows[:1] if rows.shape[0] and np.all(rows == rows[0]) else rows


def oracle(pose_q, pose_t, Pa, landmarks, La, specs, dt):
    """``(q, t, Xw), packs, metas, host_idx``: each pack a dict of NumPy arrays."""
    P, L = pose_q.shape[0], landmarks.shape[0]
    specs = [dict(s, lm_idx=s.get("lm_idx", np.zeros(np.asarray(s["meas"]).shape[0], np.int64)))
             for s in _oracle_merge(specs)]
    has_lm = [MODEL_REGISTRY[s["kind"]].HAS_LANDMARK for s in specs]
    q, t = np.asarray(pose_q, np.float64), np.asarray(pose_t, np.float64)
    new_of_old = None
    if La > 0 and all(has_lm):
        perm = plan_pose_order(np.concatenate([np.asarray(s["pose_idx"], np.int64) for s in specs]),
                               np.concatenate([np.asarray(s["lm_idx"], np.int64) for s in specs]),
                               Pa, La)[0]
        if perm is not None:
            new_of_old = np.empty(Pa, np.int64)
            new_of_old[perm] = np.arange(Pa)
            q, t = np.concatenate([q[perm], q[Pa:]]), np.concatenate([t[perm], t[Pa:]])
    graph = tuple(a.astype(dt) for a in (q, t, np.asarray(landmarks, np.float64).reshape(-1, 3)))
    lm = [i for i, h in enumerate(has_lm) if h]
    groups = [[i] for i, h in enumerate(has_lm) if not h]
    if lm:
        groups.insert(sum(1 for i, h in enumerate(has_lm) if not h and i < lm[0]), lm)
    packs, metas, host_idx = [], [], []
    for members in groups:
        sets = [specs[i] for i in members]
        kinds = {s["kind"] for s in sets}
        kind = (next(iter(kinds)) if len(kinds) == 1
                else "stereo" if kinds <= {"mono", "stereo"} else "mixed")
        rows = MODEL_REGISTRY[kind].MDIM
        meas, pi, li, om, cam, act, code, parts, start = [], [], [], [], [], [], [], [], 0
        for s in sets:
            m = np.asarray(s["meas"], np.float64)
            E = m.shape[0]
            if m.shape[1] < rows:
                m = np.concatenate([m, np.zeros((E, rows - m.shape[1]))], axis=1)
            p = np.asarray(s["pose_idx"], np.int64)
            if new_of_old is not None:
                p = np.where(p < Pa, new_of_old[np.minimum(p, Pa - 1)], p)
            a = np.broadcast_to(np.asarray(s.get("active", 1.0), np.float64), (E,))
            c = np.full(E, KIND_CODES.get(s["kind"], 0), np.uint8)
            if s.get("mask3") is not None:
                c[s["mask3"] <= 0] = KIND_CODES["mono"]
            meas.append(m), pi.append(p), li.append(np.asarray(s["lm_idx"], np.int64))
            om.append(np.asarray(s["omega"], np.float64).reshape(-1, 1))
            cam.append(np.asarray(s.get("cam", np.zeros(5)), np.float64).reshape(-1, 5))
            act.append(a), code.append(c)
            parts.append((bs.EdgeSetMeta(s["kind"], int(s.get("rk", 0)), float(s.get("delta", 1.0)),
                                         int(np.sum(a > 0))), start, start + E))
            start += E
        sizes = [b - a for _, a, b in parts]
        pose_idx, lm_idx = np.concatenate(pi), np.concatenate(li)
        code = np.concatenate(code)
        packs.append(dict(
            meas=np.ascontiguousarray(np.concatenate(meas).T).astype(dt),
            omega=_one_row(om, sizes)[:, 0].astype(dt),
            cam=np.ascontiguousarray(_one_row(cam, sizes).T).astype(dt),
            pose_idx=pose_idx, lm_idx=lm_idx,
            both_free=((pose_idx < Pa) & (lm_idx < La)).astype(dt),
            active=(np.concatenate(act) > 0).astype(dt), kind=kind,
            mask3=(code != KIND_CODES["mono"]).astype(dt) if kind == "stereo" and any(
                s["kind"] == "mono" or "mask3" in s for s in sets) else None,
            code=code if kind == "mixed" else None,
        ))
        metas.append(parts[0][0] if len(sets) == 1 else bs.EdgeSetMeta(
            kind, 0, 1.0, sum(m.nedges for m, _, _ in parts), tuple(parts)))
        host_idx.append((pose_idx, lm_idx))
    return graph, packs, metas, host_idx


# -- the cases ---------------------------------------------------------------------


def _sets(p):
    """A mixed problem's two sets (mono, stereo) as spec dicts."""
    return [dict(s) for s in p.specs]


def _mixed(seed=3, num_poses=24, num_landmarks=260):
    return make_mixed_ba_problem(num_poses=num_poses, num_landmarks=num_landmarks,
                                 mean_obs_per_landmark=3.5, seed=seed)


def _shuffled(p, seed=0):
    """``p`` with its free poses relabelled at random, so that RCM reorders
    them."""
    rng = np.random.default_rng(seed)
    Pa = p.num_active_poses
    new = np.arange(p.pose_q.shape[0])
    new[:Pa] = rng.permutation(Pa)
    old = np.argsort(new)
    specs = [dict(s, pose_idx=new[np.asarray(s["pose_idx"])].astype(np.asarray(s["pose_idx"]).dtype))
             for s in p.specs]
    return p._replace(pose_q=p.pose_q[old], pose_t=p.pose_t[old], specs=tuple(specs))


def _depth_set(p, seed):
    """A depth set over ``p``'s graph: ``[u, v, 1/z]`` rows, a weight an edge."""
    s = dict(p.specs[1], kind="depth")
    rng = np.random.default_rng(seed)
    meas = np.array(s["meas"], dtype=np.float64)
    meas[:, 2] = rng.uniform(0.05, 0.5, meas.shape[0])
    return dict(s, meas=meas, omega=rng.uniform(0.5, 2.0, meas.shape[0]))


def _plane_set(p, seed, E=40):
    rng = np.random.default_rng(seed)
    return dict(kind="plane", meas=rng.normal(size=(E, 7)),
                pose_idx=rng.integers(0, p.num_active_poses, E), omega=np.full(E, 100.0),
                cam=np.zeros(5))


def pack_case(name):
    """``(problem, specs, options)`` of one case."""
    p = _mixed()
    mono, stereo = _sets(p)
    E0, E1 = mono["meas"].shape[0], stereo["meas"].shape[0]
    rng = np.random.default_rng(7)
    if name == "merged":
        return p, [mono, stereo], {}
    if name == "mono":
        q = make_ba_problem(num_poses=20, num_landmarks=200, kind="mono", seed=4)
        return q, [dict(kind="mono", meas=q.meas, pose_idx=q.pose_idx, lm_idx=q.lm_idx,
                        omega=q.omega, cam=q.cam)], {}
    if name == "stereo":
        return p, [stereo], {}
    if name == "depth-beside-stereo":
        return p, [_depth_set(p, 1), stereo], {}
    if name == "two-robust-kernels":
        return p, [dict(mono, rk=3, delta=5.991 ** 0.5), dict(stereo, rk=3, delta=7.815 ** 0.5)], {}
    if name == "mono-mono-merged":
        return p, [mono, dict(mono, meas=mono["meas"] + 0.5)], {}
    if name == "stereo-stereo-merged":
        return p, [stereo, dict(stereo, meas=stereo["meas"] + 0.5)], {}
    if name == "per-edge-omega-and-camera":
        cams = np.tile(CAM, (E1, 1)) * rng.uniform(0.98, 1.02, (E1, 5))
        return p, [dict(mono, omega=rng.uniform(0.5, 2.0, E0)), dict(stereo, cam=cams)], {}
    if name == "uniform-rows-given-per-edge":
        return p, [dict(mono, omega=np.full(E0, 2.0), cam=np.tile(CAM, (E0, 1))),
                   dict(stereo, omega=np.array([2.0]), cam=CAM)], {}
    if name == "cameras-differ-by-set":
        return p, [dict(mono, cam=CAM * 1.01), stereo], {}
    if name == "active-masks":
        return p, [dict(mono, active=(rng.uniform(size=E0) > 0.2).astype(np.float64)),
                   dict(stereo, active=rng.uniform(size=E1) > 0.1, rk=1)], {}
    if name == "active-scalar":
        return p, [dict(mono, active=0.0, rk=2), dict(stereo, active=np.array([1.0]))], {}
    if name == "rcm":  # a band past 48 poses wide, which RCM narrows
        q = _shuffled(_mixed(num_poses=90, num_landmarks=700))
        return q, _sets(q), {}
    if name == "icp-beside-mono":
        return p, [_plane_set(p, 2), mono], {}
    if name == "int64-indices":
        return p, [dict(s, pose_idx=np.asarray(s["pose_idx"], np.int64),
                        lm_idx=np.asarray(s["lm_idx"], np.int64)) for s in (mono, stereo)], {}
    if name == "f32":
        return p, [mono, stereo], dict(dtype="float32")
    if name == "f32-meas-and-empty-set":
        return p, [dict(mono, meas=mono["meas"].astype(np.float32)),
                   dict(stereo, meas=stereo["meas"][:0], pose_idx=stereo["pose_idx"][:0],
                        lm_idx=stereo["lm_idx"][:0], omega=stereo["omega"][:0])], {}
    raise KeyError(name)


CASES = ["merged", "mono", "stereo", "depth-beside-stereo", "two-robust-kernels",
         "mono-mono-merged", "stereo-stereo-merged", "per-edge-omega-and-camera",
         "uniform-rows-given-per-edge", "cameras-differ-by-set", "active-masks", "active-scalar",
         "rcm", "icp-beside-mono", "int64-indices", "f32", "f32-meas-and-empty-set"]


def packed_solver(p, specs, device="cpu", **options):
    solver = bs.BlockSolver(GraphOptimisationOptions(**options), device)
    solver.initialize_from_arrays(p.pose_q, p.pose_t, p.num_active_poses, p.landmarks,
                                  p.num_active_landmarks, specs)
    return solver


def _same(got: torch.Tensor, want: np.ndarray, what: str):
    got = got.cpu()
    assert got.is_contiguous(), what
    assert str(got.dtype).split(".")[1] == want.dtype.name, (what, got.dtype, want.dtype)
    assert tuple(got.shape) == want.shape, (what, tuple(got.shape), want.shape)
    assert got.numpy().tobytes() == want.tobytes(), what


@pytest.mark.parametrize("case", CASES)
def test_pack_equals_the_host_packing(case):
    """Every ``PackedEdges`` field, the state, the metas and the host indices
    a structure miss reads, bit for bit the oracle's."""
    p, specs, options = pack_case(case)
    dt = np.float32 if options.get("dtype") == "float32" else np.float64
    want_graph, want_packs, want_metas, want_idx = oracle(
        p.pose_q, p.pose_t, p.num_active_poses, p.landmarks, p.num_active_landmarks, specs, dt)
    solver = packed_solver(p, specs, **options)
    assert (solver.pose_perm is not None) == (case == "rcm")
    for got, want, name in zip(solver.graph, want_graph, ("q", "t", "Xw")):
        _same(got, want, name)
    assert len(solver.packs) == len(want_packs)
    for got, want in zip(solver.packs, want_packs):
        assert got.kind == want["kind"]
        for f in ("meas", "omega", "cam", "pose_idx", "lm_idx", "both_free", "active", "mask3",
                  "code"):
            if want[f] is None:
                assert getattr(got, f) is None, f
            else:
                _same(getattr(got, f), want[f], f)
    assert list(solver.metas) == want_metas
    assert solver._host_idx_read is None  # nothing read back before a miss asks
    for (gp, gl), (wp, wl) in zip(solver._host_idx, want_idx):
        assert gp.dtype == wp.dtype and np.array_equal(gp, wp)
        assert gl.dtype == wl.dtype and np.array_equal(gl, wl)
    assert solver.pack_stats == dict(bytes=solver.pack_stats["bytes"], copies=0, pinned_new=0)


@pytest.mark.parametrize("where", ["pose-past-the-end", "landmark-negative", "icp-pose-negative"])
def test_an_index_outside_the_graph_raises(where):
    """An edge naming a vertex outside the graph raises ``ValueError``
    before anything is packed; an ICP set's landmark index is not read."""
    p = _mixed()
    mono, stereo = _sets(p)
    specs = {"pose-past-the-end": [mono, dict(stereo, pose_idx=stereo["pose_idx"] + 1000)],
             "landmark-negative": [dict(mono, lm_idx=mono["lm_idx"] - 1000), stereo],
             "icp-pose-negative": [dict(_plane_set(p, 2), pose_idx=np.full(40, -1)), mono]}[where]
    with pytest.raises(ValueError, match="outside the graph"):
        packed_solver(p, specs)
    packed_solver(p, [dict(_plane_set(p, 2), lm_idx=np.full(40, -1)), mono])


def test_a_miss_reads_the_host_indices_and_a_hit_none():
    """The structure pass of a miss reads each pack's renamed host indices,
    the oracle's; a second solver of the graph hits and reads none."""
    bs.clear_structure_cache()
    p, specs, _ = pack_case("rcm")
    want = oracle(p.pose_q, p.pose_t, p.num_active_poses, p.landmarks, p.num_active_landmarks,
                  specs, np.float64)[3]
    first = packed_solver(p, specs)
    first.build_structure()
    assert not first.structure_hit and first._host_idx_read is not None
    assert all(np.array_equal(g, w) for gw in zip(first._host_idx_read, want) for g, w in zip(*gw))
    second = packed_solver(p, specs)
    second.build_structure()
    assert second.structure_hit and second._host_idx_read is None


def test_the_digest_tells_graphs_apart():
    """One index changed, or the same edges split otherwise between the
    sets, gives another structure key; the same arrays in another dtype
    too, and equal arrays the same key."""
    p = _mixed()
    mono, stereo = _sets(p)

    def key(specs):
        return bs._struct_digest(specs, p.pose_q.shape[0], p.num_active_poses,
                                 p.landmarks.shape[0], p.num_active_landmarks)

    base = key([mono, stereo])
    assert key([dict(mono), dict(stereo, lm_idx=stereo["lm_idx"].copy())]) == base
    moved = stereo["lm_idx"].copy()
    moved[5] = (moved[5] + 1) % p.num_active_landmarks
    assert key([mono, dict(stereo, lm_idx=moved)]) != base
    n = 3  # the mono set's last three edges moved into the stereo set
    shifted = [dict(mono, **{k: mono[k][:-n] for k in ("pose_idx", "lm_idx")}),
               dict(stereo, **{k: np.concatenate([mono[k][-n:], stereo[k]])
                               for k in ("pose_idx", "lm_idx")})]
    assert key(shifted) != base
    assert key([dict(s, pose_idx=s["pose_idx"].astype(np.int64)) for s in (mono, stereo)]) != base


def test_overwriting_the_callers_arrays_after_packing_changes_nothing():
    """Packing copies the caller's arrays: overwritten right after
    ``optimizer_from_problem`` returns, the solve's trace and final state
    are bit for bit those of an untouched copy's."""
    p = _mixed(seed=5)
    keep = p._replace(pose_q=p.pose_q.copy(), pose_t=p.pose_t.copy(),
                      landmarks=p.landmarks.copy(),
                      specs=tuple({k: (v.copy() if isinstance(v, np.ndarray) else v)
                                   for k, v in s.items()} for s in p.specs))
    ref = optimizer_from_problem(keep, device="cpu")
    ref.optimize(4)
    opt = optimizer_from_problem(p, device="cpu")
    for a in (p.pose_q, p.pose_t, p.landmarks):
        a[...] = 7.0
    for s in p.specs:
        for k in ("meas", "omega", "pose_idx", "lm_idx"):
            s[k][...] = 0
    opt.optimize(4)
    assert [b.chi2 for b in opt.batch_statistics().get()] == \
        [b.chi2 for b in ref.batch_statistics().get()]
    for got, want in zip(opt.solver.result_poses() + (opt.solver.result_landmarks(),),
                         ref.solver.result_poses() + (ref.solver.result_landmarks(),)):
        assert got.tobytes() == want.tobytes()


def test_the_solve_history_keeps_the_pack_counters():
    """``pack_stats`` (the block's bytes, its copies: none on the CPU, and
    whether it was a new pinned block) goes into the solve's history entry
    beside the loop's counters."""
    from cuda_bundle_adjustment_tpu_torch.utils.profiling import solve_history

    p = _mixed(seed=6)
    opt = optimizer_from_problem(p, device="cpu")
    staged = sum(a.nbytes for a in (p.pose_q, p.pose_t, p.landmarks))
    staged += sum(np.asarray(s[k]).nbytes for s in p.specs for k in ("meas", "pose_idx", "lm_idx"))
    assert opt.pack_stats["bytes"] >= staged and opt.pack_stats["copies"] == 0
    opt.optimize(2)
    assert solve_history()[-1]["pack"] == opt.pack_stats
