"""The port's native symbolic analysis (``native/symbolic.cpp``) against the
JAX package's native pass and against the port's numpy copy, the segment
plans' counting sort against ``np.argsort``, the native band bound and pose
order against their numpy bodies, and the library's build (content-addressed
name, a failed build leaves nothing, one library for concurrent loads)."""

import functools
import threading

import numpy as np
import pytest
import torch

from chip_smoke import structure_agreement
from torch_fragile import fragile_pair_problem
from cuda_bundle_adjustment_tpu.io import synthetic as jsyn
from cuda_bundle_adjustment_tpu.solver import ordering as jord
from cuda_bundle_adjustment_tpu.solver import symbolic as jsym
from cuda_bundle_adjustment_tpu_torch.io.synthetic import make_ba_problem, make_mixed_ba_problem
from cuda_bundle_adjustment_tpu_torch.native import build
from cuda_bundle_adjustment_tpu_torch.solver import native_symbolic, ordering, symbolic
from cuda_bundle_adjustment_tpu_torch.solver.segments import make_segments


def _unique_edges(rng, E, P, L):
    keys = rng.choice(P * L, size=E, replace=False)
    return keys // L, keys % L


@functools.lru_cache(maxsize=1)
def _grown_kitti07():
    """A mono + stereo graph at KITTI-07's size (248 poses, 26,127
    landmarks), its two sets concatenated, cut to the map as it stood when
    its landmark ``m - 1`` was created: the landmarks ``< m``, the keyframes
    up to the newest that had created one, the observations among them (the
    growing map a mapping back end re-solves)."""
    p = make_mixed_ba_problem(num_poses=248, num_landmarks=26127,
                              mean_obs_per_landmark=95037 / 26127, seed=0)
    P, Pa = p.pose_q.shape[0], p.num_active_poses
    pi = np.concatenate([np.asarray(s["pose_idx"], dtype=np.int64) for s in p.specs])
    li = np.concatenate([np.asarray(s["lm_idx"], dtype=np.int64) for s in p.specs])
    seq = np.where(pi < Pa, pi + P - Pa, pi - Pa)  # sequence order: fixed poses first
    first = np.full(p.landmarks.shape[0], P, dtype=np.int64)
    np.minimum.at(first, li, seq)
    first[first == P] = 0  # a landmark no pose sees was there from the start
    m = int(0.95 * p.landmarks.shape[0])
    newest = int(np.max(first[:m]))
    keep = (li < m) & (seq <= newest)
    new_Pa = newest + 1 - (P - Pa)
    pi, li = pi[keep], li[keep]
    return np.where(pi < Pa, pi, pi - Pa + new_Pa), li, new_Pa, m


def _graph(case):
    """``(pose_idx, lm_idx, Pa, La)`` of a small edge set; fixed vertices
    are ``Pa..`` and ``La..``."""
    if case == "synthetic_grown_kitti07":
        return _grown_kitti07()
    rng = np.random.default_rng(sorted(CASES).index(case))
    if case == "random":  # fixed poses and landmarks, no duplicate observation
        pi, li = _unique_edges(rng, 500, 14, 90)
        return pi, li, 12, 80
    if case in ("duplicates", "shuffled"):
        pi, li = _unique_edges(rng, 400, 12, 70)
        rep = rng.choice(400, size=80)  # some edges twice, some three times
        pi, li = np.concatenate([pi, pi[rep]]), np.concatenate([li, li[rep]])
        if case == "shuffled":
            order = rng.permutation(pi.size)
            pi, li = pi[order], li[order]
        return pi, li, 10, 60
    if case == "landmark_seen_once":
        li = rng.permutation(120)
        return rng.integers(0, 9, 120), li, 8, 110
    if case == "one_free_pose":
        pi, li = _unique_edges(rng, 150, 3, 80)
        return pi, li, 1, 75
    if case == "no_both_free":  # every edge has a fixed pose or landmark
        fixed_pose = rng.random(200) < 0.5
        pi = np.where(fixed_pose, rng.integers(6, 8, 200), rng.integers(0, 6, 200))
        li = np.where(fixed_pose, rng.integers(0, 50, 200), rng.integers(40, 50, 200))
        return pi, li, 6, 40
    if case == "synthetic":  # its tracks observe some landmarks twice from one pose
        p = make_ba_problem(num_poses=12, num_landmarks=150, seed=2)
    elif case == "fragile_duplicates":
        p = fragile_pair_problem("duplicate_observations")
    return p.pose_idx, p.lm_idx, p.num_active_poses, p.num_active_landmarks


# a new case sorts after the others: a case's rng is seeded by its position
CASES = ("random", "duplicates", "shuffled", "landmark_seen_once", "one_free_pose",
         "no_both_free", "synthetic", "fragile_duplicates", "synthetic_grown_kitti07")
WITH_DUPLICATES = {"duplicates", "shuffled", "synthetic", "fragile_duplicates"}


def _has_duplicates(pi, li, Pa, La):
    both = (pi < Pa) & (li < La)
    keys = pi[both] * La + li[both]
    return np.unique(keys).size < keys.size


@pytest.mark.parametrize("case", CASES)
def test_native_structure_matches_the_jax_native_pass(case):
    """Array for array, order included, and the per-block offsets the
    native pass emits are the JAX triples' block counts."""
    pi, li, Pa, La = _graph(case)
    assert _has_duplicates(pi, li, Pa, La) == (case in WITH_DUPLICATES)
    want = jsym.build_schur_structure(pi, li, Pa, La, use_native=True)
    got = symbolic.build_schur_structure(pi, li, Pa, La)
    assert want.tri_sorted and got.tri_sorted  # both native, none fell back
    for name in want._fields:
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
    counts = np.bincount(want.tri_k, minlength=want.nnz_blocks)
    np.testing.assert_array_equal(got.tri_offsets, np.concatenate([[0], np.cumsum(counts)]))
    # the offsets are the native pass's: no second sort of the triples
    ei, ej, off = symbolic.sort_triples(got)
    assert ei is got.tri_ei and ej is got.tri_ej and off is got.tri_offsets
    if case == "no_both_free":
        assert got.nmul_blocks == 0 and got.nnz_blocks == Pa


@pytest.mark.parametrize("case", CASES)
def test_native_structure_matches_the_numpy_copy(case):
    """Exactly where no two both-free edges share a pose and a landmark;
    where some do, the same multiset per block, the order moved only in
    diagonal blocks that receive both multiply orders of such a pair."""
    pi, li, Pa, La = _graph(case)
    native = symbolic.build_schur_structure(pi, li, Pa, La)
    plain = symbolic.build_schur_structure(pi, li, Pa, La, use_native=False)
    reordered = structure_agreement(native, plain)
    if case in WITH_DUPLICATES:
        assert reordered > 0
    else:
        assert reordered == 0
        ei, ej, off = symbolic.sort_triples(plain)
        np.testing.assert_array_equal(native.tri_ei, ei)
        np.testing.assert_array_equal(native.tri_ej, ej)
        np.testing.assert_array_equal(native.tri_offsets, off)


@pytest.mark.parametrize("case", CASES)
def test_native_band_bound_matches_numpy(case):
    pi, li, Pa, La = _graph(case)
    want = ordering._band_bound(pi, li, Pa, La, use_native=False)
    assert ordering._band_bound(pi, li, Pa, La) == want
    assert (want is None) == (case == "no_both_free")


@pytest.mark.parametrize("long_range", [0.0, 0.02, 0.3])
def test_plan_pose_order_native_matches_numpy_and_jax(long_range, monkeypatch):
    p = jsyn.make_loop_closure_problem(
        num_poses=150, num_landmarks=1500, long_range_fraction=long_range, seed=5
    )
    args = (p.pose_idx, p.lm_idx, p.num_active_poses, p.num_active_landmarks)
    got = ordering.plan_pose_order(*args)
    want = jord.plan_pose_order(*args)
    numpy_bound = ordering._band_bound
    monkeypatch.setattr(
        ordering, "_band_bound", lambda *a: numpy_bound(*a, use_native=False))
    plain = ordering.plan_pose_order(*args)
    for other in (want, plain):
        assert got[1:] == other[1:]
        assert (got[0] is None) == (other[0] is None)
        if got[0] is not None:
            np.testing.assert_array_equal(got[0], other[0])


@pytest.mark.parametrize(
    "ids, nseg",
    [
        (np.array([3, 0, 5, 1, 3, 7, 0, 2, 9, 1]), 4),  # ids >= nseg drop out
        (np.zeros(0, dtype=np.int64), 3),
        (np.array([0, 2, 1]), 0),
        (np.full(50, 2), 3),
        (np.random.default_rng(4).permutation(np.repeat(np.arange(40), 7)), 40),
        (np.random.default_rng(5).integers(0, 1300, 20000, dtype=np.int32), 1250),
    ],
    ids=["fixed_ids", "empty", "no_segments", "all_equal", "shuffled", "int32_poses"],
)
def test_segments_match_the_stable_argsort(ids, nseg):
    """The counting sort's plan is the stable argsort's, rows past ``nseg``
    cut off by the last offset."""
    order = np.argsort(ids, kind="stable")
    offsets = np.searchsorted(ids[order], np.arange(nseg + 1), side="left")
    seg = make_segments(ids, nseg, "cpu")
    assert seg.order.dtype == seg.offsets.dtype == torch.int64
    np.testing.assert_array_equal(seg.order.numpy(), order[: offsets[-1]])
    np.testing.assert_array_equal(seg.offsets.numpy(), offsets)


def test_segments_refuse_a_negative_id():
    with pytest.raises(ValueError, match="negative"):
        make_segments(np.array([0, 1, -1, 2]), 3, "cpu")


def _past_int32():
    """An index array of 2^31 entries that takes no memory (one element,
    stride 0)."""
    return np.broadcast_to(np.int64(0), (2**31,))


@pytest.mark.parametrize(
    "call",
    [
        lambda: native_symbolic.native_structure(np.array([0, 1, -1]), np.zeros(3), 4, 4),
        lambda: native_symbolic.native_structure(np.arange(2), np.array([0, -1]), 4, 4),
        lambda: native_symbolic.native_structure(_past_int32(), _past_int32(), 4, 4),
        lambda: native_symbolic.native_structure(np.arange(3), np.arange(2), 4, 4),
        lambda: native_symbolic.pose_band_bound(np.array([0, -1]), np.array([0, 0]), 4, 4),
        lambda: native_symbolic.pose_band_bound(np.arange(3), np.arange(2), 4, 4),
    ],
    ids=["pose_outside_Pa", "negative_landmark", "edge_ids_past_int32", "structure_lengths",
         "negative_pose", "lengths"],
)
def test_binding_refuses_indices_the_library_would_overrun(call):
    """A pose at or past ``Pa`` is a fixed pose and drops out; below 0 it
    would index the block table before its start.  The pair keys are made
    inside the pass from poses in ``[0, Pa)``, so none can fall outside the
    table; the triples' edge ids must fit int32."""
    with pytest.raises(ValueError):
        call()


# -- the build -------------------------------------------------------------------


@pytest.fixture
def scratch_build(tmp_path, monkeypatch):
    """The build writing into an empty directory of its own, with no library
    loaded yet."""
    out = tmp_path / "build"
    monkeypatch.setattr(build, "BUILD_DIR", out)
    monkeypatch.setattr(build, "_libs", {})
    return out


def test_library_name_follows_source_flags_and_compiler(tmp_path, monkeypatch):
    src = tmp_path / "symbolic.cpp"
    src.write_bytes(build.SOURCE.read_bytes())
    monkeypatch.setattr(build, "SOURCE", src)
    first = build.library_path()
    assert build.library_path() == first
    src.write_bytes(build.SOURCE.read_bytes() + b"\n// edited\n")
    edited = build.library_path()
    monkeypatch.setattr(build, "FLAGS", build.FLAGS + ("-DTBA_EDITED",))
    flagged = build.library_path()
    monkeypatch.setitem(build._compiler, "version", "g++ (another) 0.0")
    compiler = build.library_path()
    assert len({first, edited, flagged, compiler}) == 4
    assert first.parent == build.BUILD_DIR and first.name.startswith("libsymbolic-")


def test_failed_build_raises_with_compiler_output_and_leaves_nothing(
    scratch_build, tmp_path, monkeypatch
):
    bad = tmp_path / "symbolic.cpp"
    bad.write_text('extern "C" int tba_broken( { return 0; }\n')
    monkeypatch.setattr(build, "SOURCE", bad)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed on symbolic.cpp") as err:
        build.load()
    assert "error" in str(err.value)
    assert list(scratch_build.iterdir()) == []
    # no fallback: the analysis raises too, and a second attempt builds again
    pi, li, Pa, La = _graph("random")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        symbolic.build_schur_structure(pi, li, Pa, La)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        ordering._band_bound(pi, li, Pa, La)
    assert list(scratch_build.iterdir()) == []


def test_concurrent_loads_build_one_library(scratch_build):
    barrier = threading.Barrier(2)
    libs = [None, None]

    def load(i):
        barrier.wait(timeout=60)
        libs[i] = build.load()

    threads = [threading.Thread(target=load, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert libs[0] is not None and libs[0] is libs[1]
    assert [p.name for p in scratch_build.iterdir()] == [build.library_path().name]
