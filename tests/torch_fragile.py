"""Edge sets and problems at which kernels B3 and B6 of the PyTorch port,
which walk their inputs in tiles and items of fixed length, can go wrong:
generators shared by the CPU tests (the twins against the JAX package; the
plans, walked in numpy) and the gpu tests (the kernels against their twins).
It imports no JAX, so tests/test_torch_gpu.py can use it on a GPU host."""

from __future__ import annotations

import numpy as np

from cuda_bundle_adjustment_tpu_torch.io.synthetic import make_ba_problem

FRAGILE_EDGE_PATTERNS = (
    "one_edge", "ragged_tail", "heavy_pose", "empty_landmarks", "sorted_by_landmark",
    "fixed_only_tile",
)
FRAGILE_PAIR_PROBLEMS = ("duplicate_observations", "one_triple_beside_thousands")


def fragile_edge_pattern(case: str, rng):
    """``(P, L, pose_idx, lm_idx)`` of an edge set at which a kernel that
    walks the edges in tiles of 128 can go wrong.  The callers fix vertices
    ``P - 2..`` and ``L - 2..``."""
    if case == "one_edge":
        return 3, 3, np.array([0]), np.array([0])
    if case == "ragged_tail":  # 2 tiles and 44 edges of a third, unsorted
        return 12, 150, rng.integers(0, 12, 300), rng.integers(0, 150, 300)
    if case == "heavy_pose":  # pose 2 sees 1100 edges, poses 0, 1 and 4 none
        pi = np.concatenate([np.full(1100, 2), rng.choice([3, 5, 6, 7], 400)])
        return 8, 200, pi, rng.integers(0, 200, 1500)
    if case == "empty_landmarks":  # landmarks 0, 5..9 and 137 have no edge
        li = rng.choice(np.setdiff1d(np.arange(140), [0, 5, 6, 7, 8, 9, 137]), 700)
        return 10, 140, rng.integers(0, 10, 700), li
    if case == "sorted_by_landmark":  # as the generators pack them: runs of 1..9
        li = np.repeat(np.arange(120), rng.integers(1, 10, 120))
        return 14, 120, rng.integers(0, 14, li.size), li
    if case == "fixed_only_tile":  # the first 128 edges touch fixed vertices only
        pi, li = rng.integers(0, 10, 500), rng.integers(0, 90, 500)
        pi[:128], li[:128] = 8 + rng.integers(0, 2, 128), 88 + rng.integers(0, 2, 128)
        return 10, 90, pi, li
    raise ValueError(case)


def fragile_pair_problem(case: str, make=make_ba_problem):
    """A small mono problem of generator ``make`` with its edges rewired to
    a shape at which the Schur pair products' items can go wrong.  The
    measurements stay the generator's: good for one linearisation, not for
    a solve."""
    if case == "duplicate_observations":
        # every fifth landmark is seen twice by one pose: both multiply orders
        # of the pair go into the pose's diagonal block
        p = make(num_poses=10, num_landmarks=60, exact_obs_per_landmark=4, kind="mono", seed=5)
        pose_idx = p.pose_idx.copy()
        first = np.nonzero(np.diff(p.lm_idx, prepend=-1))[0]
        pose_idx[first[::5] + 1] = pose_idx[first[::5]]
        return p._replace(pose_idx=pose_idx)
    if case == "one_triple_beside_thousands":
        # 2600 landmarks seen by poses 0 and 1 (blocks of 2600 triples), one
        # more by poses 1 and 2 (a block of one triple)
        p = make(num_poses=4, num_landmarks=2601, exact_obs_per_landmark=2, kind="mono", seed=6)
        if p.pose_idx.shape[0] != 2 * 2601:
            raise ValueError("the generator dropped an observation")
        pose_idx = np.tile(np.array([0, 1], dtype=p.pose_idx.dtype), 2601)
        pose_idx[-2:] = [1, 2]
        lm_idx = np.repeat(np.arange(2601), 2).astype(p.lm_idx.dtype)
        return p._replace(pose_idx=pose_idx, lm_idx=lm_idx)
    raise ValueError(case)
