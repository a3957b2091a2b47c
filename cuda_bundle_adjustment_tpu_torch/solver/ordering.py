"""Bandwidth-reducing pose ordering (reverse Cuthill-McKee).

A copy of the JAX package's ``solver/ordering.py``: numpy throughout, but
for the O(E) band pre-check, which runs in C++ (``native/symbolic.cpp
tba_pose_band_bound``) as the JAX package's does; its numpy body stays as
the tests' oracle (``use_native=False``).  The band solve
(kernels B7/B8) needs a small Hsc block bandwidth: trajectory graphs have it
natively, and RCM recovers a banded order for graphs with loop closures
whenever one exists.  ``tests/test_torch_stages.py`` pins this copy to the
original.
"""

from __future__ import annotations

import numpy as np


def pose_pairs(
    pose_idx: np.ndarray, lm_idx: np.ndarray, Pa: int, La: int
) -> np.ndarray:
    """Unique active-pose co-visibility pairs ``(a <= b)`` as keys
    ``a * Pa + b`` — the Hsc block pattern before diagonal completion."""
    pose_idx = np.asarray(pose_idx, dtype=np.int64)
    lm_idx = np.asarray(lm_idx, dtype=np.int64)
    both = (pose_idx < Pa) & (lm_idx < La)
    p = pose_idx[both]
    l = lm_idx[both]
    order = np.lexsort((p, l))
    p = p[order]
    l = l[order]
    deg = np.bincount(l, minlength=La)
    run_start = np.concatenate([[0], np.cumsum(deg)])
    dmax = int(deg.max()) if La and deg.size else 0
    keys = []
    for d in range(2, dmax + 1):
        lms = np.nonzero(deg == d)[0]
        if lms.size == 0:
            continue
        tup = p[run_start[lms][:, None] + np.arange(d)[None, :]]  # [Ld, d]
        aa, bb = np.triu_indices(d)
        keys.append((tup[:, aa] * Pa + tup[:, bb]).reshape(-1))
    if not keys:
        return np.zeros(0, dtype=np.int64)
    return np.unique(np.concatenate(keys))


def rcm_order(keys: np.ndarray, Pa: int) -> np.ndarray:
    """Reverse Cuthill-McKee over the pose co-visibility graph.

    ``keys`` are unique ``a * Pa + b`` pairs with ``a <= b``.  Returns
    ``perm`` with ``perm[i]`` = old index of the pose at new position ``i``.
    """
    a = keys // Pa
    b = keys % Pa
    off = a != b
    src = np.concatenate([a[off], b[off]])
    dst = np.concatenate([b[off], a[off]])
    order = np.argsort(src, kind="stable")
    src = src[order]
    dst = dst[order]
    ptr = np.searchsorted(src, np.arange(Pa + 1))
    deg = ptr[1:] - ptr[:-1]

    visited = np.zeros(Pa, dtype=bool)
    out = np.empty(Pa, dtype=np.int64)
    n_out = 0
    # process components in order of their lowest-degree seed
    seed_order = np.argsort(deg, kind="stable")
    si = 0
    head = 0
    while n_out < Pa:
        while si < Pa and visited[seed_order[si]]:
            si += 1
        seed = seed_order[si]
        visited[seed] = True
        out[n_out] = seed
        n_out += 1
        head = n_out - 1
        while head < n_out:
            u = out[head]
            head += 1
            nb = dst[ptr[u] : ptr[u + 1]]
            nb = nb[~visited[nb]]
            if nb.size:
                nb = np.unique(nb)  # may contain duplicates across edges
                nb = nb[np.argsort(deg[nb], kind="stable")]
                visited[nb] = True
                out[n_out : n_out + nb.size] = nb
                n_out += nb.size
    return out[::-1].copy()  # the REVERSE ordering


def _band_bound(pi, li, Pa, La, use_native: bool = True):
    """O(E) pose-bandwidth bound; ``None`` when no both-free edge exists.
    ``use_native``: one pass in C++ (raises if its library cannot be
    built), else the ``np.minimum.at`` scatter pair."""
    if use_native:
        from .native_symbolic import pose_band_bound

        return pose_band_bound(pi, li, Pa, La)
    both = (pi < Pa) & (li < La)
    p, l = pi[both], li[both]
    if p.size == 0:
        return None
    pmin = np.full(La, Pa, dtype=np.int64)
    pmax = np.full(La, -1, dtype=np.int64)
    np.minimum.at(pmin, l, p)
    np.maximum.at(pmax, l, p)
    return int(np.max(np.where(pmax >= 0, pmax - pmin, 0)))


def plan_pose_order(
    pose_idx: np.ndarray,
    lm_idx: np.ndarray,
    Pa: int,
    La: int,
    band_limit: int = 48,
):
    """Decide a pose ordering: identity when the natural order is already
    banded, RCM when it rescues bandwidth, identity otherwise.

    Returns ``(perm | None, bw_before, bw_after)`` with ``perm[i]`` = old
    index at new position ``i``.
    """
    # every landmark's (min, max) observing pose is one of the pairs and
    # dominates that landmark's contribution, so this O(E) bound is the
    # bandwidth; the full pair enumeration runs only when reordering
    pi = np.asarray(pose_idx, dtype=np.int64)
    li = np.asarray(lm_idx, dtype=np.int64)
    bw0 = _band_bound(pi, li, Pa, La)
    if bw0 is None:
        return None, 0, 0
    if bw0 + 1 <= band_limit:
        return None, bw0, bw0
    keys = pose_pairs(pose_idx, lm_idx, Pa, La)
    if keys.size == 0:
        return None, bw0, bw0
    perm = rcm_order(keys, Pa)
    new_of_old = np.empty(Pa, dtype=np.int64)
    new_of_old[perm] = np.arange(Pa)
    a = new_of_old[keys // Pa]
    b = new_of_old[keys % Pa]
    bw1 = int(np.max(np.abs(a - b)))
    if bw1 >= bw0:
        return None, bw0, bw0
    return perm, bw0, bw1
