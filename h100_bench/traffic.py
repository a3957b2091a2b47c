"""The one traffic generator: the graph each solve of a closed loop brings.

A traffic mix is a data file, ``traffic/<mix>.json``, of parameters read
here.  One client waits for each answer before it sends the next graph.

* ``growth_span``: each solve brings the map as it stood at one point of
  its own growth, within the last ``growth_span`` of its landmarks by
  creation order (a mapping back end re-running global BA as its map grows:
  keyframes and points are added, never moved or relabelled).  The seed's
  graph is the whole sequence, and its landmark ids follow their creation
  (the generator sorts them by anchor pose), so the map at the creation of
  landmark ``m`` holds landmarks ``[0, m)``, the keyframes up to the
  newest one that had created a landmark by then, and the observations
  among them.  At 0 every solve re-sends the seed's whole graph unchanged.
* ``graphs``: how many such points, evenly spaced over the span (at most
  one a landmark).  Solve ``k`` takes point ``(offset + k * stride) mod
  graphs``, ``stride`` coprime with ``graphs`` near its golden section and
  ``offset`` drawn from the seed: every run brings the same set of graph
  sizes, in an order of its own, and any run of consecutive solves covers
  the span evenly.  No graph comes twice in ``graphs`` solves, so no
  structure cache can hit while a window has fewer solves than that.
"""

from __future__ import annotations

import math

import numpy as np

PARAMETERS = ("growth_span", "graphs")
GOLDEN = (math.sqrt(5.0) - 1.0) / 2.0


def _stride(n: int) -> int:
    s = max(1, round(GOLDEN * n))
    while math.gcd(s, n) != 1:
        s += 1
    return s


def edge_sets(problem) -> list:
    """A problem's edge sets as dicts (``kind``, ``meas``, ``pose_idx``,
    ``lm_idx``, ``omega`` and whatever else a set carries)."""
    if hasattr(problem, "specs"):
        return [dict(s) for s in problem.specs]
    return [dict(kind=problem.kind, meas=problem.meas, pose_idx=problem.pose_idx,
                 lm_idx=problem.lm_idx, omega=problem.omega)]


class Mix:
    """The graphs of one run: ``problem(k)`` is solve ``k``'s graph (``k =
    -1`` the warm-up's), ``graph_key(k)`` names the graph (solves with one
    key get the same graph)."""

    def __init__(self, base, params: dict, seed: int):
        unknown = set(params) - set(PARAMETERS) - {"why"}
        if unknown:
            raise ValueError(f"unknown traffic parameters {sorted(unknown)}")
        self.base = base
        span = float(params.get("growth_span", 0.0))
        if not 0.0 <= span < 1.0:
            raise ValueError(f"growth_span {span} is not in [0, 1)")
        L = int(base.landmarks.shape[0])
        self.n = 0 if span == 0 else max(1, min(int(params.get("graphs", 1)), round(span * L)))
        if not self.n:
            return
        if int(base.num_active_landmarks) != L:
            raise ValueError("a growing map needs every landmark free")
        self.stride = _stride(self.n)
        self.offset = int(np.random.default_rng([int(seed) % 2**64, 3]).integers(0, self.n))
        # the landmark counts of the points of growth, the whole map first
        self.sizes = L - np.round(np.arange(self.n) * (span * L / self.n)).astype(np.int64)
        P, Pa = int(base.pose_q.shape[0]), int(base.num_active_poses)
        self.sets = edge_sets(base)
        self.P, self.Pa, self.nf = P, Pa, P - Pa
        # each edge's pose in sequence order (the fixed poses, first in the
        # sequence, are packed last)
        self.seq = []
        first = np.full(L, P, dtype=np.int64)
        for s in self.sets:
            p = np.asarray(s["pose_idx"]).astype(np.int64)
            q = np.where(p < Pa, p + self.nf, p - Pa)
            self.seq.append(q)
            np.minimum.at(first, np.asarray(s["lm_idx"]), q)
        first[first == P] = 0  # a landmark no pose sees was there from the start
        # the newest keyframe of the map once landmark m - 1 exists
        self.newest = np.maximum.accumulate(first)

    def point(self, k: int) -> int:
        return (self.offset + k * self.stride) % self.n

    def graph_key(self, k: int) -> int:
        return 0 if not self.n else self.point(k) + 1

    def problem(self, k: int):
        if not self.n:
            return self.base
        return self.grown(int(self.sizes[self.point(k)]))

    def grown(self, m: int):
        """The map at the creation of landmark ``m - 1``."""
        p, nf, Pa = self.base, self.nf, self.Pa
        T = int(self.newest[m - 1])  # keyframes 0..T, in sequence order
        new_Pa = T + 1 - nf
        sets = []
        for s, seq in zip(self.sets, self.seq):
            li = np.asarray(s["lm_idx"])
            e = np.flatnonzero((li < m) & (seq <= T))
            pi = np.asarray(s["pose_idx"]).take(e)
            pi = np.where(pi < Pa, pi, pi - Pa + new_Pa).astype(pi.dtype)
            sets.append(dict(s, meas=np.asarray(s["meas"]).take(e, axis=0), pose_idx=pi,
                             lm_idx=li.take(e), omega=np.asarray(s["omega"]).take(e)))
        keep_poses = np.concatenate([np.arange(new_Pa), np.arange(Pa, Pa + nf)])
        vertices = dict(pose_q=p.pose_q.take(keep_poses, axis=0),
                        pose_t=p.pose_t.take(keep_poses, axis=0), num_active_poses=new_Pa,
                        landmarks=p.landmarks[:m], num_active_landmarks=m)
        if hasattr(p, "specs"):
            return p._replace(specs=tuple(sets), **vertices)
        (s,) = sets
        return p._replace(meas=s["meas"], pose_idx=s["pose_idx"], lm_idx=s["lm_idx"],
                          omega=s["omega"], **vertices)
