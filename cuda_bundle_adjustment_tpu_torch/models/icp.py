"""Pose-only ICP measurement models: point-to-line and point-to-plane edges
(counterpart of ``models/icp.py``).

Component-form, as ``models/ba.py``, and in plain torch on every device: the
JAX package runs these models in XLA outside any Pallas kernel, so they are
not the twin of a kernel.  Two quirks of the reference implementation are
kept because they are observable behaviour, as the JAX package keeps them:

* the line chi accumulates the *raw* residual, not ``omega * e^2``;
* neither quadratic form applies the robust kernel's derivative, only omega.

The Jacobians are the JAX package's (the mathematically correct ones in the
``[omega, upsilon]`` order), not the reference's.

Measurement payload layout (component-first ``[K, E]``):

* line:  ``[ax ay az bx by bz length px py pz]`` (10 rows)
* plane: ``[nx ny nz d px py pz]`` (7 rows)
"""

from __future__ import annotations

import torch

from ..graph import BaseEdge, EdgeSet
from ..ops import components as C
from ..types import GraphArrays, PackedEdges


def _pose_comps(graph: GraphArrays, data: PackedEdges):
    """Per-edge rotation components and translation of the edge's pose."""
    qT, tT, pi = graph.q.T, graph.t.T, data.pose_idx
    q = tuple(qT[i][pi] for i in range(4))
    t = tuple(tT[i][pi] for i in range(3))
    return C.rotmat_comps(*q), t


def _cross(ax, ay, az, bx, by, bz):
    return ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx


def _pose_stack(jp, e, data: PackedEdges) -> torch.Tensor:
    """``[E, 42]``: ``w J^T J | w J^T e`` of a one-row residual."""
    pose_stack, _, _ = C.weighted_block_stacks((jp,), None, (e,), data.omega * data.active)
    return pose_stack


class LineModel:
    MDIM = 1
    HAS_LANDMARK = False

    @staticmethod
    def _residual_and_grad(graph, data):
        m = data.meas
        a, b, length, p = (m[0], m[1], m[2]), (m[3], m[4], m[5]), m[6], (m[7], m[8], m[9])
        R, t = _pose_comps(graph, data)
        Pw = C.project_w2c_comps(R, t[0], t[1], t[2], p[0], p[1], p[2])
        ux, uy, uz = Pw[0] - a[0], Pw[1] - a[1], Pw[2] - a[2]
        vx, vy, vz = Pw[0] - b[0], Pw[1] - b[1], Pw[2] - b[2]
        cx, cy, cz = _cross(ux, uy, uz, vx, vy, vz)
        cn = torch.sqrt(cx * cx + cy * cy + cz * cz)
        e = cn / length
        # de/dPw = ((a - b) x c/|c|) / L
        inv_cn = 1.0 / torch.clamp(cn, min=1e-12)
        abx, aby, abz = a[0] - b[0], a[1] - b[1], a[2] - b[2]
        gx, gy, gz = _cross(abx, aby, abz, cx * inv_cn, cy * inv_cn, cz * inv_cn)
        return e, Pw, (gx / length, gy / length, gz / length)

    @staticmethod
    def chi(graph, data, rk, delta):
        e, _, _ = LineModel._residual_and_grad(graph, data)
        # reference quirk: chi accumulates the raw distance
        return e * data.active

    @staticmethod
    def terms(graph, data, rk, delta):
        e, Pw, g = LineModel._residual_and_grad(graph, data)
        # J = de/dxi = [Pw x g, g]; negated for the g2o convention
        jw = _cross(Pw[0], Pw[1], Pw[2], g[0], g[1], g[2])
        jp = tuple(-c for c in (*jw, *g))
        return _pose_stack(jp, e, data), None, None


class PlaneModel:
    MDIM = 1
    HAS_LANDMARK = False

    @staticmethod
    def _residual_and_grad(graph, data):
        m = data.meas
        n, d, p = (m[0], m[1], m[2]), m[3], (m[4], m[5], m[6])
        R, t = _pose_comps(graph, data)
        Pw = C.project_w2c_comps(R, t[0], t[1], t[2], p[0], p[1], p[2])
        e = n[0] * Pw[0] + n[1] * Pw[1] + n[2] * Pw[2] - d
        return e, Pw, n

    @staticmethod
    def chi(graph, data, rk, delta):
        e, _, _ = PlaneModel._residual_and_grad(graph, data)
        return data.omega * e * e * data.active

    @staticmethod
    def terms(graph, data, rk, delta):
        e, Pw, n = PlaneModel._residual_and_grad(graph, data)
        # J = [Pw x n, n]; negated for the g2o convention
        jw = _cross(Pw[0], Pw[1], Pw[2], n[0], n[1], n[2])
        jp = tuple(-c for c in (*jw, *n))
        return _pose_stack(jp, e, data), None, None


class LineEdge(BaseEdge):
    """Point-to-line ICP edge; measurement is a :class:`PointToLineMatch`."""

    NVERTS = 1


class PlaneEdge(BaseEdge):
    """Point-to-plane ICP edge; measurement is a :class:`PointToPlaneMatch`."""

    NVERTS = 1


class LineEdgeSet(EdgeSet):
    KIND = "line"
    MDIM = 1
    NVERTS = 1


class PlaneEdgeSet(EdgeSet):
    KIND = "plane"
    MDIM = 1
    NVERTS = 1
