"""The ICP edge and edge-set classes (counterpart of ``models/icp.py``).

Only the user-facing classes: a line or plane graph can be built, and
packing it raises ``NotImplementedError`` naming ROADMAP A7, where the
point-to-line and point-to-plane models wait.
"""

from __future__ import annotations

from ..graph import BaseEdge, EdgeSet


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
