"""Measurement structs of the ICP edge types (counterpart of
``models/measurements.py``).

Plain host-side dataclasses; a line or plane edge carries one as its
measurement, flattened by :meth:`to_vec` when the edge set is packed.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class PointToLineMatch:
    """A 3D point matched to the line through ``a``-``b``.

    ``length`` is ``|a - b|`` (computed when left 0).  ``point`` is the
    source point in the pose's local frame.
    """

    a: np.ndarray
    b: np.ndarray
    point: np.ndarray
    length: float = 0.0

    def __post_init__(self):
        self.a = np.asarray(self.a, dtype=np.float64).reshape(3)
        self.b = np.asarray(self.b, dtype=np.float64).reshape(3)
        self.point = np.asarray(self.point, dtype=np.float64).reshape(3)
        if self.length == 0.0:
            self.length = float(np.linalg.norm(self.a - self.b))

    def to_vec(self) -> np.ndarray:
        """Flatten to ``[a(3), b(3), length(1), point(3)]`` (10 scalars)."""
        return np.concatenate([self.a, self.b, [self.length], self.point])


@dataclasses.dataclass
class PointToPlaneMatch:
    """A 3D point matched to a plane ``n . x = d`` (unit normal)."""

    normal: np.ndarray
    origin_distance: float
    point: np.ndarray

    def __post_init__(self):
        self.normal = np.asarray(self.normal, dtype=np.float64).reshape(3)
        self.point = np.asarray(self.point, dtype=np.float64).reshape(3)
        self.origin_distance = float(self.origin_distance)

    def to_vec(self) -> np.ndarray:
        """Flatten to ``[normal(3), d(1), point(3)]`` (7 scalars)."""
        return np.concatenate([self.normal, [self.origin_distance], self.point])
