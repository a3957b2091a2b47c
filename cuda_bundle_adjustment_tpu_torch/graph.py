"""Runtime options and camera intrinsics (counterpart of ``graph.py``).

Only the two value types the array path reads are ported; the object API
(vertices, edges, vertex and edge sets) waits for ROADMAP A5.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Camera:
    """Pinhole intrinsics; ``bf`` is the stereo baseline times fx."""

    fx: float = 0.0
    fy: float = 0.0
    cx: float = 0.0
    cy: float = 0.0
    bf: float = 0.0

    def to_vec(self) -> np.ndarray:
        return np.array([self.fx, self.fy, self.cx, self.cy, self.bf], dtype=np.float64)


@dataclasses.dataclass
class GraphOptimisationOptions:
    """Runtime options (same fields and defaults as the JAX package).

    ``dtype``: ``"float64"`` or ``"float32"`` (f32 mode: state, edge data
    and every stage in f32; the kernels compute in f64 and round once).
    ``solver_precision``: ``"mixed"`` (at f64, an f32 factor of the reduced
    system and two f64 refinement rounds; in f32 the f32 factor and one
    solve) or ``"exact"`` (a factor in the working type, one solve: at f64
    the dense route).  An unknown string raises ``ValueError``.  The slice
    takes global information and camera per edge set; per-edge values raise
    ``NotImplementedError``.
    """

    per_edge_information: bool = False
    per_edge_camera: bool = False
    dtype: str = "float64"
    solver_precision: str = "mixed"
