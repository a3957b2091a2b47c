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

    The slice accepts ``dtype="float64"`` with ``solver_precision="mixed"``
    (f32 band factor + f64 iterative refinement) and global information and
    camera per edge set; other values raise ``NotImplementedError``.
    """

    per_edge_information: bool = False
    per_edge_camera: bool = False
    dtype: str = "float64"
    solver_precision: str = "mixed"
