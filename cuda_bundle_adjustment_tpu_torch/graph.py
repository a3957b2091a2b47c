"""Graph model: vertices, edges, vertex sets and edge sets (counterpart of
``graph.py``).

The host-side container layer of the object-graph API, in numpy only.
Estimates live on the host; :meth:`.solver.block_solver.BlockSolver.initialize`
packs them into the solver's device tensors, and ``finalize`` writes the
optimised estimates back.

* :class:`PoseVertex` / :class:`LandmarkVertex` in :class:`PoseVertexSet` /
  :class:`LandmarkVertexSet`: active vertices get the indices
  ``0..active_size-1`` and fixed ones follow
  (:meth:`VertexSet.generate_estimate_data`); ``add_vertices_bulk`` adds
  vertices as arrays, without per-vertex objects.
* :class:`EdgeSet` holds the edges of one measurement model, as objects
  (``add_edge``) or arrays (``add_edges_bulk``), with the set's robust
  kernel, outlier threshold, information and camera.
* :class:`Camera` and :class:`GraphOptimisationOptions`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from .ops.robust import RobustKernelType

PDIM = 6  # pose block dimension (se3 twist)
LDIM = 3  # landmark block dimension


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

    ``per_edge_information``: each edge's own information is packed (omega
    ``[E]``, read by kernels B1 and B3); otherwise the edge set's global
    value.  ``per_edge_camera``: each edge that carries a camera is
    projected through it, the others (and bulk edges) through the edge
    set's camera (a ``[5, E]`` camera read by kernels B1 and B3, packed as
    one camera where all are equal); otherwise the edge set's camera is
    used.
    ``dtype``: ``"float64"`` or ``"float32"`` (f32 mode: state, edge data
    and every stage in f32; the kernels compute in f64 and round once).
    ``solver_precision``: ``"mixed"`` (at f64, an f32 factor of the reduced
    system and two f64 refinement rounds; in f32 the f32 factor and one
    solve) or ``"exact"`` (a factor in the working type, one solve: at f64
    the dense route).  An unknown string raises ``ValueError``.
    """

    per_edge_information: bool = False
    per_edge_camera: bool = False
    dtype: str = "float64"
    solver_precision: str = "mixed"


class Se3:
    """SE(3) element: quaternion ``q = [x, y, z, w]`` plus translation, the
    world->camera transform ``Xc = R(q) Xw + t``."""

    __slots__ = ("q", "t")

    def __init__(self, q, t):
        self.q = np.asarray(q, dtype=np.float64).reshape(4)
        self.t = np.asarray(t, dtype=np.float64).reshape(3)

    def __repr__(self):
        return f"Se3(q={self.q.tolist()}, t={self.t.tolist()})"


class BaseVertex:
    __slots__ = ("id", "fixed", "index")

    def __init__(self, vid: int, fixed: bool):
        self.id = int(vid)
        self.fixed = bool(fixed)
        self.index = -1  # global index, assigned at initialize()

    def is_fixed(self) -> bool:
        return self.fixed

    def set_fixed(self, fixed: bool) -> None:
        self.fixed = bool(fixed)


class PoseVertex(BaseVertex):
    """6-DoF SE3 camera pose vertex (not marginalised)."""

    __slots__ = ("estimate",)

    def __init__(self, vid: int, estimate: Se3, fixed: bool = False):
        super().__init__(vid, fixed)
        self.estimate = estimate

    def set_estimate(self, est: Se3) -> None:
        self.estimate = est

    def get_estimate(self) -> Se3:
        return self.estimate


class LandmarkVertex(BaseVertex):
    """3-DoF world-point vertex (marginalised in the Schur complement)."""

    __slots__ = ("estimate",)

    def __init__(self, vid: int, estimate, fixed: bool = False):
        super().__init__(vid, fixed)
        self.estimate = np.asarray(estimate, dtype=np.float64).reshape(3)

    def set_estimate(self, est) -> None:
        self.estimate = np.asarray(est, dtype=np.float64).reshape(3)

    def get_estimate(self) -> np.ndarray:
        return self.estimate


class VertexSet:
    """Ordered vertex container with active-first dense index assignment."""

    def __init__(self, marginilised: bool):
        self.marginilised = bool(marginilised)
        self._vertices: dict[int, BaseVertex] = {}
        self.active_size = 0
        self._ordered: list[BaseVertex] = []
        # bulk (array) vertices, without per-vertex objects: set by
        # add_vertices_bulk, None in an object-only set
        self._bulk_ids: Optional[np.ndarray] = None  # [Nb] int64
        self._bulk_fixed: Optional[np.ndarray] = None  # [Nb] bool
        self._bulk_index: Optional[np.ndarray] = None  # [Nb] per-set index
        self._bulk_gindex: Optional[np.ndarray] = None  # [Nb] global index
        self._gmap: Optional[np.ndarray] = None  # per-set -> global index
        self._n_oa = self._n_ba = self._n_of = self._n_bf = 0

    def add_vertex(self, vertex: BaseVertex) -> None:
        self._vertices[vertex.id] = vertex

    def get_vertex(self, vid: int) -> Optional[BaseVertex]:
        return self._vertices.get(vid)

    def remove_vertex(self, vertex: BaseVertex) -> bool:
        return self._vertices.pop(vertex.id, None) is not None

    def __len__(self) -> int:
        return self.total_size()

    def size(self) -> int:
        return self.total_size()

    def is_marginilised(self) -> bool:
        return self.marginilised

    def _add_bulk(self, ids, fixed) -> int:
        """Shared bulk bookkeeping; returns the bulk row count added."""
        ids = np.asarray(ids, dtype=np.int64).reshape(-1)
        if fixed is None:
            fixed = np.zeros(ids.size, dtype=bool)
        else:
            fixed = np.broadcast_to(np.asarray(fixed, dtype=bool), (ids.size,)).copy()
        if self._bulk_ids is None:
            self._bulk_ids, self._bulk_fixed = ids, fixed
        else:
            self._bulk_ids = np.concatenate([self._bulk_ids, ids])
            self._bulk_fixed = np.concatenate([self._bulk_fixed, fixed])
        return ids.size

    def total_size(self) -> int:
        nb = 0 if self._bulk_ids is None else self._bulk_ids.size
        return len(self._vertices) + nb

    def generate_estimate_data(self) -> list[BaseVertex]:
        """Assign per-set dense indices, active (non-fixed) first and fixed
        after: the per-set order is [object actives, bulk actives, object
        fixed, bulk fixed], so fixed vertices never receive solver
        increments.  ``BlockSolver.initialize`` maps these to global
        indices through :meth:`assign_global_indices`."""
        active = [v for v in self._vertices.values() if not v.fixed]
        fixed = [v for v in self._vertices.values() if v.fixed]
        self._n_oa, self._n_of = len(active), len(fixed)
        if self._bulk_ids is not None:
            bf = self._bulk_fixed
            self._n_ba = int((~bf).sum())
            self._n_bf = int(bf.sum())
            idx = np.empty(bf.size, dtype=np.int64)
            idx[~bf] = self._n_oa + np.arange(self._n_ba)
            idx[bf] = self._n_oa + self._n_ba + self._n_of + np.arange(self._n_bf)
            self._bulk_index = idx
        else:
            self._n_ba = self._n_bf = 0
            self._bulk_index = None
        for i, v in enumerate(active):
            v.index = i
        for i, v in enumerate(fixed):
            v.index = self._n_oa + self._n_ba + i
        self.active_size = self._n_oa + self._n_ba
        self._ordered = active + fixed
        return self._ordered

    def assign_global_indices(self, gmap: np.ndarray) -> None:
        """Map per-set indices to global ones (``gmap[set_idx] = global``);
        called once by ``BlockSolver.initialize`` after every set is sized."""
        for v in self._ordered:
            v.index = int(gmap[v.index])
        if self._bulk_index is not None:
            self._bulk_gindex = gmap[self._bulk_index]
        self._gmap = gmap

    def _set_positions_of_objects(self) -> np.ndarray:
        """Per-set positions of the object vertices in ``_ordered`` order."""
        pos = np.arange(len(self._ordered), dtype=np.int64)
        pos[self._n_oa :] += self._n_ba  # fixed objects sit past bulk actives
        return pos

    @property
    def ordered(self) -> list[BaseVertex]:
        return self._ordered

    def get_active_size(self) -> int:
        return self.active_size

    def _ids_and_global_indices(self) -> tuple[np.ndarray, np.ndarray]:
        """Every vertex id of the set (objects, then bulk) and its global
        index; valid after ``initialize()``."""
        n = len(self._vertices)
        ids = np.fromiter(self._vertices.keys(), dtype=np.int64, count=n)
        idx = np.fromiter((v.index for v in self._vertices.values()), dtype=np.int64, count=n)
        if self._bulk_ids is not None:
            gb = self._bulk_gindex if self._bulk_gindex is not None else self._bulk_index
            ids = np.concatenate([ids, self._bulk_ids])
            idx = np.concatenate([idx, gb])
        return ids, idx

    def index_of_ids(self, ids):
        """Vectorised vertex-id -> global-index lookup (bulk edge packing),
        over object and bulk vertices; valid after ``initialize()``."""
        return lookup_ids(*self._ids_and_global_indices(), ids)

    # camelCase aliases for users coming from the reference API
    addVertex = add_vertex
    getVertex = get_vertex
    removeVertex = remove_vertex
    isMarginilised = is_marginilised
    getActiveSize = get_active_size


def lookup_ids(all_ids: np.ndarray, all_idx: np.ndarray, ids) -> np.ndarray:
    """``all_idx`` at the position of each of ``ids`` in ``all_ids`` (unique
    vertex ids): one sort and one binary search.  An id not in ``all_ids``
    raises ``KeyError``."""
    ids = np.asarray(ids, dtype=np.int64)
    order = np.argsort(all_ids)
    sorted_ids = all_ids[order]
    n = sorted_ids.size
    pos = np.searchsorted(sorted_ids, ids)
    if np.any(pos >= n) or np.any(sorted_ids[np.minimum(pos, n - 1)] != ids):
        raise KeyError("edge references a vertex id not in the set")
    return all_idx[order][pos]


class PoseVertexSet(VertexSet):
    def __init__(self, marginilised: bool = False):
        super().__init__(marginilised)
        self._bulk_q: Optional[np.ndarray] = None
        self._bulk_t: Optional[np.ndarray] = None

    def add_vertices_bulk(self, ids, q, t, fixed=None) -> None:
        """Bulk-append pose vertices as arrays (no per-vertex objects):
        ``ids [N]``, ``q [N, 4]`` (xyzw), ``t [N, 3]``, ``fixed [N]`` bool
        (or scalar; default all free).  Mixes with :meth:`add_vertex`."""
        n = self._add_bulk(ids, fixed)
        q = np.asarray(q, dtype=np.float64).reshape(n, 4)
        t = np.asarray(t, dtype=np.float64).reshape(n, 3)
        if self._bulk_q is None:
            self._bulk_q, self._bulk_t = q.copy(), t.copy()
        else:
            self._bulk_q = np.concatenate([self._bulk_q, q])
            self._bulk_t = np.concatenate([self._bulk_t, t])

    def estimates_array(self) -> tuple[np.ndarray, np.ndarray]:
        """Pack estimates into per-set order ``(q [P, 4], t [P, 3])``."""
        P = self.total_size()
        q = np.empty((P, 4), dtype=np.float64)
        t = np.empty((P, 3), dtype=np.float64)
        pos = self._set_positions_of_objects()
        for i, v in enumerate(self._ordered):
            q[pos[i]] = v.estimate.q
            t[pos[i]] = v.estimate.t
        if self._bulk_index is not None:
            q[self._bulk_index] = self._bulk_q
            t[self._bulk_index] = self._bulk_t
        return q, t

    def write_back(self, q: np.ndarray, t: np.ndarray) -> None:
        """Write estimates back from global-indexed arrays."""
        for v in self._ordered:
            v.estimate = Se3(q[v.index], t[v.index])
        if self._bulk_gindex is not None:
            self._bulk_q = np.asarray(q)[self._bulk_gindex].copy()
            self._bulk_t = np.asarray(t)[self._bulk_gindex].copy()

    def bulk_estimates(self) -> tuple[np.ndarray, np.ndarray]:
        """``(q, t)`` of the bulk vertices in input order (the optimised
        values after ``finalize``)."""
        return self._bulk_q, self._bulk_t


class LandmarkVertexSet(VertexSet):
    def __init__(self, marginilised: bool = True):
        super().__init__(marginilised)
        self._bulk_X: Optional[np.ndarray] = None

    def add_vertices_bulk(self, ids, estimates, fixed=None) -> None:
        """Bulk-append landmark vertices as arrays: ``ids [N]``,
        ``estimates [N, 3]``, ``fixed [N]`` bool (or scalar)."""
        n = self._add_bulk(ids, fixed)
        X = np.asarray(estimates, dtype=np.float64).reshape(n, 3)
        self._bulk_X = X.copy() if self._bulk_X is None else np.concatenate([self._bulk_X, X])

    def estimates_array(self) -> np.ndarray:
        L = self.total_size()
        Xw = np.empty((L, 3), dtype=np.float64)
        pos = self._set_positions_of_objects()
        for i, v in enumerate(self._ordered):
            Xw[pos[i]] = v.estimate
        if self._bulk_index is not None:
            Xw[self._bulk_index] = self._bulk_X
        return Xw

    def write_back(self, Xw: np.ndarray) -> None:
        """Write estimates back from the global-indexed array."""
        for v in self._ordered:
            v.estimate = Xw[v.index].copy()
        if self._bulk_gindex is not None:
            self._bulk_X = np.asarray(Xw)[self._bulk_gindex].copy()

    def bulk_estimates(self) -> np.ndarray:
        return self._bulk_X


class BaseEdge:
    """An edge connecting one or two vertices with a measurement;
    ``information`` is a scalar omega."""

    __slots__ = ("vertices", "measurement", "information", "camera", "is_active")
    NVERTS = 2

    def __init__(self):
        self.vertices: list[Optional[BaseVertex]] = [None] * self.NVERTS
        self.measurement = None
        self.information = 0.0
        self.camera: Optional[Camera] = None
        self.is_active = True

    def set_vertex(self, vertex: BaseVertex, index: int) -> None:
        self.vertices[index] = vertex

    def get_vertex(self, index: int) -> Optional[BaseVertex]:
        return self.vertices[index]

    def set_measurement(self, m) -> None:
        self.measurement = m

    def set_information(self, info: float) -> None:
        self.information = float(info)

    def set_camera(self, camera: Camera) -> None:
        self.camera = camera

    def inactivate(self) -> None:
        self.is_active = False

    def set_active(self) -> None:
        self.is_active = True

    def all_vertices_fixed(self) -> bool:
        return all(v is not None and v.fixed for v in self.vertices)

    def all_vertices_not_fixed(self) -> bool:
        return all(v is not None and not v.fixed for v in self.vertices)

    # camelCase aliases
    setVertex = set_vertex
    getVertex = get_vertex
    setMeasurement = set_measurement
    setInformation = set_information
    setCamera = set_camera


class EdgeSet:
    """Homogeneous container of edges of one measurement model.

    Concrete subclasses live in :mod:`.models.ba` / :mod:`.models.icp` and
    define ``KIND`` (the model the solver runs), ``MDIM`` and ``NVERTS``.
    """

    KIND = "base"
    MDIM = 0
    NVERTS = 2

    def __init__(self):
        self.edges: list[BaseEdge] = []
        self.robust_kernel_type = RobustKernelType.NONE
        self.robust_delta = 1.0
        self.outlier_threshold = 0.0
        self.information = 0.0
        self.camera = Camera()
        self._outlier_count = 0
        self._active_edge_size = 0
        self.is_dirty = True
        # add_edges_bulk's arrays, without per-edge objects:
        # dict(meas, pose_id, lm_id, info, active), or None
        self._bulk = None

    def add_edge(self, edge: BaseEdge) -> None:
        self.edges.append(edge)

    def add_edges_bulk(self, measurements, pose_ids, landmark_ids=None, information=None) -> None:
        """Bulk-append edges as arrays (no per-edge Python objects).

        ``measurements [E, MDIM]``, ``pose_ids [E]`` (vertex ids of the pose
        sets), ``landmark_ids [E]`` (ids of the landmark sets; omit for
        pose-only models), ``information [E]`` (optional; used under
        ``per_edge_information``, the edge set's global value otherwise).
        Mixes with ``add_edge``.
        """
        meas = np.asarray(measurements, dtype=np.float64)
        E = meas.shape[0]
        pose_ids = np.asarray(pose_ids, dtype=np.int64)
        lm_ids = (
            np.zeros(E, dtype=np.int64)
            if landmark_ids is None
            else np.asarray(landmark_ids, dtype=np.int64)
        )
        info = None if information is None else np.asarray(information, dtype=np.float64)
        new = dict(
            meas=meas, pose_id=pose_ids, lm_id=lm_ids, info=info, active=np.ones(E, dtype=bool),
        )
        if self._bulk is None:
            self._bulk = new
            return
        b = self._bulk
        if (b["info"] is None) != (info is None):
            # rows without information take the edge set's global value at
            # packing (a NaN here), so a later set_information() reaches
            # them as it reaches the object edges
            def nans(n):
                return np.full(n, np.nan, dtype=np.float64)

            b["info"] = nans(b["meas"].shape[0]) if b["info"] is None else b["info"]
            new["info"] = info if info is not None else nans(E)
        self._bulk = {k: None if b[k] is None else np.concatenate([b[k], new[k]]) for k in b}

    def remove_edge(self, edge: BaseEdge) -> None:
        self.edges.remove(edge)

    def nedges(self) -> int:
        nb = 0 if self._bulk is None else self._bulk["meas"].shape[0]
        return len(self.edges) + nb

    def nactive_edges(self) -> int:
        return self._active_edge_size

    def set_robust_kernel(self, kind: RobustKernelType, delta: float) -> None:
        self.robust_kernel_type = RobustKernelType(kind)
        self.robust_delta = float(delta)

    def set_outlier_threshold(self, threshold: float) -> None:
        self.outlier_threshold = float(threshold)

    def set_information(self, info: float) -> None:
        self.information = float(info)

    def set_camera(self, camera: Camera) -> None:
        self.camera = camera

    def get_outlier_count(self) -> int:
        return self._outlier_count

    def get_inlier_count(self) -> int:
        return self._active_edge_size - self._outlier_count

    # camelCase aliases
    addEdge = add_edge
    removeEdge = remove_edge
    setRobustKernel = set_robust_kernel
    setOutlierThreshold = set_outlier_threshold
    setInformation = set_information
    setCamera = set_camera
    getOutlierCount = get_outlier_count
    getInlierCount = get_inlier_count
