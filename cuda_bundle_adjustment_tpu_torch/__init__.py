"""PyTorch + CUDA port of the bundle-adjustment engine (NVIDIA Hopper).

The JAX package ``cuda_bundle_adjustment_tpu`` is the reference; this
package mirrors its module and function names so each counterpart is easy to
find, but imports ``torch`` and never ``jax``.

The port takes a graph as vertex and edge sets (objects, or arrays through
the bulk constructors), as a graph file (``io.opencv_json``) or as raw
arrays (``io.arrays.optimizer_from_problem``), and runs it through one
packed path: mono, stereo and depth edge sets, packed as one landmark pack
(a mono and a stereo set under one robust kernel merged into one masked
stereo set first; sets that do not merge keep their own kind, robust kernel
and outlier threshold), beside point-to-line and point-to-plane ICP sets;
one camera an edge set or a camera an edge, global or per-edge information,
a robust kernel or none, f64 or f32 state
(``GraphOptimisationOptions(dtype=...)``), ``solver_precision="mixed"`` or
``"exact"``, through the device-resident LM loop.  The reduced system is
solved on a band (Hsc band up to 48 blocks), densely (``"exact"`` at f64,
and wider bands below 1024 poses) or by PCG, and without free landmarks by
the pose-only solve.  Ten kernels on that path are hand-written CUDA C++ for
``sm_90a`` (``csrc/``, listed in ``kernels``); every other stage is plain
PyTorch.

Quick start::

    import cuda_bundle_adjustment_tpu_torch as tba

    poses = tba.PoseVertexSet()
    landmarks = tba.LandmarkVertexSet()
    poses.add_vertex(tba.PoseVertex(0, tba.Se3(q0, t0), fixed=True))
    landmarks.add_vertex(tba.LandmarkVertex(100, Xw))
    ...
    edges = tba.MonoEdgeSet()
    edges.set_information(1.0)
    edges.set_camera(tba.Camera(fx, fy, cx, cy, bf))
    e = tba.MonoEdge()
    e.set_vertex(poses.get_vertex(0), 0)
    e.set_vertex(landmarks.get_vertex(100), 1)
    e.set_measurement([u, v])
    edges.add_edge(e)
    ...
    opt = tba.TorchGraphOptimisation.create(device="cuda")
    opt.add_vertex_set(poses)
    opt.add_vertex_set(landmarks)
    opt.add_edge_set(edges)
    opt.initialize()
    opt.optimize(10)
    trace = [s.chi2 for s in opt.batch_statistics().get()]
    estimate = poses.get_vertex(1).get_estimate()  # written back

Vertices and edges can also be added as arrays:
``PoseVertexSet.add_vertices_bulk``, ``LandmarkVertexSet.add_vertices_bulk``
and ``EdgeSet.add_edges_bulk``.
"""

import torch

# f32 products must stay IEEE f32 (the mixed solve's refinement assumes it)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from .graph import (  # noqa: E402
    Camera,
    GraphOptimisationOptions,
    LandmarkVertex,
    LandmarkVertexSet,
    PoseVertex,
    PoseVertexSet,
    Se3,
)
from .models import (  # noqa: E402
    DepthEdge,
    DepthEdgeSet,
    LineEdge,
    LineEdgeSet,
    MonoEdge,
    MonoEdgeSet,
    PlaneEdge,
    PlaneEdgeSet,
    PointToLineMatch,
    PointToPlaneMatch,
    StereoEdge,
    StereoEdgeSet,
)
from .ops.robust import RobustKernelType  # noqa: E402
from .optimizer import TorchGraphOptimisation, TorchGraphOptimisationImpl  # noqa: E402

__version__ = "0.1.0"

__all__ = [
    "Camera",
    "GraphOptimisationOptions",
    "Se3",
    "PoseVertex",
    "LandmarkVertex",
    "PoseVertexSet",
    "LandmarkVertexSet",
    "MonoEdge",
    "MonoEdgeSet",
    "StereoEdge",
    "StereoEdgeSet",
    "DepthEdge",
    "DepthEdgeSet",
    "LineEdge",
    "LineEdgeSet",
    "PlaneEdge",
    "PlaneEdgeSet",
    "PointToLineMatch",
    "PointToPlaneMatch",
    "RobustKernelType",
    "TorchGraphOptimisation",
    "TorchGraphOptimisationImpl",
]
