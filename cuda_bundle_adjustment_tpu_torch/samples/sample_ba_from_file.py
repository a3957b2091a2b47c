"""Bundle adjustment of a graph file or a synthetic graph through the object
API, on the CUDA card unless another device is asked for.

Loads a BA graph (OpenCV JSON FileStorage layout, ``io/opencv_json.py``)
into vertex and edge objects, or builds a named synthetic graph with the
bulk constructors, runs one warm-up, then times ``initialize();
optimize(N)`` and prints the chi2 of each iteration and the nine-stage time
profile (the profile mode runs the host loop, which reads each stage's time).

Usage:
    python -m cuda_bundle_adjustment_tpu_torch.samples.sample_ba_from_file GRAPH.json [N]
    python -m cuda_bundle_adjustment_tpu_torch.samples.sample_ba_from_file --synthetic kitti00 [N]
    (add --device cpu to run the plain twins on the CPU)
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .. import (
    Camera,
    GraphOptimisationOptions,
    LandmarkVertexSet,
    MonoEdgeSet,
    PoseVertexSet,
    StereoEdgeSet,
    TorchGraphOptimisation,
)
from ..io import opencv_json, synthetic


def bulk_graph(problem):
    """``(pose_set, landmark_set, [edge_set])`` of a one-edge-list
    :class:`~..io.synthetic.BAProblem`, built with the bulk constructors
    (vertex ids: poses ``0..P-1``, landmarks ``P..P+L-1``)."""
    P, L = problem.pose_q.shape[0], problem.landmarks.shape[0]
    poses, landmarks = PoseVertexSet(), LandmarkVertexSet()
    poses.add_vertices_bulk(np.arange(P), problem.pose_q, problem.pose_t,
                            np.arange(P) >= problem.num_active_poses)
    landmarks.add_vertices_bulk(P + np.arange(L), problem.landmarks,
                                np.arange(L) >= problem.num_active_landmarks)
    edges = MonoEdgeSet() if problem.kind == "mono" else StereoEdgeSet()
    edges.set_camera(Camera(*np.asarray(problem.cam, dtype=np.float64).tolist()))
    edges.set_information(1.0)
    edges.add_edges_bulk(problem.meas, problem.pose_idx, P + np.asarray(problem.lm_idx),
                         information=problem.omega)
    return poses, landmarks, [edges]


# each edge's own information, as a graph file gives it
OPTIONS = GraphOptimisationOptions(per_edge_information=True)


def graph_source(path: str = None, synthetic_name: str = None):
    """A function making a fresh ``(pose_set, landmark_set, edge_sets)`` for
    each run: a graph file through ``read_graph``, or a synthetic
    KITTI-scale mono graph through the bulk constructors."""
    if synthetic_name is not None:
        maker = {"kitti00": synthetic.kitti00_scale_problem,
                 "kitti07": synthetic.kitti07_scale_problem}[synthetic_name]
        problem = maker(kind="mono", seed=0)
        return lambda: bulk_graph(problem)
    return lambda: opencv_json.read_graph(path)[:3]


def optimizer(make, device) -> TorchGraphOptimisation:
    """An optimiser on ``device`` holding a fresh graph from ``make``."""
    poses, landmarks, edge_sets = make()
    opt = TorchGraphOptimisation.create(OPTIONS, device=device)
    opt.add_vertex_set(poses)
    opt.add_vertex_set(landmarks)
    for es in edge_sets:
        opt.add_edge_set(es)
    return opt


def synchronize(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(usage=__doc__.split("Usage:")[1])
    ap.add_argument("graph", nargs="?", help="graph file (OpenCV JSON)")
    ap.add_argument("niterations", nargs="?", type=int, default=10)
    ap.add_argument("--synthetic", choices=("kitti00", "kitti07"))
    ap.add_argument("--device", default="cuda", help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    if args.synthetic is not None and args.graph is not None:
        # "--synthetic kitti00 5": the count comes in the graph's place
        args.niterations, args.graph = int(args.graph), None
    if args.graph is None and args.synthetic is None:
        ap.error("a graph file or --synthetic is needed")
    make = graph_source(args.graph, args.synthetic)
    niter = args.niterations

    # warm-up: builds the kernels, fills the structure cache
    opt = optimizer(make, args.device)
    opt.set_profile(True)
    opt.initialize()
    opt.optimize(niter)

    opt = optimizer(make, args.device)
    opt.set_profile(True)
    synchronize(args.device)
    t0 = time.perf_counter()
    opt.initialize()
    opt.optimize(niter)
    synchronize(args.device)
    elapsed = time.perf_counter() - t0
    trace = [s.chi2 for s in opt.batch_statistics().get()]

    print(f"=== Bundle Adjustment on {opt.device}: {niter} iterations ===\n")
    print(f"num poses      : {opt.solver.P}")
    print(f"num landmarks  : {opt.solver.L}")
    print(f"num edges      : {opt.solver.nedges()}")
    print(f"total time     : {elapsed:.3f}[sec]\n")
    print("chi2 per iteration:")
    for i, c in enumerate(trace, 1):
        print(f"iter= {i:2d}   chi2= {c:.1f}")
    print("\ntime profile:")
    for name, ms in opt.time_profile().items():
        print(f"{name:28s}: {ms:9.2f}[msec]")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
