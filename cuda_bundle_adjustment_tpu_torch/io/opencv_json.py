"""Reader and writer of BA graph files in OpenCV's JSON FileStorage layout
(counterpart of ``io/opencv_json.py``).

The layout is plain JSON: top-level keys ``pose_vertices`` (id, fixed,
q=[x,y,z,w], t=[3]), ``landmark_vertices`` (id, fixed, Xw=[3]), the camera
intrinsics ``fx fy cx cy bf``, and the edge lists ``monocular_edges`` /
``stereo_edges`` (vertexP, vertexL, measurement, information); a leading
``//`` comment line is skipped.

``read_graph`` returns vertex and edge sets ready for the object API;
``read_problem`` returns a :class:`~.synthetic.BAProblem` (one edge list) or
:class:`~.synthetic.MixedBAProblem` for ``io.arrays.optimizer_from_problem``;
``write_graph`` writes a problem.
"""

from __future__ import annotations

import json
from typing import Optional

import numpy as np

from ..graph import Camera, LandmarkVertex, LandmarkVertexSet, PoseVertex, PoseVertexSet, Se3
from ..models import MonoEdge, MonoEdgeSet, StereoEdge, StereoEdgeSet
from .synthetic import BAProblem, MixedBAProblem


def _strip_comments(text: str) -> str:
    # OpenCV's FileStorage JSON may carry a leading comment line
    lines = [l for l in text.splitlines() if not l.lstrip().startswith("//")]
    return "\n".join(lines)


def read_graph(path: str):
    """Load a BA graph file into (pose_set, landmark_set, [edge_sets], camera)."""
    with open(path) as f:
        doc = json.loads(_strip_comments(f.read()))

    poses = PoseVertexSet()
    for node in doc.get("pose_vertices", []):
        q = np.asarray(node["q"], dtype=np.float64)
        t = np.asarray(node["t"], dtype=np.float64)
        poses.add_vertex(PoseVertex(int(node["id"]), Se3(q, t), bool(node.get("fixed", 0))))

    landmarks = LandmarkVertexSet()
    for node in doc.get("landmark_vertices", []):
        landmarks.add_vertex(
            LandmarkVertex(
                int(node["id"]),
                np.asarray(node["Xw"], dtype=np.float64),
                bool(node.get("fixed", 0)),
            )
        )

    camera = Camera(
        fx=float(doc.get("fx", 0.0)),
        fy=float(doc.get("fy", 0.0)),
        cx=float(doc.get("cx", 0.0)),
        cy=float(doc.get("cy", 0.0)),
        bf=float(doc.get("bf", 0.0)),
    )

    edge_sets = []
    mono_nodes = doc.get("monocular_edges", [])
    if mono_nodes:
        mono = MonoEdgeSet()
        mono.set_camera(camera)
        for node in mono_nodes:
            e = MonoEdge()
            e.set_vertex(poses.get_vertex(int(node["vertexP"])), 0)
            e.set_vertex(landmarks.get_vertex(int(node["vertexL"])), 1)
            e.set_measurement(np.asarray(node["measurement"], dtype=np.float64))
            e.set_information(float(node.get("information", 1.0)))
            e.set_camera(camera)
            mono.add_edge(e)
        edge_sets.append(mono)

    stereo_nodes = doc.get("stereo_edges", [])
    if stereo_nodes:
        stereo = StereoEdgeSet()
        stereo.set_camera(camera)
        for node in stereo_nodes:
            e = StereoEdge()
            e.set_vertex(poses.get_vertex(int(node["vertexP"])), 0)
            e.set_vertex(landmarks.get_vertex(int(node["vertexL"])), 1)
            e.set_measurement(np.asarray(node["measurement"], dtype=np.float64))
            e.set_information(float(node.get("information", 1.0)))
            e.set_camera(camera)
            stereo.add_edge(e)
        edge_sets.append(stereo)

    return poses, landmarks, edge_sets, camera


def write_graph(
    path: str,
    problem: Optional[BAProblem] = None,
    pose_set: Optional[PoseVertexSet] = None,
    landmark_set: Optional[LandmarkVertexSet] = None,
    edge_sets=None,
) -> None:
    """Write a BA graph file from a :class:`BAProblem` (one edge list) or a
    :class:`MixedBAProblem` (a mono and a stereo list, as KITTI graph files
    carry).  An object graph is not written: passing sets instead of a
    problem raises ``NotImplementedError``."""
    doc: dict = {}
    if problem is not None:
        doc["pose_vertices"] = [
            dict(
                id=i,
                fixed=int(i >= problem.num_active_poses),
                q=problem.pose_q[i].tolist(),
                t=problem.pose_t[i].tolist(),
            )
            for i in range(problem.pose_q.shape[0])
        ]
        doc["landmark_vertices"] = [
            dict(
                id=j,
                fixed=int(j >= problem.num_active_landmarks),
                Xw=problem.landmarks[j].tolist(),
            )
            for j in range(problem.landmarks.shape[0])
        ]
        cam = problem.cam if problem.cam.ndim == 1 else problem.cam[0]
        doc["fx"], doc["fy"], doc["cx"], doc["cy"], doc["bf"] = [
            float(v) for v in cam
        ]
        if isinstance(problem, MixedBAProblem):
            specs = problem.specs
        else:
            specs = (
                dict(
                    kind=problem.kind,
                    meas=problem.meas,
                    pose_idx=problem.pose_idx,
                    lm_idx=problem.lm_idx,
                    omega=problem.omega,
                ),
            )
        for s in specs:
            key = "monocular_edges" if s["kind"] == "mono" else "stereo_edges"
            meas = np.asarray(s["meas"])
            doc[key] = [
                dict(
                    vertexP=int(s["pose_idx"][e]),
                    vertexL=int(s["lm_idx"][e]),
                    measurement=meas[e].tolist(),
                    information=float(s["omega"][e]),
                )
                for e in range(meas.shape[0])
            ]
    else:
        raise NotImplementedError("object-graph writing: pass a BAProblem")

    with open(path, "w") as f:
        json.dump(doc, f)


def read_problem(path: str, kind: Optional[str] = None):
    """Load a graph file directly into arrays (active-first layout).

    Returns a :class:`~.synthetic.BAProblem` when the file carries one edge
    list (or ``kind`` selects one), and a :class:`~.synthetic.MixedBAProblem`
    with every edge list present otherwise: KITTI graph files carry both a
    mono and a stereo list, and nothing may be dropped.
    """
    with open(path) as f:
        doc = json.loads(_strip_comments(f.read()))

    pv = doc.get("pose_vertices", [])
    lv = doc.get("landmark_vertices", [])
    # active-first permutation for poses and landmarks
    p_act = [n for n in pv if not n.get("fixed", 0)]
    p_fix = [n for n in pv if n.get("fixed", 0)]
    l_act = [n for n in lv if not n.get("fixed", 0)]
    l_fix = [n for n in lv if n.get("fixed", 0)]
    pose_order = p_act + p_fix
    lm_order = l_act + l_fix
    pose_index = {int(n["id"]): i for i, n in enumerate(pose_order)}
    lm_index = {int(n["id"]): i for i, n in enumerate(lm_order)}

    pose_q = np.array([n["q"] for n in pose_order], dtype=np.float64)
    pose_t = np.array([n["t"] for n in pose_order], dtype=np.float64)
    landmarks = np.array([n["Xw"] for n in lm_order], dtype=np.float64)

    cam = np.array(
        [doc.get(k, 0.0) for k in ("fx", "fy", "cx", "cy", "bf")], dtype=np.float64
    )

    def _spec(k: str, nodes) -> dict:
        return dict(
            kind=k,
            meas=np.array([n["measurement"] for n in nodes], dtype=np.float64),
            pose_idx=np.array(
                [pose_index[int(n["vertexP"])] for n in nodes], dtype=np.int32
            ),
            lm_idx=np.array(
                [lm_index[int(n["vertexL"])] for n in nodes], dtype=np.int32
            ),
            omega=np.array(
                [n.get("information", 1.0) for n in nodes], dtype=np.float64
            ),
            cam=cam,
        )

    lists = {
        "mono": doc.get("monocular_edges", []),
        "stereo": doc.get("stereo_edges", []),
    }
    present = [k for k, v in lists.items() if v]
    if kind is None and len(present) > 1:
        return MixedBAProblem(
            pose_q=pose_q,
            pose_t=pose_t,
            num_active_poses=len(p_act),
            landmarks=landmarks,
            num_active_landmarks=len(l_act),
            cam=cam,
            specs=tuple(_spec(k, lists[k]) for k in present),
        )

    if kind is None:
        kind = present[0] if present else "mono"
    s = _spec(kind, lists[kind])
    return BAProblem(
        pose_q=pose_q,
        pose_t=pose_t,
        num_active_poses=len(p_act),
        landmarks=landmarks,
        num_active_landmarks=len(l_act),
        meas=s["meas"],
        pose_idx=s["pose_idx"],
        lm_idx=s["lm_idx"],
        omega=s["omega"],
        cam=cam,
        kind=kind,
    )
