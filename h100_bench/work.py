"""The least time an H100 needs for one solve's work, counted from the
problem's shapes.

The work is counted per stage of the port's stage contract (ROADMAP, "The
contract is what the XLA path produces", as it reads at commit 99f61eb),
never per kernel: each stage's inputs are read once and its outputs written
once, whatever a kernel reads again, so a change that fuses, splits or
replaces kernels leaves the count as it is.  The stages, for monocular
(M = 2 rows an edge) and stereo (M = 3) edges over one camera:

* linearise (once an iteration): state and edge data in; Hpp|bp ``[Pa, 42]``,
  Hll|bl ``[La, 12]`` and Hpl ``[E, 18]`` out;
* Schur reduce (once a trial): Hpp|bp, Hll|bl, Hpl and lambda in; the Hsc
  blocks on the pattern (the distinct pose pairs that share a free landmark,
  upper triangle and diagonal) and bsc out;
* reduced solve (once a trial): the Hsc blocks and bsc in, xp out.  Its
  operations are counted as one application of the matrix: a factor's
  operations depend on the ordering, which is the program's choice, so the
  stage is held to its bytes;
* back-substitution (once a trial): Hpl, Hll|bl and xp in, xl out;
* update and trial chi2 (once a trial): state, steps and edge data in, the
  candidate state out.

Operation counts are lower bounds (symmetric products counted once, the
transcendental functions as one operation each), so a share of this bound
cannot pass 100% by an over-count.  Peaks of one H100 SXM at 700 W
(NVIDIA's data sheet, dense, outside the tensor cores): 34 TFLOP/s in f64,
67 in f32, 3.35 TB/s of HBM.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

PEAK_FLOPS = {8: 34e12, 4: 67e12}
PEAK_BYTES_PER_S = 3.35e12


class Shapes(NamedTuple):
    """Sizes one solve's work follows from."""

    P: int  # poses
    Pa: int  # free poses
    L: int  # landmarks
    La: int  # free landmarks
    E: int  # edges
    Epl: int  # edges with a free pose and a free landmark (Hpl blocks)
    rows: int  # measurement rows, summed over the edges (M an edge)
    idx_bytes: int  # bytes of one pose or landmark index
    pairs: int  # pose-pair products of the Schur reduce (upper triangle)
    blocks: int  # Hsc blocks on the pattern (upper triangle and diagonal)


def shapes(problem) -> Shapes:
    """Count the sizes of a ``BAProblem`` or a ``MixedBAProblem`` from its
    arrays."""
    Pa, La = int(problem.num_active_poses), int(problem.num_active_landmarks)
    sets = problem.specs if hasattr(problem, "specs") else [problem._asdict()]
    pi = np.concatenate([np.asarray(s["pose_idx"]) for s in sets]).astype(np.int64)
    li = np.concatenate([np.asarray(s["lm_idx"]) for s in sets]).astype(np.int64)
    act = (pi < Pa) & (li < La)
    pa, la = pi[act], li[act]
    deg = np.bincount(la, minlength=La)
    pairs = int(np.sum(deg * (deg + 1) // 2))
    # distinct pose pairs sharing a landmark: sort the free edges by
    # landmark and pair each with the later edges of its landmark
    order = np.argsort(la, kind="stable")
    pa, la = pa[order], la[order]
    keys = [pa * Pa + pa]
    for d in range(1, int(deg.max()) if deg.size else 0):
        same = la[d:] == la[:-d]
        a, b = pa[:-d][same], pa[d:][same]
        keys.append(np.minimum(a, b) * Pa + np.maximum(a, b))
    keys.append(np.arange(Pa, dtype=np.int64) * (Pa + 1))
    blocks = int(np.unique(np.concatenate(keys)).size)
    return Shapes(
        P=int(problem.pose_q.shape[0]), Pa=Pa, L=int(problem.landmarks.shape[0]), La=La,
        E=int(pi.size), Epl=int(act.sum()), rows=sum(int(np.asarray(s["meas"]).size) for s in sets),
        idx_bytes=int(np.asarray(sets[0]["pose_idx"]).dtype.itemsize), pairs=pairs, blocks=blocks,
    )


def stage_work(s: Shapes, w: int) -> dict:
    """``{stage: (bytes, operations)}`` of one linearisation (``linearise``)
    and of one trial (the others), ``w`` bytes a float."""
    E, rows = s.E, s.rows
    state = s.P * 7 * w + s.L * 3 * w
    edges = rows * w + E * (2 * s.idx_bytes + w) + 5 * w
    hp, hl, hpl = s.Pa * 42 * w, s.La * 12 * w, s.Epl * 18 * w
    hsc = s.blocks * 36 * w
    xp, xl = s.Pa * 6 * w, s.La * 3 * w
    # an edge of M rows: transform (18), projection (7), residual (M),
    # Jacobians (6 M + 3 M, one operation an entry), weighted products of
    # the symmetric Hpp (21) and Hll (6), Hpl (18), bp (6), bl (3), each
    # entry a dot of M terms (2 M - 1 operations)
    lin_edges = E * (18 + 7) + rows * 10 + (21 + 6 + 18 + 6 + 3) * (2 * rows - E)
    # a pose's rotation matrix from its quaternion
    lin_ops = lin_edges + s.P * 30
    # a landmark: damping (3) and the 3x3 inverse (~40); an edge: Hpl inv
    # (18 entries of 3-term dots) and bsc (6 of 3); a pair: a 6x6 block of
    # 3-term dots
    schur_ops = s.La * 43 + s.Epl * (18 * 5 + 6 * 5) + s.pairs * 36 * 5
    solve_ops = 2 * (2 * s.blocks - s.Pa) * 36
    # an edge: Hpl^T xp (3 of 6-term dots) and its sum; a landmark: the 3x3
    # product with the damped inverse
    back_ops = s.Epl * (3 * 11 + 3) + s.La * (9 + 6)
    # a pose: SE3 exp and the left compose (~100); a landmark: the add; an
    # edge: transform, projection, residual (M) and its weighted square
    # (2 M + 1)
    update_ops = s.Pa * 100 + s.La * 3 + E * (18 + 7 + 1) + rows * 3
    return {
        "linearise": (state + edges + hp + hl + hpl, lin_ops),
        "schur": (hp + hl + hpl + w + hsc + xp, schur_ops),
        "solve": (hsc + xp + xp, solve_ops),
        "back": (hpl + hl + xp + xl, back_ops),
        "update": (state + xp + xl + edges + s.Pa * 7 * w + s.La * 3 * w + w, update_ops),
    }


def stage_seconds(bytes_: int, ops: int, w: int) -> float:
    """The larger of the stage's bytes over HBM bandwidth and its
    operations over the peak rate."""
    return max(bytes_ / PEAK_BYTES_PER_S, ops / PEAK_FLOPS[w])


def solve_seconds(s: Shapes, linearisations: int, trials: int, w: int = 8) -> float:
    """The least time of a solve that made ``linearisations`` and
    ``trials``."""
    t = {k: stage_seconds(b, o, w) for k, (b, o) in stage_work(s, w).items()}
    return linearisations * t["linearise"] + trials * (t["schur"] + t["solve"] + t["back"] + t["update"])
