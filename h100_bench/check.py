"""The comparison that decides ``correct``: the port's answers against the
plain reference (``reference.py``), at the timed sizes, on graphs the
window ran.

Three numbers, each against its cell's limit (``limits/<cell>.json``):

* ``chi2_gap``: the widest relative gap between a solve's chi2 trace
  (``batch_statistics()``) and the reference's, iteration by iteration,
  over every window solve of a graph the reference ran; a trace of another
  length, or a value that is not finite, reads infinite;
* ``pose_gap``: ``|x - x_ref| / |x_ref - x_0|`` over every pose's ``[q, t]``
  (the port's ``result_poses()`` against the reference's final poses,
  relative to how far the reference moved them), the widest of the sampled
  solves;
* ``landmark_gap``: the same over the landmarks (``result_landmarks()``).
"""

from __future__ import annotations

import math

import numpy as np

NAMES = ("chi2_gap", "pose_gap", "landmark_gap")


def trace_gap(trace, ref) -> float:
    if len(trace) != len(ref) or not len(ref):
        return math.inf
    a, b = np.asarray(trace, dtype=np.float64), np.asarray(ref, dtype=np.float64)
    g = np.abs(a - b) / np.abs(b)
    return float(g.max()) if np.all(np.isfinite(g)) else math.inf


def state_gap(x, ref, init) -> float:
    x, ref, init = (np.asarray(a, dtype=np.float64).ravel() for a in (x, ref, init))
    num = float(np.linalg.norm(x - ref))
    den = float(np.linalg.norm(ref - init))
    g = num / den if den > 0 else (0.0 if num == 0 else math.inf)
    return g if math.isfinite(g) else math.inf


def gaps(trace, state, ref_trace, ref_state, init) -> dict:
    """The three numbers of one solve against the reference's run of its
    graph; ``state``: ``(q, t, Xw)`` or None where only the trace was kept."""
    out = {"chi2_gap": trace_gap(trace, ref_trace)}
    if state is not None:
        q, t, X = state
        rq, rt, rX = ref_state
        iq, it, iX = init
        out["pose_gap"] = state_gap(np.concatenate([q, t], 1), np.concatenate([rq, rt], 1),
                                    np.concatenate([iq, it], 1))
        out["landmark_gap"] = state_gap(X, rX, iX)
    return out


def widest(readings) -> dict:
    """The largest reading of each number over several solves."""
    out = {}
    for r in readings:
        for k, v in r.items():
            out[k] = max(out.get(k, 0.0), v)
    return out


def judge(values: dict, limits: dict) -> tuple[bool, dict]:
    """``(correct, {name: {"value", "limit"}})``: every number present,
    finite and at most its limit."""
    checks, ok = {}, True
    for name in NAMES:
        v = values.get(name, math.inf)
        lim = float(limits[name])
        ok = ok and math.isfinite(v) and v <= lim
        checks[name] = {"value": v if math.isfinite(v) else None, "limit": lim}
    return ok, checks
