"""Kernels B5 and B9: the Schur stage's Hpl block-vector products summed per
pose and per landmark (``csrc/schurvec.cu``), and their plain twins.

Counterparts of ``pallas/schurvec.py`` ``hpl_mv_class_call`` and
``hpl_mtv_class_call``:

* B5 ``hpl_mv_segment_sum``:  ``bsc = bp - sum_{e in pose} Hpl[e] y[lm(e)]``
* B9 ``hpl_mtv_segment_sum``: ``cl = bl - sum_{e in landmark} Hpl[e]^T xp[pose(e)]``

summed in the order of the segment plans of ``solver/segments.py``, in the
working type (f64, or f32 in f32 mode: kernels and twins compute in f64 and
round each output once, ``kernels/_types.py``).  The wrappers dispatch on
the tensor's device only: a CPU tensor runs the plain
PyTorch twin, a CUDA tensor launches the kernel (or raises).  The kernels
walk B3's :class:`LinearisePlan` (B5 its pose half, B9 its landmark half) in
one pass over tiles of edges; ``csrc/schurvec.cu`` has the design.  B9 sums
as its twin does; B5 adds a pose's chunk sums in chunk order.
"""

from __future__ import annotations

import ctypes

import torch

from ..ops.components import flat_mtv_6x3, flat_mv_6x3
from ..solver.segments import Segments, segment_sum
from . import _build
from ._types import check_floats, f32_flag, narrow, wide
from .terms import LinearisePlan, make_linearise_plan


def hpl_mv_segment_sum_plain(hpl, y, lm_idx, bp, pose_seg: Segments):
    """Plain PyTorch twin of B5 (in f64, rounded to the operands' type)."""
    La = y.shape[0]
    rows = flat_mv_6x3(wide(hpl), wide(y)[lm_idx.clamp(max=La - 1)])
    return narrow(bp.dtype, wide(bp) - segment_sum(rows, pose_seg))


def hpl_mtv_segment_sum_plain(hpl, xp, pose_idx, bl, lm_seg: Segments):
    """Plain PyTorch twin of B9 (in f64, rounded to the operands' type)."""
    Pa = xp.shape[0]
    contrib = flat_mtv_6x3(wide(hpl), wide(xp)[pose_idx.clamp(max=Pa - 1)])
    return narrow(bl.dtype, wide(bl) - segment_sum(contrib, lm_seg))


_VP, _LL = ctypes.c_void_p, ctypes.c_longlong
_ARGTYPES = {
    # hpl y lm_idx bp ldb | rows chunks tile_off vertex_off count scratch | E Pa La |
    # f32 | out stream
    "tba_hpl_mv_segment_sum": [_VP] * 4 + [_LL] + [_VP] * 6 + [_LL] * 3 + [ctypes.c_int]
    + [_VP] * 2,
    # hpl xp pose_idx bl ldb | rows chunks tile_off vertex_off slot count scratch |
    # E La Pa | f32 | out stream
    "tba_hpl_mtv_segment_sum": [_VP] * 4 + [_LL] + [_VP] * 7 + [_LL] * 3 + [ctypes.c_int]
    + [_VP] * 2,
}


def _fn(name: str):
    fn = getattr(_build.load("schurvec"), name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
    return fn


def _no_edges(n: int, dev) -> Segments:
    """The segment plan of ``n`` vertices without an edge."""
    return Segments(torch.zeros(0, dtype=torch.int64, device=dev),
                    torch.zeros(n + 1, dtype=torch.int64, device=dev))


def mv_plan(pose_seg: Segments, E: int, La: int) -> LinearisePlan:
    """The plan B5 walks where its caller has none: B3's over the poses."""
    return make_linearise_plan(pose_seg, _no_edges(La, pose_seg.offsets.device), E)


def mtv_plan(lm_seg: Segments, E: int, Pa: int) -> LinearisePlan:
    """The plan B9 walks where its caller has none: B3's over the landmarks."""
    return make_linearise_plan(_no_edges(Pa, lm_seg.offsets.device), lm_seg, E)


def _operands(name, hpl, vec, idx, base, k_vec, k_out):
    """Check a CUDA launch's operands; returns them contiguous, Hpl on a
    16-byte boundary, the right-hand side with its rows at any distance
    (the solver hands over a column block of a wider row)."""
    if hpl.device.type != "cuda":
        raise NotImplementedError(f"{name}: no kernel for device {hpl.device}")
    check_floats(name, hpl, vec, base)
    if idx.dtype != torch.int64:
        raise TypeError(f"{name}: expects int64 indices")
    if not (hpl.device == vec.device == idx.device == base.device):
        raise ValueError(f"{name}: all operands must be on one device")
    E = hpl.shape[0]
    if hpl.shape != (E, 18) or idx.shape != (E,) or vec.shape[1:] != (k_vec,) or (
        base.shape[1:] != (k_out,)
    ):
        raise ValueError(f"{name}: expects Hpl [E, 18], index [E], vector [n, {k_vec}], "
                         f"right-hand side [m, {k_out}]")
    if base.shape[0] > 0 and vec.shape[0] == 0:
        raise ValueError(f"{name}: the vector has no rows to read")
    hpl, vec, idx = (t if t.is_contiguous() else t.contiguous() for t in (hpl, vec, idx))
    if base.stride(1) != 1 or base.stride(0) < k_out:
        base = base.contiguous()
    # the kernel loads the Hpl rows 16 bytes at a time.  Under CUDA-graph
    # capture (solver/fused.py) this branch is decided once, at capture, and
    # the graph keeps the clone or not for every replay: right only because
    # the loop's buffers keep their addresses from capture to replay
    if hpl.data_ptr() % 16:
        hpl = hpl.clone()
    return hpl, vec, idx, base


def hpl_mv_segment_sum(hpl, y, lm_idx, bp, pose_seg: Segments,
                       plan: LinearisePlan | None = None):
    """``Hpl [E, 18], y [La, 3], lm_idx [E], bp [Pa, 6] -> bsc [Pa, 6]``
    in the operands' type (kernel B5 on CUDA).  ``plan``: B3's :func:`make_linearise_plan` of
    the structure, for a caller that launches more than once; B5 walks its
    pose half."""
    if hpl.device.type == "cpu":
        return hpl_mv_segment_sum_plain(hpl, y, lm_idx, bp, pose_seg)
    hpl, y, lm_idx, bp = _operands("hpl_mv_segment_sum", hpl, y, lm_idx, bp, 3, 6)
    E, Pa, La = hpl.shape[0], bp.shape[0], y.shape[0]
    if plan is None:
        plan = mv_plan(pose_seg, E, La)
    if (plan.E, plan.Pa, plan.La) != (E, Pa, La) or plan.count.device != hpl.device:
        raise ValueError("hpl_mv_segment_sum: the plan belongs to another structure or device")
    out = torch.empty(bp.shape, dtype=bp.dtype, device=bp.device)
    if Pa == 0:
        return out
    p = plan.pose
    status = _fn("tba_hpl_mv_segment_sum")(
        hpl.data_ptr(), y.data_ptr(), lm_idx.data_ptr(), bp.data_ptr(), bp.stride(0),
        p.rows.data_ptr(), p.chunks.data_ptr(), p.tile_off.data_ptr(), p.vertex_off.data_ptr(),
        plan.count.data_ptr(), plan.scratch.data_ptr(), E, Pa, La, f32_flag(hpl.dtype),
        out.data_ptr(), _build.stream_ptr(hpl),
    )
    _build.check(status, "hpl_mv_segment_sum")
    hpl_mv_segment_sum.launches += 1
    return out


def hpl_mtv_segment_sum(hpl, xp, pose_idx, bl, lm_seg: Segments,
                        plan: LinearisePlan | None = None):
    """``Hpl [E, 18], xp [Pa, 6], pose_idx [E], bl [La, 3] -> cl [La, 3]``
    in the operands' type (kernel B9 on CUDA).  ``plan``: as for :func:`hpl_mv_segment_sum`;
    B9 walks its landmark half."""
    if hpl.device.type == "cpu":
        return hpl_mtv_segment_sum_plain(hpl, xp, pose_idx, bl, lm_seg)
    hpl, xp, pose_idx, bl = _operands("hpl_mtv_segment_sum", hpl, xp, pose_idx, bl, 6, 3)
    E, Pa, La = hpl.shape[0], xp.shape[0], bl.shape[0]
    if plan is None:
        plan = mtv_plan(lm_seg, E, Pa)
    if (plan.E, plan.Pa, plan.La) != (E, Pa, La) or plan.count.device != hpl.device:
        raise ValueError("hpl_mtv_segment_sum: the plan belongs to another structure or device")
    out = torch.empty(bl.shape, dtype=bl.dtype, device=bl.device)
    if La == 0:
        return out
    p = plan.lm
    status = _fn("tba_hpl_mtv_segment_sum")(
        hpl.data_ptr(), xp.data_ptr(), pose_idx.data_ptr(), bl.data_ptr(), bl.stride(0),
        p.rows.data_ptr(), p.chunks.data_ptr(), p.tile_off.data_ptr(), p.vertex_off.data_ptr(),
        plan.lm_slot.data_ptr(), plan.count.data_ptr() + 4 * Pa,
        plan.scratch.data_ptr() + 8 * 6 * plan.pose.chunks.shape[0], E, La, Pa,
        f32_flag(hpl.dtype), out.data_ptr(), _build.stream_ptr(hpl),
    )
    _build.check(status, "hpl_mtv_segment_sum")
    hpl_mtv_segment_sum.launches += 1
    return out


hpl_mv_segment_sum.launches = 0
hpl_mtv_segment_sum.launches = 0
