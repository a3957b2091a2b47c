"""Kernels B5 and B9: the Schur stage's Hpl block-vector products summed per
pose and per landmark (``csrc/schurvec.cu``), and their plain twins.

Counterparts of ``pallas/schurvec.py`` ``hpl_mv_class_call`` and
``hpl_mtv_class_call``:

* B5 ``hpl_mv_segment_sum``:  ``bsc = bp - sum_{e in pose} Hpl[e] y[lm(e)]``
* B9 ``hpl_mtv_segment_sum``: ``cl = bl - sum_{e in landmark} Hpl[e]^T xp[pose(e)]``

over the fixed-order segment plans of ``solver/segments.py``.  The wrappers
dispatch on the tensor's device only: a CPU tensor runs the plain PyTorch
twin, a CUDA tensor launches the kernel (or raises).
"""

from __future__ import annotations

import ctypes

import torch

from ..ops.components import flat_mtv_6x3, flat_mv_6x3
from ..solver.segments import Segments, segment_sum
from . import _build


def hpl_mv_segment_sum_plain(hpl, y, lm_idx, bp, pose_seg: Segments):
    """Plain PyTorch twin of B5."""
    La = y.shape[0]
    rows = flat_mv_6x3(hpl, y[lm_idx.clamp(max=La - 1)])
    return bp - segment_sum(rows, pose_seg)


def hpl_mtv_segment_sum_plain(hpl, xp, pose_idx, bl, lm_seg: Segments):
    """Plain PyTorch twin of B9."""
    Pa = xp.shape[0]
    contrib = flat_mtv_6x3(hpl, xp[pose_idx.clamp(max=Pa - 1)])
    return bl - segment_sum(contrib, lm_seg)


_VP, _LL = ctypes.c_void_p, ctypes.c_longlong


def _fn(name: str):
    fn = getattr(_build.load("schurvec"), name)
    if fn.argtypes is None:
        # hpl, vector, index, base, order, offsets, nseg, nvec, out, stream
        fn.argtypes = [_VP] * 6 + [_LL, _LL, _VP, _VP]
        fn.restype = ctypes.c_int
    return fn


def _launch(wrapper, hpl, vec, idx, base, seg: Segments, k_vec: int, k_out: int):
    name = wrapper.__name__
    if hpl.device.type != "cuda":
        raise NotImplementedError(f"{name}: no kernel for device {hpl.device}")
    floats, ints = (hpl, vec, base), (idx, seg.order, seg.offsets)
    if any(t.dtype != torch.float64 for t in floats) or any(
        t.dtype != torch.int64 for t in ints
    ):
        raise TypeError(f"{name}: expects f64 blocks and vectors and int64 indices")
    if any(t.device != hpl.device for t in floats + ints):
        raise ValueError(f"{name}: all operands must be on one device")
    E, nseg, nvec = hpl.shape[0], seg.offsets.shape[0] - 1, vec.shape[0]
    if hpl.shape != (E, 18) or idx.shape != (E,) or vec.shape[1:] != (k_vec,):
        raise ValueError(f"{name}: expects Hpl [E, 18], index [E], vector [n, {k_vec}]")
    if base.shape != (nseg, k_out):
        raise ValueError(f"{name}: expects a right-hand side of {nseg} rows of {k_out}")
    if nseg > 0 and nvec == 0:
        raise ValueError(f"{name}: the vector has no rows to read")
    hpl, vec, idx, base = (t.contiguous() for t in (hpl, vec, idx, base))
    out = torch.empty_like(base)
    if nseg == 0:
        return out
    status = _fn(f"tba_{name}")(
        hpl.data_ptr(), vec.data_ptr(), idx.data_ptr(), base.data_ptr(),
        seg.order.contiguous().data_ptr(), seg.offsets.contiguous().data_ptr(),
        nseg, nvec, out.data_ptr(), _build.stream_ptr(hpl),
    )
    _build.check(status, name)
    wrapper.launches += 1
    return out


def hpl_mv_segment_sum(hpl, y, lm_idx, bp, pose_seg: Segments):
    """``Hpl [E, 18], y [La, 3], lm_idx [E], bp [Pa, 6] -> bsc [Pa, 6]``
    f64 (kernel B5 on CUDA)."""
    if hpl.device.type == "cpu":
        return hpl_mv_segment_sum_plain(hpl, y, lm_idx, bp, pose_seg)
    return _launch(hpl_mv_segment_sum, hpl, y, lm_idx, bp, pose_seg, 3, 6)


def hpl_mtv_segment_sum(hpl, xp, pose_idx, bl, lm_seg: Segments):
    """``Hpl [E, 18], xp [Pa, 6], pose_idx [E], bl [La, 3] -> cl [La, 3]``
    f64 (kernel B9 on CUDA)."""
    if hpl.device.type == "cpu":
        return hpl_mtv_segment_sum_plain(hpl, xp, pose_idx, bl, lm_seg)
    return _launch(hpl_mtv_segment_sum, hpl, xp, pose_idx, bl, lm_seg, 6, 3)


hpl_mv_segment_sum.launches = 0
hpl_mtv_segment_sum.launches = 0
