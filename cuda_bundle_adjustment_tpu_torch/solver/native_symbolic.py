"""ctypes binding of the C++ symbolic analysis (``native/symbolic.cpp``).

Counterpart of the JAX package's ``solver/native_symbolic.py``: the Schur
structure (the landmark-pair enumeration, the Hsc pattern indexing and the
triples sorted by target block) in two linear passes over the edges, the
segment plans' stable counting sort, and the pose-bandwidth bound.  There is
no fallback: if the library cannot be built or loaded, the call raises.  The
numpy passes of :mod:`.symbolic` and :mod:`.ordering` (``use_native=False``)
and ``np.argsort`` are the oracles the tests hold these against.
"""

from __future__ import annotations

import ctypes

import numpy as np

from ..native import build

_I64P = ctypes.POINTER(ctypes.c_int64)
_I32P = ctypes.POINTER(ctypes.c_int32)
_I64 = ctypes.c_int64
_INT32_MAX = 2**31 - 1
_SIGNATURES = {
    # pose_idx lm_idx | E Pa La | start, group, table | out [T, nnz]
    "tba_structure_count": (_I64, [_I64P, _I64P, _I64, _I64, _I64, _I64P, _I64P, _I32P, _I64P]),
    # start group | La Pa | table | out rowptr, blk_row, blk_col, diag_pos, offsets,
    # tri_ei, tri_ej, tri_k
    "tba_structure_emit": (
        None, [_I64P, _I64P, _I64, _I64, _I32P, _I64P, _I32P, _I32P, _I32P, _I64P, _I32P, _I32P,
               _I32P]),
    # ids | n nseg | out offsets, order
    "tba_counting_sort": (_I64, [_I64P, _I64, _I64, _I64P, _I64P]),
    # pose_idx lm_idx | E Pa La | scratch pmin, pmax
    "tba_pose_band_bound": (_I64, [_I64P, _I64P, _I64, _I64, _I64, _I64P, _I64P]),
}


def _lib() -> ctypes.CDLL:
    lib = build.load()
    for name, (restype, argtypes) in _SIGNATURES.items():
        fn = getattr(lib, name)
        if fn.argtypes is None:
            fn.restype, fn.argtypes = restype, argtypes
    return lib


def _i64(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.int64)


def _p64(a: np.ndarray):
    return a.ctypes.data_as(_I64P)


def _p32(a: np.ndarray):
    return a.ctypes.data_as(_I32P)


def native_structure(pose_idx, lm_idx, Pa: int, La: int):
    """The Schur structure of the edges ``(pose_idx, lm_idx)`` with ``Pa``
    free poses and ``La`` free landmarks (an edge on a pose ``>= Pa`` or a
    landmark ``>= La`` is not both-free and drops out).  Returns ``(tri_ei,
    tri_ej, tri_k, blk_row, blk_col, diag_pos, rowptr, tri_offsets)``: int32
    triples in target-block order (enumeration order within a block), the
    int32 pattern sorted by ``row * Pa + col``, int64 ``rowptr [Pa + 1]`` and
    ``tri_offsets [nnz + 1]``.  Raises ValueError for a negative id, more
    edges than int32 edge ids hold, or more blocks than int32 positions."""
    lib = _lib()
    pi, li = np.asarray(pose_idx), np.asarray(lm_idx)
    if pi.shape != li.shape or pi.ndim != 1:
        raise ValueError("native_structure: expects two index arrays of one length")
    E = pi.size
    if E > _INT32_MAX:
        raise ValueError("native_structure: edge ids past the int32 triples' range")
    pi, li = _i64(pi), _i64(li)
    start = np.zeros(La + 1, dtype=np.int64)
    group = np.empty(E, dtype=np.int64)
    table = np.zeros(Pa * Pa, dtype=np.int32)
    counts = np.zeros(2, dtype=np.int64)
    if lib.tba_structure_count(
        _p64(pi), _p64(li), E, Pa, La, _p64(start), _p64(group), _p32(table), _p64(counts),
    ) < 0:
        raise ValueError("native_structure: negative pose or landmark ids")
    T, nnz = (int(c) for c in counts)
    if nnz > _INT32_MAX:
        raise ValueError("native_structure: more blocks than int32 positions hold")
    rowptr = np.empty(Pa + 1, dtype=np.int64)
    blk_row = np.empty(nnz, dtype=np.int32)
    blk_col = np.empty(nnz, dtype=np.int32)
    diag_pos = np.empty(Pa, dtype=np.int32)
    offsets = np.empty(nnz + 1, dtype=np.int64)
    tri_ei = np.empty(T, dtype=np.int32)
    tri_ej = np.empty(T, dtype=np.int32)
    tri_k = np.empty(T, dtype=np.int32)
    lib.tba_structure_emit(
        _p64(start), _p64(group), La, Pa, _p32(table), _p64(rowptr), _p32(blk_row),
        _p32(blk_col), _p32(diag_pos), _p64(offsets), _p32(tri_ei), _p32(tri_ej), _p32(tri_k),
    )
    return tri_ei, tri_ej, tri_k, blk_row, blk_col, diag_pos, rowptr, offsets


def counting_sort(ids, nseg: int):
    """The rows of ``ids`` by segment, stably, and the segments' bounds:
    ``(order [m], offsets [nseg + 1])``, int64, ``m`` the rows with ``id <
    nseg`` (rows of fixed vertices, ``id >= nseg``, drop out).  Equal to
    ``np.argsort(ids, kind="stable")[:m]`` and ``np.searchsorted`` of the
    sorted ids at ``arange(nseg + 1)``.  Raises ValueError for a negative
    id."""
    lib = _lib()
    ids = _i64(ids)
    if ids.ndim != 1:
        raise ValueError("counting_sort: expects one index array")
    offsets = np.zeros(nseg + 1, dtype=np.int64)
    order = np.empty(ids.size, dtype=np.int64)
    m = lib.tba_counting_sort(_p64(ids), ids.size, nseg, _p64(offsets), _p64(order))
    if m < 0:
        raise ValueError("counting_sort: negative segment ids")
    return order[:m], offsets


def pose_band_bound(pose_idx, lm_idx, Pa: int, La: int):
    """The largest ``max - min`` observing pose of a landmark over the
    both-free edges, in one pass; ``None`` when no both-free edge exists."""
    lib = _lib()
    pi, li = _i64(pose_idx), _i64(lm_idx)
    if pi.shape != li.shape or pi.ndim != 1:
        raise ValueError("pose_band_bound: expects two index arrays of one length")
    if pi.size and (pi.min() < 0 or li.min() < 0):
        raise ValueError("pose_band_bound: negative vertex ids")
    pmin = np.empty(max(La, 1), dtype=np.int64)
    pmax = np.empty(max(La, 1), dtype=np.int64)
    bw = int(lib.tba_pose_band_bound(_p64(pi), _p64(li), pi.size, Pa, La, _p64(pmin), _p64(pmax)))
    if not np.any(pmax[:La] >= 0):
        return None
    return bw
