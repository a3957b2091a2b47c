"""ctypes binding of the C++ symbolic analysis (``native/symbolic.cpp``).

Counterpart of the JAX package's ``solver/native_symbolic.py``: the
landmark-pair enumeration, the Hsc pattern indexing and the triples
counting-sorted by target block, and the pose-bandwidth bound.  There is no
fallback: if the library cannot be built or loaded, the call raises.  The
numpy passes of :mod:`.symbolic` and :mod:`.ordering` (``use_native=False``)
are the oracles the tests hold these against.
"""

from __future__ import annotations

import ctypes

import numpy as np

from ..native import build

_I64P = ctypes.POINTER(ctypes.c_int64)
_I32P = ctypes.POINTER(ctypes.c_int32)
_I64 = ctypes.c_int64
_SIGNATURES = {
    "tba_count_pairs": (_I64, [_I64P, _I64P, _I64]),
    # sorted edge ids, poses, landmarks | n | Pa | out pair_keys, tri_ei, tri_ej
    "tba_enumerate_pairs": (None, [_I64P, _I64P, _I64P, _I64, _I64, _I64P, _I64P, _I64P]),
    "tba_index_pairs_count": (_I64, [_I64P, _I64, _I64, _I32P]),
    # pair_keys | T | Pa | pos | out tri_k, blk_row, blk_col, diag_pos
    "tba_index_pairs_emit": (None, [_I64P, _I64, _I64, _I32P, _I32P, _I32P, _I32P, _I32P]),
    # pair_keys tri_ei tri_ej | T | Pa | pos | nnz | out rowptr, ei, ej, k
    "tba_emit_sorted": (
        None, [_I64P, _I64P, _I64P, _I64, _I64, _I32P, _I64, _I64P, _I32P, _I32P, _I32P]),
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


def native_build(eids: np.ndarray, ep: np.ndarray, el: np.ndarray, Pa: int):
    """The pair enumeration over the both-free edges ``eids`` with poses
    ``ep < Pa`` and landmarks ``el``, sorted here by (landmark, pose, edge
    id).  Returns ``(pair_keys, tri_ei, tri_ej)``, int64, in enumeration
    order."""
    lib = _lib()
    eids, ep, el = _i64(eids), _i64(ep), _i64(el)
    if not eids.shape == ep.shape == el.shape or eids.ndim != 1:
        raise ValueError("native_build: expects three index arrays of one length")
    if ep.size and (ep.min() < 0 or ep.max() >= Pa or el.min() < 0):
        raise ValueError("native_build: pose ids outside [0, Pa) or negative landmark ids")
    order = np.lexsort((eids, ep, el))
    eid_s, ep_s, el_s = eids[order], ep[order], el[order]
    n = eid_s.size
    T = lib.tba_count_pairs(_p64(ep_s), _p64(el_s), n)
    pair_keys = np.empty(T, dtype=np.int64)
    tri_ei = np.empty(T, dtype=np.int64)
    tri_ej = np.empty(T, dtype=np.int64)
    lib.tba_enumerate_pairs(
        _p64(eid_s), _p64(ep_s), _p64(el_s), n, Pa,
        _p64(pair_keys), _p64(tri_ei), _p64(tri_ej),
    )
    return pair_keys, tri_ei, tri_ej


def native_structure(pair_keys, tri_ei, tri_ej, Pa: int):
    """The Hsc pattern indexed by a counting pass over the ``Pa^2`` key
    space, and the triples counting-sorted by target block.  Returns
    ``(tri_ei, tri_ej, tri_k, blk_row, blk_col, diag_pos, tri_offsets)``:
    int32 triples in target-block order (enumeration order within a block)
    and their ``[nnz + 1]`` int64 per-block offsets."""
    lib = _lib()
    keys, ei, ej = _i64(pair_keys), _i64(tri_ei), _i64(tri_ej)
    T = keys.size
    if not keys.shape == ei.shape == ej.shape or keys.ndim != 1:
        raise ValueError("native_structure: expects three arrays of one length")
    if T and (keys.min() < 0 or keys.max() >= Pa * Pa):
        raise ValueError("native_structure: pair keys outside [0, Pa^2)")
    if T and (min(ei.min(), ej.min()) < 0 or max(ei.max(), ej.max()) >= 2**31):
        raise ValueError("native_structure: edge ids outside the int32 triples' range")
    pos = np.empty(Pa * Pa, dtype=np.int32)
    nnz = lib.tba_index_pairs_count(_p64(keys), T, Pa, _p32(pos))
    tri_k = np.empty(T, dtype=np.int32)
    blk_row = np.empty(nnz, dtype=np.int32)
    blk_col = np.empty(nnz, dtype=np.int32)
    diag_pos = np.empty(Pa, dtype=np.int32)
    lib.tba_index_pairs_emit(
        _p64(keys), T, Pa, _p32(pos), _p32(tri_k), _p32(blk_row), _p32(blk_col), _p32(diag_pos),
    )
    offsets = np.empty(nnz + 1, dtype=np.int64)
    ei_s = np.empty(T, dtype=np.int32)
    ej_s = np.empty(T, dtype=np.int32)
    k_s = np.empty(T, dtype=np.int32)
    lib.tba_emit_sorted(
        _p64(keys), _p64(ei), _p64(ej), T, Pa, _p32(pos), nnz,
        _p64(offsets), _p32(ei_s), _p32(ej_s), _p32(k_s),
    )
    return ei_s, ej_s, k_s, blk_row, blk_col, diag_pos, offsets


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
