"""Host-side symbolic analysis of the Schur-complement structure.

Counterpart of the JAX package's ``solver/symbolic.py``.  By default
(``use_native=True``) the whole pass runs in C++ (``native/symbolic.cpp``
through :mod:`.native_symbolic`): the both-free mask, a counting sort of the
edges by (landmark, pose, edge id), the enumeration, the pattern indexing
and the triples written in target-block order, all linear in the edges and
triples; there is no fallback.  ``use_native=False`` is a numpy copy of the
JAX numpy path, the oracle of the tests.  One pass over the packed edge
arrays gives:

* ``(blk_row, blk_col)``: upper-triangular block coordinates of Hsc's nonzero
  6x6 blocks (diagonal blocks always present), sorted by ``row * Pa + col``;
* ``diag_pos[p]``: position of block ``(p, p)``;
* ``(tri_ei, tri_ej, tri_k)``: for every landmark and every ordered pair of
  its observing both-free edges, ``W[ei] @ Hpl[ej]^T`` goes into block
  ``tri_k``.

The native pass gives the JAX package's native arrays element for element.
The two passes list the same triples per block, and in the same order
except where two both-free edges share a pose and a landmark: the native
pass emits such a pair's swapped copy right after it, the numpy pass
appends all swapped copies at the end.  :func:`sort_triples` gives the
triples in target-block order with CSR offsets, the layout kernel B6 walks
(the native pass emits that order itself).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np


class SchurStructure(NamedTuple):
    num_poses: int  # Pa: active pose count
    num_landmarks: int  # La: active landmark count
    nnz_blocks: int  # number of stored upper-tri 6x6 blocks in Hsc
    blk_row: np.ndarray  # [nnz] int32, row block index (<= col)
    blk_col: np.ndarray  # [nnz] int32
    diag_pos: np.ndarray  # [Pa] int32 position of (p, p)
    tri_ei: np.ndarray  # [T] int32 edge index of the W = Hpl inv(Hll) factor
    tri_ej: np.ndarray  # [T] int32 edge index of the Hpl^T factor
    tri_k: np.ndarray  # [T] int32 target block position
    tri_sorted: bool  # True when triples are pre-sorted by tri_k (native pass)
    rowptr: np.ndarray  # [Pa+1] int64 CSR row pointers over the blocks
    nmul_blocks: int  # == T
    # [nnz + 1] int64 per-block offsets of the sorted triples (native pass
    # only; None when tri_sorted is False)
    tri_offsets: Optional[np.ndarray] = None


def _pairs_within_groups(group_sizes: np.ndarray):
    """Enumerate (first, second) sorted-position pairs with first <= second
    inside each contiguous group.  Returns flat position arrays."""
    M = int(group_sizes.sum())
    if M == 0:
        z = np.zeros(0, dtype=np.int64)
        return z, z
    group_end = np.cumsum(group_sizes)
    # per sorted position: its group's end
    pos = np.arange(M, dtype=np.int64)
    gid = np.repeat(np.arange(len(group_sizes), dtype=np.int64), group_sizes)
    cnt = group_end[gid] - pos  # partners per position (incl. itself)
    T = int(cnt.sum())
    first = np.repeat(pos, cnt)
    run_starts = np.cumsum(cnt) - cnt
    idx_in_run = np.arange(T, dtype=np.int64) - np.repeat(run_starts, cnt)
    second = first + idx_in_run
    return first, second


def build_schur_structure(
    pose_idx: np.ndarray,
    lm_idx: np.ndarray,
    num_poses: int,
    num_landmarks: int,
    use_native: bool = True,
) -> SchurStructure:
    """Build the Schur block pattern and multiply plan.

    ``pose_idx``/``lm_idx`` are the dense indices of all packed BA edges;
    edges touching a fixed pose (``pose_idx >= num_poses``) or fixed
    landmark (``lm_idx >= num_landmarks``) are excluded.  ``use_native``:
    the C++ pass (raises if its library cannot be built, and ValueError for
    a negative index), else the numpy copy.
    """
    Pa, La = int(num_poses), int(num_landmarks)
    if use_native:
        from .native_symbolic import native_structure

        indexed = native_structure(pose_idx, lm_idx, Pa, La)
        tri_ei, tri_ej, tri_k, blk_row, blk_col, diag_pos, rowptr, tri_offsets = indexed
    else:
        pose_idx = np.asarray(pose_idx, dtype=np.int64)
        lm_idx = np.asarray(lm_idx, dtype=np.int64)
        valid = (pose_idx >= 0) & (pose_idx < Pa) & (lm_idx >= 0) & (lm_idx < La)
        eids = np.nonzero(valid)[0].astype(np.int64)
        tri_ei, tri_ej, tri_k, blk_row, blk_col, diag_pos = _numpy_pass(
            eids, pose_idx[eids], lm_idx[eids], Pa)
        tri_offsets = None
        rowptr = np.zeros(Pa + 1, dtype=np.int64)
        np.add.at(rowptr, blk_row + 1, 1)
        rowptr = np.cumsum(rowptr)

    return SchurStructure(
        num_poses=Pa,
        num_landmarks=La,
        nnz_blocks=int(blk_row.size),
        blk_row=blk_row,
        blk_col=blk_col,
        diag_pos=diag_pos.astype(np.int32, copy=False),
        tri_ei=tri_ei.astype(np.int32, copy=False),
        tri_ej=tri_ej.astype(np.int32, copy=False),
        tri_k=tri_k.astype(np.int32, copy=False),
        tri_sorted=use_native,
        rowptr=rowptr,
        nmul_blocks=int(tri_k.size),
        tri_offsets=tri_offsets,
    )


def _numpy_pass(eids, ep, el, Pa: int):
    """The numpy enumeration and pattern indexing: ``(tri_ei, tri_ej,
    tri_k, blk_row, blk_col, diag_pos)``, triples in enumeration order."""
    # deterministic order: sort by (landmark, pose, edge id)
    order = np.lexsort((eids, ep, el))
    ep_s, el_s, eid_s = ep[order], el[order], eids[order]

    # contiguous group sizes per landmark
    if el_s.size:
        change = np.nonzero(np.diff(el_s))[0] + 1
        bounds = np.concatenate([[0], change, [el_s.size]])
        group_sizes = np.diff(bounds)
    else:
        group_sizes = np.zeros(0, dtype=np.int64)

    first, second = _pairs_within_groups(group_sizes)
    tri_ei = eid_s[first].astype(np.int64)
    tri_ej = eid_s[second].astype(np.int64)
    pair_keys = ep_s[first] * Pa + ep_s[second]

    # duplicate observations (two edges sharing pose AND landmark) hit a
    # diagonal block, which is not mirrored at densify time — emit both
    # multiply orders so (p, p) receives W_e1 Hpl_e2^T + W_e2 Hpl_e1^T
    same_pose = (ep_s[first] == ep_s[second]) & (first != second)
    if np.any(same_pose):
        extra_ei = tri_ej[same_pose]
        extra_ej = tri_ei[same_pose]
        tri_ei = np.concatenate([tri_ei, extra_ei])
        tri_ej = np.concatenate([tri_ej, extra_ej])
        pair_keys = np.concatenate([pair_keys, pair_keys[same_pose]])

    diag_keys = np.arange(Pa, dtype=np.int64) * (Pa + 1)
    unique_keys = np.unique(np.concatenate([pair_keys, diag_keys]))
    tri_k = np.searchsorted(unique_keys, pair_keys).astype(np.int32)
    diag_pos = np.searchsorted(unique_keys, diag_keys).astype(np.int32)
    blk_row = (unique_keys // Pa).astype(np.int32)
    blk_col = (unique_keys % Pa).astype(np.int32)
    return tri_ei, tri_ej, tri_k, blk_row, blk_col, diag_pos


def sort_triples(s: SchurStructure) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Triples in target-block order: ``(tri_ei, tri_ej, offsets [nnz+1])``,
    int32 triples and int64 offsets.

    The native pass emitted them so (``tri_sorted``); the numpy pass's are
    sorted here, stably, so within one block the triples keep the
    enumeration order above."""
    if s.tri_sorted:
        return s.tri_ei, s.tri_ej, s.tri_offsets
    order = np.argsort(s.tri_k, kind="stable")
    counts = np.bincount(s.tri_k, minlength=s.nnz_blocks)
    offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    return s.tri_ei[order], s.tri_ej[order], offsets
