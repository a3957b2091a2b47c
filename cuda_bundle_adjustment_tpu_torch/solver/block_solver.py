"""Block solver: packing, structure analysis and the LM pipeline stages
(counterpart of ``solver/block_solver.py``, slice stages only).

Same stage decomposition and math as the JAX package's default accelerator
path, in plain PyTorch around ten hand-written kernels:

* per-edge state gathers through kernel B2 (``models/ba.py edge_state``);
* chi through kernel B1 (:func:`compute_chi`) and the linearisation through
  kernel B3 (:func:`build_system`), for mono, stereo and depth edges, with
  one camera or a camera an edge; a robust kernel (Huber, Cauchy, Tukey)
  applies rho to B1's per-edge output and hands B3 the weight rescaled by
  rho';
* the damped landmark inverse and ``y = inv(Hll) bl`` through kernel B4, the
  bsc product through kernel B5 and the Schur pair products through kernel
  B6 (:func:`schur_reduce`);
* the reduced solve (:func:`solve_reduced`) by the route the structure
  fixes (:func:`reduced_route`): the band factor and solves through kernels
  B7 and B8 (:func:`solve_reduced_band`) for a band height up to
  ``MAX_BAND`` where the factor's type is f32, a dense Cholesky in plain
  torch (:func:`solve_reduced_dense`) on fewer than ``PCG_MIN_POSES``
  poses, and under ``solver_precision="exact"`` at f64 on a band that
  passes the JAX package's VMEM test, and block-Jacobi preconditioned CG in
  plain torch (:func:`solve_reduced_pcg`, ``solver/pcg.py``) for the rest; under ``"mixed"`` at f64 the f32 band or dense factor is followed
  by exactly two f64 refinement rounds and the ``1e-8 ||b||`` residual
  check, elsewhere the one solve is returned as it is;
* the back-substitution products through kernels B9 and B10
  (:func:`schur_back_substitute`);
* without free landmarks, the pose-only solve (:func:`solve_pose_only`):
  ``Hpp`` is block-diagonal and each damped 6x6 block is solved on its own,
  with no Schur reduction and no landmark step.

Every edge set with landmarks (mono, stereo, depth; a mono and a stereo
set under one robust kernel merge into one masked stereo set first) goes
into one landmark pack, the sets concatenated in the caller's order, each
keeping its kind, robust kernel and bounds (:class:`EdgeSetMeta`): B1 and
B3 launch once a pass over the pack, whatever the number of sets, rho and
rho' apply set by set to B1's output, and the Schur stages run on the
concatenation unchanged.  Beside it a graph may hold pose-only ICP sets
(``models/icp.py``, plain torch); their per-pose stacks are summed set
after set onto the pose side.  Edges above an edge set's outlier threshold
are masked by :meth:`BlockSolver.update_edges`, at the end of every
``optimize()``.

An object graph (vertex and edge sets, :meth:`BlockSolver.initialize`) is
turned into the same edge specs as an array problem and packed by
:meth:`BlockSolver.initialize_from_arrays`; :meth:`BlockSolver.finalize`
writes the estimates back into its vertices.

Every per-pose, per-landmark and per-block-row sum is a
fixed-order CSR segment sum over rows sorted by target once per structure
(:class:`Segments`), never a float atomic, so two runs on one device give
the same chi2 trace bit for bit.  Everything derived from the index arrays
alone (the RCM order, the symbolic structure and the device plan) is cached
across solvers by a content digest (:func:`_struct_digest`), so a
re-optimisation of the same topology skips the host analysis and the plan
uploads.

The working type is ``options.dtype``: f64, or f32 (f32 mode), in which the
state, the edge data and every stage's output are f32 and the kernels
compute in f64 registers and round at their stores, as the plain twins do.
"""

from __future__ import annotations

import contextlib
import hashlib
from collections import OrderedDict
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..graph import EdgeSet, lookup_ids
from ..kernels import pairprod as _pairprod
from ..kernels import terms as _terms
from ..kernels import (
    LinearisePlan,
    PairPlan,
    band_factor,
    band_solve,
    chi_edges,
    damped_inverse,
    hpl_mtv_segment_sum,
    hpl_mv_segment_sum,
    linearise,
    make_linearise_plan,
    make_pair_plan,
    schur_pair_products,
    sym3x3_mv,
)
from ..models.ba import MODEL_REGISTRY, edge_state
from ..ops import components as C
from ..ops.lie import se3_exp, se3_update_left
from ..ops.robust import RobustKernelType, robust_derivative, robustify
from ..types import KIND_CODES, GraphArrays, PackedEdges, SystemBlocks
from ..utils import profiling as prof
from . import pcg as _pcg
from .segments import Segments, make_segments, segment_sum
from .staging import FLOATS, INTS, Slot, Staging, own
from .symbolic import SchurStructure, build_schur_structure, sort_triples

# widest band the band kernels take (bw + 1 <= MAX_BAND); a wider Hsc takes
# the dense solve below PCG_MIN_POSES poses and PCG from there
MAX_BAND = 48
# pose count from which a wide Hsc pattern is solved by PCG instead of the
# dense solve (the JAX package's constant of the same name)
PCG_MIN_POSES = 1024
# the band (``(Pa + SB) SB`` rows of 512 bytes) above which an f64 factor
# from PCG_MIN_POSES poses goes to PCG: the JAX package's VMEM budget for its
# band kernels (its solver/block_solver.py:2426), which decides there where
# the dense branch runs
DENSE_BAND_BYTES = 11 * 2**20
# the options the solver takes, and the torch type of each working dtype
DTYPES = {"float64": torch.float64, "float32": torch.float32}
PRECISIONS = ("mixed", "exact")

# -- structure cache ----------------------------------------------------------
#
# Re-optimising the same graph structure (identical edge index arrays) is the
# common production pattern: sliding-window SLAM re-packs the same topology
# every frame, and the reference sample re-runs initialize + optimize on one
# input.  The RCM order, the Schur pattern with its triples, the segment plans
# and the B3/B6 plans depend only on the index arrays and a few knobs
# (:meth:`BlockSolver._plan_knobs`), so they are kept here under a content
# digest of the index arrays, after the JAX package's ``_STRUCT_CACHE``.
# Cached values are never written: numpy arrays are read-only, and each
# solver takes the cached plan with its own edge index tensors and its own
# B5/B9 counters and scratch (:func:`_solver_plan`).
_STRUCT_CACHE: "OrderedDict[str, dict]" = OrderedDict()
_STRUCT_CACHE_MAX = 8
# plans one structure keeps, one a set of knobs (:meth:`BlockSolver._plan_knobs`:
# a CPU and a card solver of one graph, f64 and f32, "mixed" and "exact"),
# the least recently used going first
_PLANS_PER_STRUCTURE = 4
# plans reused (hits) and built (misses) by build_structure
_STRUCT_STATS = {"hits": 0, "misses": 0}
# fused loops one structure keeps for its next solves, one a
# ``solver/fused.py`` ``loop_key`` (two iteration counts, as local BA's
# ``optimize(5)`` then ``optimize(10)``), the least recently used going
# first; each holds its graphs, its system and a copy of the edge data on
# the device
_LOOPS_PER_STRUCTURE = 2
# the edge tensors a kept loop holds copies of and takes each solve's values
# into (:meth:`BlockSolver.load`); the index tensors are the structure's
LOOP_EDGE_DATA = ("meas", "omega", "cam", "both_free", "active", "mask3", "code")


def _drop_loops(bundle: dict) -> None:
    """A structure's kept loops go with its cache entry, though a solver
    still holds the entry."""
    bundle.pop("loops", None)


def clear_structure_cache() -> None:
    """Empty the structure cache and zero its hit and miss counts."""
    for b in _STRUCT_CACHE.values():
        _drop_loops(b)
    _STRUCT_CACHE.clear()
    _STRUCT_STATS.update(hits=0, misses=0)


def structure_cache_info() -> dict:
    """``{"hits", "misses", "size"}``: plans :meth:`BlockSolver.build_structure`
    reused and built since the last :func:`clear_structure_cache`, and the
    structures held."""
    return dict(_STRUCT_STATS, size=len(_STRUCT_CACHE))


def _struct_bundle(key: str) -> dict:
    """The cache entry of one structure digest, made empty on first use; the
    least recently used of more than ``_STRUCT_CACHE_MAX`` entries goes."""
    b = _STRUCT_CACHE.get(key)
    if b is None:
        b = {}
        _STRUCT_CACHE[key] = b
        while len(_STRUCT_CACHE) > _STRUCT_CACHE_MAX:
            _drop_loops(_STRUCT_CACHE.popitem(last=False)[1])
    else:
        _STRUCT_CACHE.move_to_end(key)
    return b


def _struct_digest(edge_specs, P, Pa, L, La) -> str:
    """Content digest of everything the host symbolic pipeline reads: the
    vertex counts and each edge set's kind and index arrays as the caller
    gave them (two graphs whose sets split the same edges otherwise do not
    share it).  An array is hashed as it comes, its dtype and shape with it
    (no int64 copy: half the bytes for int32 indices), by SHA-256, which the
    host CPU accelerates; a set without ``lm_idx`` hashes a marker."""
    h = hashlib.sha256(np.array([P, Pa, L, La], dtype=np.int64).tobytes())
    for sp in edge_specs:
        h.update(f"|{sp['kind']}|".encode())
        for key in ("pose_idx", "lm_idx"):
            if sp.get(key) is None:
                h.update(b"|-|")
                continue
            a = np.ascontiguousarray(sp[key])
            h.update(f"|{a.dtype.str}{a.shape}|".encode())
            h.update(a)
    return h.hexdigest()


def _frozen(a):
    """``a`` made read-only (a cached numpy array; None passes)."""
    if a is not None:
        a.setflags(write=False)
    return a


class EdgeSetMeta(NamedTuple):
    """Static info of one packed set: the model it runs, its robust kernel
    and its active edges.  A pack of several landmark sets (:func:`pack_kind`)
    has ``parts``: each set's own meta, with its kind, robust kernel and
    active edges, and the set's edges ``[start, stop)`` in the pack; the
    pack's ``rk`` is then 0 and ``nedges`` their sum."""

    kind: str
    rk: int  # RobustKernelType value
    delta: float
    nedges: int
    parts: tuple = ()  # ((EdgeSetMeta, start, stop), ...)


class BandMeta(NamedTuple):
    bw: int  # block bandwidth (max col - row over the Hsc pattern)
    sb: int  # band height: bw + 1 rounded up to a multiple of 8


def band_meta(blk_row: np.ndarray, blk_col: np.ndarray) -> BandMeta:
    """The band of a reduced-system block pattern (host arrays)."""
    bw = int(np.max(blk_col.astype(np.int64) - blk_row)) if blk_row.size else 0
    return BandMeta(bw=bw, sb=-(-(bw + 1) // 8) * 8)


def reduced_route(bw: int, Pa: int, target: torch.dtype) -> str:
    """How the reduced system of a structure is solved, decided once a
    structure:

    * ``"band"`` (kernels B7/B8) where the band fits ``MAX_BAND`` (``bw + 1
      <= 48``) and the factor's type ``target`` is f32;
    * ``"dense"`` (a Cholesky of the whole scaled matrix) under an f64
      factor (``"exact"``) where the JAX package keeps its dense branch:
      below ``PCG_MIN_POSES`` poses, or where the band fits ``MAX_BAND``
      and passes the JAX package's VMEM test ``(Pa + SB) SB 512 B <=
      DENSE_BAND_BYTES`` (SB as :func:`band_meta` rounds it: Pa up to 1392
      at SB 16, 672 at SB 32, 421 at SB 48); and for an f32 factor, for
      any wider pattern below ``PCG_MIN_POSES`` poses;
    * ``"pcg"`` (``solver/pcg.py``) for the rest: an f64 factor from
      ``PCG_MIN_POSES`` poses past the VMEM test, whose two ``[6 Pa, 6
      Pa]`` matrices would outgrow the card (~58 GB at Pa = 9999), and a
      wider pattern from ``PCG_MIN_POSES`` poses.

    Under an f32 factor the port keeps the band wherever it fits 48, past
    the VMEM test the JAX package also holds its band kernels to: kernels
    B7/B8 stream the band, on the card they are the faster solve, and an
    f32 band factor with two f64 rounds behind the ``1e-8 ||b||`` residual
    test is at least as exact as CG at ``1e-10``."""
    fits = bw + 1 <= MAX_BAND
    if fits and target == torch.float32:
        return "band"
    if Pa < PCG_MIN_POSES:
        return "dense"
    sb = -(-(bw + 1) // 8) * 8
    if target != torch.float32 and fits and (Pa + sb) * sb * 512 <= DENSE_BAND_BYTES:
        return "dense"
    return "pcg"


class SchurPlan(NamedTuple):
    """Device-side plan for the stages, constant per structure.  All but the
    edge index tensors (the solver's own) and B5/B9's counters and scratch
    come from the structure cache.  Without free landmarks (the pose-only
    solve, ``route == "pose_only"``) the Schur fields are None."""

    ba_pose_idx: Optional[torch.Tensor]  # [E] int64 of the landmark set
    ba_lm_idx: Optional[torch.Tensor]  # [E] int64
    blk_row: Optional[torch.Tensor]  # [nnz] int64 (sorted by row, then col)
    blk_col: Optional[torch.Tensor]  # [nnz]
    diag_pos: Optional[torch.Tensor]  # [Pa]
    # [T] int32 triples sorted by target block; on the card the very tensors
    # of pair_plan (no int64 copy)
    tri_ei: Optional[torch.Tensor]
    tri_ej: Optional[torch.Tensor]  # [T] int32
    tri_offsets: Optional[torch.Tensor]  # [nnz + 1] int64 CSR offsets of the triples
    pose_seg: Optional[Segments]  # the landmark set's edges -> poses
    lm_seg: Optional[Segments]  # its edges -> landmarks
    row_seg: Optional[Segments]  # Hsc blocks -> block rows
    col_seg: Optional[Segments]  # Hsc blocks -> block columns
    band: Optional[BandMeta]
    route: str  # "band", "dense", "pcg" (:func:`reduced_route`) or "pose_only"
    target: torch.dtype  # the reduced factor's type
    # what the CUDA kernels B3, B5, B9 and B6 walk; None on the CPU, where the
    # twins run
    lin_plan: Optional[LinearisePlan]  # tiles and chunks over pose_seg, lm_seg
    pair_plan: Optional[PairPlan]  # int32 triples and items
    pcg: Optional[_pcg.PcgPlan]  # the preconditioner's plan on the "pcg" route
    # every edge set's edges -> poses, in set order (the landmark set's is
    # pose_seg)
    set_segs: tuple = ()


def _solver_plan(cached: SchurPlan, packed: Optional[PackedEdges]) -> SchurPlan:
    """The cached plan of a structure for one solver: its own edge index
    tensors of the landmark set (``packed``, None without one) and, on the
    card, its own B5/B9 counters and scratch, so that no stage writes a
    cached tensor."""
    lin = cached.lin_plan
    if lin is not None:
        lin = lin._replace(count=torch.zeros_like(lin.count), scratch=torch.empty_like(lin.scratch))
    if packed is None:
        return cached
    return cached._replace(ba_pose_idx=packed.pose_idx, ba_lm_idx=packed.lm_idx, lin_plan=lin)


def make_schur_plan(
    set_idx: Sequence[tuple[np.ndarray, np.ndarray]], ba: Optional[int], Pa: int, La: int,
    device, target: torch.dtype, pattern=None, triples=None,
    ba_lm_idx: Optional[torch.Tensor] = None, route: Optional[str] = None,
) -> SchurPlan:
    """The device plan of a structure (the rest of stages "1: Build
    Structure" and "5: Symbolic Decomposition", after the symbolic pass),
    shared by :meth:`BlockSolver.build_structure` and a rank of the
    distributed path (``parallel/distributed.py``).

    ``set_idx``: each packed set's ``(pose_idx, lm_idx)`` on the host, ``ba``
    the landmark pack's position (None without one), whose ``La`` landmarks
    get their segment plan and, on the card, B3's plan.  ``pattern``: the
    reduced system's ``(blk_row, blk_col, diag_pos)`` (None without free
    landmarks: the pose-only solve); ``triples``: ``(tri_ei, tri_ej,
    offsets [nnz + 1])`` sorted by block, over the landmark pack's edges
    (a rank's own triples on the global pattern on the distributed path),
    with B6's plan over ``ba_lm_idx`` (the pack's landmark index on the
    device); ``route``: the reduced route, :func:`reduced_route` of the
    pattern's bandwidth and ``target`` (the reduced factor's type) by
    default."""
    dev = torch.device(device)
    set_segs = tuple(make_segments(pi, Pa, dev) for pi, _ in set_idx)
    pose_seg = lm_seg = lin_plan = None
    if ba is not None:
        pose_idx, lm_idx = set_idx[ba]
        pose_seg, lm_seg = set_segs[ba], make_segments(lm_idx, La, dev)
        if dev.type == "cuda":
            lin_plan = make_linearise_plan(pose_seg, lm_seg, pose_idx.shape[0])
    plan = SchurPlan(
        ba_pose_idx=None, ba_lm_idx=None, blk_row=None, blk_col=None, diag_pos=None,
        tri_ei=None, tri_ej=None, tri_offsets=None, pose_seg=pose_seg, lm_seg=lm_seg,
        row_seg=None, col_seg=None, band=None, route="pose_only", target=target,
        lin_plan=lin_plan, pair_plan=None, pcg=None, set_segs=set_segs,
    )
    if pattern is None:
        return plan
    blk_row, blk_col, diag_pos = pattern
    # banded Hsc in an f32 factor -> band kernels (B7/B8); else dense or, for
    # a wide pattern on many poses, PCG
    band = band_meta(blk_row, blk_col)
    route = route or reduced_route(band.bw, Pa, target)

    def up(a, dtype=np.int64):
        return torch.as_tensor(np.asarray(a, dtype=dtype), device=dev)

    # int32 triples: on the card make_pair_plan keeps these very tensors, so
    # no int64 copy of the ~1.7M triples stays beside them
    tri_ei, tri_ej, tri_off = triples
    tri_ei, tri_ej, tri_off = up(tri_ei, np.int32), up(tri_ej, np.int32), up(tri_off)
    return plan._replace(
        blk_row=up(blk_row),
        blk_col=up(blk_col),
        diag_pos=up(diag_pos),
        tri_ei=tri_ei,
        tri_ej=tri_ej,
        tri_offsets=tri_off,
        row_seg=make_segments(blk_row, Pa, dev),
        col_seg=make_segments(blk_col, Pa, dev),
        band=band,
        route=route,
        pair_plan=(make_pair_plan(ba_lm_idx, tri_ei, tri_ej, tri_off)
                   if dev.type == "cuda" else None),
        pcg=_pcg.build_pcg_plan(blk_row, blk_col, Pa, dev) if route == "pcg" else None,
    )


def _ids_to_indices(sets, ids) -> np.ndarray:
    """Vectorised vertex-id -> global-index lookup across several vertex
    sets (the global indices :meth:`BlockSolver.initialize` assigns).  Ids
    must be unique across the sets of one role."""
    pairs = [vs._ids_and_global_indices() for vs in sets]
    return lookup_ids(np.concatenate([a for a, _ in pairs]),
                      np.concatenate([b for _, b in pairs]), ids)


# the edge kinds a spec may name, and the model a pack of several landmark
# sets runs
SET_KINDS = ("mono", "stereo", "depth", "line", "plane")


def pack_kind(kinds: Sequence[str]) -> str:
    """The model of a pack of edge sets of ``kinds`` (B1/B3's
    instantiation): their one kind where they share it; ``"stereo"`` for
    mono beside stereo (the mono rows' third row masked, ``mask3``);
    ``"mixed"`` for depth beside either (a kind code an edge)."""
    kinds = set(kinds)
    if len(kinds) == 1:
        return kinds.pop()
    return "stereo" if kinds <= {"mono", "stereo"} else "mixed"


def _merges(edge_specs) -> bool:
    """Whether the edge sets merge into one masked stereo set: two or more
    mono and stereo sets under one robust kernel.  The mono residual and
    Jacobian are the stereo model's rows 0-1, so a per-edge third-component
    mask (``PackedEdges.mask3``) makes one stereo set equivalent to running
    both sets.  Sets under differing robust kernels stay sets of their own."""
    return (
        len(edge_specs) >= 2
        and all(s["kind"] in ("mono", "stereo") for s in edge_specs)
        and len({(s.get("rk", 0), s.get("delta", 1.0)) for s in edge_specs}) == 1
    )


def _merged_threshold(edge_specs, sizes) -> Optional[np.ndarray]:
    """The outlier threshold of merged sets: each set's, an edge, where some
    set has one above 0; else None."""
    thr = [np.asarray(s.get("outlier_threshold", 0.0), dtype=np.float64) for s in edge_specs]
    if not any(np.any(t > 0) for t in thr):
        return None
    return np.concatenate([np.broadcast_to(t, (E,)) for t, E in zip(thr, sizes)])


def _merge_ba_specs(edge_specs):
    """Mono+stereo edge specs merged into one masked stereo spec where they
    merge (:func:`_merges`), as host arrays (the distributed path's
    packing; the one-card solver merges on the device)."""
    if not _merges(edge_specs):
        return edge_specs

    meas_p, mask_p, omega_p, cam_p, pi_p, li_p, act_p = [], [], [], [], [], [], []
    for s in edge_specs:
        meas = np.asarray(s["meas"], dtype=np.float64)
        E = meas.shape[0]
        if s["kind"] == "mono":
            meas = np.concatenate([meas, np.zeros((E, 1))], axis=1)
            mask_p.append(np.zeros(E))
        else:
            mask_p.append(np.ones(E))
        meas_p.append(meas)
        omega_p.append(np.asarray(s["omega"], np.float64).reshape(-1))
        cam = np.asarray(s.get("cam", np.zeros(5)), dtype=np.float64)
        cam_p.append(cam.reshape(-1, 5))
        pi_p.append(np.asarray(s["pose_idx"]))
        li_p.append(np.asarray(s["lm_idx"]))
        act = s.get("active")
        act_p.append(np.ones(E) if act is None else np.asarray(act, dtype=np.float64))
    # uniform omega / camera stay one row
    sizes = tuple(m.shape[0] for m in meas_p)
    if all(o.size == 1 for o in omega_p) and all(
        np.array_equal(o, omega_p[0]) for o in omega_p[1:]
    ):
        omega = omega_p[0]
    else:
        omega = np.concatenate([np.broadcast_to(o, (E,)) for o, E in zip(omega_p, sizes)])
    if all(c.shape[0] == 1 for c in cam_p) and all(
        np.array_equal(c, cam_p[0]) for c in cam_p[1:]
    ):
        cam_m = cam_p[0]
    else:
        cam_m = np.concatenate([np.broadcast_to(c, (E, 5)) for c, E in zip(cam_p, sizes)])
    merged = dict(
        kind="stereo",
        meas=np.concatenate(meas_p, axis=0),
        pose_idx=np.concatenate(pi_p),
        lm_idx=np.concatenate(li_p),
        omega=omega,
        cam=cam_m,
        rk=edge_specs[0].get("rk", 0),
        delta=edge_specs[0].get("delta", 1.0),
        mask3=np.concatenate(mask_p),
        active=np.concatenate(act_p),
    )
    thr = _merged_threshold(edge_specs, sizes)
    if thr is not None:
        merged["outlier_threshold"] = thr
    merged["merged_sizes"] = sizes  # the un-merge map of update_edges
    return [merged]


class _StagedSet(NamedTuple):
    """One caller edge set as :meth:`BlockSolver._stage_set` staged it: its
    kind, edges and measurement rows, and a slot of the staging block for
    each array.  ``omega`` and ``cam`` hold one row where ``rows`` has it
    (every edge's is the same); ``one``: whether each came as one row;
    ``lm_idx`` None: landmark 0 for every edge; ``active`` None: every
    edge ``on``; ``nedges``: its active edges."""

    kind: str
    E: int
    K: int
    meas: Slot
    pose_idx: Slot
    lm_idx: Optional[Slot]
    omega: Slot
    cam: Slot
    rows: tuple  # (omega's one row or None, cam's one row or None), on the host
    one: tuple
    active: Optional[Slot]
    on: bool
    nedges: int


def _pack_row(sets: Sequence[_StagedSet], which: int) -> Optional[_StagedSet]:
    """The set whose one row of weight (``which`` 0) or camera (1) is the
    whole pack's, where every edge of the pack has the same, else None: the
    first set's where every set's came as one row and they are equal, else
    the first set with edges' where every set with edges has one row and
    they are equal (the sets' rows stacked and compared with ``==``)."""
    def same(group):
        r0 = group[0].rows[which]
        return r0 is not None and all(
            s.rows[which] is not None and np.array_equal(s.rows[which], r0) for s in group[1:])

    if all(s.one[which] for s in sets) and same(sets):
        return sets[0]
    live = [s for s in sets if s.E]
    return live[0] if live and same(live) else None


# ---------------------------------------------------------------------------
# pipeline stages
# ---------------------------------------------------------------------------


def robust_parts(meta: EdgeSetMeta) -> tuple:
    """``(rk, delta, slice)`` of each edge set of a pack: the pack's own, or
    each of its ``parts``."""
    if not meta.parts:
        return ((meta.rk, meta.delta, slice(None)),)
    return tuple((m.rk, m.delta, slice(a, b)) for m, a, b in meta.parts)


def is_robust(meta: EdgeSetMeta) -> bool:
    """Whether some set of the pack has a robust kernel (B3 then takes the
    weight rescaled by rho', from a B1 pass)."""
    return any(rk for rk, _, _ in robust_parts(meta))


def _by_set(meta: EdgeSetMeta, x: torch.Tensor, fn) -> torch.Tensor:
    """``fn(rk, delta, x)`` on each set's stretch of the per-edge ``x``, in
    set order (one call on the whole of ``x`` for a pack of one set)."""
    parts = robust_parts(meta)
    if len(parts) == 1:
        return fn(parts[0][0], parts[0][1], x)
    return torch.cat([fn(rk, delta, x[sl]) for rk, delta, sl in parts])


def robust_weight(data: PackedEdges, meta: EdgeSetMeta, x: torch.Tensor) -> torch.Tensor:
    """The weight ``[E]`` B3 takes: ``omega`` times each set's rho' of B1's
    per-edge ``x`` on that set's edges."""
    return data.omega * _by_set(meta, x, robust_derivative)


def set_chi(graph: GraphArrays, data: PackedEdges, meta: EdgeSetMeta) -> torch.Tensor:
    """Per-edge robustified chi2 ``[E]`` of one pack: for a landmark pack
    each set's rho on kernel B1's ``omega |e|^2`` over its edges (inert rows
    give 0, and rho(0) = 0), for an ICP set its model's chi."""
    model = MODEL_REGISTRY[meta.kind]
    if not model.HAS_LANDMARK:
        return model.chi(graph, data, meta.rk, meta.delta)
    return _by_set(meta, chi_edges(*edge_state(graph, data), data), robustify)


def compute_chi(graph: GraphArrays, packs: Sequence[PackedEdges],
                metas: Sequence[EdgeSetMeta]) -> torch.Tensor:
    """Total chi2 (reference stage "2: Compute Error"): every edge set's
    robustified chi summed, set after set (the sets of a landmark pack from
    one B1 launch)."""
    total = None
    for data, meta in zip(packs, metas):
        chi = set_chi(graph, data, meta)
        for _, _, sl in robust_parts(meta):
            total = chi[sl].sum() if total is None else total + chi[sl].sum()
    return total


def build_system(graph: GraphArrays, packs: Sequence[PackedEdges],
                 metas: Sequence[EdgeSetMeta], plan: SchurPlan) -> SystemBlocks:
    """Assemble Hpp/bp/Hll/bl and per-edge Hpl blocks (stage "3: Build
    System").  The landmark pack goes through kernel B3; contributions of
    fixed vertices drop out because their rows are not in the segment
    plans.  Under a robust kernel the weight is rescaled by rho'(x) before
    the quadratic form, as the reference does: x per edge from kernel B1,
    each set's rho' in plain tensor code, then B3 with the ``[E]`` weight.  An ICP
    set's per-edge pose stacks (plain torch) are summed per pose through
    its own segment plan and added, set after set.  Without free landmarks
    ``Hll``, ``bl`` and ``Hpl`` are None."""
    pose_acc = Hll = bl = Hpl = None
    for data, meta, seg in zip(packs, metas, plan.set_segs):
        model = MODEL_REGISTRY[meta.kind]
        if model.HAS_LANDMARK:
            state = edge_state(graph, data)
            if is_robust(meta):
                x = chi_edges(*state, data)
                data = data._replace(omega=robust_weight(data, meta, x))
            acc, lm_acc, hpl = linearise(
                *state, data, plan.pose_seg, plan.lm_seg, plan.lin_plan
            )  # [Pa, 42], [La, 12], [E, 18]
            if plan.route != "pose_only":
                Hll, bl, Hpl = lm_acc[:, :9], lm_acc[:, 9:], hpl
        else:
            acc = segment_sum(model.terms(graph, data, meta.rk, meta.delta)[0], seg)
        pose_acc = acc if pose_acc is None else pose_acc + acc
    Pa = pose_acc.shape[0]
    return SystemBlocks(
        Hpp=pose_acc[:, :36].reshape(Pa, 6, 6), bp=pose_acc[:, 36:], Hll=Hll, bl=bl, Hpl=Hpl,
    )


def max_diagonal(sys: SystemBlocks) -> torch.Tensor:
    """Max Hessian diagonal entry for the initial lambda (a 0-d tensor).
    The diagonals are strided views: no index tensor is made, so nothing
    is uploaded and a CUDA graph can capture it."""
    m = torch.diagonal(sys.Hpp, dim1=-2, dim2=-1).max()
    if sys.Hll is None:
        return m
    return torch.maximum(m, sys.Hll[:, 0::4].max())  # Hll entries 0, 4, 8


def as_lam(lam, ref: torch.Tensor) -> torch.Tensor:
    """The damping as the stages take it: a 0-d tensor of ``ref``'s dtype
    on its device.  A Python float (the host loop's) is filled in on the
    device, not copied from the host."""
    if isinstance(lam, torch.Tensor):
        return lam
    return torch.full((), lam, dtype=ref.dtype, device=ref.device)


def schur_terms(sys: SystemBlocks, lam: torch.Tensor, plan: SchurPlan, bp: torch.Tensor):
    """The kernels of the Schur stage on the plan's edges and triples:
    the damped landmark inverse and ``y = inv(Hll) bl`` (kernel B4),
    ``bp - sum Hpl y`` per pose (kernel B5; ``bp`` zero gives a rank's
    share ``-sum Hpl y`` on the distributed path) and the Schur pair
    products summed per block (kernel B6).  ``lam``: a 0-d tensor.  Returns
    ``(invHll [La, 9], bsc [Pa, 6], pairs [nnz, 36])``."""
    # bsc re-associates as Hpl (inv(Hll) bl), as on the kernel path of the
    # JAX package, so no per-edge W is materialised for it either
    invHll, y = damped_inverse(sys.Hll, sys.bl, lam)
    bsc = hpl_mv_segment_sum(sys.Hpl, y, plan.ba_lm_idx, bp, plan.pose_seg, plan.lin_plan)
    pairs = schur_pair_products(
        sys.Hpl, invHll, plan.ba_lm_idx, plan.tri_ei, plan.tri_ej, plan.tri_offsets,
        plan.pair_plan,
    )
    return invHll, bsc, pairs


def damp_blocks(blocks: torch.Tensor, Hpp: torch.Tensor, lam: torch.Tensor,
                plan: SchurPlan) -> torch.Tensor:
    """``blocks`` (the negated pair products) with ``Hpp + lam I`` added on
    the diagonal blocks, in place; returns ``blocks``."""
    Pa = Hpp.shape[0]
    Hpp_d = Hpp + lam * torch.eye(6, dtype=Hpp.dtype, device=Hpp.device)
    blocks[plan.diag_pos] = blocks[plan.diag_pos] + Hpp_d.reshape(Pa, 36)
    return blocks


def schur_reduce(
    sys: SystemBlocks, lam, plan: SchurPlan
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Stage "4: Schur Complement": damp, invert the Hll blocks (kernel
    B4), form ``bsc = bp - Hpl inv(Hll) bl`` (kernel B5) and the Hsc blocks
    ``(Hpp + lam I) - Hpl inv(Hll) Hpl^T`` on the symbolic block pattern
    (kernel B6) (:func:`schur_terms`, :func:`damp_blocks`).  ``lam``: a 0-d
    tensor on the system's device or a Python float.  Returns ``(blocks
    [nnz, 36], bsc [Pa, 6], invHll [La, 9])``."""
    lam = as_lam(lam, sys.bp)
    invHll, bsc, pairs = schur_terms(sys, lam, plan, sys.bp)
    return damp_blocks(-pairs, sys.Hpp, lam, plan), bsc, invHll


def scaled_blocks(blocks: torch.Tensor, bsc: torch.Tensor, plan: SchurPlan):
    """Symmetric Jacobi scaling of the reduced system in block form.
    Returns ``(bl_s, bv, s)``: the scaled blocks and right-hand side in the
    working type, and the scale vector.  In f32 the ``1e-300`` floor
    rounds to 0, as the JAX package's weak-typed constant does."""
    nnz = blocks.shape[0]
    brow, bcol = plan.blk_row, plan.blk_col
    # BA Hessian diagonals span many orders of magnitude (focal-length-
    # squared pixel terms vs unit-metric terms)
    diag = blocks[plan.diag_pos][:, 0::7]  # [Pa, 6]: entries 0, 7, ..., 35
    s = 1.0 / torch.sqrt(torch.clamp(diag, min=1e-300))
    bl_s = blocks * (s[brow][:, :, None] * s[bcol][:, None, :]).reshape(nnz, 36)
    return bl_s, bsc * s, s


def scaled_band(blocks: torch.Tensor, bsc: torch.Tensor, plan: SchurPlan):
    """The scaled reduced system (:func:`scaled_blocks`) and its f32
    block-row band.  Returns ``(band, bl_s, bv, s)``: the band, the scaled
    blocks and right-hand side in the working type, and the scale vector."""
    Pa, SB = bsc.shape[0], plan.band.sb
    bl_s, bv, s = scaled_blocks(blocks, bsc, plan)
    band = torch.zeros(((Pa + SB) * SB, 36), dtype=torch.float32, device=blocks.device)
    band[plan.blk_row * SB + (plan.blk_col - plan.blk_row)] = bl_s.to(torch.float32)
    return band, bl_s, bv, s


def block_matvec(bl_s: torch.Tensor, plan: SchurPlan):
    """The symmetric block SpMV ``y = A x`` of the scaled upper-triangle
    blocks ``bl_s`` on the plan's pattern (``x``, ``y``: ``[Pa, 6]``):
    fixed-order row and column segment sums, no float atomics."""
    brow, bcol = plan.blk_row, plan.blk_col
    bl_s_off = bl_s * (brow != bcol).to(bl_s.dtype)[:, None]

    def matvec(xv):
        y = segment_sum(C.flat_mv_6x6(bl_s, xv[bcol]), plan.row_seg)
        return y + segment_sum(C.flat_mtv_6x6(bl_s_off, xv[brow]), plan.col_seg)

    return matvec


def _refined(tri_solve, bl_s, bv, s, plan: SchurPlan, factored=None):
    """``solver_precision="mixed"`` at f64 behind an f32 factor: exactly two
    f64 refinement rounds against the scaled f64 blocks, then success only
    for a refined residual below ``1e-8 ||b||`` and a finite result (and a
    factor that completed: ``factored``, a 0-d bool, where the factor
    reports it), as in the JAX package: an f64 factor here would accept
    steps the reference rejects."""
    matvec = block_matvec(bl_s, plan)  # in the scaled space, f64
    x = tri_solve(bv)
    # two rounds suffice for LM-damped, Jacobi-scaled systems; the residual
    # check below rejects any solve they do not converge
    for _ in range(2):
        x = x + tri_solve(bv - matvec(x))

    res = torch.linalg.vector_norm(bv - matvec(x))
    ok = torch.isfinite(res) & (res <= 1e-8 * (torch.linalg.vector_norm(bv) + 1e-300))
    xp = x * s
    ok = ok & torch.all(torch.isfinite(xp))
    return xp, ok if factored is None else ok & factored


def solve_reduced_band(
    blocks: torch.Tensor, bsc: torch.Tensor, plan: SchurPlan
) -> tuple[torch.Tensor, torch.Tensor]:
    """Solve ``Hsc xp = bsc`` (stage "6: Numerical Decomposition") on the
    band route: symmetric Jacobi scaling, the f32 band factor and solves
    (kernels B7/B8).  Under ``"mixed"`` at f64, two f64 refinement rounds
    and the residual test follow (:func:`_refined`); in f32 the one solve
    is the step, taken where it is finite (the JAX package's direct solve
    in the working type)."""
    Pa = bsc.shape[0]
    dtype = blocks.dtype
    SB, bw = plan.band.sb, plan.band.bw

    band, bl_s, bv, s = scaled_band(blocks, bsc, plan)
    Lb = band_factor(band, Pa, SB)

    def tri_solve(r):
        return band_solve(Lb, r.to(torch.float32), Pa, SB, bw).to(dtype)

    if dtype == torch.float32:
        x = tri_solve(bv)
        return x * s, torch.all(torch.isfinite(x))
    return _refined(tri_solve, bl_s, bv, s, plan)


def dense_scaled(bl_s: torch.Tensor, plan: SchurPlan, dtype: torch.dtype) -> torch.Tensor:
    """The scaled reduced matrix ``[6 Pa, 6 Pa]`` in ``dtype``: each block
    at ``(brow, bcol)`` and the transpose of each off-diagonal block at
    ``(bcol, brow)``, written block-flat and then laid out by one
    reshape-transpose, as the JAX package's dense branch builds it (the
    pattern's blocks are distinct, so writing is its sum with zeros)."""
    Pa = plan.diag_pos.shape[0]
    nnz = bl_s.shape[0]
    brow, bcol = plan.blk_row, plan.blk_col
    vals = bl_s.to(dtype)
    off = brow != bcol
    mirror = vals.reshape(nnz, 6, 6).transpose(-1, -2).reshape(nnz, 36)
    flat = torch.zeros((Pa * Pa, 36), dtype=dtype, device=bl_s.device)
    flat[brow * Pa + bcol] = vals
    flat[bcol * Pa + brow] = torch.where(off[:, None], mirror, flat[bcol * Pa + brow])
    return flat.reshape(Pa, Pa, 6, 6).permute(0, 2, 1, 3).reshape(Pa * 6, Pa * 6)


def solve_reduced_dense(
    blocks: torch.Tensor, bsc: torch.Tensor, plan: SchurPlan
) -> tuple[torch.Tensor, torch.Tensor]:
    """Solve ``Hsc xp = bsc`` on the dense route (the dense branch of the
    JAX package's ``_solve_reduced_blocks``), in plain torch: the Jacobi-
    scaled matrix (:func:`dense_scaled`) factored by ``cholesky_ex`` in the
    plan's target type and solved by two triangular solves.  Where the
    target is the working type (``"exact"``, or f32 mode) the one solve is
    the step; under ``"mixed"`` at f64 the f32 factor is followed by two
    f64 refinement rounds and the residual test (:func:`_refined`).  A
    matrix that is not positive definite gives ``info > 0``, folded into
    the verdict on the device: nothing is read back and nothing raises, so
    the LM loop re-damps as the JAX package does on its factor's NaNs."""
    dtype, target = blocks.dtype, plan.target
    Pa = bsc.shape[0]
    bl_s, bv, s = scaled_blocks(blocks, bsc, plan)
    L, info = torch.linalg.cholesky_ex(dense_scaled(bl_s, plan, target))
    factored = info == 0

    def tri_solve(r):
        y = torch.linalg.solve_triangular(L, r.reshape(-1, 1).to(target), upper=False)
        x = torch.linalg.solve_triangular(L.mT, y, upper=True)
        return x.to(dtype).reshape(Pa, 6)

    if target == dtype:
        x = tri_solve(bv)
        return x * s, torch.all(torch.isfinite(x)) & factored
    return _refined(tri_solve, bl_s, bv, s, plan, factored)


def solve_reduced_pcg(
    blocks: torch.Tensor, bsc: torch.Tensor, plan: SchurPlan, runner=None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Solve ``Hsc xp = bsc`` on the PCG route (the JAX package's
    ``solve_blocks_pcg``): symmetric Jacobi scaling in block form, then
    preconditioned CG on the scaled blocks through :func:`block_matvec`
    (``solver/pcg.py``); success only for a converged, finite result, so an
    unconverged CG is a rejected trial.  ``runner``: what runs the CG
    blocks (``pcg.CgRunner``; the fused loop's capture takes its place)."""
    bl_s, bv, s = scaled_blocks(blocks, bsc, plan)
    return _pcg.solve_blocks_pcg(bl_s, bv, s, block_matvec(bl_s, plan), bsc.shape[0], plan.pcg,
                                 runner)


def solve_reduced(
    blocks: torch.Tensor, bsc: torch.Tensor, plan: SchurPlan, runner=None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Stage "6: Numerical Decomposition" by the structure's route:
    ``(xp [Pa, 6], success)``, both on the device.  ``runner``: the PCG
    route's block runner."""
    if plan.route == "band":
        return solve_reduced_band(blocks, bsc, plan)
    if plan.route == "pcg":
        return solve_reduced_pcg(blocks, bsc, plan, runner)
    return solve_reduced_dense(blocks, bsc, plan)


def solve_pose_only(sys: SystemBlocks, lam) -> tuple[torch.Tensor, torch.Tensor]:
    """The pose-only solve (no free landmarks): ``Hpp`` is block-diagonal,
    so each damped 6x6 block is solved on its own by a batched
    ``cholesky_ex`` and two triangular solves, the same solution as a
    factor of the whole matrix.  A block that is not positive definite
    gives ``info > 0``, folded into the verdict on the device with the
    finiteness of ``xp``, as the JAX package's NaN factor makes its
    verdict False.  ``lam``: a 0-d tensor or a Python float."""
    lam = as_lam(lam, sys.bp)
    Hpp_d = sys.Hpp + lam * torch.eye(6, dtype=sys.bp.dtype, device=sys.bp.device)
    L, info = torch.linalg.cholesky_ex(Hpp_d)
    z = torch.linalg.solve_triangular(L, sys.bp[..., None], upper=False)
    xp = torch.linalg.solve_triangular(L.mT, z, upper=True)[..., 0]
    return xp, torch.all(torch.isfinite(xp)) & torch.all(info == 0)


def schur_back_substitute(
    sys: SystemBlocks, invHll: torch.Tensor, xp: torch.Tensor, plan: SchurPlan
) -> torch.Tensor:
    """Landmark back-substitution ``xl = inv(Hll)(bl - Hpl^T xp)``: the
    bracket through kernel B9, the product through kernel B10."""
    cl = hpl_mtv_segment_sum(sys.Hpl, xp, plan.ba_pose_idx, sys.bl, plan.lm_seg, plan.lin_plan)
    return sym3x3_mv(invHll, cl)


def apply_update(graph: GraphArrays, xp: torch.Tensor, xl: Optional[torch.Tensor]) -> GraphArrays:
    """SE3-exp left-compose pose update + additive landmark update (stage
    "7: Update Solution"); ``xl`` None (the pose-only solve) leaves the
    landmarks as they are."""
    Pa = xp.shape[0]
    dq, dt = se3_exp(xp)
    q_new, t_new = se3_update_left(dq, dt, graph.q[:Pa], graph.t[:Pa])
    Xw = graph.Xw
    if xl is not None:
        Xw = torch.cat([Xw[: xl.shape[0]] + xl, Xw[xl.shape[0]:]], dim=0)
    return GraphArrays(
        q=torch.cat([q_new, graph.q[Pa:]], dim=0), t=torch.cat([t_new, graph.t[Pa:]], dim=0), Xw=Xw,
    )


def landmark_scale(xl: torch.Tensor, bl: torch.Tensor, lam) -> torch.Tensor:
    """The landmark term of the gain-ratio denominator, ``sum xl (lam xl +
    bl)``."""
    return torch.sum(xl * (lam * xl + bl))


def compute_scale(xp: torch.Tensor, xl: Optional[torch.Tensor], sys: SystemBlocks,
                  lam) -> torch.Tensor:
    """LM gain-ratio denominator ``sum x (lam x + b)`` (``lam``: a 0-d
    tensor on the device or a Python float; ``xl`` None: no landmark
    term)."""
    scale = torch.sum(xp * (lam * xp + sys.bp))
    if xl is None:
        return scale
    return scale + landmark_scale(xl, sys.bl, lam)


# ---------------------------------------------------------------------------
# host orchestration
# ---------------------------------------------------------------------------


class BlockSolver:
    """Owns the packed device arrays, the symbolic structure and the plan."""

    def __init__(self, options, device):
        if options.dtype not in DTYPES:
            raise ValueError(f"unknown dtype {options.dtype!r} (one of {sorted(DTYPES)})")
        if options.solver_precision not in PRECISIONS:
            raise ValueError(
                f"unknown solver_precision {options.solver_precision!r} (one of {PRECISIONS})"
            )
        self.options = options
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device='cuda' requested but no CUDA device is available")
        self.dtype = DTYPES[options.dtype]
        # an f32 factor with f64 refinement: only where the working type is f64
        self.mixed = options.solver_precision == "mixed" and self.dtype == torch.float64
        self.graph: Optional[GraphArrays] = None
        # every packed set and its meta: the landmark pack (every set with
        # landmarks, concatenated) where its first set stands, each ICP set
        # where it stands; ``ba``: the landmark pack's position, None
        # without one; ``_pack_specs``: the edge specs (after the mono+stereo
        # merge) each pack holds
        self.packs: tuple[PackedEdges, ...] = ()
        self.metas: tuple[EdgeSetMeta, ...] = ()
        self.ba: Optional[int] = None
        self._pack_specs: list[tuple[int, ...]] = []
        self.P = self.Pa = self.L = self.La = 0
        self.schur: Optional[SchurStructure] = None
        self.plan: Optional[SchurPlan] = None
        self.pose_perm = None  # RCM pose order; None = identity
        # the ms of the last build_structure()'s symbolic pass (its span
        # "structure/symbolic"); 0 on a cache hit
        self.symbolic_ms = 0.0
        # host-clock ms of packing, the structure pass and the loop by span
        # name (utils/profiling.py), from the last packing on
        self.spans = prof.Spans()
        # each pack's (pose_idx, lm_idx) as packed, read back on the host
        # where first asked for (:attr:`_host_idx`)
        self._host_idx_read: Optional[list] = None
        # the last packing's staging block: its bytes, host-to-device copies
        # and whether it was a new pinned allocation (``Staging.stats``)
        self.pack_stats: Optional[dict] = None
        self._struct_bundle: Optional[dict] = None  # this structure's cache entry
        self._digest: Optional[str] = None  # its key
        # whether the last build_structure() found its plan in the cache
        self.structure_hit = False
        # runs the PCG route's CG blocks: iterations of every solve and host
        # reads (the fused loop's capture takes its place while it captures)
        self.cg = _pcg.CgRunner()
        # the stage timer of profile mode (``utils/profiling.py StageTimer``),
        # set by the optimiser around a host-loop run alone: each stage is then
        # timed and ends in a device synchronise
        self.timer: Optional[prof.StageTimer] = None
        # outliers: each edge spec's threshold (a scalar, or per edge for a
        # merged set), its sizes before a merge, and the last update_edges'
        # deactivations per spec
        self._spec_thresholds: list = []
        self._merged_sizes: list = []
        self._outlier_counts: list[int] = []
        # the object graph packed by initialize(): finalize() writes back into
        # these vertex sets; an array problem leaves them empty
        self._pose_sets: list = []
        self._lm_sets: list = []
        self._edge_sets: list[EdgeSet] = []
        # global active pose and landmark counts while the specs are made
        self._obj_Pa = self._obj_La = 0

    # -- packing ------------------------------------------------------------

    def initialize(self, edge_sets: Sequence[EdgeSet], vertex_sets) -> None:
        """Pack an object graph into device state (stage "0: Initialize")
        through :meth:`initialize_from_arrays`, so that it runs the array
        path's packing, ordering, merging, kernels and loops.

        Any number of pose and landmark vertex sets is taken: the sets of one
        role share one global table, indexed active first across the sets
        (every set's active vertices, then every set's fixed ones), and each
        vertex's ``index`` becomes its global index."""
        pose_sets = [v for v in vertex_sets if not v.is_marginilised()]
        lm_sets = [v for v in vertex_sets if v.is_marginilised()]
        if not pose_sets:
            raise ValueError("BlockSolver requires at least one pose vertex set")
        live_sets = [es for es in edge_sets if es.nedges() > 0]

        def reindex(sets):
            """Global active-first indices over several sets (object and
            bulk vertices); returns the active and total counts."""
            for vs in sets:
                vs.generate_estimate_data()
            acts = [vs.get_active_size() for vs in sets]
            tots = [vs.total_size() for vs in sets]
            na = sum(acts)
            act_off, fix_off = 0, na
            for vs, a, tot in zip(sets, acts, tots):
                gmap = np.empty(tot, dtype=np.int64)
                gmap[:a] = act_off + np.arange(a)
                gmap[a:] = fix_off + np.arange(tot - a)
                vs.assign_global_indices(gmap)
                act_off += a
                fix_off += tot - a
            return na, sum(tots)

        Pa, P = reindex(pose_sets)
        q = np.empty((P, 4), dtype=np.float64)
        t = np.empty((P, 3), dtype=np.float64)
        for vs in pose_sets:
            q[vs._gmap], t[vs._gmap] = vs.estimates_array()  # per-set order
        La, L = reindex(lm_sets) if lm_sets else (0, 0)
        Xw = np.empty((L, 3), dtype=np.float64)
        for vs in lm_sets:
            Xw[vs._gmap] = vs.estimates_array()

        # _spec_from_edge_set reads the sets for the bulk edges' id lookups
        self._pose_sets, self._lm_sets = pose_sets, lm_sets
        self._obj_Pa, self._obj_La = Pa, La
        specs = [self._spec_from_edge_set(es) for es in live_sets]
        self.initialize_from_arrays(
            pose_q=q, pose_t=t, num_active_poses=Pa,
            landmarks=Xw, num_active_landmarks=La, edge_specs=specs,
        )
        # initialize_from_arrays forgets any object graph: keep this one's
        # sets for update_edges() and finalize()
        self._pose_sets, self._lm_sets, self._edge_sets = pose_sets, lm_sets, live_sets

    def _spec_from_edge_set(self, es: EdgeSet) -> dict:
        """The array spec of one object edge set (the packing of
        :meth:`initialize`).  Edge objects are read in one pass a field;
        ``add_edges_bulk`` arrays pass through a vectorised id lookup.
        Edges whose vertices are all fixed are masked inactive here, and
        ``es._active_edge_size`` counts the others."""
        opts = self.options
        edges = es.edges
        E_obj = len(edges)
        if es.KIND in ("mono", "stereo", "depth"):
            K = es.MDIM
            try:  # one C-level conversion of the whole list
                meas_obj = np.array([e.measurement for e in edges], dtype=np.float64)
                meas_obj = meas_obj.reshape(E_obj, K)
            except (ValueError, TypeError):  # ragged shapes, e.g. (K, 1) beside (K,)
                meas_obj = np.zeros((E_obj, K), dtype=np.float64)
                for i, e in enumerate(edges):
                    meas_obj[i] = np.asarray(e.measurement, dtype=np.float64).reshape(K)
        else:
            K = 10 if es.KIND == "line" else 7
            vecs = [e.measurement.to_vec() for e in edges]
            meas_obj = np.stack(vecs, axis=0) if vecs else np.zeros((0, K))

        info_obj = np.fromiter((e.information for e in edges), np.float64, E_obj)
        # per-edge information under the global-information mode would be
        # ignored, and a zero global weight zeroes the whole system
        if (E_obj > 0 and not opts.per_edge_information and es.information == 0.0
                and np.any(info_obj != 0.0)):
            raise ValueError(
                f"{es.KIND} edge set: edges carry non-zero information but the "
                "edge set's global information is 0 and "
                "GraphOptimisationOptions.per_edge_information is False; either "
                "call edge_set.set_information(...) or enable per-edge "
                "information in the options"
            )
        # a camera an edge where edges carry one (the others take the set's),
        # packed as [5, E] unless every edge's is the same
        cam = global_cam = es.camera.to_vec()
        if opts.per_edge_camera and any(e.camera is not None for e in edges):
            cam = np.broadcast_to(global_cam, (E_obj, 5)).copy()
            for i, e in enumerate(edges):
                if e.camera is not None:
                    cam[i] = e.camera.to_vec()

        pose_idx = np.fromiter((e.vertices[0].index for e in edges), np.int64, E_obj)
        if es.NVERTS == 2:
            lm_idx = np.fromiter((e.vertices[1].index for e in edges), np.int64, E_obj)
        else:
            lm_idx = np.zeros(E_obj, dtype=np.int64)
        omega = info_obj if opts.per_edge_information else np.full(E_obj, es.information)
        active = np.fromiter((e.is_active for e in edges), np.bool_, E_obj).astype(np.float64)

        b = es._bulk
        if b is not None and b["meas"].shape[0]:
            Eb = b["meas"].shape[0]
            pib = _ids_to_indices(self._pose_sets, b["pose_id"])
            lib = (
                _ids_to_indices(self._lm_sets, b["lm_id"])
                if es.NVERTS == 2 and self._lm_sets
                else np.zeros(Eb, dtype=np.int64)
            )
            ob = (
                b["info"]
                if opts.per_edge_information and b["info"] is not None
                else np.full(Eb, es.information)
            )
            # NaN rows: batches added without information take the edge
            # set's global value now, at packing
            ob = np.where(np.isnan(ob), es.information, ob)
            meas_obj = np.concatenate([meas_obj, b["meas"]], axis=0)
            pose_idx = np.concatenate([pose_idx, pib])
            lm_idx = np.concatenate([lm_idx, lib])
            omega = np.concatenate([omega, ob])
            active = np.concatenate([active, b["active"].astype(np.float64)])
            if cam.ndim == 2:  # bulk rows take the set's camera
                cam = np.concatenate([cam, np.broadcast_to(global_cam, (Eb, 5))], axis=0)

        # edges whose vertices are all fixed contribute nothing: masked
        # (global active counts across every vertex set)
        all_fixed = pose_idx >= self._obj_Pa
        if es.NVERTS == 2:
            all_fixed &= lm_idx >= self._obj_La
        active = np.where(all_fixed, 0.0, active)
        es._active_edge_size = int(np.sum(~all_fixed))

        return dict(
            kind=es.KIND,
            meas=meas_obj,
            pose_idx=pose_idx,
            lm_idx=lm_idx,
            omega=omega,
            cam=cam,
            rk=int(es.robust_kernel_type),
            delta=float(es.robust_delta),
            active=active,
            outlier_threshold=float(es.outlier_threshold),
        )

    def initialize_from_arrays(
        self,
        pose_q: np.ndarray,
        pose_t: np.ndarray,
        num_active_poses: int,
        landmarks: np.ndarray,
        num_active_landmarks: int,
        edge_specs: Sequence[dict],
    ) -> None:
        """Pack array inputs into device state (stage "0: Initialize").

        Each ``edge_spec`` dict has keys ``kind, meas [E,K], pose_idx [E],
        lm_idx [E], omega [E], cam ([5] or [E,5])`` and optional ``rk``
        (a ``RobustKernelType`` value), ``delta, active,
        outlier_threshold`` (a scalar, or ``[E]``).  ``kind`` is
        ``"mono"``, ``"stereo"``, ``"depth"`` (``[u, v, 1/z]``), or a
        pose-only ICP kind, ``"line"`` or ``"plane"`` (``lm_idx`` may be
        left out).  Vertices are active-first: the first ``num_active_*``
        rows are free, the rest fixed.  A mono and a stereo set under one
        robust kernel merge into one masked stereo set (:func:`_merges`);
        the sets with landmarks are packed as one (:meth:`_pack`), each ICP
        set on its own, in the order given, and edges in the order given.
        An object graph packed before is forgotten: ``finalize`` writes
        nothing back.

        The host checks each set and copies each array once, in its own
        dtype, into one staging block (``solver/staging.py``), which goes
        to the device in one copy; the merge, the padding, the RCM
        renaming, the masks and the casts to the working type run there.
        The caller's arrays are not read after this returns.  The spans
        start anew (:attr:`spans`): ``pack/arrays`` (the host's checks and
        its copies into the block), ``pack/upload`` (the block's copy and
        the pack on the device, up to its last enqueue), and the structure
        layer's ``structure/digest`` and ``structure/order`` (the RCM
        order, on a cache miss), which run here.  :attr:`pack_stats`: the
        block's bytes, its host-to-device copies and whether it was a new
        pinned allocation."""
        spans = self.spans
        spans.clear()
        self._pose_sets, self._lm_sets, self._edge_sets = [], [], []
        self._host_idx_read = None
        staging = Staging(self.device)
        with spans.span("pack/arrays"):
            if not edge_specs:
                raise ValueError("the graph has no edges")
            for spec in edge_specs:
                if spec["kind"] not in SET_KINDS:
                    raise ValueError(f"unknown edge kind {spec['kind']!r} (one of {SET_KINDS})")
                if int(spec.get("rk", 0)) not in tuple(RobustKernelType):
                    raise ValueError(f"unknown robust kernel rk={spec.get('rk')}")
            self.P = pose_q.shape[0]
            self.Pa = int(num_active_poses)
            self.L = landmarks.shape[0]
            self.La = int(num_active_landmarks)
            sets = [self._stage_set(staging, spec) for spec in edge_specs]
            state = [staging.add(own(a, FLOATS, np.float64)) for a in (pose_q, pose_t)]
            state.append(staging.add(own(landmarks, FLOATS, np.float64).reshape(-1, 3)))
            # the logical sets, (kind, rk, delta, their staged sets): merged
            # mono and stereo sets are one
            if _merges(edge_specs):
                s0 = edge_specs[0]
                logical = [("stereo", int(s0.get("rk", 0)), float(s0.get("delta", 1.0)), sets)]
                sizes = tuple(s.E for s in sets)
                thr = _merged_threshold(edge_specs, sizes)
                self._spec_thresholds = [0.0 if thr is None else thr]
                self._merged_sizes = [sizes]
            else:
                logical = [(sp["kind"], int(sp.get("rk", 0)), float(sp.get("delta", 1.0)), [s])
                           for sp, s in zip(edge_specs, sets)]
                self._spec_thresholds = [sp.get("outlier_threshold", 0.0) for sp in edge_specs]
                self._merged_sizes = [None] * len(edge_specs)
            has_lm = [MODEL_REGISTRY[kind].HAS_LANDMARK for kind, *_ in logical]

        # the structure's cache entry, keyed on the index arrays as given
        with spans.span("structure/digest"):
            digest = _struct_digest(edge_specs, self.P, self.Pa, self.L, self.La)
        self._struct_bundle = bundle = _struct_bundle(digest)
        self._digest = digest
        # bandwidth-reducing pose ordering over every set's edges, applied as
        # in the JAX package (trajectory graphs keep the identity order):
        # where every set has landmarks and some landmark is free
        self.pose_perm = perm = None
        if self.La > 0 and all(has_lm):
            if "pose_perm" not in bundle:
                from .ordering import plan_pose_order

                with spans.span("structure/order"):
                    bundle["pose_perm"] = _frozen(plan_pose_order(
                        np.concatenate([np.asarray(sp["pose_idx"], np.int64) for sp in edge_specs]),
                        np.concatenate([np.asarray(sp["lm_idx"], np.int64) for sp in edge_specs]),
                        self.Pa, self.La)[0])
            self.pose_perm = perm = bundle["pose_perm"]
        with spans.span("pack/arrays"):
            # every pose's old index at its new position, and its new index
            maps = None
            if perm is not None:  # perm[i] = old pose at new position i
                order = np.concatenate([perm, np.arange(self.Pa, self.P)])
                new_of_old = np.empty(self.P, dtype=np.int64)
                new_of_old[order] = np.arange(self.P)
                maps = (staging.add(order), staging.add(new_of_old))
            staging.stage()

        # one pack of every landmark set, in set order, where the first of
        # them stands; each ICP set a pack of its own
        lm_sets = [i for i, h in enumerate(has_lm) if h]
        groups = []
        for i, h in enumerate(has_lm):
            if not h:
                groups.append([i])
            elif i == lm_sets[0]:
                self.ba = len(groups)
                groups.append(lm_sets)
        if not lm_sets:
            self.ba = None
        self._outlier_counts = []
        self._pack_specs = [tuple(m) for m in groups]
        dt = self.dtype
        with spans.span("pack/upload"):
            buf = staging.upload()
            q, t, Xw = (Staging.view(buf, s) for s in state)
            new_of_old = None
            if maps is not None:
                order, new_of_old = (Staging.view(buf, m) for m in maps)
                q, t = q.index_select(0, order), t.index_select(0, order)
            self.graph = GraphArrays(q=q.to(dt, copy=True), t=t.to(dt, copy=True),
                                     Xw=Xw.to(dt, copy=True))
            packs, metas = zip(*(self._pack(buf, [logical[i] for i in m], new_of_old)
                                 for m in groups))
        self.packs, self.metas = tuple(packs), tuple(metas)
        self.pack_stats = staging.stats
        self.schur = None
        self.plan = None

    def _stage_set(self, staging: Staging, spec: dict) -> _StagedSet:
        """One caller edge set checked and given its slots in ``staging``:
        its vertex indices within the graph (else ``ValueError``), its
        weight and camera one row where every edge has the same, and its
        active edges counted."""
        kind = spec["kind"]
        meas = own(spec["meas"], FLOATS, np.float64)
        E = meas.shape[0]
        pose_idx = own(spec["pose_idx"], INTS, np.int64)
        lm_idx = None if spec.get("lm_idx") is None else own(spec["lm_idx"], INTS, np.int64)
        # a set without lm_idx names landmark 0
        if E and (pose_idx.min() < 0 or pose_idx.max() >= self.P or (
                MODEL_REGISTRY[kind].HAS_LANDMARK and (
                    self.L <= 0 if lm_idx is None else lm_idx.min() < 0 or lm_idx.max() >= self.L))):
            raise ValueError(f"{kind} edges name a vertex outside the graph's "
                             f"{self.P} poses and {self.L} landmarks")
        omega = own(spec["omega"], FLOATS, np.float64).reshape(-1)
        cam = own(spec.get("cam", np.zeros(5)), FLOATS, np.float64).reshape(-1, 5)
        rows = tuple(a if a.shape[0] == 1 else a[:1] if E and np.all(a == a[0]) else None
                     for a in (omega, cam))
        active, on, nedges = spec.get("active"), True, E
        if active is not None:
            active = own(active, FLOATS, np.float64)
            if active.size == 1 and active.ndim <= 1:  # one value for every edge
                on, active = bool(active.reshape(-1)[0] > 0), None
                nedges = E if on else 0
            else:
                nedges = int(np.count_nonzero(active > 0))
        return _StagedSet(
            kind=kind, E=E, K=meas.shape[1], meas=staging.add(meas),
            pose_idx=staging.add(pose_idx),
            lm_idx=None if lm_idx is None else staging.add(lm_idx),
            omega=staging.add(omega if rows[0] is None else rows[0]),
            cam=staging.add(cam if rows[1] is None else rows[1]),
            rows=rows, one=(omega.shape[0] == 1, cam.shape[0] == 1),
            active=None if active is None else staging.add(active), on=on, nedges=nedges,
        )

    def _pack(self, buf: torch.Tensor, members: list, new_of_old: Optional[torch.Tensor]) -> tuple:
        """One packed set of ``members``, logical sets ``(kind, rk, delta,
        staged sets)`` (one edge set, a merged pair, or several landmark
        sets concatenated in their order), built on the device from the
        uploaded block ``buf``: ``(PackedEdges, EdgeSetMeta)``.
        ``new_of_old``: the RCM renaming of every pose on the device, None
        for the identity.  A uniform weight packs as ``[1]`` and a uniform
        camera as ``[5, 1]`` (:func:`_pack_row`), whatever shape they came
        in; several sets' model is :func:`pack_kind`'s, a mono set's
        measurement padded with a zero third row where the pack's rows are
        three.  Every tensor is the pack's own, none a view of ``buf``."""
        dev, dt = self.device, self.dtype
        kind = pack_kind([k for k, *_ in members])
        sets = [s for *_, ss in members for s in ss]
        # the model's residual rows, or an ICP set's wider measurement
        rows = max([MODEL_REGISTRY[kind].MDIM] + [s.K for s in sets])
        E = sum(s.E for s in sets)
        fl = dict(dtype=dt, device=dev)
        meas = (torch.zeros if any(s.K < rows for s in sets) else torch.empty)((rows, E), **fl)
        pose_idx = torch.empty(E, dtype=torch.int64, device=dev)
        lm_idx = torch.empty(E, dtype=torch.int64, device=dev)
        active = torch.empty(E, **fl)
        # the per-edge kind: a code where depth rows stand beside others, the
        # third-row mask where mono rows stand beside stereo ones (or in a
        # merged set)
        code = torch.empty(E, dtype=torch.uint8, device=dev) if kind == "mixed" else None
        mask3 = None
        if kind == "stereo" and (len(sets) > len(members) or any(s.kind == "mono" for s in sets)):
            mask3 = torch.empty(E, **fl)
        one = [_pack_row(sets, w) for w in (0, 1)]
        omega = (Staging.view(buf, one[0].omega).to(dt, copy=True) if one[0]
                 else torch.empty(E, **fl))
        cam = (Staging.view(buf, one[1].cam).reshape(5).to(dt, copy=True).reshape(5, 1)
               if one[1] else torch.empty((5, E), **fl))
        a = 0
        for s in sets:
            b = a + s.E
            meas[:s.K, a:b].copy_(Staging.view(buf, s.meas).t())
            pose_idx[a:b].copy_(Staging.view(buf, s.pose_idx))
            if s.lm_idx is None:
                lm_idx[a:b].zero_()
            else:
                lm_idx[a:b].copy_(Staging.view(buf, s.lm_idx))
            if s.active is None:
                active[a:b].fill_(float(s.on))
            else:
                active[a:b].copy_(Staging.view(buf, s.active) > 0)
            if code is not None:
                code[a:b].fill_(KIND_CODES.get(s.kind, 0))
            if mask3 is not None:
                mask3[a:b].fill_(float(s.kind != "mono"))
            if one[0] is None:
                omega[a:b].copy_(Staging.view(buf, s.omega).expand(s.E))
            if one[1] is None:
                cam[:, a:b].copy_(Staging.view(buf, s.cam).t().expand(5, s.E))
            a = b
        if new_of_old is not None:
            pose_idx = new_of_old.index_select(0, pose_idx)
        pack = PackedEdges(
            meas=meas, omega=omega, cam=cam, pose_idx=pose_idx, lm_idx=lm_idx,
            both_free=((pose_idx < self.Pa) & (lm_idx < self.La)).to(dt),
            active=active, kind=kind, mask3=mask3, code=code,
        )
        parts, start = [], 0
        for k, rk, delta, ss in members:
            stop = start + sum(s.E for s in ss)
            nedges = sum(s.nedges for s in ss)
            parts.append((EdgeSetMeta(kind=k, rk=rk, delta=delta, nedges=nedges), start, stop))
            start = stop
        if len(members) == 1:
            return pack, parts[0][0]
        return pack, EdgeSetMeta(kind=kind, rk=0, delta=1.0, parts=tuple(parts),
                                 nedges=sum(m.nedges for m, _, _ in parts))

    @property
    def _host_idx(self) -> list:
        """Each pack's ``(pose_idx, lm_idx)`` on the host, as packed (the RCM
        renaming applied): read back from the device in one copy where
        first asked for (a structure miss), then kept; a hit reads none."""
        if self._host_idx_read is None:
            self._host_idx_read = [tuple(torch.stack([p.pose_idx, p.lm_idx]).cpu().numpy())
                                   for p in self.packs]
        return self._host_idx_read

    @property
    def packed(self) -> Optional[PackedEdges]:
        """The landmark pack (every mono, stereo and depth set), else the
        first set."""
        return self.packs[0 if self.ba is None else self.ba] if self.packs else None

    @property
    def meta(self) -> Optional[EdgeSetMeta]:
        """The meta of :attr:`packed`."""
        return self.metas[0 if self.ba is None else self.ba] if self.metas else None

    # -- structure ------------------------------------------------------------

    def build_structure(self) -> None:
        """Host symbolic analysis and the device plan (stages "1: Build
        Structure" + "5: Symbolic Decomposition").  A structure whose plan
        the cache holds for this solver's knobs reuses it: no symbolic pass
        (``symbolic_ms = 0``), no plan made and nothing uploaded.  Without
        free landmarks no Schur pattern, triples, band or PCG plan is made:
        the pose-only solve needs the per-set pose segments alone (and, for
        a landmark pack, B3's plan).  Spans (:attr:`spans`): ``structure``
        round the whole, ``structure/symbolic`` (the symbolic pass) and
        ``structure/plan`` (the plan made and uploaded) on a miss."""
        with self.spans.span("structure"):
            self._build_structure()

    def _build_structure(self) -> None:
        knobs = self._plan_knobs()
        plans = self._struct_bundle.setdefault("plans", OrderedDict())
        ba_packed = None if self.ba is None else self.packed
        self.structure_hit = knobs in plans
        if self.structure_hit:
            _STRUCT_STATS["hits"] += 1
            plans.move_to_end(knobs)
            self.schur, cached = plans[knobs]
            self.plan = _solver_plan(cached, ba_packed)
            self.symbolic_ms = 0.0
            return
        _STRUCT_STATS["misses"] += 1

        Pa, La = self.Pa, self.La
        s = triples = None
        self.symbolic_ms = 0.0
        if self.ba is not None and La > 0:
            pose_idx, lm_idx = self._host_idx[self.ba]
            with self.spans.span("structure/symbolic") as symbolic:
                s = build_schur_structure(pose_idx, lm_idx, Pa, La)
                triples = sort_triples(s)
            self.symbolic_ms = symbolic.ms
        with self.spans.span("structure/plan"):
            plan = make_schur_plan(
                self._host_idx, self.ba, Pa, La, self.device,
                torch.float32 if self.mixed else self.dtype,
                pattern=None if s is None else (s.blk_row, s.blk_col, s.diag_pos),
                triples=triples, ba_lm_idx=None if self.ba is None else self.packed.lm_idx,
            )
        for a in s or ():
            if isinstance(a, np.ndarray):
                _frozen(a)
        plans[knobs] = (s, plan)
        while len(plans) > _PLANS_PER_STRUCTURE:
            plans.popitem(last=False)
        self.schur = s
        self.plan = _solver_plan(plan, ba_packed)

    def _plan_knobs(self) -> tuple:
        """What a cached plan depends on beyond the index digest: the torch
        device (type and index), the dtype and solve precision (they fix the
        reduced route and its factor's type; the kernels' workspaces are f64
        in either working type, so no workspace depends on them), and the
        module constants the plans capture when they are made (tests
        monkeypatch such constants, and a stale cached plan would keep the
        old values)."""
        dev = self.device
        index = dev.index
        if dev.type == "cuda" and index is None:
            index = torch.cuda.current_device()
        return (
            dev.type, index, str(self.dtype), self.options.solver_precision,
            MAX_BAND, PCG_MIN_POSES, _pairprod.ITEM, _terms.TILE,
            float(_pcg.CG_TOL), int(_pcg.CG_MAXITER),
        )

    # -- fused loops kept across the solvers of a structure ---------------------

    def take_loop(self, key):
        """The fused loop this structure's cache entry keeps under ``key``
        (``solver/fused.py loop_key``), taken out of it, or None: a run that
        raises leaves nothing kept, and :meth:`keep_loop` puts it back."""
        return self._struct_bundle.setdefault("loops", OrderedDict()).pop(key, None)

    def keep_loop(self, key, loop) -> None:
        """Keep ``loop`` for the next solver of this structure under ``key``,
        while the structure is in the cache."""
        if _STRUCT_CACHE.get(self._digest) is not self._struct_bundle:
            return  # evicted since it was packed
        loops = self._struct_bundle.setdefault("loops", OrderedDict())
        loops[key] = loop
        while len(loops) > _LOOPS_PER_STRUCTURE:
            loops.popitem(last=False)

    def loop_layout(self) -> tuple:
        """What a fused loop's graphs read of this solver by value, beyond
        its structure: the plan knobs, each pack's kind, robust kernels and
        their parameters (:class:`EdgeSetMeta` without its active count),
        and each edge tensor's shape, strides and type (a weight or a camera
        is one column for every edge, or a column an edge)."""
        def meta(m):
            return (m.kind, m.rk, m.delta, tuple((meta(p), a, b) for p, a, b in m.parts))

        def layout(t):
            return None if t is None else (tuple(t.shape), t.stride(), t.dtype)

        return (self._plan_knobs(), tuple(meta(m) for m in self.metas),
                tuple((p.kind,) + tuple(layout(getattr(p, f)) for f in LOOP_EDGE_DATA)
                      for p in self.packs))

    def loop_shell(self) -> "BlockSolver":
        """A solver of this structure over copies of this one's edge data,
        for a fused loop kept across solves (which copies the state in turn):
        its graphs read them by address, and each later solver's are copied
        in (:meth:`load`).  The metas, the edge index tensors and the cached
        plan are shared (nothing writes them); the B5/B9 counters and
        scratch are its own."""
        shell = BlockSolver(self.options, self.device)
        shell.P, shell.Pa, shell.L, shell.La = self.P, self.Pa, self.L, self.La
        shell.packs = tuple(p._replace(**{f: getattr(p, f).clone() for f in LOOP_EDGE_DATA
                                          if getattr(p, f) is not None}) for p in self.packs)
        shell.metas, shell.ba = self.metas, self.ba
        shell.plan = _solver_plan(self.plan, None if self.ba is None else shell.packed)
        shell.graph = self.graph
        return shell

    def load(self, other: "BlockSolver") -> None:
        """Copy ``other``'s state and edge data into this solver's tensors in
        place (``other``: a solver of the same structure and
        :meth:`loop_layout`)."""
        for dst, src in zip(self.graph, other.graph):
            dst.copy_(src)
        for dst, src in zip(self.packs, other.packs):
            for f in LOOP_EDGE_DATA:
                if getattr(dst, f) is not None:
                    getattr(dst, f).copy_(getattr(src, f))

    # -- stage API used by the LM loops -----------------------------------------
    # With a ``timer`` (profile mode) each stage is timed and ends in a device
    # synchronise; the arithmetic is the same either way.

    def _stage(self, name: str):
        if self.timer is None:
            return contextlib.nullcontext()
        return self.timer.stage(name, self.device)

    def chi(self, graph: GraphArrays) -> torch.Tensor:
        """Total chi2 of ``graph`` over every edge set."""
        return compute_chi(graph, self.packs, self.metas)

    # the LM loops' hooks (solver/fused.py, solver/host_loop.py): the chi2
    # they start from, the first damping's diagonal entry, whether the steps
    # may be captured and the collectives they count (none on one card)
    comm = None

    def start_chi(self) -> torch.Tensor:
        with self._stage(prof.PROF_COMPUTE_ERROR):
            return self.chi(self.graph)

    def top_diagonal(self, sys: SystemBlocks) -> torch.Tensor:
        return max_diagonal(sys)

    @property
    def capturable(self) -> bool:
        return self.device.type == "cuda"

    def linearise(self) -> SystemBlocks:
        """The linearised system at the current state."""
        with self._stage(prof.PROF_BUILD_SYSTEM):
            return build_system(self.graph, self.packs, self.metas, self.plan)

    def head(self):
        """Chi2 and the linearised system at the current state."""
        return self.start_chi(), self.linearise()

    def max_diagonal(self, sys: SystemBlocks) -> float:
        return float(max_diagonal(sys))

    def trial(self, sys: SystemBlocks, lam):
        """One damped trial: ``(new_graph, Fhat, scale, success)`` in the
        order of the JAX package's trial stage, all on the device.  ``lam``:
        the host loop's Python float or the fused loop's 0-d device tensor
        (the same value gives the same bits).  Without free landmarks the
        pose-only solve takes the place of the Schur stages."""
        lam = as_lam(lam, sys.bp)
        if self.plan.route == "pose_only":
            with self._stage(prof.PROF_NUMERICAL_DECOMP):
                xp, success = solve_pose_only(sys, lam)
            xl = None
        else:
            with self._stage(prof.PROF_SCHUR_COMPLEMENT):
                blocks, bsc, invHll = schur_reduce(sys, lam, self.plan)
            with self._stage(prof.PROF_NUMERICAL_DECOMP):
                xp, success = solve_reduced(blocks, bsc, self.plan, self.cg)
        with self._stage(prof.PROF_UPDATE):
            if self.plan.route != "pose_only":
                xl = schur_back_substitute(sys, invHll, xp, self.plan)
            new_graph = apply_update(self.graph, xp, xl)
        with self._stage(prof.PROF_COMPUTE_ERROR):
            Fhat = self.chi(new_graph)
        scale = compute_scale(xp, xl, sys, lam)
        return new_graph, Fhat, scale, success

    def accept(self, new_graph: GraphArrays) -> None:
        self.graph = new_graph

    def nedges(self) -> int:
        return sum(m.nedges for m in self.metas)

    # -- outliers ---------------------------------------------------------------

    def update_edges(self) -> None:
        """Mask the edges whose robustified chi2 is above their set's outlier
        threshold for every later ``optimize()`` (the shapes stay: the
        structure cache hits), and write the masks back to the object graph:
        ``edge.inactivate()`` on edge objects, the ``active`` array of bulk
        edges, and each set's ``get_outlier_count()``.  Packed order is the
        caller's edge order (object edges, then bulk edges); a landmark pack
        is split back by its sets' bounds, and a merged mono+stereo set by
        its sizes before the merge."""
        newly_masks = self._update_edges_arrays()
        if newly_masks is None or not self._edge_sets:
            return
        if len(newly_masks) == 1 and self._merged_sizes[0]:
            sizes = self._merged_sizes[0]
            if newly_masks[0] is None:
                parts = [None] * len(sizes)
            else:
                parts = np.split(newly_masks[0], np.cumsum(sizes)[:-1])
        else:
            parts = newly_masks
        for es, newly in zip(self._edge_sets, parts):
            if newly is None or es.outlier_threshold <= 0.0:
                continue
            n_out = 0
            for i, edge in enumerate(es.edges):
                if newly[i] and edge.is_active:
                    edge.inactivate()
                    n_out += 1
            b = es._bulk
            if b is not None and b["meas"].shape[0]:
                nb = newly[len(es.edges):]
                n_out += int((b["active"] & nb).sum())
                b["active"] = b["active"] & ~nb
            es._outlier_count = n_out

    def _update_edges_arrays(self) -> Optional[list]:
        """Outlier thresholding on the packed arrays: each pack with a set
        whose threshold is above 0 has its robustified per-edge chi2
        computed (:func:`set_chi`: kernels B2 and B1 and each set's rho on
        the card) and read once, and keeps the edges at or below their
        set's threshold.  Only deactivations the threshold causes count: an
        edge masked before (at packing, where all its vertices are fixed, or
        by an earlier call) is not reported.  Returns each edge set's newly
        masked edges in packed order (None where no threshold applies), or
        None when no set has a threshold."""
        thrs = [np.asarray(t, dtype=np.float64) for t in self._spec_thresholds]
        if not any(np.any(t > 0) for t in thrs):
            return None
        packs = list(self.packs)
        newly_masks: list = [None] * len(thrs)
        self._outlier_counts = [0] * len(thrs)
        for si, (data, meta, members) in enumerate(zip(self.packs, self.metas, self._pack_specs)):
            if not any(np.any(thrs[i] > 0) for i in members):
                continue
            E = data.active.shape[0]
            bounds = [(a, b) for _, a, b in meta.parts] if meta.parts else [(0, E)]
            thr = np.concatenate([np.broadcast_to(thrs[i], (b - a,))
                                  for i, (a, b) in zip(members, bounds)])
            chi = set_chi(self.graph, data, meta).cpu().numpy()
            was = data.active.cpu().numpy() > 0
            keep = ((thr <= 0) | (chi <= thr)) & was
            newly = was & ~keep
            packs[si] = data._replace(active=torch.as_tensor(keep, device=self.device).to(self.dtype))
            for i, (a, b) in zip(members, bounds):
                if np.any(thrs[i] > 0):
                    newly_masks[i] = newly[a:b]
                    self._outlier_counts[i] = int(newly[a:b].sum())
        self.packs = tuple(packs)
        return newly_masks

    # -- results ---------------------------------------------------------------

    def result_poses(self) -> tuple[np.ndarray, np.ndarray]:
        """Pose estimates ``(q, t)`` in the caller's order (undoes RCM), as
        f64 arrays in either working type, as the JAX package returns them."""
        q = self.graph.q.cpu().numpy().astype(np.float64, copy=False)
        t = self.graph.t.cpu().numpy().astype(np.float64, copy=False)
        if self.pose_perm is None:
            return q, t
        out_q, out_t = q.copy(), t.copy()
        out_q[self.pose_perm] = q[: self.Pa]
        out_t[self.pose_perm] = t[: self.Pa]
        return out_q, out_t

    def result_landmarks(self) -> np.ndarray:
        """Landmark estimates in the caller's order (f64 arrays)."""
        return self.graph.Xw.cpu().numpy().astype(np.float64, copy=False)

    def finalize(self) -> None:
        """Write the estimates back into the vertex sets of the object graph
        (every object and bulk vertex, through its global index, in the
        caller's pose order); an array problem keeps them in ``graph``."""
        if not self._pose_sets:
            return
        q, t = self.result_poses()
        for vs in self._pose_sets:
            vs.write_back(q, t)
        if self._lm_sets and self.L > 0:
            Xw = self.result_landmarks()
            for vs in self._lm_sets:
                vs.write_back(Xw)
