"""Bundle adjustment across ``torch.distributed`` ranks: the distributed
Schur reduction (counterpart of ``parallel/distributed.py``).

The JAX package runs it under ``shard_map`` over a device mesh.  Here each
rank of a ``torch.distributed`` process group (None: the default group)
runs the same program on its own shard, and the mesh's ``psum`` is an
``all_reduce``:

* poses are replicated on every rank;
* landmarks are dealt round-robin (landmark ``l`` to rank ``l % D``, slot
  ``l // D`` there) and every edge follows its landmark, so Hll, bl, Hpl
  and the Schur pair products are rank-local.  A rank holds its shard at
  its own size: nothing is padded (the JAX package pads every shard to the
  largest, as ``shard_map`` needs equal shapes); the all-reduced tensors
  keep their global shapes ``[Pa, 42]``, ``[Pa, 6]`` and ``[nnz, 36]``;
* a trial makes three sum all-reduces: chi with the per-pose ``Hpp|bp``
  stacks (once an iteration, at the linearisation), the ranks' ``-sum Hpl
  y`` with their negated pair-product blocks, and the trial chi with the
  landmark half of the gain-ratio denominator; the first damping takes one
  ``all_reduce(MAX)`` of the largest Hessian diagonal entry, at iteration 0;
* the reduced pose solve is replicated: every rank solves the same system
  by the route the structure fixes (``block_solver.reduced_route``: the
  band kernels B7/B8, a dense Cholesky, or PCG);
* the landmark back-substitution is rank-local.

Every rank-local stage is the one-card solver's (``solver/block_solver.py``)
on a ``SchurPlan`` over the rank's edges and landmarks and its triples on
the global block pattern (``block_solver.make_schur_plan``), so on the card
a rank runs kernels B1-B6, B9 and B10, and B7/B8 on the band route.  At one
rank the arithmetic is the one-card host loop's, bit for bit.

The LM loop (:meth:`RankSolver.optimize`, and
:func:`make_distributed_optimize_fused` with the JAX package's signature)
runs by default as the one-card device-resident loop does
(``solver/fused.py FusedLoop``, driving the rank's own steps): the LM state
as 0-d device tensors, iteration 0 eager (its head's all-reduce gives F,
one ``all_reduce(MAX)`` the first damping, no host read), then one flag
read a trial.  Under NCCL on the card each later step is captured into a
CUDA graph at its first use and replayed, its all-reduces with it (on the
PCG route the first and the third graph of a step's cut hold them).  Torch
needs nothing more for that than NCCL's communicator before the first
capture, which iteration 0's eager collectives make (no ``device_id`` at
``init_process_group``, no environment; checked with torch 2.11 and NCCL
2.28 at one rank).  Under gloo, whose collectives a CUDA graph cannot
hold, and on the CPU the same steps run eagerly (``stats["capture"]`` is
False, 0 captures).  A capture that fails raises: nothing falls back.  A
run makes exactly the host loop's collectives on the same buffers: one sum
a linearisation (the head keeps its chi, which only iteration 0 reads),
two a trial and one MAX a run, so at every D and on either backend the
trace and the final state are the host loop's bit for bit.  The collective
counts (``comm``) are kept as the launch counts are: a capture's are taken
back and added again on every replay.

``use_fused_loop = False`` runs the host loop, the oracle: the JAX
distributed loop's semantics (``MAXQ`` trials, ``TAU``, the ``+1e-3``
scale, the ``Fdiff < 1e-4`` bail, ``rho < 1e-6`` done, F carried from the
accepted trial) through the one card's host loop (``solver/host_loop.py
HostLoop``, over the same steps), one small read on the host a trial.
In either loop every rank takes the same branch because every value read
comes from an all-reduce.

Backends: gloo reduces CPU tensors and CUDA tensors (through the host), and
several ranks may share one card; NCCL takes a card a rank.  The device is
the CUDA card (``torch.cuda.current_device()``: set it in each rank) unless
the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist

from ..models.ba import MODEL_REGISTRY
from ..solver.block_solver import (
    MAX_BAND,
    EdgeSetMeta,
    _merge_ba_specs,
    apply_update,
    as_lam,
    band_meta,
    build_system,
    compute_chi,
    compute_scale,
    damp_blocks,
    landmark_scale,
    make_schur_plan,
    max_diagonal,
    reduced_route,
    schur_back_substitute,
    schur_terms,
    set_chi,
    solve_reduced,
)
from ..solver.fused import FusedLoop
from ..solver.host_loop import HostLoop
from ..solver.ordering import plan_pose_order
from ..solver.pcg import CgRunner
from ..solver.symbolic import build_schur_structure, sort_triples
from ..types import GraphArrays, PackedEdges, SystemBlocks

# what shard_problem's pose_solver takes: the band rule of one card, the
# band route forced, or PCG forced
POSE_SOLVERS = ("auto", "band", "pcg")


class Shard(NamedTuple):
    """One rank's share of a :class:`ShardedProblem`, on the host."""

    meas: np.ndarray  # [Es, K]
    omega: np.ndarray  # [1] or [Es]
    cam: np.ndarray  # [1, 5] or [Es, 5]
    pose_idx: np.ndarray  # [Es] int64 global pose index, in the solve's pose order
    lm_local: np.ndarray  # [Es] int64 the landmark's slot on this rank
    active: np.ndarray  # [Es] float64: 1.0 active, 0.0 masked
    mask3: Optional[np.ndarray]  # [Es] 1.0 stereo row, 0.0 mono row (merged sets)
    edge_ids: np.ndarray  # [Es] int64 each edge's position in the caller's order
    Xw: np.ndarray  # [Ls, 3] landmarks rank, rank + D, rank + 2 D, ...
    tri_ei: np.ndarray  # [Ts] int32 rank-local edge of W = Hpl inv(Hll)
    tri_ej: np.ndarray  # [Ts] int32 rank-local edge of Hpl^T
    tri_offsets: np.ndarray  # [nnz + 1] int64 the triples of each global block


class ShardedProblem(NamedTuple):
    """A problem dealt to ``num_shards`` ranks by landmark, on the host
    (:func:`shard_problem`); each rank uploads its own shard."""

    pose_q: np.ndarray  # [P, 4] in the caller's order
    pose_t: np.ndarray  # [P, 3]
    # [Pa] the bandwidth-reducing pose order of the one-card path: the
    # caller's pose at solve position i (None: the identity)
    pose_perm: Optional[np.ndarray]
    shards: tuple  # a Shard a rank
    num_shards: int
    num_active_poses: int
    num_landmarks: int
    kind: str  # the model the edges run ("stereo" for merged mono + stereo)
    # the global pattern of the reduced system (replicated)
    blk_row: np.ndarray  # [nnz] int32
    blk_col: np.ndarray  # [nnz] int32
    diag_pos: np.ndarray  # [Pa] int32
    route: str  # the reduced route: "band", "dense" or "pcg"
    # per-edge robustified chi2 above which make_distributed_update_edges
    # masks an edge; 0 = off (EdgeSet.setOutlierThreshold)
    outlier_threshold: float = 0.0

    @property
    def nnz_blocks(self) -> int:
        return int(self.blk_row.shape[0])

    @property
    def edges_per_shard(self) -> tuple:
        return tuple(int(s.pose_idx.shape[0]) for s in self.shards)

    @property
    def lms_per_shard(self) -> tuple:
        return tuple(int(s.Xw.shape[0]) for s in self.shards)

    @property
    def tris_per_shard(self) -> tuple:
        return tuple(int(s.tri_ei.shape[0]) for s in self.shards)


def _uniform_rows(parts: Sequence[np.ndarray], sizes: Sequence[int]) -> np.ndarray:
    """The rows of several sets' ``[1 or E, K]`` arrays as one array: one
    row where every edge has the same, else a row an edge."""
    if all(p.shape[0] == 1 for p in parts) and all(
            np.array_equal(p, parts[0]) for p in parts[1:]):
        return parts[0]
    rows = np.concatenate([np.broadcast_to(p, (E, p.shape[1])) for p, E in zip(parts, sizes)])
    return rows[:1] if rows.shape[0] and np.all(rows == rows[0]) else rows


def _edge_spec(problem) -> dict:
    """The problem's edges as one spec: a ``BAProblem``'s set, or a
    ``MixedBAProblem``'s sets merged into one masked stereo set
    (``block_solver._merge_ba_specs``)."""
    if not hasattr(problem, "specs"):
        return dict(kind=problem.kind, meas=problem.meas, pose_idx=problem.pose_idx,
                    lm_idx=problem.lm_idx, omega=problem.omega, cam=problem.cam)
    merged = _merge_ba_specs([dict(s) for s in problem.specs])
    if len(merged) != 1:
        raise ValueError(
            "the distributed path needs edge sets that merge into one (mono and stereo "
            "sets under one robust kernel); these do not: "
            f"{[(s['kind'], s.get('rk', 0), s.get('delta', 1.0)) for s in problem.specs]}"
        )
    return merged[0]


def shard_problem(problem, num_shards: int, outlier_threshold: float = 0.0,
                  pose_solver: str = "auto") -> ShardedProblem:
    """Deal a ``BAProblem`` or a ``MixedBAProblem`` (mono + stereo merged
    into one masked stereo set first; sets that do not merge raise
    ``ValueError``) to ``num_shards`` ranks by landmark, in host numpy.

    Landmark ``l`` goes to rank ``l % D``; each edge follows its landmark,
    in the caller's order (a stable sort).  The poses take the one-card
    path's order (``solver/ordering.py plan_pose_order``), the global block
    pattern and its triples come from the one-card symbolic pass, and each
    triple goes to the rank of its edges' landmark, its edges renamed to the
    rank's.  As in the JAX package, every landmark is free on a rank.

    ``pose_solver``: ``"auto"`` takes the one-card band rule
    (``block_solver.reduced_route`` under an f32 factor: the band where the
    band fits ``MAX_BAND``, else dense below ``PCG_MIN_POSES`` poses, else
    PCG); ``"band"`` raises where the band does not fit; ``"pcg"`` forces
    PCG."""
    if pose_solver not in POSE_SOLVERS:
        raise ValueError(f"unknown pose_solver {pose_solver!r} (one of {POSE_SOLVERS})")
    spec = _edge_spec(problem)
    kind = spec["kind"]
    if not MODEL_REGISTRY[kind].HAS_LANDMARK:
        raise ValueError(f"the distributed path shards by landmark: {kind!r} edges have none")
    D = int(num_shards)
    P, Pa = problem.pose_q.shape[0], int(problem.num_active_poses)
    L, La = problem.landmarks.shape[0], int(problem.num_active_landmarks)
    if not 1 <= D <= L:
        raise ValueError(f"{D} shards of {L} landmarks: every shard needs a landmark")
    if La == 0:
        raise ValueError("the distributed path needs free landmarks")
    meas = np.asarray(spec["meas"], dtype=np.float64)
    E = meas.shape[0]
    pose_idx = np.asarray(spec["pose_idx"], dtype=np.int64)
    lm_idx = np.asarray(spec["lm_idx"], dtype=np.int64)
    if E and (pose_idx.min() < 0 or pose_idx.max() >= P or lm_idx.min() < 0
              or lm_idx.max() >= L):
        raise ValueError(f"edges name a vertex outside the graph's {P} poses and {L} landmarks")
    omega = np.asarray(spec["omega"], dtype=np.float64).reshape(-1, 1)
    cam = np.asarray(spec.get("cam", np.zeros(5)), dtype=np.float64).reshape(-1, 5)
    active = np.broadcast_to(np.asarray(spec.get("active", 1.0), dtype=np.float64), (E,))
    mask3 = spec.get("mask3")

    # the one-card pose order, and its renaming of the edges' poses
    perm = plan_pose_order(pose_idx, lm_idx, Pa, La)[0]
    if perm is not None:
        new_of_old = np.empty(Pa, dtype=np.int64)
        new_of_old[perm] = np.arange(Pa)
        pose_idx = np.where(pose_idx < Pa, new_of_old[np.minimum(pose_idx, Pa - 1)], pose_idx)

    # each edge's rank and its position there
    edge_shard = lm_idx % D
    order = np.argsort(edge_shard, kind="stable")
    bounds = np.concatenate([[0], np.cumsum(np.bincount(edge_shard, minlength=D))])
    slot = np.empty(E, dtype=np.int64)
    slot[order] = np.arange(E) - np.repeat(bounds[:-1], np.diff(bounds))

    # the global pattern and its triples sorted by block; a triple's two
    # edges share a landmark, so both lie on one rank
    s = build_schur_structure(pose_idx, lm_idx, Pa, La)
    tri_ei, tri_ej, tri_off = sort_triples(s)
    nnz = s.nnz_blocks
    tri_blk = np.repeat(np.arange(nnz), np.diff(tri_off))
    tri_shard = edge_shard[tri_ei]

    shards = []
    for r in range(D):
        sel = order[bounds[r]:bounds[r + 1]]
        Es = sel.shape[0]
        t = np.nonzero(tri_shard == r)[0] if D > 1 else slice(None)
        per_block = np.bincount(tri_blk[t], minlength=nnz)
        shards.append(Shard(
            meas=meas[sel],
            omega=_uniform_rows([omega if omega.shape[0] == 1 else omega[sel]], [Es])[:, 0],
            cam=_uniform_rows([cam if cam.shape[0] == 1 else cam[sel]], [Es]),
            pose_idx=pose_idx[sel],
            lm_local=lm_idx[sel] // D,
            active=(active[sel] > 0).astype(np.float64),
            mask3=None if mask3 is None else (np.asarray(mask3)[sel] > 0).astype(np.float64),
            edge_ids=sel,
            Xw=np.asarray(problem.landmarks, dtype=np.float64).reshape(-1, 3)[r::D],
            tri_ei=slot[tri_ei[t]].astype(np.int32),
            tri_ej=slot[tri_ej[t]].astype(np.int32),
            tri_offsets=np.concatenate([[0], np.cumsum(per_block)]).astype(np.int64),
        ))

    bw = band_meta(s.blk_row, s.blk_col).bw
    if pose_solver == "band" and bw + 1 > MAX_BAND:
        raise ValueError(f"pose_solver='band' but the reduced system's band height {bw + 1} "
                         f"is over {MAX_BAND}; use 'auto' or 'pcg'")
    route = {"auto": reduced_route(bw, Pa, torch.float32), "band": "band", "pcg": "pcg"}[
        pose_solver]
    return ShardedProblem(
        pose_q=np.asarray(problem.pose_q, dtype=np.float64),
        pose_t=np.asarray(problem.pose_t, dtype=np.float64),
        pose_perm=perm, shards=tuple(shards), num_shards=D, num_active_poses=Pa,
        num_landmarks=L, kind=kind, blk_row=s.blk_row, blk_col=s.blk_col, diag_pos=s.diag_pos,
        route=route,
        outlier_threshold=float(outlier_threshold),
    )


class RankSolver:
    """One rank's share of a distributed solve: its shard on the device,
    its plan, the stages with their all-reduces, and the LM loop.  Every
    rank of ``group`` (None: the default group) makes one over the same
    :class:`ShardedProblem` and calls the same methods in the same order.

    The steps both LM loops drive work on the rank's state ``graph`` and
    the run's edge masks: :meth:`linearise` (the head, its all-reduced chi
    kept in ``head_chi``), :meth:`trial`, :meth:`accept`, with the hooks
    :meth:`start_chi`, :meth:`top_diagonal` and :attr:`capturable`.

    ``comm`` counts the all-reduces since :meth:`optimize` began (or since
    it was last emptied): calls and bytes.  ``use_fused_loop = False``
    runs the host loop."""

    def __init__(self, group, sp: ShardedProblem, rk: int = 0, delta: float = 1.0,
                 device: Union[str, torch.device] = "cuda"):
        dev = torch.device(device)
        if dev.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("device='cuda' requested but no CUDA device is available")
            if dev.index is None:
                dev = torch.device("cuda", torch.cuda.current_device())
        self.group = group
        self.rank = dist.get_rank(group)
        world = dist.get_world_size(group)
        if world != sp.num_shards:
            raise ValueError(f"{sp.num_shards} shards for a group of {world} ranks")
        self.device, self.dtype, self.sp = dev, torch.float64, sp
        sh = sp.shards[self.rank]
        self.P, self.Pa = sp.pose_q.shape[0], sp.num_active_poses
        self.L = self.La = sh.Xw.shape[0]

        def f64(a):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=self.dtype, device=dev)

        pose_idx = torch.as_tensor(sh.pose_idx, device=dev)
        lm_idx = torch.as_tensor(sh.lm_local, device=dev)
        self.packed = PackedEdges(
            meas=f64(sh.meas.T), omega=f64(sh.omega), cam=f64(sh.cam.T), pose_idx=pose_idx,
            lm_idx=lm_idx, both_free=(pose_idx < self.Pa).to(self.dtype), active=f64(sh.active),
            kind=sp.kind, mask3=None if sh.mask3 is None else f64(sh.mask3),
        )
        self.meta = EdgeSetMeta(kind=sp.kind, rk=int(rk), delta=float(delta),
                                nedges=int(np.sum(sh.active > 0)))
        self.plan = make_schur_plan(
            [(sh.pose_idx, sh.lm_local)], 0, self.Pa, self.La, dev, torch.float32,
            pattern=(sp.blk_row, sp.blk_col, sp.diag_pos),
            triples=(sh.tri_ei, sh.tri_ej, sh.tri_offsets), ba_lm_idx=lm_idx, route=sp.route,
        )._replace(ba_pose_idx=pose_idx, ba_lm_idx=lm_idx)
        self.perm = None if sp.pose_perm is None else torch.as_tensor(sp.pose_perm, device=dev)
        self.zero_bp = torch.zeros((self.Pa, 6), dtype=self.dtype, device=dev)
        # a trial's all-reduce of ``-sum Hpl y`` and the negated pair products
        self.reduce_buf = torch.empty(6 * self.Pa + 36 * sp.nnz_blocks, dtype=self.dtype,
                                      device=dev)
        self.cg = CgRunner()
        self.comm = dict(calls=0, bytes=0)
        self.graph = self.state()
        self.run_packs = self.packs  # the edge masks of the run
        self.head_chi: Optional[torch.Tensor] = None
        self.use_fused_loop = True
        self.stats: dict = {}

    @property
    def packs(self) -> tuple:
        return (self.packed,)

    @property
    def metas(self) -> tuple:
        return (self.meta,)

    # -- state ------------------------------------------------------------------

    def state(self, q=None, t=None, Xw=None) -> GraphArrays:
        """The solve's state from the caller's: poses ``[P, 4]``/``[P, 3]``
        in the caller's order, the rank's landmarks ``[Ls, 3]`` (each None:
        the problem's)."""
        sh = self.sp.shards[self.rank]

        def f64(a, default):
            return torch.as_tensor(default if a is None else a, dtype=self.dtype,
                                   device=self.device)

        q, t = f64(q, self.sp.pose_q), f64(t, self.sp.pose_t)
        if self.perm is not None:
            q = torch.cat([q[self.perm], q[self.Pa:]])
            t = torch.cat([t[self.perm], t[self.Pa:]])
        return GraphArrays(q=q, t=t, Xw=f64(Xw, sh.Xw))

    def caller_poses(self, graph: GraphArrays) -> tuple[torch.Tensor, torch.Tensor]:
        """``(q, t)`` of ``graph`` in the caller's pose order."""
        if self.perm is None:
            return graph.q, graph.t
        q, t = graph.q.clone(), graph.t.clone()
        q[self.perm], t[self.perm] = graph.q[: self.Pa], graph.t[: self.Pa]
        return q, t

    def _packs(self, active) -> tuple:
        if active is None:
            return self.packs
        return (self.packed._replace(active=torch.as_tensor(
            active, dtype=self.dtype, device=self.device)),)

    # -- the stages ---------------------------------------------------------------

    def all_reduce(self, t: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
        """``t`` all-reduced in place over the group, counted in ``comm``."""
        dist.all_reduce(t, op=op, group=self.group)
        self.comm["calls"] += 1
        self.comm["bytes"] += t.numel() * t.element_size()
        return t

    @property
    def capturable(self) -> bool:
        """Whether the fused loop may capture the steps: on the card under
        NCCL (gloo's collectives cannot be captured)."""
        return self.device.type == "cuda" and "nccl" in str(dist.get_backend(self.group))

    def head(self, graph: GraphArrays) -> tuple[torch.Tensor, SystemBlocks]:
        """Chi2 and the linearised system at ``graph`` under the run's edge
        masks (``run_packs``): the rank's chi (B2, B1) and system (B2, B3),
        then one all-reduce of chi with the ``[Pa, 42]`` pose stacks.  Returns the total chi2 (0-d) and the
        system with the summed ``Hpp``/``bp`` and the rank's ``Hll``,
        ``bl``, ``Hpl``."""
        packs = self.run_packs
        chi = compute_chi(graph, packs, self.metas)
        sys = build_system(graph, packs, self.metas, self.plan)
        Pa = self.Pa
        buf = torch.empty(1 + 42 * Pa, dtype=self.dtype, device=self.device)
        acc = buf[1:].view(Pa, 42)
        buf[0] = chi
        acc[:, :36] = sys.Hpp.reshape(Pa, 36)
        acc[:, 36:] = sys.bp
        self.all_reduce(buf)
        return buf[0], sys._replace(Hpp=acc[:, :36].view(Pa, 6, 6), bp=acc[:, 36:])

    def linearise(self) -> SystemBlocks:
        """The head at the rank's state: the system, with the total chi2
        kept in ``head_chi`` (0-d, on the device)."""
        self.head_chi, sys = self.head(self.graph)
        return sys

    def start_chi(self) -> None:
        """None: the LM loops take their first F from iteration 0's head
        (``head_chi``), which every rank all-reduces anyway."""
        return None

    def top_diagonal(self, sys: SystemBlocks) -> torch.Tensor:
        """The largest diagonal entry over every rank, 0-d on the device:
        one ``all_reduce(MAX)``, no host read."""
        return self.all_reduce(max_diagonal(sys).reshape(1).clone(), dist.ReduceOp.MAX)[0]

    def accept(self, new_graph: GraphArrays) -> None:
        self.graph = new_graph

    def trial(self, sys: SystemBlocks, lam):
        """One damped trial at the rank's state: ``(new_graph, Fhat, scale,
        success)`` on the device, as ``BlockSolver.trial``.  The rank's B4, B5 (zero ``bp``)
        and B6, one all-reduce of ``-sum Hpl y`` with the negated pair
        products, ``bsc = bp + that`` and ``Hpp + lam I`` on the diagonal
        (the one-card ``schur_reduce``'s arithmetic); the replicated solve;
        the rank's B9, B10 and update; one all-reduce of the trial chi with
        the landmark half of the scale."""
        graph, packs = self.graph, self.run_packs
        lam = as_lam(lam, sys.bp)
        Pa, plan = self.Pa, self.plan
        invHll, part, pairs = schur_terms(sys, lam, plan, self.zero_bp)
        nnz, buf = pairs.shape[0], self.reduce_buf
        buf[: 6 * Pa].view(Pa, 6).copy_(part)
        torch.neg(pairs, out=buf[6 * Pa:].view(nnz, 36))
        self.all_reduce(buf)
        bsc = sys.bp + buf[: 6 * Pa].view(Pa, 6)
        blocks = damp_blocks(buf[6 * Pa:].view(nnz, 36), sys.Hpp, lam, plan)
        xp, success = solve_reduced(blocks, bsc, plan, self.cg)
        xl = schur_back_substitute(sys, invHll, xp, plan)
        new_graph = apply_update(graph, xp, xl)
        out = self.all_reduce(torch.stack(
            [compute_chi(new_graph, packs, self.metas), landmark_scale(xl, sys.bl, lam)]))
        return new_graph, out[0], compute_scale(xp, None, sys, lam) + out[1], success

    # -- the loop and the outliers ------------------------------------------------

    def optimize(self, niterations: int, q=None, t=None, Xw=None, active=None):
        """The LM loop from the caller's state (None: the problem's) with
        ``active`` the rank's edge mask (None: the shard's): the fused loop,
        or the host loop under ``use_fused_loop = False``.  Returns the chi2
        trace and the final state (the solve's pose order); ``stats`` holds
        the trials, the iterations, the wall time, the all-reduces, the CG
        iterations and, for the fused loop, its ``FusedLoop.stats`` (host
        reads, captures, replays, eager / capture / replay ms) and whether
        its steps were captured (``capture``)."""
        t_start = time.perf_counter()
        self.graph = self.state(q, t, Xw)
        self.run_packs = self._packs(active)
        self.comm = dict(calls=0, bytes=0)
        fused = self.use_fused_loop
        loop = FusedLoop(self, niterations) if fused else HostLoop(self, niterations)
        trace = loop.run()
        run = dict(loop.stats, fused=fused, capture=fused and loop.capture)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.stats = dict(run, iterations=len(trace), seconds=time.perf_counter() - t_start,
                          all_reduce=dict(self.comm), cg_iterations=list(self.cg.iterations))
        return trace, self.graph

    def update_edges(self, graph: GraphArrays, active) -> tuple[torch.Tensor, int]:
        """Outlier thresholding on the rank: the robustified per-edge chi2
        (B2, B1 and rho) above ``outlier_threshold`` masks an edge.
        Returns the new mask ``[Es]`` and the edges newly masked over every
        rank (one all-reduce)."""
        active = torch.as_tensor(active, dtype=self.dtype, device=self.device)
        chi = set_chi(graph, self.packed._replace(active=active), self.meta)
        was = active > 0
        thr = self.sp.outlier_threshold
        keep = was & (chi <= thr) if thr > 0 else was
        n_new = self.all_reduce((was & ~keep).sum().reshape(1))
        return keep.to(self.dtype), int(n_new.item())


def _solver(group, sp: ShardedProblem, rk, delta, device, solver: Optional[RankSolver]):
    """``solver`` where the caller keeps one (its shard and plan stay on the
    device between the calls), else a new :class:`RankSolver`."""
    if solver is None:
        return RankSolver(group, sp, rk, delta, device)
    if solver.sp is not sp:
        raise ValueError("solver was made for another ShardedProblem")
    return solver


def make_distributed_lm_step(group, sp: ShardedProblem, rk: int = 0, delta: float = 1.0,
                             device: Union[str, torch.device] = "cuda",
                             solver: Optional[RankSolver] = None):
    """One damped LM trial step on every rank of ``group``.  Returns
    ``step(q, t, Xw, lam) -> (q', t', Xw', chi_before, chi_after, scale,
    success)``: poses in the caller's order, ``Xw`` the rank's landmarks,
    the rest 0-d tensors on the device.  Three sum all-reduces a step.
    ``solver``: a :class:`RankSolver` over ``sp`` to run on (None: a new one,
    as for :func:`distributed_optimize` and
    :func:`make_distributed_update_edges`)."""
    rs = _solver(group, sp, rk, delta, device, solver)

    def step(q, t, Xw, lam):
        rs.accept(rs.state(q, t, Xw))
        rs.run_packs = rs.packs
        chi0, sys = rs.head(rs.graph)
        new_graph, chi1, scale, success = rs.trial(sys, lam)
        q2, t2 = rs.caller_poses(new_graph)
        return q2, t2, new_graph.Xw, chi0, chi1, scale, success

    return step


def make_distributed_optimize_fused(group, sp: ShardedProblem, niterations: int, rk: int = 0,
                                    delta: float = 1.0,
                                    device: Union[str, torch.device] = "cuda",
                                    solver: Optional[RankSolver] = None):
    """The whole distributed LM loop on every rank of ``group``, device
    resident (``RankSolver.optimize``: captured into CUDA graphs under NCCL
    on the card, its steps eager under gloo and on the CPU; the host loop
    only where ``solver.use_fused_loop`` is False).  Returns
    ``optimize(q, t, Xw, active=None) -> (q, t, Xw, trace, n_done)``, the
    JAX package's results: poses ``[P, 4]``/``[P, 3]`` in the caller's
    order, ``Xw`` the rank's landmarks ``[Ls, 3]`` (None: the shard's),
    ``active`` the rank's edge mask (None: the shard's), ``trace`` the chi2
    of each iteration as an f64 tensor ``[niterations]`` on the host (the
    loop's one trace read; zeros past the ``n_done`` iterations run).
    ``solver``: as for :func:`make_distributed_lm_step`."""
    rs = _solver(group, sp, rk, delta, device, solver)
    n = int(niterations)

    def optimize(q, t, Xw, active=None):
        trace, graph = rs.optimize(n, q, t, Xw, active=active)
        out = torch.zeros(n, dtype=torch.float64)
        out[: len(trace)] = torch.tensor(trace, dtype=torch.float64)
        return (*rs.caller_poses(graph), graph.Xw, out, len(trace))

    return optimize


def distributed_optimize(group, sp: ShardedProblem, niterations: int, rk: int = 0,
                         delta: float = 1.0, active=None,
                         device: Union[str, torch.device] = "cuda",
                         solver: Optional[RankSolver] = None):
    """The distributed LM loop on every rank of ``group`` from the
    problem's state (``active``: the rank's edge mask, None: the shard's),
    through :func:`make_distributed_optimize_fused`: ``(trace, (q, t,
    Xw))`` with the poses in the caller's order and ``Xw`` the rank's
    landmarks (:func:`gather_landmarks` puts the ranks' together).  A caller
    that runs the loop again, or thresholds outliers between runs, passes
    one ``solver`` to every call."""
    opt = make_distributed_optimize_fused(group, sp, niterations, rk, delta, device, solver)
    q, t, Xw, trace, n_done = opt(sp.pose_q, sp.pose_t, None, active)
    return trace[:n_done].tolist(), (q, t, Xw)


def make_distributed_update_edges(group, sp: ShardedProblem, rk: int = 0, delta: float = 1.0,
                                  device: Union[str, torch.device] = "cuda",
                                  solver: Optional[RankSolver] = None):
    """Distributed outlier thresholding: ``update(q, t, Xw, active) ->
    (active', n_new)``, the rank's new edge mask and the count of edges
    newly masked over every rank (``RankSolver.update_edges``).
    ``solver``: as for :func:`make_distributed_lm_step`."""
    rs = _solver(group, sp, rk, delta, device, solver)

    def update(q, t, Xw, active=None):
        return rs.update_edges(rs.state(q, t, Xw), rs.packed.active if active is None else active)

    return update


def gather_landmarks(sp: ShardedProblem, parts: Sequence) -> np.ndarray:
    """Undo the round-robin deal: every rank's landmarks ``[Ls, 3]`` (in
    rank order, arrays or tensors) -> ``[L, 3]`` in the caller's order."""
    if len(parts) != sp.num_shards:
        raise ValueError(f"{len(parts)} parts for {sp.num_shards} shards")
    out = np.empty((sp.num_landmarks, 3), dtype=np.float64)
    for r, x in enumerate(parts):
        out[r::sp.num_shards] = torch.as_tensor(x).detach().cpu().numpy()
    return out
