"""Chunked-block-Jacobi preconditioned CG on flat Hsc blocks (counterpart of
``solver/pcg.py``).

The pose solve for reduced systems that are neither banded (kernels B7/B8)
nor small enough to densify: O(nnz) memory, a chunk-diagonal preconditioner
factored batched in f32, no sequential factorisation.  Plain torch, as the
JAX package's is plain XLA: the SpMV is the refinement's fixed-order
row/column segment sums (``block_solver.block_matvec``), no float atomics.

The JAX package's CG is one ``while_loop``.  Here the iterations run in
blocks of ``CG_BLOCK``: an iteration past convergence or past ``maxiter``
leaves ``x, r, z, p, rz`` and the count as they were (``torch.where``, not a
zero step), so the result is the ``while_loop``'s stop at the first
``||r|| <= atol`` whatever the block length.  After each block a runner
(:class:`CgRunner`) reads ``[done, iterations]`` on the host and runs
another block or stops: on the card the fused LM loop captures one block
into a CUDA graph of its own and replays it through the same runner
(``solver/fused.py``), so the host loop and the fused loop run the same
blocks and stay bit for bit.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

PC_CHUNK = 64  # pose-chunk width: 6*PC_CHUNK scalar rows per dense chunk
CG_MAXITER = 200
CG_TOL = 1e-10
# CG iterations a block: one host read of the status a block
CG_BLOCK = 16


class PcgPlan(NamedTuple):
    """Scatter plan of the chunk-diagonal preconditioner, made once a
    structure.  ``tol``/``maxiter`` are captured from the module constants
    when it is made (the structure cache keys on them), so a solver built
    under other CG settings never reuses a plan with the old ones."""

    src: torch.Tensor  # [n_in] int64 block ids inside a diagonal chunk
    dst: torch.Tensor  # [n_in * 36] int64 flat scalar positions
    src_m: torch.Tensor  # [n_mir] int64 off-diagonal in-chunk block ids (mirrored)
    dst_m: torch.Tensor  # [n_mir * 36] int64 flat positions of the transposes
    nch: int  # number of pose chunks
    tol: float = CG_TOL
    maxiter: int = CG_MAXITER


def build_pcg_plan(blk_row, blk_col, Pa: int, device, ch: int = PC_CHUNK) -> PcgPlan:
    """Scatter targets of every Hsc block inside a diagonal ``[6 ch, 6 ch]``
    chunk (the upper block and its mirror), in host numpy."""
    blk_row = np.asarray(blk_row, dtype=np.int64)
    blk_col = np.asarray(blk_col, dtype=np.int64)
    nch = max(1, -(-int(Pa) // ch))
    src = np.nonzero((blk_row // ch) == (blk_col // ch))[0]
    r_in, c_in = blk_row[src] % ch, blk_col[src] % ch
    w = ch * 6
    ij = np.arange(36, dtype=np.int64)
    ii, jj = ij // 6, ij % 6
    base = (blk_row[src] // ch) * (w * w)
    dst = base[:, None] + (r_in[:, None] * 6 + ii) * w + c_in[:, None] * 6 + jj
    off = blk_row[src] != blk_col[src]
    # component (i, j) of block (r, c) lands at scalar (c*6+j, r*6+i): the
    # transpose, so the values need no transposing
    dst_m = (base[off][:, None] + (c_in[off][:, None] * 6 + jj) * w
             + r_in[off][:, None] * 6 + ii)

    def up(a):
        return torch.as_tensor(np.ascontiguousarray(a).reshape(-1), device=device)

    return PcgPlan(src=up(src), dst=up(dst), src_m=up(src[off]), dst_m=up(dst_m), nch=nch,
                   tol=CG_TOL, maxiter=CG_MAXITER)


class CgState(NamedTuple):
    """The CG iterate, written in place by every block (a captured block
    reads and writes these very tensors)."""

    x: torch.Tensor  # [Pa, 6]
    r: torch.Tensor
    z: torch.Tensor
    p: torch.Tensor
    rz: torch.Tensor  # 0-d
    it: torch.Tensor  # 0-d int32: iterations taken
    status: torch.Tensor  # [2] int32: done, iterations (what a runner reads)
    atol: torch.Tensor  # 0-d
    maxiter: int
    matvec: Callable
    precond: Callable


class CgRunner:
    """Runs CG blocks until one reports done, reading ``[done, iterations]``
    on the host after each; keeps the iterations of every solve and the
    reads made.  ``block`` is a block's function or the replay of a captured
    block."""

    def __init__(self):
        self.iterations: list[int] = []
        self.reads = 0

    def __call__(self, block: Callable[[], None], status: torch.Tensor) -> None:
        while True:
            block()
            self.reads += 1
            done, it = status.tolist()
            if done:
                break
        self.iterations.append(int(it))


def preconditioner(bl_s: torch.Tensor, Pa: int, pc: PcgPlan):
    """``(precond, factored)``: ``z = M^-1 r`` of the chunk-diagonal blocks
    of the scaled system, assembled by scatter and factored batched in f32
    (the preconditioner's accuracy does not move the answer), and a 0-d
    bool, every chunk factored.  Every in-chunk block and mirror has a
    position of its own, so the JAX package's scatter-add is a scatter
    here.  A chunk that is not positive definite gives a NaN factor, as
    ``jnp.linalg.cholesky`` does, so CG stops unconverged."""
    w = PC_CHUNK * 6
    dev = bl_s.device
    vals = bl_s.to(torch.float32)
    flat = torch.zeros(pc.nch * w * w, dtype=torch.float32, device=dev)
    flat[pc.dst] = vals[pc.src].reshape(-1)
    flat[pc.dst_m] = vals[pc.src_m].reshape(-1)
    chunks = flat.reshape(pc.nch, w, w)
    # rows beyond Pa*6 get an identity diagonal so that the factor exists
    pad = torch.arange(pc.nch * w, device=dev).reshape(pc.nch, w) >= Pa * 6
    chunks = chunks + torch.diag_embed(pad.to(torch.float32))
    L, info = torch.linalg.cholesky_ex(chunks)
    L = torch.where((info == 0)[:, None, None], L, float("nan"))
    Lt = L.mT
    n = pc.nch * w

    def precond(r: torch.Tensor) -> torch.Tensor:
        rq = torch.nn.functional.pad(r.reshape(-1), (0, n - Pa * 6))
        rq = rq.to(torch.float32).reshape(pc.nch, w, 1)
        y = torch.linalg.solve_triangular(L, rq, upper=False)
        z = torch.linalg.solve_triangular(Lt, y, upper=True)
        return z.reshape(-1)[: Pa * 6].to(r.dtype).reshape(Pa, 6)

    return precond, torch.all(info == 0)


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sum(a * b)


def cg_start(b, matvec, precond, pc: PcgPlan) -> CgState:
    """The CG iterate before the first iteration: ``x = 0, r = b, z = p =
    M^-1 b`` and the stopping threshold ``tol (||b|| + 1e-300)``."""
    z0 = precond(b)
    it = torch.zeros((), dtype=torch.int32, device=b.device)
    atol = pc.tol * (torch.linalg.vector_norm(b) + 1e-300)
    return CgState(
        x=torch.zeros_like(b), r=b.clone(), z=z0, p=z0.clone(), rz=_dot(b, z0), it=it,
        status=torch.zeros(2, dtype=torch.int32, device=b.device), atol=atol,
        maxiter=pc.maxiter, matvec=matvec, precond=precond,
    )


def cg_block(st: CgState) -> None:
    """``CG_BLOCK`` CG iterations, each taken only while ``||r|| > atol``
    and fewer than ``maxiter`` were taken; then the status."""
    for _ in range(CG_BLOCK):
        live = (torch.linalg.vector_norm(st.r) > st.atol) & (st.it < st.maxiter)
        q = st.matvec(st.p)
        alpha = st.rz / torch.clamp(_dot(st.p, q), min=1e-300)
        x = st.x + alpha * st.p
        r = st.r - alpha * q
        z = st.precond(r)
        rz = _dot(r, z)
        p = z + (rz / torch.clamp(st.rz, min=1e-300)) * st.p
        for dst, new in ((st.x, x), (st.r, r), (st.z, z), (st.p, p), (st.rz, rz)):
            dst.copy_(torch.where(live, new, dst))
        st.it.add_(live.to(torch.int32))
    live = (torch.linalg.vector_norm(st.r) > st.atol) & (st.it < st.maxiter)
    st.status.copy_(torch.stack([(~live).to(torch.int32), st.it]))


def solve_blocks_pcg(bl_s, bv, s, matvec, Pa: int, pc: PcgPlan, runner=None):
    """Solve the Jacobi-scaled ``bl_s x = bv`` (``matvec``: its block SpMV)
    by preconditioned CG and return ``(xp = x s [Pa, 6], ok)``, ``ok`` only
    for a converged, finite result, on the device: an unconverged CG is a
    rejected trial and LM re-damps, as in the JAX package.  ``runner`` runs
    the blocks (:class:`CgRunner` by default)."""
    precond, factored = preconditioner(bl_s, Pa, pc)
    st = cg_start(bv, matvec, precond, pc)
    (runner if runner is not None else CgRunner())(lambda: cg_block(st), st.status)
    ok = (torch.linalg.vector_norm(st.r) <= st.atol) & torch.all(torch.isfinite(st.x))
    return st.x * s, ok & factored
