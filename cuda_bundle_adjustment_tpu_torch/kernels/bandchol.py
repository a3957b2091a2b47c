"""Kernels B7/B8: banded block Cholesky factor and solve
(``csrc/bandchol.cu``) and their plain twins.

Counterparts of ``pallas/bandchol.py band_factor2`` (SB <= 16),
``band_factor`` (v1, 16 < SB <= 48) and ``band_solve``, with the same
block-row band layout: ``band [(Pa + SB) * SB, 36]`` f32, row ``c*SB + d`` =
upper block ``(c, c+d)``; the factor stores ``inv(L_cc)`` at ``d = 0`` and
``L_{(c+d),c}^T`` at ``d >= 1`` and zeros in the ``SB`` slack columns past
``Pa``.  ``SB`` is a runtime value up to 48 (one kernel family for the TPU's
v1 and v2 factors).  A non-SPD band gives non-finite output, which the
solver reads as a rejected step.

On the card neither bytes nor operations bound these kernels but the
dependent chain of the column recurrence, so the design keeps everything
else beside that chain.  The factor holds the blocks that still receive
trailing updates in a sliding triangular window in shared memory (58 KB at
SB = 16, 188 KB at SB = 32, 200 KB at SB = 48; for SB <= 22 each thread keeps
its half block in registers between its first and last update), streams the
original blocks in ahead with ``cp.async``, and factors the next column's
6x6 pivot block in a warp of its own, a column ahead of the warps that form
and apply ``Lt``.  The solve keeps the running right-hand side in shared
memory and has a producer warp stream the read-only factor ahead of the one
consumer warp with bulk copies completing on ``mbarrier``s.

Precision: the factor is stored in f32; its window accumulates in f64 up to
SB = 32 and is rounded once, when a strip is finished
(:func:`accumulation_dtype`; an f64 window of height 48 does not fit, so
wider bands accumulate in f32); the solve accumulates in f32.  The twins
follow the same rules.

Each wrapper dispatches on the tensor's device only: a CPU tensor runs the
plain PyTorch twin, a CUDA tensor launches the kernel (or raises).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

MAX_SB = 48
F64_WINDOW_MAX_SB = 32


def _check_band(band: torch.Tensor, Pa: int, SB: int) -> None:
    if not 1 <= SB <= MAX_SB:
        raise ValueError(f"band height SB={SB} outside 1..{MAX_SB}")
    if band.dtype != torch.float32 or band.shape != ((Pa + SB) * SB, 36):
        raise ValueError(
            f"band must be f32 [{(Pa + SB) * SB}, 36], got {band.dtype} {tuple(band.shape)}"
        )


def accumulation_dtype(SB: int) -> torch.dtype:
    """What the factor's window accumulates in: f64 up to band height 32,
    f32 above (an f64 window of height 48 does not fit the card's shared
    memory).  Kernel and twin follow the same rule."""
    return torch.float64 if SB <= F64_WINDOW_MAX_SB else torch.float32


def _chol6_inv_plain(A: torch.Tensor) -> torch.Tensor:
    """inv(L) for the Cholesky factor L of a symmetric 6x6 block (lower
    triangle read), in A's dtype.  As in the kernel, the trailing update
    multiplies by the reciprocal pivot and the column of L and the inverse
    by its reciprocal square root, never a division by ``L[i, i]``; a
    non-positive pivot yields inf/NaN."""
    D = A.clone()
    L = torch.zeros_like(A)
    r = []
    for k in range(6):
        r.append(1.0 / torch.sqrt(D[k, k]))
        L[k:, k] = D[k:, k] * r[k]
        col = D[k + 1 :, k]
        D[k + 1 :, k + 1 :] -= (col[:, None] * col[None, :]) * (1.0 / D[k, k])
    inv = torch.zeros_like(A)
    eye = torch.eye(6, dtype=A.dtype, device=A.device)
    for i in range(6):
        acc = eye[i] - (L[i, :i, None] * inv[:i]).sum(0) if i else eye[i]
        inv[i] = acc * r[i]
    return inv


def band_factor_plain(band: torch.Tensor, Pa: int, SB: int) -> torch.Tensor:
    """Plain PyTorch twin of :func:`band_factor`: a loop over the columns
    on a window in :func:`accumulation_dtype`, each finished strip rounded
    to f32 once.  ``Lt_d`` is formed from the rounded ``inv(L_cc)`` and the
    trailing update takes the rounded ``Lt_d``: the recurrence runs on
    exactly the factor that the solve will read."""
    _check_band(band, Pa, SB)
    acc = accumulation_dtype(SB)
    win = band.to(acc)  # a copy: band is f32, or cloned below
    if win is band:
        win = band.clone()
    out = torch.zeros_like(band)
    # trailing-update targets (c+d2, d1-d2) for 1 <= d2 <= d1 < SB, relative
    # to column c's first row
    d1, d2 = torch.meshgrid(
        torch.arange(1, SB, device=band.device),
        torch.arange(1, SB, device=band.device),
        indexing="ij",
    )
    keep = d2 <= d1
    d1, d2 = d1[keep], d2[keep]
    rel = d2 * SB + (d1 - d2)
    for c in range(Pa):
        base = c * SB
        S = win[base : base + SB].view(SB, 6, 6)
        invL32 = _chol6_inv_plain(S[0]).to(torch.float32)
        Lt32 = torch.matmul(invL32.to(acc), S[1:]).to(torch.float32)  # [SB-1, 6, 6]
        out[base] = invL32.reshape(36)
        out[base + 1 : base + SB] = Lt32.reshape(SB - 1, 36)
        Lt = Lt32.to(acc)
        upd = torch.matmul(Lt[d2 - 1].transpose(-1, -2), Lt[d1 - 1]).reshape(-1, 36)
        rows = base + rel
        win[rows] = win[rows] - upd
    return out


def band_solve_plain(L: torch.Tensor, b: torch.Tensor, Pa: int, SB: int, bw: int) -> torch.Tensor:
    """Plain PyTorch twin of :func:`band_solve`: forward then back block
    substitution in f32, a loop over the columns.  As in the kernel, the
    forward sweep gathers the pushes into a block in a pending sum and
    subtracts it from ``b_c`` once."""
    _check_band(L, Pa, SB)
    L3 = L.view(-1, SB, 6, 6)
    x = torch.empty_like(b)
    pend = torch.zeros((Pa + SB, 6), dtype=b.dtype, device=b.device)
    for c in range(Pa):
        y = L3[c, 0] @ (b[c] - pend[c])
        x[c] = y
        n = min(bw, Pa - 1 - c)
        if n:
            pend[c + 1 : c + 1 + n] += (L3[c, 1 : 1 + n] * y[None, :, None]).sum(1)
    for c in range(Pa - 1, -1, -1):
        n = min(bw, Pa - 1 - c)
        z = x[c]
        if n:
            z = z - (L3[c, 1 : 1 + n] * x[c + 1 : c + 1 + n, None, :]).sum((0, 2))
        x[c] = L3[c, 0].T @ z
    return x


def _fns():
    lib = _build.load("bandchol")
    f, s = lib.tba_band_factor, lib.tba_band_solve
    if f.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        f.argtypes = [vp, vp, ci, ci, vp]
        f.restype = ci
        s.argtypes = [vp, vp, vp, ci, ci, ci, vp]
        s.restype = ci
    return f, s


def band_factor(band: torch.Tensor, Pa: int, SB: int) -> torch.Tensor:
    """Factor the block-row band (kernel B7 on CUDA); same layout out."""
    if band.device.type == "cpu":
        return band_factor_plain(band, Pa, SB)
    if band.device.type != "cuda":
        raise NotImplementedError(f"band_factor: no kernel for device {band.device}")
    _check_band(band, Pa, SB)
    band = band.contiguous()
    out = torch.empty_like(band)
    status = _fns()[0](band.data_ptr(), out.data_ptr(), Pa, SB, _build.stream_ptr(band))
    _build.check(status, "band_factor")
    band_factor.launches += 1
    return out


def band_solve(L: torch.Tensor, b: torch.Tensor, Pa: int, SB: int, bw: int) -> torch.Tensor:
    """Solve ``A x = b`` with the factor of :func:`band_factor`;
    ``b [Pa, 6] f32 -> [Pa, 6] f32`` (kernel B8 on CUDA)."""
    if L.device.type == "cpu":
        return band_solve_plain(L, b, Pa, SB, bw)
    if L.device.type != "cuda":
        raise NotImplementedError(f"band_solve: no kernel for device {L.device}")
    _check_band(L, Pa, SB)
    if not 0 <= bw < SB:
        raise ValueError(f"bandwidth bw={bw} must satisfy 0 <= bw < SB={SB}")
    if b.dtype != torch.float32 or b.shape != (Pa, 6) or b.device != L.device:
        raise ValueError(f"b must be f32 [{Pa}, 6] on {L.device}")
    L, b = L.contiguous(), b.contiguous()
    x = torch.empty_like(b)
    status = _fns()[1](
        L.data_ptr(), b.data_ptr(), x.data_ptr(), Pa, SB, bw, _build.stream_ptr(L)
    )
    _build.check(status, "band_solve")
    band_solve.launches += 1
    return x


band_factor.launches = 0
band_solve.launches = 0
