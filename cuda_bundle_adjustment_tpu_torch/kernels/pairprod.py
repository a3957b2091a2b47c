"""Kernel B6: Schur pair products (``csrc/pairprod.cu``) and its plain twin.

Counterpart of ``pallas/pairprod.py`` (``_pairprod_call_v2``):

    out[k] = sum_{t: block k} Hpl[ei_t] @ invHll[lm(ei_t)] @ Hpl[ej_t]^T

as flat row-major ``[nnz, 36]`` blocks in the working type (f64, or f32 in
f32 mode, where kernel and twin compute in f64 and round each block once:
``kernels/_types.py``), over triples sorted by target
block with CSR ``offsets [nnz + 1]`` (``solver/symbolic.py sort_triples``;
the solver's triples are int32, and on the card they are its plan's).
The wrapper dispatches on the tensor's device only: a CPU tensor runs the
plain PyTorch twin, a CUDA tensor launches the kernel (or raises).  The
kernel walks a :class:`PairPlan` (int32 triples with their landmark, blocks
cut into items of at most ``ITEM`` triples), made once a structure by
:func:`make_pair_plan`; ``csrc/pairprod.cu`` has the design.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..ops.components import flat_mm_6x3_3x3
from . import _build
from ._types import check_floats, f32_flag, narrow, wide


def schur_pair_products_plain(hpl, inv_hll, lm_idx, tri_ei, tri_ej, offsets):
    """Plain PyTorch twin: per-edge ``W = Hpl inv(Hll)``, a gathered einsum
    over the triples, then a fixed-order segment sum per block, in f64,
    rounded to the operands' type."""
    dtype = hpl.dtype
    hpl, inv_hll = wide(hpl), wide(inv_hll)
    La = inv_hll.shape[0]
    W = flat_mm_6x3_3x3(hpl, inv_hll[lm_idx.clamp(0, max(La - 1, 0))])
    T = tri_ei.shape[0]
    prod = torch.einsum(
        "tik,tjk->tij", W[tri_ei].view(T, 6, 3), hpl[tri_ej].view(T, 6, 3)
    ).reshape(T, 36)
    return narrow(dtype, torch.segment_reduce(prod, "sum", offsets=offsets))


# most triples one warp sums into one row (an item)
ITEM = 128


class PairPlan(NamedTuple):
    """B6's plan, int32 tensors.  An item is a stretch of at most ``ITEM``
    triples of one block; its target is the block's output row where the
    block has no other item, else ``-1 - number`` for scratch row
    ``number``.  ``E``, ``T`` and ``nnz`` are the sizes of the structure it
    was made for: the wrapper compares these three integers a call and
    nothing else."""

    tri_ei: torch.Tensor  # [T]
    tri_ej: torch.Tensor  # [T]
    tri_lm: torch.Tensor  # [T] lm_idx[tri_ei]
    items: torch.Tensor  # [items, 4] first triple, last + 1, target, 0
    block_off: torch.Tensor  # [nnz + 1] a block's stretch of item numbers
    E: int
    T: int
    nnz: int


def make_pair_plan(lm_idx, tri_ei, tri_ej, offsets) -> PairPlan:
    """The plan of one structure's triples.  Made once a structure
    (``build_structure``); :func:`schur_pair_products` makes it itself when
    it is given none."""
    dev = offsets.device
    if lm_idx.shape[0] >= 2**31 or tri_ei.shape[0] >= 2**31:
        raise ValueError("schur_pair_products: the kernel's indices are 32-bit")
    nnz = offsets.shape[0] - 1
    per_block = torch.div(offsets[1:] - offsets[:-1] + ITEM - 1, ITEM, rounding_mode="floor")
    block_off = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev), per_block.cumsum(0)])
    block = torch.repeat_interleave(torch.arange(nnz, device=dev), per_block)
    number = torch.arange(block.shape[0], device=dev)
    first = offsets[block] + (number - block_off[block]) * ITEM
    last = torch.minimum(first + ITEM, offsets[block + 1])
    target = torch.where(per_block[block] == 1, block, -1 - number)
    items = torch.stack([first, last, target, torch.zeros_like(first)], dim=1)
    i32 = torch.int32
    return PairPlan(tri_ei.to(i32), tri_ej.to(i32), lm_idx[tri_ei].to(i32),
                    items.to(i32).contiguous(), block_off.to(i32),
                    lm_idx.shape[0], tri_ei.shape[0], nnz)


def _lib():
    fn = _build.load("pairprod").tba_schur_pair_products
    if fn.argtypes is None:
        vp, ll = ctypes.c_void_p, ctypes.c_longlong
        # hpl inv_hll tri_ei tri_ej tri_lm items | nitems | block_off | nnz |
        # f32 | scratch out stream
        fn.argtypes = [vp] * 6 + [ll, vp, ll, ctypes.c_int, vp, vp, vp]
        fn.restype = ctypes.c_int
    return fn


def schur_pair_products(hpl, inv_hll, lm_idx, tri_ei, tri_ej, offsets,
                        plan: PairPlan | None = None):
    """``Hpl [E, 18], invHll [La, 9] f64 or f32; lm_idx [E], offsets
    [nnz + 1] int64; tri_ei/tri_ej [T] int32 or int64 -> [nnz, 36]`` in the
    blocks' type (kernel B6 on CUDA, which reads its indices from the plan).  ``plan``: the
    indices' :func:`make_pair_plan`, for a caller that launches more than
    once."""
    if hpl.device.type == "cpu":
        return schur_pair_products_plain(hpl, inv_hll, lm_idx, tri_ei, tri_ej, offsets)
    if hpl.device.type != "cuda":
        raise NotImplementedError(f"schur_pair_products: no kernel for device {hpl.device}")
    floats, ints = (hpl, inv_hll), (lm_idx, tri_ei, tri_ej, offsets)
    check_floats("schur_pair_products", *floats)
    if (
        lm_idx.dtype != torch.int64 or offsets.dtype != torch.int64
        or tri_ei.dtype not in (torch.int32, torch.int64) or tri_ej.dtype != tri_ei.dtype
    ):
        raise TypeError(
            "schur_pair_products: expects int64 lm_idx and offsets, and int32 or int64 triples"
        )
    if any(t.device != hpl.device for t in floats + ints):
        raise ValueError("schur_pair_products: all operands must be on one device")
    if hpl.shape[1:] != (18,) or inv_hll.shape[1:] != (9,):
        raise ValueError("schur_pair_products: expects Hpl [E, 18] and invHll [La, 9]")
    if lm_idx.shape[0] != hpl.shape[0] or tri_ei.shape != tri_ej.shape:
        raise ValueError("schur_pair_products: index arrays do not match")
    hpl, inv_hll = hpl.contiguous(), inv_hll.contiguous()
    nnz = offsets.shape[0] - 1
    if plan is None:
        plan = make_pair_plan(lm_idx, tri_ei, tri_ej, offsets)
    if (plan.E, plan.T, plan.nnz) != (hpl.shape[0], tri_ei.shape[0], nnz) or (
        plan.items.device != hpl.device
    ):
        raise ValueError("schur_pair_products: the plan belongs to another structure or device")
    # the kernel copies the Hpl rows 16 bytes at a time (decided once under
    # CUDA-graph capture: see kernels/schurvec.py _operands)
    if hpl.data_ptr() % 16:
        hpl = hpl.clone()
    out = torch.empty((nnz, 36), dtype=hpl.dtype, device=hpl.device)
    if nnz == 0:
        return out
    nitems = plan.items.shape[0]
    # the items' partial rows, f64 in either working type
    scratch = torch.empty((nitems, 36), dtype=torch.float64, device=hpl.device)
    status = _lib()(
        hpl.data_ptr(), inv_hll.data_ptr(), plan.tri_ei.data_ptr(), plan.tri_ej.data_ptr(),
        plan.tri_lm.data_ptr(), plan.items.data_ptr(), nitems, plan.block_off.data_ptr(),
        nnz, f32_flag(hpl.dtype), scratch.data_ptr(), out.data_ptr(), _build.stream_ptr(hpl),
    )
    _build.check(status, "schur_pair_products")
    schur_pair_products.launches += 1
    return out


schur_pair_products.launches = 0
