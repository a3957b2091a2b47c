"""Kernel B6: Schur pair products (``csrc/pairprod.cu``) and its plain twin.

Counterpart of ``pallas/pairprod.py`` (``_pairprod_call_v2``):

    out[k] = sum_{t: block k} Hpl[ei_t] @ invHll[lm(ei_t)] @ Hpl[ej_t]^T

as flat row-major ``[nnz, 36]`` f64 blocks, over triples sorted by target
block with CSR ``offsets [nnz + 1]`` (``solver/symbolic.py sort_triples``).
The wrapper dispatches on the tensor's device only: a CPU tensor runs the
plain PyTorch twin, a CUDA tensor launches the kernel (or raises).
"""

from __future__ import annotations

import ctypes

import torch

from ..ops.components import flat_mm_6x3_3x3
from . import _build


def schur_pair_products_plain(hpl, inv_hll, lm_idx, tri_ei, tri_ej, offsets):
    """Plain PyTorch twin: per-edge ``W = Hpl inv(Hll)``, a gathered einsum
    over the triples, then a fixed-order segment sum per block."""
    La = inv_hll.shape[0]
    W = flat_mm_6x3_3x3(hpl, inv_hll[lm_idx.clamp(0, max(La - 1, 0))])
    T = tri_ei.shape[0]
    prod = torch.einsum(
        "tik,tjk->tij", W[tri_ei].view(T, 6, 3), hpl[tri_ej].view(T, 6, 3)
    ).reshape(T, 36)
    return torch.segment_reduce(prod, "sum", offsets=offsets)


def _lib():
    fn = _build.load("pairprod").tba_schur_pair_products
    if fn.argtypes is None:
        vp = ctypes.c_void_p
        fn.argtypes = [vp] * 7 + [ctypes.c_longlong, vp]
        fn.restype = ctypes.c_int
    return fn


def schur_pair_products(hpl, inv_hll, lm_idx, tri_ei, tri_ej, offsets):
    """``Hpl [E, 18], invHll [La, 9] f64; lm_idx [E], tri_ei/tri_ej [T],
    offsets [nnz + 1] int64 -> [nnz, 36] f64`` (kernel B6 on CUDA)."""
    if hpl.device.type == "cpu":
        return schur_pair_products_plain(hpl, inv_hll, lm_idx, tri_ei, tri_ej, offsets)
    if hpl.device.type != "cuda":
        raise NotImplementedError(f"schur_pair_products: no kernel for device {hpl.device}")
    floats, ints = (hpl, inv_hll), (lm_idx, tri_ei, tri_ej, offsets)
    if any(t.dtype != torch.float64 for t in floats) or any(
        t.dtype != torch.int64 for t in ints
    ):
        raise TypeError("schur_pair_products: expects f64 blocks and int64 indices")
    if any(t.device != hpl.device for t in floats + ints):
        raise ValueError("schur_pair_products: all operands must be on one device")
    if hpl.shape[1:] != (18,) or inv_hll.shape[1:] != (9,):
        raise ValueError("schur_pair_products: expects Hpl [E, 18] and invHll [La, 9]")
    if lm_idx.shape[0] != hpl.shape[0] or tri_ei.shape != tri_ej.shape:
        raise ValueError("schur_pair_products: index arrays do not match")
    hpl, inv_hll = hpl.contiguous(), inv_hll.contiguous()
    lm_idx, tri_ei, tri_ej, offsets = (t.contiguous() for t in ints)
    nnz = offsets.shape[0] - 1
    out = torch.empty((nnz, 36), dtype=hpl.dtype, device=hpl.device)
    if nnz == 0:
        return out
    status = _lib()(
        hpl.data_ptr(), inv_hll.data_ptr(), lm_idx.data_ptr(), tri_ei.data_ptr(),
        tri_ej.data_ptr(), offsets.data_ptr(), out.data_ptr(), nnz,
        _build.stream_ptr(hpl),
    )
    _build.check(status, "schur_pair_products")
    schur_pair_products.launches += 1
    return out


schur_pair_products.launches = 0
