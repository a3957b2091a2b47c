"""Kernel B2: per-edge state gather (``csrc/gather.cu``) and its plain twin.

Counterpart of ``pallas/onehot.py expand``: ``out[e, :] = table[idx[e], :]``
in the table's type (f64 or f32), with an index outside ``[0, M)`` giving a
zero row.  The wrapper
dispatches on the tensor's device only: a CPU tensor runs the plain PyTorch
twin, a CUDA tensor launches the kernel (or raises).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from ._types import check_floats, f32_flag

# the kernel indexes the output's elements and the table's rows in 32 bits
_INT32_MAX = 2**31 - 1


def gather_rows_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch twin: masked ``table[idx]``."""
    M, K = table.shape
    if M == 0:
        return table.new_zeros((idx.shape[0], K))
    valid = (idx >= 0) & (idx < M)
    rows = table[idx.clamp(0, M - 1)]
    return torch.where(valid[:, None], rows, torch.zeros((), dtype=table.dtype, device=table.device))


def _lib():
    lib = _build.load("gather")
    fn = lib.tba_gather_rows
    if fn.argtypes is None:
        vp = ctypes.c_void_p
        fn.argtypes = [vp, vp, vp, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_int, vp]
        fn.restype = ctypes.c_int
    return fn


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``[M, K] f64 or f32, [E] int64 -> [E, K]`` in the table's type
    (kernel B2 on CUDA; ``E * K`` and ``M`` below 2^31 there).  A contiguous
    table is read in place at any address: one that is not 16-byte aligned
    takes the kernel's element loads."""
    if table.device.type == "cpu":
        return gather_rows_plain(table, idx)
    if table.device.type != "cuda":
        raise NotImplementedError(f"gather_rows: no kernel for device {table.device}")
    dtype = check_floats("gather_rows", table)
    if idx.dtype != torch.int64:
        raise TypeError("gather_rows: expects int64 indices")
    if table.dim() != 2 or idx.dim() != 1 or idx.device != table.device:
        raise ValueError("gather_rows: expects table [M, K] and idx [E] on one device")
    M, K = table.shape
    E = idx.shape[0]
    if E * K > _INT32_MAX or M > _INT32_MAX:
        raise ValueError(f"gather_rows: [{M}, {K}] rows for {E} edges exceed the kernel's "
                         "32-bit indices")
    table = table.contiguous()
    idx = idx.contiguous()
    out = torch.empty((E, K), dtype=table.dtype, device=table.device)
    if out.numel() == 0:
        return out
    status = _lib()(
        table.data_ptr(), idx.data_ptr(), out.data_ptr(), M, E, K, f32_flag(dtype),
        _build.stream_ptr(table),
    )
    _build.check(status, "gather_rows")
    gather_rows.launches += 1
    return out


gather_rows.launches = 0
