"""Kernels B4 and B10: the damped landmark-block inverse with ``y = inv bl``
and the back-substitution product ``xl = inv cl`` (``csrc/lminv.cu``), and
their plain twins.

Counterparts of ``pallas/lminv.py`` ``lminv_call`` and ``sym3x3_mv_call``:

* B4 ``damped_inverse``: ``inv = (Hll + lam I)^-1`` by the adjugate formula
  and ``y = inv bl``, per landmark;
* B10 ``sym3x3_mv``: ``xl = inv cl`` per landmark.

Blocks are row-major ``[La, 9]`` f64, vectors ``[La, 3]`` f64: the layouts
kernels B5, B6 and B9 read and write.  The kernels evaluate the twins'
expressions (``ops/components.py flat_sym3x3_inv``, ``flat_mv_3x3``)
operation for operation, so they agree with them bit for bit.  The damped
block is inverted without a determinant guard: ``lam > 0`` on every LM
trial keeps a zero block invertible (``lam I``).  The wrappers dispatch on
the tensor's device only: a CPU tensor runs the plain PyTorch twin, a CUDA
tensor launches the kernel (or raises).
"""

from __future__ import annotations

import ctypes

import torch

from ..ops.components import flat_mv_3x3, flat_sym3x3_inv
from . import _build


def damped_inverse_plain(Hll: torch.Tensor, bl: torch.Tensor, lam: float):
    """Plain PyTorch twin of B4."""
    diag9 = torch.tensor(
        [1.0, 0, 0, 0, 1.0, 0, 0, 0, 1.0], dtype=Hll.dtype, device=Hll.device
    )
    invHll = flat_sym3x3_inv(Hll + lam * diag9)
    return invHll, flat_mv_3x3(invHll, bl)


def sym3x3_mv_plain(invHll: torch.Tensor, cl: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch twin of B10."""
    return flat_mv_3x3(invHll, cl)


_VP, _LL = ctypes.c_void_p, ctypes.c_longlong
_ARGTYPES = {
    # Hll, bl, lam, La, inv, y, stream
    "tba_damped_inverse": [_VP, _VP, ctypes.c_double, _LL, _VP, _VP, _VP],
    # inv, cl, La, xl, stream
    "tba_sym3x3_mv": [_VP, _VP, _LL, _VP, _VP],
}


def _fn(name: str):
    fn = getattr(_build.load("lminv"), name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
    return fn


def _check(name: str, blocks: torch.Tensor, vec: torch.Tensor):
    """Validate the operands of a CUDA launch; returns them contiguous."""
    if blocks.device.type != "cuda":
        raise NotImplementedError(f"{name}: no kernel for device {blocks.device}")
    if blocks.dtype != torch.float64 or vec.dtype != torch.float64:
        raise TypeError(f"{name}: expects f64 blocks and vectors")
    if vec.device != blocks.device:
        raise ValueError(f"{name}: all operands must be on one device")
    La = blocks.shape[0]
    if blocks.shape != (La, 9) or vec.shape != (La, 3):
        raise ValueError(f"{name}: expects blocks [La, 9] and a vector [La, 3]")
    return blocks.contiguous(), vec.contiguous()


def damped_inverse(Hll: torch.Tensor, bl: torch.Tensor, lam: float):
    """``Hll [La, 9], bl [La, 3], lam -> (inv(Hll + lam I) [La, 9],
    y = inv bl [La, 3])`` f64 (kernel B4 on CUDA).  ``lam`` is a host float
    passed by value: no device read-back."""
    if Hll.device.type == "cpu":
        return damped_inverse_plain(Hll, bl, lam)
    Hll, bl = _check("damped_inverse", Hll, bl)
    inv, y = torch.empty_like(Hll), torch.empty_like(bl)
    La = Hll.shape[0]
    if La == 0:
        return inv, y
    status = _fn("tba_damped_inverse")(
        Hll.data_ptr(), bl.data_ptr(), float(lam), La, inv.data_ptr(), y.data_ptr(),
        _build.stream_ptr(Hll),
    )
    _build.check(status, "damped_inverse")
    damped_inverse.launches += 1
    return inv, y


def sym3x3_mv(invHll: torch.Tensor, cl: torch.Tensor) -> torch.Tensor:
    """``inv [La, 9], cl [La, 3] -> xl = inv cl [La, 3]`` f64 (kernel B10 on
    CUDA)."""
    if invHll.device.type == "cpu":
        return sym3x3_mv_plain(invHll, cl)
    invHll, cl = _check("sym3x3_mv", invHll, cl)
    xl = torch.empty_like(cl)
    La = invHll.shape[0]
    if La == 0:
        return xl
    status = _fn("tba_sym3x3_mv")(
        invHll.data_ptr(), cl.data_ptr(), La, xl.data_ptr(), _build.stream_ptr(invHll)
    )
    _build.check(status, "sym3x3_mv")
    sym3x3_mv.launches += 1
    return xl


damped_inverse.launches = 0
sym3x3_mv.launches = 0
