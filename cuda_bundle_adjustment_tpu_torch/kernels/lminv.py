"""Kernels B4 and B10: the damped landmark-block inverse with ``y = inv bl``
and the back-substitution product ``xl = inv cl`` (``csrc/lminv.cu``), and
their plain twins.

Counterparts of ``pallas/lminv.py`` ``lminv_call`` and ``sym3x3_mv_call``:

* B4 ``damped_inverse``: ``inv = (Hll + lam I)^-1`` by the adjugate formula
  and ``y = inv bl``, per landmark;
* B10 ``sym3x3_mv``: ``xl = inv cl`` per landmark.

Blocks are row-major ``[La, 9]``, vectors ``[La, 3]``, in the working type
(f64, or f32 in f32 mode): the layouts kernels B5, B6 and B9 read and write.
In f32 the kernels and twins compute in f64 and round each output once
(``kernels/_types.py``).  B4 reads its operands at their own
row stride: the solver hands over ``Hll`` and ``bl`` as column blocks of
B3's ``[La, 12]`` rows, and they reach the kernel uncopied, in one launch
(:func:`damped_inverse_operands`).  The kernels evaluate the twins'
expressions (``ops/components.py flat_sym3x3_inv``, ``flat_mv_3x3``)
operation for operation, so they agree with them bit for bit.  The damped
block is inverted without a determinant guard: ``lam > 0`` on every LM
trial keeps a zero block invertible (``lam I``).  ``lam`` is a 0-d tensor
of the operands' type on their device, which B4 reads through its pointer: the LM
loop keeps it on the card, and a CUDA graph that captured the launch reads
each trial's value (a caller with a Python float wraps it, as the solver's
``schur_reduce`` does).  The wrappers dispatch on the tensor's device only:
a CPU tensor runs the plain PyTorch twin, a CUDA tensor launches the kernel
(or raises).
"""

from __future__ import annotations

import ctypes

import torch

from ..ops.components import flat_mv_3x3, flat_sym3x3_inv
from . import _build
from ._types import check_floats, f32_flag, narrow, wide


def damped_inverse_plain(Hll: torch.Tensor, bl: torch.Tensor, lam: torch.Tensor):
    """Plain PyTorch twin of B4 (``lam``: a 0-d tensor of the operands'
    type, as B4 takes it; at f64 a Python float gives the same bits), in
    f64: ``y`` from the unrounded inverse, both rounded to the operands'
    type."""
    dtype = Hll.dtype
    Hll, bl = wide(Hll), wide(bl)
    if isinstance(lam, torch.Tensor):
        lam = wide(lam)
    diag9 = torch.tensor(
        [1.0, 0, 0, 0, 1.0, 0, 0, 0, 1.0], dtype=Hll.dtype, device=Hll.device
    )
    invHll = flat_sym3x3_inv(Hll + lam * diag9)
    return narrow(dtype, invHll, flat_mv_3x3(invHll, bl))


def sym3x3_mv_plain(invHll: torch.Tensor, cl: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch twin of B10 (in f64, rounded to the operands' type)."""
    return narrow(invHll.dtype, flat_mv_3x3(wide(invHll), wide(cl)))


_VP, _LL = ctypes.c_void_p, ctypes.c_longlong
_ARGTYPES = {
    # Hll, ldh, bl, ldb, lam (a device pointer), La, f32, inv, y, stream
    "tba_damped_inverse": [_VP, _LL, _VP, _LL, _VP, _LL, ctypes.c_int, _VP, _VP, _VP],
    # inv, cl, La, f32, xl, stream
    "tba_sym3x3_mv": [_VP, _VP, _LL, ctypes.c_int, _VP, _VP],
}


def _fn(name: str):
    fn = getattr(_build.load("lminv"), name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
    return fn


def _validate(name: str, blocks: torch.Tensor, vec: torch.Tensor) -> None:
    """Raise unless ``blocks`` is ``[La, 9]`` and ``vec`` ``[La, 3]``, both
    f64 or both f32, on one device."""
    check_floats(name, blocks, vec)
    if vec.device != blocks.device:
        raise ValueError(f"{name}: all operands must be on one device")
    La = blocks.shape[0]
    if blocks.shape != (La, 9) or vec.shape != (La, 3):
        raise ValueError(f"{name}: expects blocks [La, 9] and a vector [La, 3]")


def _check(name: str, blocks: torch.Tensor, vec: torch.Tensor):
    """Validate the operands of a CUDA launch; returns them contiguous."""
    if blocks.device.type != "cuda":
        raise NotImplementedError(f"{name}: no kernel for device {blocks.device}")
    _validate(name, blocks, vec)
    return blocks.contiguous(), vec.contiguous()


def damped_inverse_operands(Hll: torch.Tensor, bl: torch.Tensor):
    """B4's operands as its kernel reads them: ``(Hll, ldh, bl, ldb)``, each
    tensor with its row stride in entries.  A tensor whose entries lie
    adjacent within a row (inner stride 1) is passed as it is, at any row
    stride and offset: the solver's column blocks of ``[La, 12]`` rows keep
    their storage and stride 12.  Any other is copied to contiguous rows.
    Raises for the wrong type, shape or a second device."""
    _validate("damped_inverse", Hll, bl)
    if Hll.stride(1) != 1:
        Hll = Hll.contiguous()
    if bl.stride(1) != 1:
        bl = bl.contiguous()
    return Hll, Hll.stride(0), bl, bl.stride(0)


def _check_lam(lam, ref: torch.Tensor) -> None:
    """Raise unless ``lam`` is a 0-d tensor of ``ref``'s type on its
    device."""
    if not isinstance(lam, torch.Tensor) or lam.dtype != ref.dtype or lam.dim() != 0:
        name = "f64" if ref.dtype == torch.float64 else "f32"
        raise TypeError(f"damped_inverse: expects lam as a 0-d {name} tensor")
    if lam.device != ref.device:
        raise ValueError("damped_inverse: lam must be on the operands' device")


def damped_inverse(Hll: torch.Tensor, bl: torch.Tensor, lam: torch.Tensor):
    """``Hll [La, 9], bl [La, 3], lam [] -> (inv(Hll + lam I) [La, 9],
    y = inv bl [La, 3])`` in the operands' type (f64 or f32), both
    contiguous (kernel B4 on CUDA, one launch).  ``lam`` is a 0-d tensor of
    that type on the operands' device; the kernel reads it there, so
    nothing is read back or uploaded."""
    if Hll.device.type == "cpu":
        _check_lam(lam, Hll)
        return damped_inverse_plain(Hll, bl, lam)
    if Hll.device.type != "cuda":
        raise NotImplementedError(f"damped_inverse: no kernel for device {Hll.device}")
    _check_lam(lam, Hll)
    Hll, ldh, bl, ldb = damped_inverse_operands(Hll, bl)
    La = Hll.shape[0]
    inv = torch.empty((La, 9), dtype=Hll.dtype, device=Hll.device)
    y = torch.empty((La, 3), dtype=Hll.dtype, device=Hll.device)
    if La == 0:
        return inv, y
    status = _fn("tba_damped_inverse")(
        Hll.data_ptr(), ldh, bl.data_ptr(), ldb, lam.data_ptr(), La, f32_flag(Hll.dtype),
        inv.data_ptr(), y.data_ptr(), _build.stream_ptr(Hll),
    )
    _build.check(status, "damped_inverse")
    damped_inverse.launches += 1
    return inv, y


def sym3x3_mv(invHll: torch.Tensor, cl: torch.Tensor) -> torch.Tensor:
    """``inv [La, 9], cl [La, 3] -> xl = inv cl [La, 3]`` in the operands'
    type (kernel B10 on CUDA)."""
    if invHll.device.type == "cpu":
        return sym3x3_mv_plain(invHll, cl)
    invHll, cl = _check("sym3x3_mv", invHll, cl)
    xl = torch.empty_like(cl)
    La = invHll.shape[0]
    if La == 0:
        return xl
    status = _fn("tba_sym3x3_mv")(
        invHll.data_ptr(), cl.data_ptr(), La, f32_flag(invHll.dtype), xl.data_ptr(),
        _build.stream_ptr(invHll)
    )
    _build.check(status, "sym3x3_mv")
    sym3x3_mv.launches += 1
    return xl


damped_inverse.launches = 0
sym3x3_mv.launches = 0
