"""The two working types of the kernels and what their twins do in f32.

Every kernel reads and writes the working type (f64, or f32 in f32 mode)
and computes in f64 registers: an f32 input enters exact, the arithmetic is
the f64 kernel's, and each output is rounded to f32 once, at its store.
Partial sums that a kernel leaves in device memory between its passes stay
f64.  The plain twins do the same in plain PyTorch: upcast the operands
(:func:`wide`), run the f64 twin and round the outputs (:func:`narrow`), so
that an f32 kernel is held against its twin as tightly as an f64 one.  At
f64 both are no-ops.
"""

from __future__ import annotations

import torch

FLOATS = (torch.float64, torch.float32)


def wide(t):
    """``t`` in f64 (None passes; an f64 tensor is returned as it is)."""
    return None if t is None else t.to(torch.float64)


def wide_edges(data):
    """A ``PackedEdges`` with its float fields in f64."""
    return data._replace(
        meas=wide(data.meas), omega=wide(data.omega), cam=wide(data.cam),
        both_free=wide(data.both_free), active=wide(data.active), mask3=wide(data.mask3),
    )


def narrow(dtype: torch.dtype, *ts):
    """Each of ``ts`` rounded to ``dtype`` once (one tensor, or a tuple)."""
    out = tuple(t.to(dtype) for t in ts)
    return out[0] if len(out) == 1 else out


def check_floats(name: str, *ts) -> torch.dtype:
    """The one working type of ``ts`` (None skipped); raises ``TypeError``
    unless they share f64 or f32."""
    dtypes = {t.dtype for t in ts if t is not None}
    if len(dtypes) != 1 or not dtypes <= set(FLOATS):
        raise TypeError(f"{name}: expects f64 or f32 operands of one type, got {sorted(map(str, dtypes))}")
    return dtypes.pop()


def f32_flag(dtype: torch.dtype) -> int:
    """The launchers' type argument: 1 for f32, 0 for f64."""
    return int(dtype == torch.float32)
