"""Fixed-order segment sums (counterpart of ``solver/segments.py``).

The JAX package reduces per-edge rows through bucket plans and the
co-visibility group layout.  The port sorts the rows by target once per
structure and sums each target's run in that order, so every per-pose,
per-landmark and per-block-row sum is deterministic without float atomics.
The sort is a stable counting sort over the known range of targets, in C++
(``native/symbolic.cpp`` through :mod:`.native_symbolic`): linear in the
rows, and the order ``np.argsort(ids, kind="stable")`` gives.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .native_symbolic import counting_sort


class Segments(NamedTuple):
    """A fixed-order segment sum plan: ``sum_j values[order[j]]`` over
    ``offsets[s] <= j < offsets[s+1]`` for segment ``s``.  ``order`` is a
    stable sort of the rows by target, truncated to rows whose target is in
    range (rows of fixed vertices drop out)."""

    order: torch.Tensor  # [n] int64
    offsets: torch.Tensor  # [nseg + 1] int64


def make_segments(ids: np.ndarray, nseg: int, device) -> Segments:
    """The plan of rows with targets ``ids`` into ``nseg`` segments; ids
    ``>= nseg`` drop out, a negative id raises ValueError."""
    order, offsets = counting_sort(ids, nseg)
    return Segments(
        order=torch.as_tensor(order, device=device),
        offsets=torch.as_tensor(offsets, device=device),
    )


def segment_sum(values: torch.Tensor, seg: Segments) -> torch.Tensor:
    """Fixed-order sum of the rows of ``values`` per segment (no atomics).
    ``unsafe=True`` skips ``segment_reduce``'s validation of the offsets,
    which reads them back to the host (a device synchronise on every call,
    and a failure under CUDA-graph capture): :func:`make_segments` made them
    once a structure, sorted, from 0 to the row count.  It changes no
    arithmetic."""
    return torch.segment_reduce(
        values.index_select(0, seg.order), "sum", offsets=seg.offsets, unsafe=True
    )
