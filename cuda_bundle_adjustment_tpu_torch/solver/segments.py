"""Fixed-order segment sums (counterpart of ``solver/segments.py``).

The JAX package reduces per-edge rows through bucket plans and the
co-visibility group layout.  The port sorts the rows by target once per
structure and sums each target's run in that order, so every per-pose,
per-landmark and per-block-row sum is deterministic without float atomics.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class Segments(NamedTuple):
    """A fixed-order segment sum plan: ``sum_j values[order[j]]`` over
    ``offsets[s] <= j < offsets[s+1]`` for segment ``s``.  ``order`` is a
    stable sort of the rows by target, truncated to rows whose target is in
    range (rows of fixed vertices drop out)."""

    order: torch.Tensor  # [n] int64
    offsets: torch.Tensor  # [nseg + 1] int64


def make_segments(ids: np.ndarray, nseg: int, device) -> Segments:
    ids = np.asarray(ids, dtype=np.int64)
    order = np.argsort(ids, kind="stable")
    offsets = np.searchsorted(ids[order], np.arange(nseg + 1), side="left")
    return Segments(
        order=torch.as_tensor(order[: offsets[-1]], device=device),
        offsets=torch.as_tensor(offsets.astype(np.int64), device=device),
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
