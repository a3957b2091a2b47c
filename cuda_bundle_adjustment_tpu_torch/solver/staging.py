"""One upload of a graph's host arrays (the packing layer's staging block).

Each array is copied once, in its own dtype, into an 8-byte-aligned slot of
one ``uint8`` block, and the block goes to the device in one copy, where
each array is read as a typed view of the device buffer at its offset (the
reference's pinned arena and its one memcpy, ``arena.h``).  On a CUDA device
the block is pinned, from torch's caching host allocator: the copy is
asynchronous, and the allocator hands the block to a later pack only once
the copy has completed, so no block is kept across packs here.  On the CPU
the block is the buffer, and nothing is copied.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

# the dtypes a slot holds as they come; anything else is converted first
_TORCH = {np.dtype(np.float64): torch.float64, np.dtype(np.float32): torch.float32,
          np.dtype(np.int32): torch.int32, np.dtype(np.int64): torch.int64}
FLOATS = (np.dtype(np.float64), np.dtype(np.float32))
INTS = (np.dtype(np.int32), np.dtype(np.int64))


def own(a, kinds: tuple, default) -> np.ndarray:
    """``a`` as an array in its own dtype where that is one of ``kinds``,
    else converted to ``default``."""
    a = np.asarray(a)
    return a if a.dtype in kinds else a.astype(default)


class Slot(NamedTuple):
    offset: int
    nbytes: int
    dtype: torch.dtype
    shape: tuple


def _host_allocs() -> int:
    """Pinned blocks torch's caching host allocator has made so far (its
    statistics are empty until CUDA is initialised: none then)."""
    return int(torch.cuda.host_memory_stats().get("num_host_alloc", 0))


class Staging:
    """The arrays of one pack, laid out in one block: :meth:`add` each array,
    :meth:`stage` the block (the host's one copy of each), :meth:`upload` it,
    and read each array back by :meth:`view`.  ``stats``: the bytes staged,
    the host-to-device copies made (1 on a card, 0 on the CPU) and whether
    the block was a new pinned allocation (``pinned_new``)."""

    def __init__(self, device: torch.device):
        self.device = device
        self.nbytes = 0
        self._arrays: list = []
        self._block = None
        self.stats = dict(bytes=0, copies=0, pinned_new=0)

    def add(self, a: np.ndarray) -> Slot:
        """Reserve a slot for ``a`` (an array in one of ``_TORCH``'s dtypes);
        its bytes are copied at :meth:`stage`."""
        slot = Slot(self.nbytes, a.nbytes, _TORCH[a.dtype], a.shape)
        self._arrays.append((a, slot))
        self.nbytes += -(-a.nbytes // 8) * 8
        return slot

    def stage(self) -> None:
        """Copy every array into its slot of the block (pinned on a card)."""
        pinned = self.device.type == "cuda"
        before = _host_allocs() if pinned else 0
        self._block = torch.empty(self.nbytes, dtype=torch.uint8, pin_memory=pinned)
        if pinned:
            self.stats["pinned_new"] = int(_host_allocs() > before)
        host = self._block.numpy()
        for a, s in self._arrays:
            np.copyto(host[s.offset:s.offset + s.nbytes].view(a.dtype).reshape(a.shape), a)
        self._arrays = []
        self.stats["bytes"] = self.nbytes

    def upload(self) -> torch.Tensor:
        """The block on the device: one asynchronous copy on a card (the
        block goes back to the allocator, which keeps it from a later pack
        until the copy has completed), the block itself on the CPU."""
        block, self._block = self._block, None
        if self.device.type != "cuda":
            return block
        buf = torch.empty(self.nbytes, dtype=torch.uint8, device=self.device)
        buf.copy_(block, non_blocking=True)
        self.stats["copies"] = 1
        return buf

    @staticmethod
    def view(buf: torch.Tensor, slot: Slot) -> torch.Tensor:
        """The array of ``slot`` in the uploaded buffer (a view of it)."""
        return buf[slot.offset:slot.offset + slot.nbytes].view(slot.dtype).view(slot.shape)
