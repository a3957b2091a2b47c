"""Stage timing with the reference's nine TimeProfile keys (counterpart of
``utils/profiling.py``), and the port's own spans.

A stage is timed on the host clock; when its device is a CUDA card the timer
synchronises that device before reading the clock, so the time covers the
stage's kernels and not only their enqueue.

A span (:meth:`Spans.span`) times one piece of the port's work where it
runs: packing, the structure pass and the LM loop.  It always adds its
host-clock ms to a per-optimiser dict (``TorchGraphOptimisation.span_profile``);
only while a torch profiler is running does it also open
``record_function("ba/" + name)``, so that the trace names what the host
does beside the device's work.  No profiler, no ``record_function``: one
costs microseconds even with nothing recording, the check a tenth of one.
Each ``optimize()`` leaves its span readings, the fused loop's scalar
counters and the packing's counters in :func:`solve_history`, for a caller
that does not keep the optimiser.
"""

from __future__ import annotations

import time
from collections import deque
from contextlib import contextmanager
from typing import Optional

import torch

PROF_INITIALIZE = "0: Initialize Optimizer"
PROF_BUILD_STRUCTURE = "1: Build Structure"
PROF_COMPUTE_ERROR = "2: Compute Error"
PROF_BUILD_SYSTEM = "3: Build System"
PROF_SCHUR_COMPLEMENT = "4: Schur Complement"
PROF_SYMBOLIC_DECOMP = "5: Symbolic Decomposition"
PROF_NUMERICAL_DECOMP = "6: Numerical Decomposition"
PROF_UPDATE = "7: Update Solution"
PROF_SOLVE_HPP = "8: Hpp linear solver"

ALL_STAGES = [
    PROF_INITIALIZE,
    PROF_BUILD_STRUCTURE,
    PROF_COMPUTE_ERROR,
    PROF_BUILD_SYSTEM,
    PROF_SCHUR_COMPLEMENT,
    PROF_SYMBOLIC_DECOMP,
    PROF_NUMERICAL_DECOMP,
    PROF_UPDATE,
    PROF_SOLVE_HPP,
]

# a span's name in a profiler trace: this prefix and its own name
SPAN_PREFIX = "ba/"

TimeProfile = dict


def profiling() -> bool:
    """Whether a torch profiler is recording (about 0.1 us to ask)."""
    return torch.autograd._profiler_enabled()


class StageTimer:
    def __init__(self):
        self.profile: TimeProfile = {k: 0.0 for k in ALL_STAGES}

    def clear(self) -> None:
        for k in self.profile:
            self.profile[k] = 0.0

    @contextmanager
    def stage(self, name: str, device: torch.device):
        t0 = time.perf_counter()
        yield
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        self.profile[name] = self.profile.get(name, 0.0) + (time.perf_counter() - t0) * 1e3

    def add(self, name: str, millis: float) -> None:
        self.profile[name] = self.profile.get(name, 0.0) + millis


class Spans(dict):
    """Host-clock ms by span name, summed over every run of each span."""

    def span(self, name: str) -> "Span":
        return Span(self, name)

    def add(self, other: dict) -> None:
        for k, ms in other.items():
            self[k] = self.get(k, 0.0) + ms


class Span:
    """One run of a span (a context manager): its ms go into its
    :class:`Spans` at the end, and stay in ``ms``."""

    __slots__ = ("_spans", "_name", "_t0", "_rf", "ms")

    def __init__(self, spans: Spans, name: str):
        self._spans, self._name, self.ms = spans, name, 0.0

    def __enter__(self) -> "Span":
        self._rf = None
        if profiling():
            self._rf = torch.profiler.record_function(SPAN_PREFIX + self._name)
            self._rf.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        self.ms = (time.perf_counter() - self._t0) * 1e3
        self._spans[self._name] = self._spans.get(self._name, 0.0) + self.ms
        if self._rf is not None:
            self._rf.__exit__(*exc)
        return False


# the span readings and the fused loop's scalar counters of the newest
# optimize() calls of the process, oldest first
SOLVE_HISTORY = 4096
_HISTORY: deque = deque(maxlen=SOLVE_HISTORY)


def record_solve(spans: dict, loop: Optional[dict], pack: Optional[dict] = None) -> None:
    counters = None if loop is None else {
        k: v for k, v in loop.items() if isinstance(v, (int, float))}
    _HISTORY.append(dict(spans=dict(spans), loop=counters,
                         pack=None if pack is None else dict(pack)))


def solve_history() -> list[dict]:
    """One dict for each of the process's last ``SOLVE_HISTORY``
    ``optimize()`` calls, oldest first: ``spans`` (the optimiser's span
    readings so far, :meth:`TorchGraphOptimisation.span_profile`),
    ``loop`` (the scalar counters of the fused loop's ``loop_stats``:
    trials, reads, captures, replays and host ms; None on the host loop)
    and ``pack`` (the packing's ``pack_stats``: bytes staged, copies,
    ``pinned_new``)."""
    return list(_HISTORY)
