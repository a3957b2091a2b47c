"""Stage timing with the reference's nine TimeProfile keys (counterpart of
``utils/profiling.py``).

A stage is timed on the host clock; when its device is a CUDA card the timer
synchronises that device before reading the clock, so the time covers the
stage's kernels and not only their enqueue.
"""

from __future__ import annotations

import time
from contextlib import contextmanager

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

TimeProfile = dict


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
