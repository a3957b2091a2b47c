"""The host LM loop (counterpart of the JAX package's host loop in
``optimizer.py``).

:class:`HostLoop` drives a solver through the step interface the fused loop
drives (``solver/fused.py``: ``linearise``, ``trial(sys, lam)``,
``accept``, ``start_chi``, ``head_chi``, ``top_diagonal``, ``cg``), one
card's (``BlockSolver``) or a rank's (``parallel/distributed.py
RankSolver``), and keeps the LM state in Python floats on the host.  At
iteration 0 it reads F (``start_chi()``, or ``head_chi`` where that is
None) and the largest diagonal entry in one read, and takes ``lam = TAU *
top``; after every trial it reads ``[Fhat, scale, success]`` in one read
and applies :func:`lm_update`.  F is carried from the accepted trial, as in
the fused loop, so the head runs no chi pass.  One read a trial and one at
iteration 0, with the PCG route's block reads.

The constants are the fused loop's (imported from there, so the two loops
cannot drift), and :func:`lm_update` here and ``fused.lm_update`` agree bit
for bit at f64.  In f32 mode lambda stays a Python float here, as in the
JAX package's host loop.
"""

from __future__ import annotations

import math
import time
from typing import Callable, Optional

import torch

from . import pcg
from .fused import MAXQ, RHO_DONE, TAU


def lm_update(F: float, Fhat: float, scale: float, success: bool, lam: float, nu: float,
              q: int):
    """The verdict on one trial, in Python floats: returns ``(accept, stop,
    rho, lam, nu, q)``.  ``stop``: no more trials this iteration because the
    step was accepted or the damping bailed out (``fused.lm_update`` is the
    same rule on device scalars)."""
    scale = scale + 1e-3
    Fdiff = Fhat - F
    rho = (F - Fhat) / scale if success else -1.0
    if rho > 0:
        x = 2.0 * rho - 1.0
        lam *= min(max(1.0 - x * x * x, 1.0 / 3.0), 2.0 / 3.0)
        return True, True, rho, lam, 2.0, q
    lam *= nu
    nu *= 2.0
    if not math.isfinite(lam) or Fdiff < 1e-4:
        return False, True, rho, lam, nu, q
    return False, False, rho, lam, nu, q + 1


def lm_done(q: int, rho: float, lam: float) -> bool:
    """The outer termination test after an iteration."""
    return q == MAXQ or rho < RHO_DONE or not math.isfinite(lam)


class HostLoop:
    """One ``optimize(niterations)`` of the host loop over a solver whose
    structure is built.  :meth:`run` returns the chi2 trace and leaves the
    final state in ``solver.graph``; ``stats`` then holds the trials, the
    host reads (``trials + 1`` and the CG blocks') and the CG iterations of
    every trial.  ``on_iteration(iteration, F, lam, rho, q, ms)`` is called
    after each iteration with its LM state and host-clock ms."""

    def __init__(self, solver, niterations: int,
                 on_iteration: Optional[Callable[..., None]] = None):
        self.solver = solver
        self.n = int(niterations)
        self.on_iteration = on_iteration
        self.stats = dict(trials=0, reads=0, cg_iterations=[])

    def run(self) -> list[float]:
        s = self.solver
        s.cg = pcg.CgRunner()
        nu, lam, F = 2.0, 0.0, 0.0
        trace = []
        for it in range(self.n):
            t0 = time.perf_counter()
            sys = s.linearise()
            if it == 0:
                chi = s.start_chi()
                F, top = torch.stack(
                    [s.head_chi if chi is None else chi, s.top_diagonal(sys)]).tolist()
                lam = TAU * top
            q, rho = 0, -1.0
            while q < MAXQ and rho < 0:
                new_graph, Fhat, scale, success = s.trial(sys, lam)
                self.stats["trials"] += 1
                Fhat, scale, ok = torch.stack([Fhat, scale, success.to(Fhat.dtype)]).tolist()
                accept, stop, rho, lam, nu, q = lm_update(F, Fhat, scale, ok > 0, lam, nu, q)
                if accept:
                    F = Fhat
                    s.accept(new_graph)
                if stop:
                    break
            trace.append(F)
            if self.on_iteration is not None:
                self.on_iteration(it, F, lam, rho, q, (time.perf_counter() - t0) * 1e3)
            if lm_done(q, rho, lam):
                break
        self.stats.update(reads=self.stats["trials"] + 1 + s.cg.reads,
                          cg_iterations=s.cg.iterations)
        return trace
