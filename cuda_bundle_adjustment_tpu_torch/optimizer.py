"""The Levenberg-Marquardt graph optimiser (counterpart of ``optimizer.py``).

:class:`TorchGraphOptimisation` is the counterpart of the JAX package's
``TpuGraphOptimisation`` and runs its two LM loops: ``maxq = 10`` inner
trials, ``tau = 1e-5`` initial-lambda factor, the ``clamp(1 - (2 rho -
1)^3, 1/3, 2/3)`` attenuation, the ``+1e-3`` scale epsilon and the same
termination tests.  By default ``optimize`` runs the device-resident loop
(``solver/fused.py``: CUDA-graph replays on the card, the same step
functions run eagerly on the CPU), as the JAX package does; under
``verbose`` or ``set_profile(True)``, or with ``use_fused_loop = False``,
it runs the host loop (``solver/host_loop.py``), which reads every value on
the host where it is made.  The two give the same trace and final state bit
for bit.  A graph
whose structure the structure cache holds replays the fused loop an earlier
solve of that structure kept: no eager iteration and no capture.

A graph is given as vertex and edge sets (``add_vertex_set``,
``add_edge_set``, then ``initialize()``), or as arrays
(``io.arrays.optimizer_from_problem``).  Both loops end in the solver's
``update_edges()``, which masks the edges above their set's outlier
threshold for the next ``optimize()``, and ``finalize()``, which writes the
estimates back into the vertex sets.
"""

from __future__ import annotations

import time
from typing import Optional, Sequence, Union

import torch

from .graph import EdgeSet, GraphOptimisationOptions, VertexSet
from .solver.block_solver import BlockSolver
from .solver.fused import FusedLoop, loop_key
from .solver.host_loop import HostLoop
from .utils import profiling as prof
from .utils.stats import BatchInfo, BatchStatistics


class TorchGraphOptimisation:
    """Graph optimiser holding vertex and edge sets and a block solver on
    one torch device: the CUDA card unless the caller asks for
    ``device="cpu"`` (without a card the default raises ``RuntimeError``;
    there is no fallback)."""

    def __init__(
        self,
        options: Optional[GraphOptimisationOptions] = None,
        device: Union[str, torch.device] = "cuda",
    ):
        self.options = options or GraphOptimisationOptions()
        self.vertex_sets: list[VertexSet] = []
        self.edge_sets: list[EdgeSet] = []
        self.solver = BlockSolver(self.options, device)
        self.stats = BatchStatistics()
        self.timer = prof.StageTimer()
        self.verbose = False
        self.should_profile = False
        self.use_fused_loop = True
        # the last fused run's FusedLoop.stats (trials, host reads, captures,
        # replays, whether it replayed a kept loop, host-clock ms and read
        # waits, CG iterations); None before one
        self.loop_stats: Optional[dict] = None
        # the CG iterations of every trial of the last optimize() on the PCG
        # route, through either loop (empty on the other routes)
        self.cg_iterations: list[int] = []

    @classmethod
    def create(
        cls,
        options: Optional[GraphOptimisationOptions] = None,
        device: Union[str, torch.device] = "cuda",
    ):
        return cls(options, device)

    @property
    def device(self) -> torch.device:
        return self.solver.device

    @property
    def pack_stats(self) -> Optional[dict]:
        """The last packing's counters (``BlockSolver.pack_stats``): the
        staging block's ``bytes``, its host-to-device ``copies`` (1 on a
        card, 0 on the CPU) and ``pinned_new`` (1 where the pack had to
        allocate a new pinned block); None before a packing."""
        return self.solver.pack_stats

    def add_vertex_set(self, vset: VertexSet) -> None:
        self.vertex_sets.append(vset)

    def add_edge_set(self, eset: EdgeSet) -> None:
        self.edge_sets.append(eset)

    def n_vertices(self, set_id: int) -> int:
        return len(self.vertex_sets[set_id])

    def get_edge_sets(self) -> Sequence[EdgeSet]:
        return self.edge_sets

    # -- lifecycle ---------------------------------------------------------------

    def initialize(self) -> None:
        """Pack the vertex and edge sets onto the device (stage "0:
        Initialize"), and clear the statistics and the stage times."""
        t0 = time.perf_counter()
        self.solver.initialize(self.edge_sets, self.vertex_sets)
        self.stats.clear()
        self.timer.clear()
        self.timer.add(prof.PROF_INITIALIZE, (time.perf_counter() - t0) * 1e3)

    def optimize(self, niterations: int) -> None:
        solver = self.solver
        if solver.graph is None:
            raise RuntimeError("optimize() called before the graph was packed")

        # stages 1 + 5: the structure span of this build_structure()
        total_ms = solver.spans.get("structure", 0.0)
        solver.build_structure()
        total_ms = solver.spans["structure"] - total_ms
        self.timer.add(prof.PROF_SYMBOLIC_DECOMP, solver.symbolic_ms)
        self.timer.add(prof.PROF_BUILD_STRUCTURE, total_ms - solver.symbolic_ms)
        # the device-resident loop unless the caller asks to see every
        # iteration or stage (verbose, profile): the host loop, same trace
        fused = self.use_fused_loop and not (self.verbose or self.should_profile)
        if fused:
            trace = self._optimize_fused(niterations)
        else:
            loop = HostLoop(solver, niterations, self._print_iteration if self.verbose else None)
            solver.timer = self.timer if self.should_profile else None
            try:
                trace = loop.run()
            finally:
                solver.timer = None
            self.cg_iterations = loop.stats["cg_iterations"]
        for it, chi2 in enumerate(trace):
            self.stats.add_stat(BatchInfo(it, chi2))
        solver.update_edges()
        solver.finalize()
        prof.record_solve(solver.spans, self.loop_stats if fused else None, solver.pack_stats)

    def _optimize_fused(self, niterations: int) -> list[float]:
        solver = self.solver
        # a structure the cache holds keeps its loop for its next solve, which
        # replays it (FusedLoop.bind); a miss runs a loop of its own and keeps
        # nothing
        key = loop_key(solver, niterations) if solver.structure_hit else None
        loop = None if key is None else solver.take_loop(key)
        if loop is None:
            loop = FusedLoop(solver, niterations, keep=key is not None)
        else:
            loop.bind(solver)
        trace = loop.run()
        if key is not None:
            solver.keep_loop(key, loop)
        solver.spans.add(loop.spans)
        self.loop_stats = loop.stats
        self.cg_iterations = loop.stats["cg_iterations"]
        return trace

    def _print_iteration(self, iteration: int, F: float, lam: float, rho: float, q: int,
                         ms: float) -> None:
        """The verbose line of one host-loop iteration."""
        print(
            f"iteration= {iteration};   time(ms): {ms:.4f}   "
            f"chi2= {F:f};   lambda= {lam:f}   rho= {rho:f}\t   "
            f"nedges= {self.solver.nedges()}    levenberg iterations = {q}   "
            f"outliers = {sum(es.get_outlier_count() for es in self.edge_sets)}"
        )

    # -- introspection -------------------------------------------------------------

    def batch_statistics(self) -> BatchStatistics:
        return self.stats

    def time_profile(self) -> prof.TimeProfile:
        return dict(self.timer.profile)

    def span_profile(self) -> dict:
        """Host-clock ms by span name since the graph was packed
        (``utils/profiling.py``): ``pack/arrays``, ``pack/upload``,
        ``structure/digest``, ``structure/order`` (a structure-cache miss),
        ``structure``, ``structure/symbolic`` and ``structure/plan`` (a
        miss), and the fused loop's ``loop/eager``, ``loop/capture``,
        ``loop/replay``, ``loop/read`` and ``loop/bind`` (a kept loop's
        copies in and out), summed over the optimize() calls.  A span that
        did not run is absent."""
        return dict(self.solver.spans)

    def set_verbose(self, flag: bool = True) -> None:
        self.verbose = bool(flag)

    def set_profile(self, flag: bool = True) -> None:
        self.should_profile = bool(flag)

    # camelCase aliases matching the reference API
    addVertexSet = add_vertex_set
    addEdgeSet = add_edge_set
    nVertices = n_vertices
    getEdgeSets = get_edge_sets
    batchStatistics = batch_statistics
    timeProfile = time_profile
    setVerbose = set_verbose
    setProfile = set_profile


# the reference's name for its implementation class
TorchGraphOptimisationImpl = TorchGraphOptimisation
