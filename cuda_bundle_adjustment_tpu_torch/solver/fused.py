"""The device-resident LM loop (counterpart of ``solver/fused.py``).

The host loop (``solver/host_loop.py``) reads Fhat, the scale and the
solve's verdict after every trial, and makes every one of a trial's ~800
launches from Python.  Here the LM state lives on the solver's device as
0-d tensors -- lambda, nu, F and the chi2 trace in the working type (f64,
or f32 in f32 mode, as in the JAX package's fused loop), the trial count
and the iteration counter in int32 -- and each step is made of pieces,
each a function of those tensors alone (:data:`STEPS`):

* ``linearise``: the linearisation (``build_system`` only: F is carried
  from the accepted trial, as in the JAX package, so the head runs no chi
  pass) into the loop's system ``sys``;
* ``damp``: iteration 0's F (the chi2 the loop starts from) and lambda's
  first value ``TAU * max_diagonal`` into the loop's ``F`` and ``lam``;
* ``trial``: one damped trial on ``sys`` with the loop's ``lam`` and the LM
  update; ``retry``: the same, one more trial of this iteration.

Iteration 0 is the step ``first`` (linearise, damp, trial), every later
iteration ``linearise_and_trial`` (linearise, trial), and every further
trial of an iteration ``retry``.

On the card each piece is captured once into a CUDA graph and a step
replays its pieces' graphs in order, so ``first`` and
``linearise_and_trial`` share the linearisation's graph, and a retry reads
the system where that one graph writes it.  On the PCG route a trial's CG
runs in blocks of iterations whose number depends on the data
(``solver/pcg.py``), so its capture is cut in three graphs: up to the first
CG block, one CG block, and the rest.  A replay runs the first, then the CG
block through the solver's ``pcg.CgRunner`` (one host read of ``[done,
iterations]`` a block, as the eager steps and the host loop run the blocks)
until it reports done, then the rest.  A new loop runs iteration 0
eagerly: that is the warm-up every capture needs (kernel modules loaded,
shared-memory attributes set, the library's lazy state made) and it is
iteration 0's own work, so nothing runs twice and the trace cannot move.
From iteration 1 on each piece is captured at its first use.  Every capture
goes into one memory pool, and the loop holds the system the captured
linearisation made (the one tensor of the pool that a step passes on to
the next), so no later capture is given its memory.  That pool is the process's for the
device (:func:`_capture_pool`), shared by every loop: loops run one at a
time and a graph writes every other block it uses before it reads it, so
the next loop may take the blocks a loop gave back, and a capture allocates
no device memory once a loop of that size has run.

A loop may be kept across solves of one structure (``keep=True``; the
optimiser keeps one where the structure cache hit, ``optimizer.py``): it
then runs over copies of its solver's state and edge data
(``BlockSolver.loop_shell``), captures ``first`` too at the end of its run,
keeps its system, and copies the final state out into new tensors for its
solver.  :meth:`FusedLoop.bind` hands it the next solver of the structure:
that solver's state and edge data are copied into the loop's tensors, the
LM state is reset on the device, and the run replays every step, iteration
0 included, with no eager step and no capture.  The same kernels run on the
same values, so the trace and the final state are a new loop's bit for bit.

After every trial the host reads two flags (another trial of this
iteration? is the loop done?) through pinned memory, and at the end the
trace and the iteration count: one read a trial and one a run.  A capture
or a replay that fails raises: nothing goes on eagerly or on the host
loop.  On the CPU the same pieces run eagerly and nothing is captured.

The loop's host time is kept in spans (``utils/profiling.py``):
``loop/eager``, ``loop/capture`` and ``loop/replay``, a kept loop's copies
in and out in ``loop/bind``, each step's flag read and the trace read in
``loop/read``.

The loop drives any solver with this step interface (as the host loop
does): ``graph``, ``device``, ``dtype``, ``cg``, ``accept``,
``linearise``, ``trial(sys, lam)`` on its own graph, and what differs
between one card and a rank of the distributed path (``parallel/distributed.py RankSolver``):
``start_chi()`` (the chi2 the loop starts from, or None where iteration 0's
linearisation gives it, as a rank's all-reduced head does: then the
solver's ``head_chi``), ``top_diagonal(sys)`` (the largest diagonal entry
of the whole system, a 0-d tensor: over every rank there, through one
``all_reduce(MAX)``), ``capturable`` (whether its steps may be captured: on
the card, and for a rank only under NCCL, whose collectives a CUDA graph
can hold; gloo's run eagerly) and ``comm`` (the collectives it counts, or
None).

A rejected trial leaks nothing: its candidate is selected away by
``torch.where`` into the loop's own ``q``/``t``/``Xw`` buffers, which the
next linearisation reads.  Launch counters (``kernels.launch_counts``)
and the solver's collectives (``comm``: calls and bytes) count what the
device runs: a capture's increments are taken back and added again on every
replay.

Control flow of the JAX package's ``optimize_fused``, operation for
operation (its ``while_loop`` of trials inside a ``fori_loop`` of
iterations): ``MAXQ`` trials at most, accept on ``rho > 0`` with
``lam *= clamp(1 - (2 rho - 1)^3, 1/3, 2/3)`` and ``nu = 2``, reject with
``lam *= nu`` and ``nu *= 2``, bail on a non-finite lambda or ``Fhat - F <
1e-4``, stop on ``q == MAXQ``, ``rho < RHO_DONE`` or a non-finite lambda.
The float rule of the host loop (``host_loop.lm_update``) and
:func:`lm_update` here agree bit for bit at f64, so the two loops' traces
do.  In f32 the constants stay weak (a Python float times an f32 tensor is
f32), so the LM state stays f32 as in the JAX package's fused loop, while
the host loop keeps lambda as a Python float, as the JAX package's host
loop does: in f32 the two loops are not bit for bit in either package.
"""

from __future__ import annotations

import torch

from .. import kernels
from ..types import GraphArrays
from ..utils import profiling as prof
from . import pcg

MAXQ = 10  # inner trials at most
TAU = 1e-5  # initial lambda factor
# outer-termination rho threshold; the host loop (host_loop.py) imports these
# three constants from here, so the two loops cannot drift
RHO_DONE = 1e-6

# the pieces of each step, in the order they run (and their graphs replay)
STEPS = {
    "first": ("linearise", "damp", "trial"),
    "linearise_and_trial": ("linearise", "trial"),
    "retry": ("retry",),
}

# the capture memory pool and side stream of each CUDA device, made at the
# first capture on it and kept for the process, as the caching allocator
# keeps its own blocks
_CAPTURE: dict = {}


def _capture_pool(dev: torch.device):
    """``(pool, stream)`` that every loop on ``dev`` captures with.  The
    pool (a CUDA-graph memory pool id) takes a capture's allocations; it is
    held alive by an anchor graph of one fill node that is never replayed,
    so that blocks a finished loop's graphs and tensors gave back go to the
    next capture instead of new device memory.  (A pool's life is counted
    by the graphs captured into it, in the device and the pinned-host
    allocator both; a ``torch.cuda.MemPool`` holds only the first.)"""
    index = _index(dev)
    entry = _CAPTURE.get(index)
    if entry is None:
        stream = torch.cuda.Stream(index)
        anchor = torch.cuda.CUDAGraph()
        stream.wait_stream(torch.cuda.current_stream(index))
        with torch.cuda.stream(stream):
            anchor.capture_begin()
            torch.zeros(1, device=torch.device("cuda", index))
            anchor.capture_end()
        entry = _CAPTURE[index] = (anchor.pool(), stream, anchor)
    return entry[:2]


def _index(dev: torch.device) -> int:
    return torch.cuda.current_device() if dev.index is None else dev.index


def lm_update(F, Fhat, scale, success, lam, nu, q):
    """One trial's verdict and the LM update on 0-d tensors, the host
    loop's float rule operation for operation.  Returns ``(accept, F, lam,
    nu, rho, q, more, done)``: ``more`` asks for another trial of this
    iteration; ``done`` (read when ``more`` is False) ends the loop."""
    scale = scale + 1e-3
    rho = torch.where(success, (F - Fhat) / scale, -1.0)
    accept = rho > 0
    x = 2.0 * rho - 1.0
    att = torch.clamp(1.0 - x * x * x, 1.0 / 3.0, 2.0 / 3.0)
    lam = torch.where(accept, lam * att, lam * nu)
    nu = torch.where(accept, 2.0, nu * 2.0)
    stop = accept | ~torch.isfinite(lam) | (Fhat - F < 1e-4)
    q = torch.where(stop, q, q + 1)
    more = ~stop & (q < MAXQ) & (rho < 0)
    done = (q == MAXQ) | (rho < RHO_DONE) | ~torch.isfinite(lam)
    return accept, torch.where(accept, Fhat, F), lam, nu, rho, q, more, done


def loop_key(solver, niterations: int) -> tuple:
    """What a kept loop's graphs read by value, beyond its structure: the
    solver's (``BlockSolver.loop_layout``: the plan knobs, the edge sets'
    kinds, robust kernels and their parameters, the edge tensors' shapes),
    the iterations (the length of the trace) and the LM constants.  A kept
    loop serves a later solver of its structure only under the same key."""
    return (solver.loop_layout(), int(niterations), TAU, MAXQ, RHO_DONE)


class FusedLoop:
    """One ``optimize(niterations)`` of the device-resident loop over a
    solver whose structure is built.  :meth:`run` returns the chi2 trace and
    leaves the final state in ``solver.graph``; ``stats`` then holds the
    trials, host reads, captures and replays, whether the run replayed a
    kept loop (``reused``: 1 or 0), and the host-clock ms (the readings of
    :attr:`spans`) of the eager steps with a kept loop's copies in and out
    (``eager_ms``), the captures and the replays (each ending in its trial's
    flag read) and of the host's waits in its reads (``read_wait_ms``), and
    on the PCG route the CG iterations of every trial and the reads of
    their blocks (counted in the host reads).  ``graphs`` holds the
    captured graphs of each step by name, in replay order
    (``keep_graph=True``: their nodes can be inspected) until the loop is
    dropped.

    ``keep=True``: the loop runs over ``solver.loop_shell()``, its own
    copies of the solver's state and edge data, copies the final state out
    into ``solver.graph`` and stays fit for :meth:`bind` and another run."""

    def __init__(self, solver, niterations: int, keep: bool = False):
        # the solver whose graph the run solves and which takes the result;
        # a kept loop runs over its own shell of it
        self.owner = solver
        self.keep = keep
        if keep:
            solver = solver.loop_shell()
        self.solver = solver
        self.n = int(niterations)
        dev, dt, i32 = solver.device, solver.dtype, torch.int32
        # the loop's own state buffers, written in place: a captured graph
        # reads and writes them at the addresses it was captured with
        solver.accept(GraphArrays(*(a.clone() for a in solver.graph)))
        self.F = torch.zeros((), dtype=dt, device=dev)
        self.lam = torch.zeros((), dtype=dt, device=dev)
        self.nu = torch.full((), 2.0, dtype=dt, device=dev)
        self.q = torch.zeros((), dtype=i32, device=dev)
        self.it = torch.zeros((), dtype=i32, device=dev)
        self.trace = torch.zeros(self.n, dtype=dt, device=dev)
        self.flags = torch.zeros(2, dtype=torch.bool, device=dev)  # more, done
        self._iota = torch.arange(self.n, dtype=i32, device=dev)
        self._q0 = torch.zeros((), dtype=i32, device=dev)
        self.sys = None  # the current linearisation
        self.card = dev.type == "cuda"
        self.capture = solver.capturable
        self._host_flags = (
            torch.empty(2, dtype=torch.bool, pin_memory=True) if self.card else None
        )
        # each captured piece's graphs in replay order, with the launch counts
        # each adds a replay and, for a CG block, the status its runner reads;
        # each captured step's graphs, its pieces' in order
        self._pieces: dict[str, list[tuple]] = {}
        self._parts: dict[str, list[tuple]] = {}
        self._new_run(reused=False)

    def _new_run(self, reused: bool) -> None:
        """The counters, spans and CG runner of one run."""
        self.spans = prof.Spans()
        # the CG runner of this run: every PCG solve's iterations and reads
        self.solver.cg = pcg.CgRunner()
        self.stats = dict(trials=0, reads=0, captures=0, replays=0, reused=int(reused),
                          eager_ms=0.0, capture_ms=0.0, replay_ms=0.0, read_wait_ms=0.0,
                          cg_iterations=self.solver.cg.iterations, cg_reads=0)

    def bind(self, solver) -> None:
        """Make the next run of this kept loop solve ``solver``'s graph:
        ``solver`` is a later solver of the structure the loop was kept for,
        under the same :func:`loop_key`.  Its state and the edge data the
        graphs read by address are copied into the loop's tensors
        (``BlockSolver.load``), and the LM state is reset on the device; the
        copies are the span ``loop/bind``."""
        self.owner = solver
        self._new_run(reused=True)
        with self.spans.span("loop/bind"):
            self.solver.load(solver)
            for t in (self.F, self.lam, self.q, self.it, self.trace, self.flags):
                t.zero_()
            self.nu.fill_(2.0)

    @property
    def graphs(self) -> dict[str, list[torch.cuda.CUDAGraph]]:
        """Each captured step's graphs by name, in replay order."""
        return {name: [g for g, _, _ in parts] for name, parts in self._parts.items()}

    # -- the pieces of the steps ----------------------------------------------------

    def linearise(self) -> None:
        self.sys = self.solver.linearise()

    def damp(self) -> None:
        """Iteration 0's F and first lambda: F the chi2 the solver starts
        from (``start_chi``, or its ``head_chi`` where that is None) and
        ``lam = TAU * top_diagonal(sys)``."""
        s = self.solver
        F = s.start_chi()
        self.F.copy_(s.head_chi if F is None else F)
        self.lam.copy_(TAU * s.top_diagonal(self.sys))

    def trial(self) -> None:
        self._trial(self.lam, self._q0)

    def retry(self) -> None:
        self._trial(self.lam, self.q)

    def _trial(self, lam, q) -> None:
        s = self.solver
        new, Fhat, scale, success = s.trial(self.sys, lam)
        accept, F, lam, nu, _, q, more, done = lm_update(
            self.F, Fhat, scale, success, lam, self.nu, q)
        for dst, cand in zip(s.graph, new):
            dst.copy_(torch.where(accept, cand, dst))
        self.F.copy_(F)
        self.lam.copy_(lam)
        self.nu.copy_(nu)
        self.q.copy_(q)
        self.trace.copy_(torch.where(self._iota == self.it, F, self.trace))
        self.it.add_((~more).to(torch.int32))
        self.flags.copy_(torch.stack([more, done]))

    # -- host side ----------------------------------------------------------------

    def run(self) -> list[float]:
        iterations = 0
        # iteration 0 warms the captures up, eagerly, unless a kept loop
        # replays it
        warm = bool(self.stats["reused"])
        for it in range(self.n):
            iterations += 1
            eager = it == 0 and not warm
            more, done = self._step("first" if it == 0 else "linearise_and_trial", eager)
            while more:
                more, done = self._step("retry", eager)
            if done:
                break
        # one read for the trace and the device's iteration count; the CG
        # runner's reads (one a CG block) count as host reads too
        self.stats["cg_reads"] = self.solver.cg.reads
        self.stats["reads"] += 1 + self.solver.cg.reads
        with self.spans.span("loop/read"):
            *trace, n_done = torch.cat(
                [self.trace[:iterations], self.it.view(1).to(self.trace.dtype)]).tolist()
        if self.keep:
            # what the next run replays: iteration 0, and the step whose
            # pieces it shares, where this run did not reach it
            for name in ("linearise_and_trial", "first") if self.capture else ():
                if name not in self._parts:
                    self._capture(name)
            # the result in tensors of the caller's own, which no later run
            # of this loop writes
            with self.spans.span("loop/bind"):
                self.owner.accept(GraphArrays(*(a.clone() for a in self.solver.graph)))
        else:
            self.sys = None
        for key, name in (("eager_ms", "loop/eager"), ("capture_ms", "loop/capture"),
                          ("replay_ms", "loop/replay"), ("read_wait_ms", "loop/read")):
            self.stats[key] = self.spans.get(name, 0.0)
        self.stats["eager_ms"] += self.spans.get("loop/bind", 0.0)
        if int(n_done) != iterations:
            raise RuntimeError(
                f"fused loop: {int(n_done)} iterations on the device, {iterations} on the host")
        return trace

    def _step(self, name: str, eager: bool) -> list[bool]:
        self.stats["trials"] += 1
        if eager or not self.capture:
            with self.spans.span("loop/eager"):
                for piece in STEPS[name]:
                    getattr(self, piece)()
                return self._read()
        parts = self._parts.get(name)
        if parts is None:
            parts = self._capture(name)
        with self.spans.span("loop/replay"):
            for graph, delta, status in parts:
                if status is None:
                    graph.replay()
                else:  # a CG block, until it reports done
                    self.solver.cg(graph.replay, status)
                self._add_counts(delta)
            self.stats["replays"] += 1
            return self._read()

    def _read(self) -> list[bool]:
        """The two flags on the host: through pinned memory on the card."""
        self.stats["reads"] += 1
        with self.spans.span("loop/read"):
            if not self.card:
                return self.flags.tolist()
            self._host_flags.copy_(self.flags, non_blocking=True)
            torch.cuda.current_stream(self.solver.device).synchronize()
        return self._host_flags.tolist()

    def _counts(self) -> dict:
        """The launch counts and the solver's collectives (``comm.`` keys)."""
        counts = kernels.launch_counts()
        for k, n in (self.solver.comm or {}).items():
            counts["comm." + k] = n
        return counts

    def _add_counts(self, delta: dict) -> None:
        kernels.add_launch_counts({k: n for k, n in delta.items() if not k.startswith("comm.")})
        comm = self.solver.comm
        for k, n in delta.items():
            if k.startswith("comm."):
                comm[k[5:]] += n

    def _capture(self, name: str) -> list[tuple]:
        """Capture the pieces of step ``name`` that no step captured yet, on
        the device's capture stream into its pool, and make the step's
        graphs of its pieces'.  On the PCG route the solver's CG runner is
        replaced for the capture by one that ends the graph captured so far,
        captures one CG block into a graph of its own and begins the next: a
        trial becomes the graphs ``(graph, counts, None)`` and ``(block,
        counts, status)`` in replay order.  Capture launches nothing, so the
        launch and collective counts it moved are taken back and kept per
        graph for every replay.  A failure raises (after the capture is
        ended, so the stream is usable)."""
        with self.spans.span("loop/capture"):
            self._pieces.update(
                self._capture_pieces([p for p in STEPS[name] if p not in self._pieces]))
        parts = self._parts[name] = [part for p in STEPS[name] for part in self._pieces[p]]
        self.stats["captures"] += 1
        return parts

    def _capture_pieces(self, pieces: list[str]) -> dict[str, list[tuple]]:
        dev = self.solver.device
        pool, stream = _capture_pool(dev)
        if "linearise" in pieces:
            self.sys = None  # the eager iteration's system is not the graph's
        captured: dict[str, list[tuple]] = {}
        parts: list[tuple] = []
        graph = before = None  # the graph being captured, the counts at its start

        def begin():
            nonlocal graph, before
            graph = torch.cuda.CUDAGraph(keep_graph=True)
            graph.capture_begin(pool=pool)
            before = self._counts()

        def end(status=None):
            nonlocal graph
            graph.capture_end()
            delta = {k: n - before[k] for k, n in self._counts().items()}
            self._add_counts({k: -d for k, d in delta.items()})
            parts.append((graph, delta, status))
            graph = None

        def split(block, status):  # the CG runner while capturing
            end()
            begin()
            block()
            end(status)
            begin()

        stream.wait_stream(torch.cuda.current_stream(dev))
        runner, self.solver.cg = self.solver.cg, split
        with torch.cuda.stream(stream):
            try:
                for piece in pieces:
                    parts = captured[piece] = []
                    begin()
                    getattr(self, piece)()
                    end()
            except BaseException:
                if graph is not None:
                    try:
                        graph.capture_end()
                    except RuntimeError:
                        pass  # the capture was invalidated by the error raised below
                    self._add_counts({k: before[k] - n for k, n in self._counts().items()})
                # a capture that failed may stay registered with the allocator
                # as recording to its pool, which then refuses every later
                # capture: the next loop takes a new pool and stream
                _CAPTURE.pop(_index(dev), None)
                raise
            finally:
                self.solver.cg = runner
        for piece_parts in captured.values():
            for g, _, _ in piece_parts:
                g.instantiate()
        return captured
