"""One run of one benchmark cell: set-up, the measured window, the traced
solves, the comparison with the reference, and the result line.

Everything that belongs to one configuration, one traffic mix, one metric
or one cell is a file that the harness finds by the name
``BENCHMARK.json`` gives it, under the benchmark's folder:

* ``configs/<config>.json`` (the file the configuration names): the
  generator's function and arguments, the optimiser's options, the robust
  kernel and the iterations a solve;
* ``traffic/<mix>.json``: the parameters of the one traffic generator
  (``traffic.py``);
* ``metrics/<metric>.py``: a reader, ``read(run)``, that returns the
  metric's value from the run's counters, spans or trace, or None where it
  finds nothing to read;
* ``limits/<cell>.json``: the limit of each number the comparison reads
  (``check.py``).

A solve is the upstream protocol (``samples/sample_ba_from_file/main.cpp``):
the graph packed by ``io.arrays.optimizer_from_problem`` and
``optimize(iterations)``, its clock from the call to the synchronise after
``optimize`` returns.  One client sends the next graph when the answer is
in (a closed loop).
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import math
import time
from pathlib import Path
from typing import NamedTuple, Optional

import numpy as np

import check
import devtrace
import generator
import traffic
import work

FOLDER = "h100_bench"
# solves traced with torch.profiler after the window, in a --trace 1 run
TRACED_SOLVES = 5
# the window solve whose state is compared, beside the last one, is drawn
# from the seed among the first SAMPLE_SPAN solves
SAMPLE_SPAN = 8


class Cell(NamedTuple):
    name: str
    config: dict
    traffic: dict
    limits: dict
    metrics: list  # (entry of BENCHMARK.json, reader module)


def load_reader(path: Path):
    """The metric reader in the file ``path``: a module with ``read(run)``."""
    spec = importlib.util.spec_from_file_location(f"h100_bench_metric_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    if not callable(getattr(mod, "read", None)):
        raise ValueError(f"{path} has no read(run)")
    return mod


def load_cell(root: Path, workload: str, trace: bool) -> Cell:
    """The cell ``workload`` of ``root/BENCHMARK.json`` with its files.  The
    metrics are its end-to-end ones (``trace`` false) or its per-layer ones:
    an end-to-end metric with a ``workloads`` key is the listed cells'
    alone, and a per-layer metric is a cell's where its own ``workloads``
    key (if any) lists it and the cell reports the metric it ``moves``."""
    root = Path(root)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    cfg_entry = next(c for c in bench["configs"] if c["name"] == w["config"])
    folder = root / FOLDER

    def here(m):
        return workload in m.get("workloads", [workload])

    reported = {m["name"] for m in bench["end_to_end"] if here(m)}
    entries = ([m for m in bench["per_layer"] if here(m) and m["moves"] in reported] if trace
               else [m for m in bench["end_to_end"] if here(m)])
    return Cell(
        name=workload,
        config=json.loads((root / cfg_entry["file"]).read_text()),
        traffic=json.loads((folder / "traffic" / f"{w['traffic']}.json").read_text()),
        limits=json.loads((folder / "limits" / f"{workload}.json").read_text()),
        metrics=[(m, load_reader(folder / "metrics" / f"{m['name']}.py")) for m in entries],
    )


def base_problem(config: dict, seed: int):
    """The seed's graph, made by the frozen generator (``generator.py``)."""
    args = dict(config["generator"])
    fn = getattr(generator, args.pop("function"))
    return fn(seed=int(seed) % 2**63, **args)


def port_problem(problem):
    """The graph as the port's own problem type: ``optimizer_from_problem``
    tells a problem of several edge sets by its class."""
    if not isinstance(problem, generator.MixedBAProblem):
        return problem
    from cuda_bundle_adjustment_tpu_torch.io.synthetic import MixedBAProblem

    return MixedBAProblem(*problem)


class Run:
    """What a metric reader reads: the window's solves (one dict each:
    ``solve_s``, ``pack_ms``, ``structure_ms``, ``loop_host_ms``, ``reads``,
    ``trials``, ``iterations``), the window's length, the set-up time, the
    client's drawing time, and ``trace`` (``devtrace.reduce``'s dict with
    ``work_s``, the least time of the traced solves' work; None without a
    trace)."""

    def __init__(self):
        self.solves: list[dict] = []
        self.window_s = 0.0
        self.setup_s = 0.0
        self.draw_s = 0.0
        self.trace: Optional[dict] = None


def _sync(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def solve(problem, config: dict, dev, traced: bool = False):
    """One solve: ``(opt, record)``."""
    from torch.profiler import record_function

    from cuda_bundle_adjustment_tpu_torch.graph import GraphOptimisationOptions
    from cuda_bundle_adjustment_tpu_torch.io.arrays import optimizer_from_problem

    span = record_function if traced else (lambda name: contextlib.nullcontext())
    options = GraphOptimisationOptions(**config["options"])
    problem = port_problem(problem)
    with span("bench/solve"):
        t0 = time.perf_counter()
        with span("bench/pack"):
            opt = optimizer_from_problem(problem, options=options, rk=config["robust_kernel"],
                                         delta=config["delta"], device=dev)
            _sync(dev)
        t1 = time.perf_counter()
        with span("bench/optimize"):
            opt.optimize(config["iterations"])
            _sync(dev)
        t2 = time.perf_counter()
    tp = opt.time_profile()
    ls = opt.loop_stats
    chi2 = [b.chi2 for b in opt.batch_statistics().get()]
    return opt, dict(
        solve_s=t2 - t0,
        pack_ms=(t1 - t0) * 1e3,
        structure_ms=tp.get("1: Build Structure", 0.0) + tp.get("5: Symbolic Decomposition", 0.0),
        loop_host_ms=None if ls is None else ls["eager_ms"] + ls["capture_ms"],
        reads=None if ls is None else ls["reads"],
        trials=None if ls is None else ls["trials"],
        iterations=len(chi2),
        chi2=chi2,
    )


def answer(opt):
    """The solve's answer ``(q, t, Xw)`` in the problem's order, as the caller reads it."""
    q, t = opt.solver.result_poses()
    return q.copy(), t.copy(), opt.solver.result_landmarks().copy()


def run_cell(root: Path, workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: Optional[float] = None, log=print):
    """Run one cell; returns ``(result, checks)``: the result line's dict and
    the comparison's numbers with their limits.  ``log`` takes the earlier
    lines.  ``device`` is the card in a benchmark run; the tests pass the
    CPU."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    dev = torch.device(device)
    cell = load_cell(root, workload, trace)
    cfg = cell.config
    run = Run()

    # -- set-up: the graph, a warm-up solve of the cell's own traffic ----------
    built = Path(root, "build", "torch_kernels")
    cold = not (built.is_dir() and any(built.glob("*.so")))
    t0 = time.perf_counter()
    torch.zeros(1, device=dev).add_(1)  # the device's context
    _sync(dev)
    t1 = time.perf_counter()
    base = base_problem(cfg, seed)
    mix = traffic.Mix(base, cell.traffic, seed)
    first = mix.problem(-1)
    t2 = time.perf_counter()
    opt, rec = solve(first, cfg, dev)
    del opt
    t3 = time.perf_counter()
    log(f"set-up: process start to the device's context {t1 - t_start:.4f} s (the context "
        f"{t1 - t0:.4f}), the seed's graph and the first draw {t2 - t1:.4f} s, warm-up solve "
        f"{t3 - t2:.4f} s (packing {rec['pack_ms'] / 1e3:.4f}, optimize "
        f"{rec['solve_s'] - rec['pack_ms'] / 1e3:.4f})"
        + (" with the kernels built in it: a cold checkout" if cold else ""))
    if trace:  # the profiler's own start-up, outside the traced solves
        with devtrace.traced():
            torch.zeros(1, device=dev).add_(1)
            _sync(dev)
    rng = np.random.default_rng([int(seed) % 2**64, 2**32])
    k_sample = int(rng.integers(0, SAMPLE_SPAN))

    # -- the measured window ------------------------------------------------------
    from cuda_bundle_adjustment_tpu_torch.solver.block_solver import structure_cache_info

    cache0 = structure_cache_info()
    kept = {}  # solve index -> its answer (q, t, Xw)
    w0 = time.perf_counter()
    run.setup_s = w0 - t_start
    k = 0
    while True:
        d0 = time.perf_counter()
        problem = mix.problem(k)
        run.draw_s += time.perf_counter() - d0
        opt, rec = solve(problem, cfg, dev)
        rec["key"] = mix.graph_key(k)
        run.solves.append(rec)
        last = time.perf_counter() - w0 >= seconds
        if k == k_sample or last:
            kept[k] = answer(opt)
        del opt
        k += 1
        if last:
            break
    run.window_s = time.perf_counter() - w0
    cache1 = structure_cache_info()
    log(f"window: {len(run.solves)} solves in {run.window_s:.4f} s; the client's drawing of the "
        f"graphs {run.draw_s:.4f} s, {100 * run.draw_s / run.window_s:.4f}% of the window; "
        f"structure cache hits {cache1['hits'] - cache0['hits']}, misses "
        f"{cache1['misses'] - cache0['misses']}")
    n = len(run.solves)
    log("window, ms a solve: packing {:.4f}, structure {:.4f}, LM loop host {}, the rest of "
        "optimize {:.4f}".format(
            sum(r["pack_ms"] for r in run.solves) / n,
            sum(r["structure_ms"] for r in run.solves) / n,
            "not read" if any(r["loop_host_ms"] is None for r in run.solves)
            else "{:.4f}".format(sum(r["loop_host_ms"] for r in run.solves) / n),
            sum(1e3 * r["solve_s"] - r["pack_ms"] - r["structure_ms"] - (r["loop_host_ms"] or 0.0)
                for r in run.solves) / n))

    # -- traced solves (--trace 1) ------------------------------------------------
    if trace:
        recs, probs = [], []
        with devtrace.traced() as trace_events:
            for j in range(TRACED_SOLVES):
                with torch.profiler.record_function("bench/draw"):
                    probs.append(mix.problem(k + j))
                opt, rec = solve(probs[-1], cfg, dev, traced=True)
                recs.append(rec)
                del opt
        t0 = time.perf_counter()
        reduced = devtrace.reduce(trace_events)
        del trace_events
        if reduced:
            w = 4 if cfg["options"].get("dtype") == "float32" else 8
            sizes = {}
            for p, r in zip(probs, recs):
                sizes.setdefault(id(p), work.shapes(p))
            reduced["work_s"] = sum(
                work.solve_seconds(sizes[id(p)], r["iterations"], r["trials"] or r["iterations"], w)
                for p, r in zip(probs, recs))
            run.trace = reduced
            traced = sum(r["solve_s"] for r in recs) / len(recs)
            untraced = sum(r["solve_s"] for r in run.solves) / len(run.solves)
            log(f"traced {reduced['solves']} solves: {reduced['window_s']:.6f} s inside their spans, "
                f"device busy {reduced['busy_s']:.6f} s in {reduced['device_events']} device events "
                f"(not counted: {reduced['skipped']}), least time of their work "
                f"{reduced['work_s']:.6f} s; the profiler's cost: a traced solve {traced:.6f} s "
                f"against {untraced:.6f} s untraced in the window; trace read in "
                f"{time.perf_counter() - t0:.1f} s")
        else:
            log("the trace holds no traced solve")

    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    # the program's state goes before the reference runs: its cached plans
    # and the allocator's blocks
    from cuda_bundle_adjustment_tpu_torch.solver.block_solver import clear_structure_cache

    clear_structure_cache()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # -- correctness: the reference on the kept solves' graphs ---------------------
    import reference

    t0 = time.perf_counter()
    readings = []
    keys = sorted({run.solves[i]["key"] for i in kept})
    for key in keys:
        solves = [i for i, r in enumerate(run.solves) if r["key"] == key]
        problem = mix.problem(solves[0])
        ref = reference.ReferenceLM(problem, torch.float64, dev)
        ref_trace = ref.optimize(cfg["iterations"])
        ref_state = ref.state()
        del ref
        init = (problem.pose_q, problem.pose_t, problem.landmarks)
        for i in solves:
            readings.append(check.gaps(run.solves[i]["chi2"], kept.get(i), ref_trace, ref_state,
                                       init))
    values = check.widest(readings)
    correct, checks = check.judge(values, cell.limits)
    failed = sum(1 for r in run.solves
                 if not r["chi2"] or not all(math.isfinite(c) for c in r["chi2"]))
    correct = correct and failed == 0
    log(f"reference: {len(keys)} graphs, the answers of solves "
        f"{sorted(kept)} compared whole, in {time.perf_counter() - t0:.2f} s")

    metrics = {}
    for entry, reader in cell.metrics:
        v = reader.read(run)
        if v is not None:
            metrics[entry["name"]] = {"value": float(v), "unit": entry["unit"]}
    result = {
        "correct": bool(correct),
        "attempted": len(run.solves),
        "failed": failed,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            "count": 1,
            "memory_peak_bytes": int(peak),
        },
    }
    if trace and run.trace:
        result["device"]["busy_s"] = run.trace["busy_s"]
        result["device"]["window_s"] = run.trace["window_s"]
        result["breakdown"] = {"device_ops": run.trace["device_ops"],
                               "idle_gaps": run.trace["idle_gaps"]}
    result["checks"] = checks
    return result, checks
