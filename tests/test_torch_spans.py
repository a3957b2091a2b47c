"""The port's spans (``utils/profiling.py``): each piece of packing, the
structure pass and the LM loop is timed where it runs into the optimiser's
``span_profile()``; under a torch profiler each span is also a
``ba/``-named annotation of the trace, nested as the work is, and without
one no ``record_function`` is entered; ``time_profile()`` keeps its nine
keys, fed by the spans; a profiler changes no bit of the answer."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from cuda_bundle_adjustment_tpu_torch.io.arrays import optimizer_from_problem
from cuda_bundle_adjustment_tpu_torch.io.synthetic import make_mixed_ba_problem
from cuda_bundle_adjustment_tpu_torch.solver import block_solver as bs
from cuda_bundle_adjustment_tpu_torch.utils import profiling as prof

torch.set_num_threads(1)

# the spans a solve on the CPU runs (no capture there: loop/capture and
# loop/replay are the card's), in the order they begin
PACK = ["pack/arrays", "structure/digest", "structure/order", "pack/upload"]
STRUCTURE = ["structure", "structure/symbolic", "structure/plan"]
LOOP = ["loop/eager", "loop/read"]


@pytest.fixture(autouse=True)
def empty_cache():
    bs.clear_structure_cache()
    yield
    bs.clear_structure_cache()


def _problem(seed=3):
    return make_mixed_ba_problem(num_poses=12, num_landmarks=300, seed=seed)


def _solve(problem, n=4):
    opt = optimizer_from_problem(problem, device="cpu")
    opt.optimize(n)
    return opt


@pytest.mark.parametrize("name", PACK + STRUCTURE + LOOP)
def test_each_span_reads_on_an_array_problem(name):
    sp = _solve(_problem()).span_profile()
    assert sp[name] > 0, sp


def test_loop_counters_are_the_loop_spans():
    opt = _solve(_problem())
    sp, ls = opt.span_profile(), opt.loop_stats
    assert ls["eager_ms"] == sp["loop/eager"] and ls["read_wait_ms"] == sp["loop/read"]
    assert ls["capture_ms"] == ls["replay_ms"] == 0.0
    # the flag reads wait inside the eager steps' time (the trace read after)
    assert 0 < ls["read_wait_ms"] < ls["eager_ms"]


def test_a_cache_hit_runs_no_symbolic_pass_plan_or_order():
    problem = _problem()
    first = _solve(problem)
    opt = _solve(problem)
    sp = opt.span_profile()
    assert bs.structure_cache_info()["hits"] == 1
    for name in ("structure/symbolic", "structure/plan", "structure/order"):
        assert sp.get(name, 0.0) == 0.0, name
    assert opt.solver.symbolic_ms == 0.0 and sp["structure"] > 0 and sp["structure/digest"] > 0
    assert first.solver.symbolic_ms == first.span_profile()["structure/symbolic"] > 0


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "host-profile"])
def test_time_profile_keeps_its_nine_keys_fed_by_the_structure_spans(fused):
    opt = optimizer_from_problem(_problem(), device="cpu")
    opt.set_profile(not fused)
    opt.optimize(3)
    tp, sp = opt.time_profile(), opt.span_profile()
    assert list(tp) == prof.ALL_STAGES
    assert tp[prof.PROF_SYMBOLIC_DECOMP] == sp["structure/symbolic"]
    assert tp[prof.PROF_BUILD_STRUCTURE] + tp[prof.PROF_SYMBOLIC_DECOMP] == pytest.approx(
        sp["structure"], rel=1e-12)
    timed = [prof.PROF_COMPUTE_ERROR, prof.PROF_BUILD_SYSTEM, prof.PROF_SCHUR_COMPLEMENT,
             prof.PROF_NUMERICAL_DECOMP, prof.PROF_UPDATE]
    # the host loop's stages only in profile mode, as before
    assert all((tp[k] > 0) != fused for k in timed), tp
    assert tp[prof.PROF_INITIALIZE] == tp[prof.PROF_SOLVE_HPP] == 0.0


def test_no_record_function_is_entered_without_a_profiler(monkeypatch):
    entered = []
    real = torch.profiler.record_function

    def counting(name, *a, **k):
        entered.append(name)
        return real(name, *a, **k)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    _solve(_problem())
    assert entered == []
    with profile(activities=[ProfilerActivity.CPU]):
        _solve(_problem(seed=4))
    assert entered and all(n.startswith(prof.SPAN_PREFIX) for n in entered)
    assert not prof.profiling()


def _spans_of(events) -> dict:
    """Each ``ba/`` span of a trace: its name -> [(start, end), ...]."""
    out: dict = {}
    for e in events:
        if e.name.startswith(prof.SPAN_PREFIX):
            out.setdefault(e.name[len(prof.SPAN_PREFIX):], []).append(
                (e.time_range.start, e.time_range.end))
    return out


def _inside(inner, outer) -> bool:
    return all(any(a0 <= a and b <= b0 for a0, b0 in outer) for a, b in inner)


def test_spans_appear_under_a_profiler_and_nest_as_the_work_does():
    problem = _problem()
    with profile(activities=[ProfilerActivity.CPU]) as p:
        with torch.profiler.record_function("pack"):
            opt = optimizer_from_problem(problem, device="cpu")
        opt.optimize(4)
    spans = _spans_of(p.events())
    assert set(spans) == set(PACK + STRUCTURE + LOOP), sorted(spans)
    # packing's spans (the structure layer's digest and order among them)
    # lie inside the packing call, in order, before the structure pass
    pack = [(e.time_range.start, e.time_range.end) for e in p.events() if e.name == "pack"]
    assert all(_inside(spans[n], pack) for n in PACK)
    starts = [min(a for a, _ in spans[n]) for n in PACK]
    assert starts == sorted(starts)
    assert max(b for _, b in spans["pack/upload"]) <= min(a for a, _ in spans["structure"])
    assert _inside(spans["structure/symbolic"], spans["structure"])
    assert _inside(spans["structure/plan"], spans["structure"])
    assert max(b for _, b in spans["structure/symbolic"]) <= min(
        a for a, _ in spans["structure/plan"])
    # each flag read inside its eager step; the trace read after the steps
    reads = sorted(spans["loop/read"])
    assert _inside(reads[:-1], spans["loop/eager"]) and len(reads) == len(spans["loop/eager"]) + 1
    assert reads[-1][0] >= max(b for _, b in spans["loop/eager"])
    assert min(a for a, _ in spans["loop/eager"]) >= max(b for _, b in spans["structure"])


def test_a_profiler_changes_no_bit_of_the_trace_or_the_state():
    problem = _problem()
    plain = _solve(problem, 6)
    bs.clear_structure_cache()
    with profile(activities=[ProfilerActivity.CPU]):
        traced = _solve(problem, 6)
    assert [b.chi2 for b in plain.batch_statistics().get()] == [
        b.chi2 for b in traced.batch_statistics().get()]
    assert all(torch.equal(a, b) for a, b in zip(plain.solver.graph, traced.solver.graph))


def test_each_optimize_leaves_its_readings_in_the_history():
    problem = _problem()
    opts = [_solve(problem) for _ in range(3)]
    last = prof.solve_history()[-3:]
    for opt, entry in zip(opts, last):
        assert entry["spans"] == opt.span_profile()
        # the loop's scalar counters, copied: no list or dict of the loop kept
        assert entry["loop"] == {k: v for k, v in opt.loop_stats.items()
                                 if not isinstance(v, (list, dict))}
        assert entry["loop"]["read_wait_ms"] == opt.loop_stats["read_wait_ms"] > 0
    host = optimizer_from_problem(problem, device="cpu")
    host.use_fused_loop = False
    host.optimize(2)
    entry = prof.solve_history()[-1]
    assert entry["loop"] is None and entry["spans"]["structure"] > 0
    assert len(prof.solve_history()) <= prof.SOLVE_HISTORY


def test_a_span_times_its_block_and_sums_its_runs():
    spans = prof.Spans()
    for _ in range(2):
        with spans.span("x") as s:
            np.linalg.inv(np.eye(50) * 2.0)
        assert s.ms > 0
    with pytest.raises(ZeroDivisionError):
        with spans.span("y"):
            1 / 0
    assert set(spans) == {"x", "y"} and spans["x"] > s.ms
