"""CPU tests of the readers of the port's own spans and counters
(``readings.py``, ``metrics/packing.*``, ``structure.*``, ``loop.*``): a
traced CPU run reads them where the cell runs their code; a port
without the history, or a history that does not match the window, gives
nothing to read; the port's spans appear in the benchmark's trace as host
annotations.  Run from the repository root:
``python -m pytest h100_bench -q``."""

import json
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]

import devtrace  # noqa: E402
import harness  # noqa: E402
import readings  # noqa: E402
from test_h100_bench_harness import tiny_root  # noqa: E402

BENCH = json.loads((HERE.parent / "BENCHMARK.json").read_text())
PORT = [m for m in BENCH["per_layer"]
        if m["name"].startswith(("packing.", "structure.", "loop."))
        and m["name"] not in ("packing.host_ms", "structure.host_ms", "loop.host_ms",
                              "loop.host_reads")]


def test_every_port_metric_has_its_reader_and_moves_solve_s():
    assert len(PORT) == 7
    for m in PORT:
        assert (HERE / "metrics" / f"{m['name']}.py").is_file(), m["name"]
        assert m["moves"] == "solve_s" and m["source"] in ("program_span", "program_counter")
    miss_only = {m["name"] for m in PORT if "workloads" in m}
    assert miss_only == {"structure.order_ms", "structure.symbolic_ms", "structure.plan_ms"}
    for m in PORT:
        assert all(w.endswith(".new_graph") for w in m.get("workloads", []))


@pytest.mark.parametrize("workload", ["kitti07_mixed.same_graph", "kitti07_mixed.new_graph"])
def test_a_traced_cpu_run_reads_the_port_metrics(tmp_path, workload):
    root = tiny_root(tmp_path)
    result, checks = harness.run_cell(root, workload, 2**33 + 7, 0.5, True, "cpu",
                                      log=lambda s: None)
    assert result["correct"], checks
    got = result["metrics"]
    host = [m["name"] for m in PORT if workload in m.get("workloads", [workload])]
    assert all(got[n]["value"] > 0 for n in host), got
    if workload.endswith("same_graph"):
        assert not {"structure.order_ms", "structure.symbolic_ms", "structure.plan_ms"} & set(got)
    # the spans inside packing account for no more than the harness's span
    inside = sum(got[n]["value"] for n in host if n in (
        "packing.arrays_ms", "packing.upload_ms", "structure.digest_ms", "structure.order_ms"))
    assert 0 < inside <= got["packing.host_ms"]["value"]


def _run(structure_ms):
    run = harness.Run()
    run.solves = [dict(structure_ms=s) for s in structure_ms]
    return run


def test_readers_find_the_window_by_its_structure_readings(monkeypatch):
    log = [dict(spans={"structure": s, "pack/arrays": 1.0 + s}, loop=dict(
        read_wait_ms=s)) for s in range(1, 9)]
    monkeypatch.setattr(readings, "_history", lambda: log)
    run = _run([3.0, 4.0, 5.0])
    assert [e["spans"]["structure"] for e in readings.window(run)] == [3, 4, 5]
    assert readings.span_ms(run, "pack/arrays") == 5.0
    assert readings.span_ms(run, "structure/order") is None
    assert readings.loop_ms(run, "read_wait_ms") == 4.0
    # a window the history does not hold in order, or no history at all
    assert readings.window(_run([3.0, 5.0])) is None
    assert readings.window(_run([3.5])) is None
    monkeypatch.setattr(readings, "_history", lambda: None)
    assert readings.span_ms(run, "pack/arrays") is None
    assert readings.loop_ms(run, "read_wait_ms") is None


def test_the_port_spans_are_host_annotations_of_the_benchmark_trace():
    from cuda_bundle_adjustment_tpu_torch.io.arrays import optimizer_from_problem
    from cuda_bundle_adjustment_tpu_torch.io.synthetic import make_mixed_ba_problem

    problem = make_mixed_ba_problem(num_poses=10, num_landmarks=150, seed=2)
    with devtrace.traced() as events:
        opt = optimizer_from_problem(problem, device="cpu")
        opt.optimize(3)
    spans = [e for e in events if e.name.startswith("ba/")]
    names = {e.name for e in spans}
    assert {"ba/pack/arrays", "ba/pack/upload", "ba/structure", "ba/loop/eager"} <= names
    assert all(e.annotation and not e.device for e in spans)
    assert not any(devtrace._is_device_op(e) for e in spans)
