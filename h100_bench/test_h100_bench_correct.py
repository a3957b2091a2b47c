"""CPU tests of the comparison that decides ``correct``: the reference
against the port and the port's numpy oracle, the float32 control failing
every cell's limits, and whole runs with the timed path broken underneath
coming out not correct.  A last test, marked ``gpu``, runs a short cell on
the card.  Run from the repository root: ``python -m pytest h100_bench -q``."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path[:0] = [str(HERE), str(ROOT)]

import check  # noqa: E402
import generator  # noqa: E402
import harness  # noqa: E402
import reference  # noqa: E402
from test_h100_bench_harness import BENCH, tiny_root  # noqa: E402

from cuda_bundle_adjustment_tpu_torch.io.arrays import optimizer_from_problem  # noqa: E402
from cuda_bundle_adjustment_tpu_torch.solver import block_solver  # noqa: E402
from cuda_bundle_adjustment_tpu_torch.utils.dense_reference import DenseLM  # noqa: E402

CELLS = [w["name"] for w in BENCH["workloads"]]


def sample_problem(seed=3):
    return generator.make_mixed_ba_problem(num_poses=12, num_landmarks=200, seed=seed)


def port_answer(p):
    opt = optimizer_from_problem(harness.port_problem(p), device="cpu")
    opt.optimize(10)
    q, t = opt.solver.result_poses()
    return [b.chi2 for b in opt.batch_statistics().get()], (q, t, opt.solver.result_landmarks())


@pytest.mark.parametrize("kind", ["mixed", "mono", "stereo"])
def test_reference_agrees_with_the_port_numpy_oracle(kind):
    p = (sample_problem() if kind == "mixed" else
         generator.make_ba_problem(num_poses=12, num_landmarks=200, kind=kind, seed=3))
    dense = DenseLM(p)
    dense_trace = dense.optimize(10)
    ref = reference.ReferenceLM(p)
    trace = ref.optimize(10)
    q, t, X = ref.state()
    np.testing.assert_allclose(trace, dense_trace, rtol=1e-12)
    for a, b in ((q, dense.q), (t, dense.t), (X, dense.Xw)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-10)


@pytest.mark.parametrize("seed", [3, 2**31 + 11])
def test_the_port_on_the_cpu_passes_every_cell_and_the_float32_control_fails_every_cell(seed):
    p = sample_problem(seed)
    init = (p.pose_q, p.pose_t, p.landmarks)
    ref = reference.ReferenceLM(p)
    ref_trace = ref.optimize(10)
    ref_state = ref.state()
    low = reference.ReferenceLM(p, torch.float32)
    low_trace = low.optimize(10)
    program = check.gaps(*port_answer(p), ref_trace, ref_state, init)
    control = check.gaps(low_trace, low.state(), ref_trace, ref_state, init)
    for cell in CELLS:
        limits = json.loads((HERE / "limits" / f"{cell}.json").read_text())
        assert check.judge(program, limits)[0], (cell, program)
        assert not check.judge(control, limits)[0], (cell, control)


def test_judge_reads_a_missing_or_infinite_number_as_a_failure():
    limits = {"chi2_gap": 1.0, "pose_gap": 1.0, "landmark_gap": 1.0}
    assert check.judge({"chi2_gap": 0.0, "pose_gap": 0.0, "landmark_gap": 0.0}, limits)[0]
    assert not check.judge({"chi2_gap": 0.0, "pose_gap": 0.0}, limits)[0]
    ok, checks = check.judge({"chi2_gap": float("inf"), "pose_gap": 0.0, "landmark_gap": 0.0}, limits)
    assert not ok and checks["chi2_gap"]["value"] is None
    assert check.trace_gap([1.0, 2.0], [1.0]) == float("inf")


def _unchanged_state(monkeypatch):
    monkeypatch.setattr(block_solver, "apply_update", lambda graph, xp, xl: graph)


def _half_the_edges(monkeypatch):
    original = block_solver.BlockSolver.initialize_from_arrays

    def half(self, *args, edge_specs, **kw):
        cut = [dict(s, **{k: s[k][: len(s[k]) // 2] for k in ("meas", "pose_idx", "lm_idx", "omega")})
               for s in edge_specs]
        return original(self, *args, edge_specs=cut, **kw)

    monkeypatch.setattr(block_solver.BlockSolver, "initialize_from_arrays", half)


def _answer_altered(monkeypatch):
    original = block_solver.BlockSolver.result_landmarks

    def altered(self):
        X = original(self).copy()
        X[len(X) // 2, 2] += 0.05
        return X

    monkeypatch.setattr(block_solver.BlockSolver, "result_landmarks", altered)


@pytest.mark.parametrize("fault", [None, _unchanged_state, _half_the_edges, _answer_altered],
                         ids=["sound", "state_unchanged", "half_the_edges", "answer_altered"])
@pytest.mark.parametrize("workload", ["kitti07_mixed.same_graph", "kitti00_mixed.new_graph"])
def test_a_run_with_the_timed_path_broken_comes_out_not_correct(tmp_path, monkeypatch, workload, fault):
    root = tiny_root(tmp_path)
    if fault is not None:
        fault(monkeypatch)
    block_solver.clear_structure_cache()
    result, checks = harness.run_cell(root, workload, 2**31 + 3, 0.3, False, "cpu",
                                      log=lambda s: None)
    assert result["correct"] is (fault is None), checks
    assert result["attempted"] >= 1 and set(checks) == set(check.NAMES)


@pytest.mark.gpu
def test_a_short_cell_runs_correct_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, str(HERE / "run.py"), "--workload", "kitti07_mixed.same_graph",
         "--seed", str(2**31 + 1), "--seconds", "2", "--trace", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.splitlines()[-1])
    assert result["correct"] and result["device"]["busy_s"] > 0
    assert 0 < result["metrics"]["kernels.roofline_pct"]["value"] < 100
