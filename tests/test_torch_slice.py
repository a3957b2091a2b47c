"""The PyTorch port's slice end to end on the CPU: ``optimizer_from_problem``
-> ``optimize(10)`` -> ``batch_statistics()`` against the JAX package and
the numpy ``DenseLM`` oracle, determinism, and the no-JAX import rule."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from cuda_bundle_adjustment_tpu.io import synthetic as jsyn
from cuda_bundle_adjustment_tpu.io.arrays import optimizer_from_problem as jax_optimizer
from cuda_bundle_adjustment_tpu_torch.io.arrays import optimizer_from_problem
from cuda_bundle_adjustment_tpu_torch.io.synthetic import make_ba_problem, make_mixed_ba_problem
from cuda_bundle_adjustment_tpu_torch.utils import profiling as prof
from cuda_bundle_adjustment_tpu_torch.utils.dense_reference import DenseLM

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _trace(opt):
    return [s.chi2 for s in opt.batch_statistics().get()]


def test_trace_matches_jax_and_dense_oracle():
    """chi2 trace of optimize(10) against the JAX package on the CPU at rtol
    1e-8 (both solve with an f32 factor and two f64 refinement rounds), and
    against DenseLM with the tolerances of tests/test_lm.py."""
    problem = make_ba_problem(
        num_poses=10, num_landmarks=50, mean_obs_per_landmark=4.0, kind="mono", seed=5
    )
    opt = optimizer_from_problem(problem)
    opt.optimize(10)
    got = _trace(opt)

    jopt = jax_optimizer(problem)
    jopt.optimize(10)
    assert len(got) == len(_trace(jopt)) >= 5
    np.testing.assert_allclose(got, _trace(jopt), rtol=1e-8)

    ref = DenseLM(problem)
    want = ref.optimize(10)
    assert len(got) == len(want)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    Pa, La = opt.solver.Pa, opt.solver.La
    q, t = opt.solver.result_poses()
    np.testing.assert_allclose(q[:Pa], ref.q[:Pa], atol=1e-7)
    np.testing.assert_allclose(t[:Pa], ref.t[:Pa], atol=1e-6)
    np.testing.assert_allclose(opt.solver.result_landmarks()[:La], ref.Xw[:La], atol=1e-6)


@pytest.mark.parametrize("kind", ["stereo", "mixed"])
def test_stereo_and_mixed_traces_match_jax_and_dense_oracle(kind):
    """A stereo set and a mono+stereo pair (merged into one masked stereo
    set): chi2 trace of optimize(10) against the JAX package at rtol 1e-9
    and its final state at 1e-9 of the state's scale, and against DenseLM
    as above."""
    kw = dict(num_poses=10, num_landmarks=60, mean_obs_per_landmark=4.0, seed=6)
    if kind == "mixed":  # each package takes its own problem class
        problem, jproblem = make_mixed_ba_problem(**kw), jsyn.make_mixed_ba_problem(**kw)
    else:
        problem = jproblem = make_ba_problem(kind=kind, **kw)
    opt = optimizer_from_problem(problem)
    opt.optimize(10)
    got = _trace(opt)
    assert (opt.solver.packed.mask3 is not None) == (kind == "mixed")

    jopt = jax_optimizer(jproblem)
    jopt.optimize(10)
    assert len(got) == len(_trace(jopt)) >= 5
    np.testing.assert_allclose(got, _trace(jopt), rtol=1e-9)
    Pa, La = opt.solver.Pa, opt.solver.La
    q, t = opt.solver.result_poses()
    jq, jt = jopt.solver.result_poses()
    for a, b in [(q, jq), (t, jt), (opt.solver.result_landmarks()[:La],
                                     jopt.solver.result_landmarks()[:La])]:
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-9 * np.abs(b).max())

    ref = DenseLM(problem)
    want = ref.optimize(10)
    assert len(got) == len(want)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_allclose(q[:Pa], ref.q[:Pa], atol=1e-7)
    np.testing.assert_allclose(t[:Pa], ref.t[:Pa], atol=1e-6)
    np.testing.assert_allclose(opt.solver.result_landmarks()[:La], ref.Xw[:La], atol=1e-6)


def test_repeat_runs_and_profile_mode_give_identical_traces():
    """Fixed-order reductions: two runs give the same trace bit for bit, and
    the per-stage profiled path runs the same arithmetic."""
    problem = make_ba_problem(num_poses=12, num_landmarks=90, seed=8)
    traces = []
    for profile in (False, False, True):
        opt = optimizer_from_problem(problem)
        opt.set_profile(profile)
        opt.optimize(6)
        traces.append(_trace(opt))
    assert traces[0] == traces[1] == traces[2]
    tp = opt.time_profile()
    for stage in (prof.PROF_COMPUTE_ERROR, prof.PROF_BUILD_SYSTEM,
                  prof.PROF_SCHUR_COMPLEMENT, prof.PROF_NUMERICAL_DECOMP,
                  prof.PROF_UPDATE, prof.PROF_SYMBOLIC_DECOMP):
        assert tp[stage] > 0.0, stage


def test_port_imports_no_jax():
    """The port and a small CPU optimize(3) run without importing jax."""
    code = (
        "import sys\n"
        "import cuda_bundle_adjustment_tpu_torch\n"
        "from cuda_bundle_adjustment_tpu_torch.io.arrays import optimizer_from_problem\n"
        "from cuda_bundle_adjustment_tpu_torch.io.synthetic import make_ba_problem\n"
        "opt = optimizer_from_problem(make_ba_problem(num_poses=6, num_landmarks=40, seed=1))\n"
        "opt.optimize(3)\n"
        "trace = [s.chi2 for s in opt.batch_statistics().get()]\n"
        "assert len(trace) == 3 and trace[-1] < trace[0], trace\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_cuda_device_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        optimizer_from_problem(make_ba_problem(num_poses=4, num_landmarks=20), device="cuda")
