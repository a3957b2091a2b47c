"""The port's distributed Schur layer (``parallel/distributed.py``) on the
CPU: gloo ranks spawned once a rank count for the whole module, held against
the JAX package's ``parallel/distributed.py`` at the same number of shards
(its virtual CPU mesh), on the cases of ``tests/test_distributed.py``:

* one LM step at D = 2 and 4 (chi0 at rtol 1e-10, chi1 and the scale at
  1e-8, q at atol 1e-10, t and the gathered landmarks at 1e-9);
* the LM loop's trace at D = 2 and 4 on a mono, a merged mono + stereo and
  a depth graph (rtol 1e-7) through ``make_distributed_optimize_fused``
  against the JAX package's, its ``n_done`` the JAX package's;
* the fused loop's eager steps (gloo) at D = 1, 2 and 4, on the band and
  PCG routes and around the outlier thresholding: trace, poses, landmarks
  and the collectives (op, size, order) bit for bit the host loop's;
* the band route against PCG (rtol 1e-7), and against the JAX package's
  band route with its kernels in interpret mode;
* the outlier masks and counts;
* one rank: bit for bit the port's one-card host loop and trial;
* at most three sum all-reduces a step and a trial, counted at
  ``torch.distributed.all_reduce``;
* the shard counts, the refusal of sets that do not merge, the card as
  the default device, and no JAX import under ``parallel/``.

The ranks and the JAX programs run side by side in processes of their own
(``tests/torch_dist_cases.py``)."""

import os
import pathlib
import re
import subprocess
import sys
from concurrent.futures import ProcessPoolExecutor

import jax
import multiprocessing
import numpy as np
import pytest
import torch

import torch_dist_cases as tdc
from cuda_bundle_adjustment_tpu_torch.io import synthetic
from cuda_bundle_adjustment_tpu_torch.io.arrays import optimizer_from_problem
from cuda_bundle_adjustment_tpu_torch.parallel import (
    RankSolver,
    gather_landmarks,
    distributed_optimize,
    shard_problem,
)

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
LOOP_CASES = ("mono", "mixed", "depth")
# what the ranks of each count run
RANK_CASES = {
    1: ("step", *LOOP_CASES),
    2: ("step", *LOOP_CASES, "band_pcg", "outliers"),
    4: ("step", *LOOP_CASES),
}
# the JAX programs, the slowest to compile first
JAX_JOBS = [("band", 2), ("outliers", 2)] + [
    (case, D) for case in ("step", *LOOP_CASES) for D in (2, 4)]
JAX_WORKERS = 6
# a rank or a JAX program not done by then fails the module
TIMEOUT_S = 240
# the sample on two gloo ranks of the CPU, a small city-scale graph
SAMPLE_ARGS = ("2", "3", "--cpu", "--city", "0.002")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``(ranks, jax)``: every rank's results by rank count, and the JAX
    package's by ``(case, D)``."""
    base = tmp_path_factory.mktemp("ranks")
    contexts = {D: tdc.run_ranks(D, cases, str(base / f"d{D}")) for D, cases in RANK_CASES.items()}
    sample = subprocess.Popen(
        [sys.executable, "-m", "cuda_bundle_adjustment_tpu_torch.samples.sample_distributed_schur",
         *SAMPLE_ARGS], cwd=REPO, env=dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    # the JAX processes share the suite's compilation cache (tests/conftest.py)
    cache_dir = jax.config.jax_compilation_cache_dir
    with ProcessPoolExecutor(JAX_WORKERS, mp_context=multiprocessing.get_context("spawn")) as ex:
        futures = {job: ex.submit(tdc.jax_case, *job, cache_dir) for job in JAX_JOBS}
        jax_out = {job: f.result(timeout=TIMEOUT_S) for job, f in futures.items()}
    for ctx in contexts.values():
        tdc.join(ctx, TIMEOUT_S)
    ranks = {D: tdc.read_ranks(D, str(base / f"d{D}")) for D in RANK_CASES}
    jax_out["sample"] = sample.communicate(timeout=TIMEOUT_S) + (sample.returncode,)
    return ranks, jax_out


def _problem(case):
    return tdc.problem(case, synthetic)


def _same_on_every_rank(ranks, case, keys):
    """The replicated values of ``case`` are one rank's bit for bit."""
    for r in ranks[1:]:
        for k in keys:
            a, b = ranks[0][case][k], r[case][k]
            assert np.array_equal(np.asarray(a), np.asarray(b)), f"{case} {k} differs across ranks"


def _gathered(ranks, case, D):
    sp = shard_problem(_problem(case), D)
    return gather_landmarks(sp, [r[case]["Xw"] for r in ranks])


def test_ranks_import_no_jax(runs):
    ranks, _ = runs
    assert not any(r["jax_imported"] for D in ranks for r in ranks[D])


@pytest.mark.parametrize("D", [2, 4])
def test_sharded_step_matches_jax(runs, D):
    """One damped trial step at lam 0.1 against the JAX package's
    ``make_distributed_lm_step`` at the same D; three sum all-reduces and no
    other collective."""
    ranks, jax_out = runs
    got, want = ranks[D][0]["step"], jax_out[("step", D)]
    _same_on_every_rank(ranks[D], "step", ("q", "t", "chi0", "chi1", "scale", "success"))
    assert got["success"] and want["success"]
    np.testing.assert_allclose(got["chi0"], want["chi0"], rtol=1e-10)
    np.testing.assert_allclose(got["chi1"], want["chi1"], rtol=1e-8)
    np.testing.assert_allclose(got["scale"], want["scale"], rtol=1e-8)
    np.testing.assert_allclose(got["q"], want["q"], atol=1e-10)
    np.testing.assert_allclose(got["t"], want["t"], atol=1e-9)
    np.testing.assert_allclose(_gathered(ranks[D], "step", D), want["Xw"], atol=1e-9)
    assert (got["sums"], got["maxes"]) == (3, 0)


@pytest.mark.parametrize("D", [2, 4])
@pytest.mark.parametrize("case", LOOP_CASES)
def test_distributed_loop_matches_jax(runs, case, D):
    """The LM loop's chi2 trace over 4 iterations against the JAX
    package's ``distributed_optimize`` at the same D (rtol 1e-7), the final
    state replicated bit for bit; a trial costs two sum all-reduces, an
    iteration's linearisation one, and the first damping one MAX."""
    ranks, jax_out = runs
    got, want = ranks[D][0][case], jax_out[(case, D)]
    _same_on_every_rank(ranks[D], case, ("trace", "q", "t"))
    assert len(got["trace"]) == len(want["trace"]) == got["n_done"] == want["n_done"]
    assert got["padded"] == [0.0] * (tdc.NITER - got["n_done"])
    np.testing.assert_allclose(got["trace"], want["trace"], rtol=1e-7)
    assert got["sums"] == len(got["trace"]) + 2 * got["trials"] and got["maxes"] == 1
    assert got["comm"]["calls"] == got["sums"] + got["maxes"]


@pytest.mark.parametrize("D", [1, 2, 4])
@pytest.mark.parametrize("case", LOOP_CASES)
def test_fused_loop_is_the_host_loop_on_gloo_ranks(runs, case, D):
    """``make_distributed_optimize_fused`` on gloo ranks (its steps eager:
    gloo's collectives cannot be captured) against the host loop on the same
    ``RankSolver``: trace, poses and the rank's landmarks bit for bit, and
    the same all-reduces (op and size) in the same order; one flag read a
    trial and one for the trace."""
    ranks, _ = runs
    for r in ranks[D]:
        fused, host = r[case], r[case]["host"]
        for key in ("trace", "n_done", "trials", "calls", "comm"):
            assert fused[key] == host[key], key
        for key in ("q", "t", "Xw"):
            assert np.array_equal(fused[key], host[key]), key
        st = fused["stats"]
        assert st["fused"] and not host["stats"]["fused"]
        assert not st["capture"] and st["captures"] == st["replays"] == 0
        assert st["reads"] == st["trials"] + 1 == host["stats"]["reads"]


def test_fused_band_and_pcg_routes_are_the_host_loop(runs):
    """The band and PCG routes at D = 2: the fused loop's trace, final state
    and CG iterations bit for bit the host loop's on every rank."""
    ranks, _ = runs
    for r in ranks[2]:
        for route in ("band", "pcg"):
            got = r["band_pcg"][route]
            host = got["host"]
            assert got["trace"] == host["trace"] and got["cg"] == host["cg"], route
            assert all(np.array_equal(a, b) for a, b in zip(got["state"], host["state"]))
            assert got["stats"]["all_reduce"] == host["stats"]["all_reduce"]


def test_fused_outlier_runs_are_the_host_loops(runs):
    """``make_distributed_optimize_fused`` twice around
    ``make_distributed_update_edges`` (the JAX package's outliers case):
    both traces, the mask, the count, the final state and the collectives
    bit for bit the host loop's on every rank, ``n_done`` the JAX
    package's."""
    ranks, jax_out = runs
    want = jax_out[("outliers", 2)]
    for r in ranks[2]:
        got, host = r["outliers"], r["outliers"]["host"]
        for key in ("trace", "trace2", "n_done", "n_new", "calls"):
            assert got[key] == host[key], key
        assert np.array_equal(got["active"], host["active"])
        assert all(np.array_equal(a, b) for a, b in zip(got["state"], host["state"]))
        assert got["n_done"] == (len(want["trace"]), len(want["trace2"]))


def test_band_pose_solve_matches_pcg(runs):
    """``pose_solver="band"`` (the B7/B8 route, twins on the CPU) against
    ``"pcg"`` at D = 2 (rtol 1e-7), and against the JAX package's band
    route (its band kernels in interpret mode)."""
    ranks, jax_out = runs
    out = ranks[2][0]["band_pcg"]
    assert (out["band"]["route"], out["pcg"]["route"]) == ("band", "pcg")
    assert out["pcg"]["cg"] and not out["band"]["cg"]
    assert len(out["band"]["trace"]) == len(out["pcg"]["trace"])
    np.testing.assert_allclose(out["band"]["trace"], out["pcg"]["trace"], rtol=1e-7)
    np.testing.assert_allclose(out["band"]["trace"], jax_out[("band", 2)]["trace"], rtol=1e-7)


def test_distributed_outlier_masks_match_jax(runs):
    """Every 37th measurement moved by 120 px: after ``optimize(4)`` the
    threshold of 500 masks the same edges as the JAX package's
    ``make_distributed_update_edges``, the same count, and the second run
    on the inliers traces as the JAX package's.  One ``RankSolver`` serves
    the loop and the thresholding, and refuses another sharded problem."""
    ranks, jax_out = runs
    want = jax_out[("outliers", 2)]
    E = _problem("outliers").meas.shape[0]
    mask = np.full(E, -1.0)
    for r in ranks[2]:
        mask[r["outliers"]["edge_ids"]] = r["outliers"]["active"]
    np.testing.assert_array_equal(mask, want["active"])
    bad = np.arange(0, E, 37)
    assert not mask[bad].any()
    assert all(r["outliers"]["n_new"] == want["n_new"] for r in ranks[2])
    got = ranks[2][0]["outliers"]
    np.testing.assert_allclose(got["trace"], want["trace"], rtol=1e-7)
    np.testing.assert_allclose(got["trace2"], want["trace2"], rtol=1e-7)
    assert got["trace2"][-1] < 0.05 * got["trace"][0]
    assert all(r["outliers"]["refused"] for r in ranks[2])


@pytest.mark.parametrize("case", LOOP_CASES)
def test_one_rank_is_the_one_card_host_loop(runs, case):
    """At one rank the loop is the port's one-card host loop bit for bit:
    the trace and the final poses and landmarks."""
    ranks, _ = runs
    got = ranks[1][0][case]
    opt = optimizer_from_problem(_problem(case), device="cpu")
    opt.use_fused_loop = False
    opt.optimize(tdc.NITER)
    assert got["trace"] == [s.chi2 for s in opt.batch_statistics().get()]
    q, t = opt.solver.result_poses()
    assert np.array_equal(got["q"], q) and np.array_equal(got["t"], t)
    assert np.array_equal(got["Xw"], opt.solver.result_landmarks())


def test_one_rank_step_is_the_one_card_trial(runs):
    """At one rank the step is the one-card ``BlockSolver.head`` and
    ``trial`` at the same damping, bit for bit."""
    ranks, _ = runs
    got = ranks[1][0]["step"]
    solver = optimizer_from_problem(_problem("step"), device="cpu").solver
    solver.build_structure()
    chi, sys = solver.head()
    new_graph, Fhat, scale, ok = solver.trial(sys, tdc.STEP_LAM)
    assert bool(ok) and got["success"]
    assert (got["chi0"], got["chi1"], got["scale"]) == (float(chi), float(Fhat), float(scale))
    solver.accept(new_graph)
    q, t = solver.result_poses()
    assert np.array_equal(got["q"], q) and np.array_equal(got["t"], t)
    assert np.array_equal(got["Xw"], solver.result_landmarks())


def test_sample_runs_on_gloo_ranks(runs):
    """``samples/sample_distributed_schur.py`` spawns its ranks and prints a
    falling trace: the one-card host loop's, to the printed digit."""
    _, jax_out = runs
    out, err, rc = jax_out["sample"]
    assert rc == 0, err
    assert "DISTRIBUTED OK" in out
    trace = [float(line.split("chi2=")[1]) for line in out.splitlines() if "chi2=" in line]
    opt = optimizer_from_problem(synthetic.city_scale_problem(scale=0.002), device="cpu")
    opt.use_fused_loop = False
    opt.optimize(3)
    want = [s.chi2 for s in opt.batch_statistics().get()]
    np.testing.assert_allclose(trace, want, rtol=0, atol=0.05)


def test_shard_counts():
    """Every edge on the rank of its landmark, each landmark on exactly one
    rank, and each rank's edges those of the JAX package's shard (its real,
    unpadded rows)."""
    from cuda_bundle_adjustment_tpu.io.synthetic import make_ba_problem as jax_problem
    from cuda_bundle_adjustment_tpu.parallel.distributed import shard_problem as jax_shard

    args = dict(num_poses=6, num_landmarks=20, mean_obs_per_landmark=3.0, kind="mono", seed=41)
    p = synthetic.make_ba_problem(**args)
    sp = shard_problem(p, 4)
    jsp = jax_shard(jax_problem(**args), 4)
    E, L = p.meas.shape[0], p.landmarks.shape[0]
    assert sum(sp.edges_per_shard) == E
    assert sum(sp.lms_per_shard) == L
    ids = np.concatenate([s.edge_ids for s in sp.shards])
    assert np.array_equal(np.sort(ids), np.arange(E))
    active = np.asarray(jsp.active).reshape(4, -1)
    assert list(sp.edges_per_shard) == [int(a.sum()) for a in active]
    for r, s in enumerate(sp.shards):
        assert np.all(p.lm_idx[s.edge_ids] % 4 == r)
        assert np.array_equal(s.Xw, p.landmarks[r::4])
        assert np.array_equal(s.lm_local, p.lm_idx[s.edge_ids] // 4)
    assert sp.nnz_blocks == jsp.nnz_blocks
    tri_k = np.asarray(jsp.tri_k).reshape(4, -1)
    assert list(sp.tris_per_shard) == [int((k < jsp.nnz_blocks).sum()) for k in tri_k]


def test_unmergeable_sets_are_refused():
    """Sets that do not merge into one (here a mono and a stereo set under
    different robust kernels) raise ``ValueError``, as in the JAX package."""
    mp = synthetic.make_mixed_ba_problem(**tdc.LOOPS["mixed"])
    specs = [dict(mp.specs[0], rk=3, delta=2.0), dict(mp.specs[1])]
    with pytest.raises(ValueError, match="merge"):
        shard_problem(mp._replace(specs=specs), 2)
    with pytest.raises(ValueError, match="pose_solver"):
        shard_problem(_problem("mono"), 2, pose_solver="dense")


def test_default_device_is_the_card():
    """Without ``device="cpu"`` a rank takes the card, and without one it
    raises: nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    sp = shard_problem(_problem("mono"), 1)
    with pytest.raises(RuntimeError, match="CUDA"):
        distributed_optimize(None, sp, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        RankSolver(None, sp)


def test_parallel_imports_no_jax():
    """No module under ``parallel/`` imports jax or the JAX package, and
    importing every name ``parallel`` exports (``__all__``: each public
    function of ``distributed.py``, ``make_distributed_optimize_fused``
    among them) pulls in neither."""
    import cuda_bundle_adjustment_tpu_torch.parallel as par
    import cuda_bundle_adjustment_tpu_torch.parallel.distributed as pd

    files = sorted((REPO / "cuda_bundle_adjustment_tpu_torch" / "parallel").glob("*.py"))
    assert files
    bad = re.compile(r"^\s*(import|from)\s+(jax|cuda_bundle_adjustment_tpu)(\s|\.|$)", re.M)
    for f in files:
        assert not bad.search(f.read_text()), f"{f.name} imports jax or the JAX package"
    public = {n for n, v in vars(pd).items() if not n.startswith("_")
              and getattr(v, "__module__", None) == pd.__name__}
    assert "make_distributed_optimize_fused" in par.__all__
    assert public - {"Shard"} == set(par.__all__)
    code = ("import sys; from cuda_bundle_adjustment_tpu_torch.parallel import *; "
            "from cuda_bundle_adjustment_tpu_torch.parallel import "
            "make_distributed_optimize_fused; "
            "assert not [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'cuda_bundle_adjustment_tpu')], 'jax imported'")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   env=dict(os.environ, PYTHONPATH=str(REPO)))
