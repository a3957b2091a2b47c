#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card.  It imports
nothing of JAX.  In order, each phase failing the run (no phase's failure is
caught):

1. prints the card's name and power limit, the torch/CUDA/nvcc versions and
   the host's CPU model;
2. builds the ten kernels from ``cuda_bundle_adjustment_tpu_torch/csrc``
   (one ``nvcc`` per source) and the host symbolic analysis
   (``native/symbolic.cpp``, ``g++``), all started together, and prints
   the builds' times and the ``g++`` version; then times the native
   symbolic analysis against its numpy copy on the host at
   ``kitti00_mono`` and ``kitti00_mixed`` and holds the one against the
   other (the same pattern, the same triples per block, the order moved
   only in diagonal blocks of duplicate observations, counted);
3. holds each kernel against its plain PyTorch twin on the card, at the
   shapes and values of the first linearisation of ``kitti00_mono`` and
   again of every other input the full-size paths give the kernels:
   ``kitti00_huber`` (B3 with the weight rescaled by rho'), ``kitti00_mixed``,
   ``kitti07_mono`` and ``kitti07_mono_wide`` (band height asserted > 16);
   times the kernel, the twin and, where one PyTorch call computes the same
   function, that call (``ms``: median of CUDA-event-timed calls, the call
   as the path pays for it, the wrapper's host work included wherever the
   device is done first), reads the kernel's own time on the device apart
   from its wrapper (``device_ms``: calls captured into a CUDA graph and
   replayed back to back between two events) and the wrapper's own time on
   the host (``host_ms``: the Python body on the host clock), and works out
   each kernel's bound from the bytes and operations of these inputs (the
   other inputs read ``device_ms`` and ``host_ms`` for B3 and B6, for B5 and
   B9 at ``kitti00_mixed`` and ``kitti07_mono``, and at the wide band for B7
   and B8); holds B3's and B5's per-vertex sums bit for bit, and B6's within
   1e-12, against the twins' values summed in the kernels' order, B9 bit
   for bit against its twin, B4 bit for bit on the solver's ``Hll``/``bl``
   views (read in place: one device kernel a call, checked by its trace at
   ``kitti00_mono``; ``lam`` a 0-d tensor the kernel reads on the card, a
   captured launch replayed after ``lam`` changed bit for bit the twin at
   the new value), and B5, B9, B7 and B8 against their library calls;
   then
   holds the band kernels B7 and B8 against their twins on a random banded
   SPD system of band height 48, which no generator reaches end to end;
   then holds the eight kernels retyped for f32 mode (all but B7 and B8)
   against their twins in f32 at the first linearisation of
   ``kitti00_huber_f32`` (each the f64 computation rounded once: within one
   f32 rounding, bit for bit where the f64 kernel is), every time read;
4. runs a small mono, stereo and mixed problem without a robust kernel and
   under Huber, Cauchy and Tukey on the card and on the CPU and holds both
   chi2 traces against the numpy ``DenseLM`` oracle (the mixed graph under
   Tukey at a stated looser tolerance from its eighth iteration, with the
   measurements that say why printed beside it), then solves the
   population of borderline reduced systems (16-pose mono graph, seeds
   0..15, Cauchy and Tukey) on the card and holds its verdicts against the
   CPU twins';
5. runs ``kitti00_mono``, ``kitti00_huber``, ``kitti00_stereo``,
   ``kitti00_mixed``, ``kitti07_mono`` and ``kitti07_mono_wide``
   (``optimizer_from_problem(...).optimize(10)`` on the default device, the
   card, through the default loop: the fused loop's CUDA-graph replays),
   each with the structure cache emptied and the launch counters zeroed
   just before its first run and read just after: the first run must miss
   the cache, replay captured graphs, read the host once a trial and once
   more, and every kernel must have been launched as often as its
   iterations and trials say (``expected_launches``); the later runs must
   hit the cache and repeat the first run's trace and final state bit for
   bit, and so must a run of the host loop (its own launch counts printed
   beside), and the chi2 must fall; prints stages 1 and 5 of a profiled
   run (the host loop) that hits the cache and of one that misses it;
   ``kitti07_mono``'s trace must agree with a run of the plain twins on the
   CPU, and ``kitti07_mono_wide`` (the same graph, poses renamed) with
   ``kitti07_mono``; prints cold and warm times and a per-stage profile;
   then the ``object_api`` phase (``object_api_phase``): ``kitti00_mono``
   built with the bulk constructors of the object API, ``initialize()`` +
   ``optimize(10)`` with the launch counters zeroed just before and read
   just after, bit for bit the array path's trace, final state and launch
   counts, the estimates written back exactly, and a re-initialize with the
   estimates reset that must hit the structure cache and repeat the trace;
   ``kitti07_mono`` through ``write_graph`` and ``read_graph`` (one edge
   object an edge) against the same file's ``read_problem`` at rtol 1e-9;
   the committed fixture through ``read_graph`` against its golden trace at
   rtol 1e-6; then runs ``kitti00_huber_f32`` alike (one B8 a trial; its trace within
   rtol 1e-3 of ``kitti00_huber``'s; the host loop's printed, not held) and
   the dense route: ``kitti00_mono`` under ``"exact"`` (against
   ``kitti00_mono`` at 1e-8) and an 800-pose loop-closure graph whose band is
   over 48 after RCM under ``"mixed"`` and ``"exact"`` (against each other),
   each dense cell's factor, build and solve ms at one trial and its
   allocator peak printed (``dense_cells``);
6. runs the paths of PCG, the pose-only solve and outlier thresholding:
   ``loop5000_pcg`` (the JAX package's 5000-pose loop-closure acceptance
   graph on the PCG route: its kernels held against their twins, the fused
   loop's three graphs a step with the CG block replayed until it reports
   done, the CG iterations of every trial, the device ms of a CG iteration,
   the trace within rtol 1e-6 of the port's f64 dense route forced on the
   same graph and printed beside the JAX package's logged trace);
   ``pcg1000_oracle`` (the stored dense
   oracle of ``tests/data/pcg_1000pose_oracle.json`` at rtol 1e-6);
   ``kitti00_mono_outliers`` (every 100th measurement moved by 30 px,
   Huber and a threshold of 5.991: ``optimize(5)``, the mask held against
   the twins' robustified chi2 thresholded, then ``optimize(10)`` on the
   inliers, a structure-cache hit); ``kitti00_motion_only`` (every landmark
   fixed: B1-B3 alone, the pose-only solve) with ``kitti07_mono``'s
   motion-only trace against the CPU; and ``icp_scan`` (one scan against
   50 000 planes and 5 000 lines, the pose recovered to the noise).  Every
   path's fused loop is held bit for bit against its host loop;
7. runs the distributed path (``parallel/distributed.py``,
   ``distributed_phase``): the city-scale graph (10k poses, 1M landmarks,
   4.18M edges) on one card (its kernels but B7/B8 held against their
   twins at its first linearisation), then dealt to two gloo ranks spawned
   on the same card (``city_scale_d2``, the band route: rank 0's ten
   kernels held against their twins at its shard's first linearisation, B5
   with a zero ``bp``, B6 on the shard's triples and B7/B8 at the global
   band among them; each rank's launches
   counted, its fused loop's eager steps (gloo: 0 captures) bit for bit its
   host loop, its trace and poses bit for bit the other's, the trace within
   rtol 1e-7 of the one-card run's) and with ``pose_solver="pcg"``
   (``city_scale_d2_pcg``, within rtol 1e-6 of the JAX package's logged
   trace, ``artifacts/CITY_SCALE.log``), and one NCCL rank in this process
   running the fused loop captured into CUDA graphs beside its host loop:
   ``kitti07_mono`` (``kitti07_nccl_d1``) and the city-scale graph
   (``city_scale_nccl_d1``) bit for bit the one-card runs, and its PCG
   route (``city_scale_nccl_d1_pcg``) within rtol 1e-6 of the log.

The last two lines are a JSON line describing the kernels and the JSON
result line ``{"ok": true, "device": {...}}``.  Without a CUDA device, or
without the package beside it, the script exits non-zero and prints no
result.
"""

from __future__ import annotations

import json
import os
import shutil
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

SRC = "cuda_bundle_adjustment_tpu_torch/csrc"
PALLAS = "cuda_bundle_adjustment_tpu/pallas"
# file:line of the pallas_call each kernel replaces
KERNEL_INFO = {
    "chi_edges": (f"{SRC}/terms.cu", f"{PALLAS}/terms.py:549"),
    "gather_rows": (f"{SRC}/gather.cu", f"{PALLAS}/onehot.py:243"),
    "linearise": (f"{SRC}/terms.cu", f"{PALLAS}/terms.py:461"),
    "damped_inverse": (f"{SRC}/lminv.cu", f"{PALLAS}/lminv.py:169"),
    "hpl_mv_segment_sum": (f"{SRC}/schurvec.cu", f"{PALLAS}/schurvec.py:128"),
    "schur_pair_products": (f"{SRC}/pairprod.cu", f"{PALLAS}/pairprod.py:201"),
    # one kernel with a runtime band height for the v2 factor (SB <= 16) and
    # the v1 factor (16 < SB <= 48)
    "band_factor": (
        f"{SRC}/bandchol.cu", f"{PALLAS}/bandchol.py:412 and {PALLAS}/bandchol.py:260"
    ),
    "band_solve": (f"{SRC}/bandchol.cu", f"{PALLAS}/bandchol.py:275"),
    "hpl_mtv_segment_sum": (f"{SRC}/schurvec.cu", f"{PALLAS}/schurvec.py:152"),
    "sym3x3_mv": (f"{SRC}/lminv.cu", f"{PALLAS}/lminv.py:206"),
}
# f64 kernels against their twins: the same terms, fused multiply-adds and
# another summation order, as a fraction of the largest magnitude
F64_TOL = 1e-12
# f32 factor/solve agreement between the kernel and its twin (two f32
# implementations of the same recurrence, different rounding order), as a
# fraction of the largest magnitude
F32_TOL = 1e-3
# f32 mode: a retyped kernel and its twin are each the f64 computation
# rounded to f32 once, so where their f64 values agree within F64_TOL their
# f32 outputs agree within one rounding: 2^-23 of the largest magnitude
F32_ROUND = 2.0**-23
# an f32-mode yardstick (a library call in f32 arithmetic, or the f32 trace)
# against the port's: f32 rounding of the sums, as a fraction of the largest
# magnitude (the JAX package's own f32 check, tests/test_terms_integration.py)
F32_STAGE_TOL = 1e-4
TIMED_REPS = 20

# Published peaks of one H100 SXM (NVIDIA's data sheet): device memory rate,
# and the f64 and f32 rates outside the tensor cores (none of these kernels
# uses them).  A kernel's bound is the larger of its bytes over the first and
# its operations over the second.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"f64": 34e12, "f32": 67e12}
# Operations per edge of the twins' arithmetic, counted from
# ``models/ba.py`` and ``ops/components.py``: projection (18), 1/z,
# residual and weighted square for chi; for the linearisation the Jacobians
# (~100) and the 42 + 12 + 18 stack entries of 2 mdim operations each.
CHI_FLOPS = {2: 40, 3: 50}
LINEARISE_FLOPS = {2: 400, 3: 560}
ROBUST = {"none": 0, "tukey": 1, "cauchy": 2, "huber": 3}  # RobustKernelType values
# small-graph case whose traces are held over fewer than 10 iterations
HELD_SHORT = {("mono", "tukey"): 6}
# small-graph case whose card-against-CPU tolerance widens after its first
# iterations: (iterations held at 1e-9, tolerance of the later ones)
HELD_LOOSER = {("mixed", "tukey"): (7, 1e-8)}
# the committed mono + stereo graph file and its 10-iteration chi2 trace from
# the dense f64 oracle (tests/test_io.py holds the JAX package to it)
FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "data",
                       "mini_mixed_graph.json")
GOLDEN_MIXED_TRACE = [
    1797.1091985976145,
    1230.5173422653224,
    1194.830797312648,
    1172.7164165427946,
    1150.446571696927,
    1131.7173476567623,
    1112.5951707431036,
    1092.1643143753622,
    1076.0163186443292,
    1067.623531588372,
]


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout
    return out.strip().splitlines()[0]


def nvcc_version() -> str:
    from cuda_bundle_adjustment_tpu_torch.kernels._build import _nvcc

    out = subprocess.run([_nvcc(), "--version"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[-1]


def ptxas_report(name: str) -> list[str]:
    """Registers, spills and static shared memory of every kernel of
    ``csrc/<name>.cu``, as ``nvcc -Xptxas -v`` reports them, a line a kernel
    (the band kernels' shared memory is dynamic: its sizes are in the
    source's note)."""
    import re
    import tempfile

    from cuda_bundle_adjustment_tpu_torch.kernels import _build

    with tempfile.TemporaryDirectory() as tmp:
        cmd = [_build._nvcc(), *_build._flags(name), "-Xptxas", "-v",
               "-o", f"{tmp}/lib.so", str(_build.CSRC_DIR / f"{name}.cu")]
        err = subprocess.run(cmd, capture_output=True, text=True, check=True).stderr
    lines = []
    for fn, stack, used in re.findall(
        r"Function properties for (\S+)\n\s*(.*)\nptxas info\s*: Used (.*)", err
    ):
        kernel = fn  # the mangled name where no demangler is installed
        if shutil.which("c++filt"):
            kernel = subprocess.run(["c++filt", fn], capture_output=True, text=True).stdout
            # "void (anonymous namespace)::kernel<2>((anonymous namespace)::Args, ...)"
            kernel = kernel.strip().split("(anonymous namespace)::", 1)[-1].split("(")[0]
        lines.append(f"ptxas {name}.cu {kernel}: {used}; {stack}")
    return lines


def cuda_ms(fn, reps: int = TIMED_REPS) -> float:
    """Median device time of ``fn`` over ``reps`` calls, after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_ms(fn, calls: int = 10, replays: int = 3) -> float:
    """The device's own time for one call of ``fn``: ``calls`` calls captured
    into one CUDA graph (the wrapper's allocations and its kernel launches,
    none of its host work), the graph replayed ``replays`` times between two
    events, so that the device and not the host sets the pace."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(replays):
        graph.replay()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / (calls * replays)


def device_ms_by_kernel(fn, reps: int = 10) -> dict:
    """Mean device time of each device kernel that one call of ``fn``
    launches, by kernel name (a hand kernel's without its namespace and
    arguments), from a ``torch.profiler`` trace of ``reps`` calls (a trace
    that comes back empty is taken again, three times at most)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    by_name = {}
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        by_name = {e.key.split("(anonymous namespace)::", 1)[-1].split("(")[0]:
                   e.device_time_total / 1e3 / reps for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and e.device_time_total > 0}
        if by_name:
            break
    check(bool(by_name), "device_ms_by_kernel: the profiler saw no device time")
    return by_name


def host_ms(fn, reps: int = 100) -> float:
    """Median host time of one call of ``fn``: what the Python wrapper
    costs whatever the device does meanwhile (no synchronise between the
    calls; the device's queue takes them all)."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return statistics.median(times) * 1e3


def timed(kernel, plain, library=None, plain_reps: int = TIMED_REPS, full: bool = True) -> dict:
    """``ms``, ``device_ms``, ``host_ms``, ``plain_ms`` and ``library_ms`` of
    one kernel row.  ``full=False``, for a row that no table reports, times
    the kernel over five calls and its twin once."""
    if not full:
        return dict(ms=cuda_ms(kernel, reps=5), plain_ms=cuda_ms(plain, reps=1),
                    library_ms=None if library is None else cuda_ms(library, reps=5))
    return dict(
        ms=cuda_ms(kernel), device_ms=device_ms(kernel), host_ms=host_ms(kernel),
        plain_ms=cuda_ms(plain, reps=plain_reps),
        library_ms=None if library is None else cuda_ms(library),
    )


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def report(label: str, name: str, r: dict) -> None:
    lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
    own = ""
    if "device_ms" in r:
        own = f" (on the device {r['device_ms']:.4f} ms, the wrapper on the host {r['host_ms']:.4f} ms)"
    print(
        f"{label} {name}: kernel {r['ms']:.4f} ms{own}, "
        f"twin {r['plain_ms']:.4f} ms, "
        f"library call {lib}, bound {r['bound_ms']:.5f} ms ({r['bound_by']})"
    )


def bound(tensors, flops: float, dtype: str) -> dict:
    """The least time the card could take: every tensor of ``tensors`` (the
    function's inputs and outputs) moved once against the operations."""
    nbytes = sum(t.numel() * t.element_size() for t in tensors if t is not None)
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return dict(
        bound_ms=max(by_bytes, by_ops),
        bound_by="bytes" if by_bytes >= by_ops else "operations",
    )


def reverse_pose_blocks(problem, block: int = 16):
    """The same graph in a less lucky pose order: every consecutive block of
    ``block`` free poses reversed (the last, partial block within itself).
    Fixed poses and landmarks keep their places.  Returns the renamed problem
    and the map, its own inverse, between old and new free-pose numbers."""
    import numpy as np

    Pa = problem.num_active_poses
    i = np.arange(Pa)
    lo = block * (i // block)
    rename = lo + np.minimum(lo + block - 1, Pa - 1) - i
    pose_q, pose_t = problem.pose_q.copy(), problem.pose_t.copy()
    pose_q[:Pa], pose_t[:Pa] = problem.pose_q[rename], problem.pose_t[rename]
    idx = problem.pose_idx
    pose_idx = np.where(idx < Pa, rename[np.minimum(idx, Pa - 1)], idx)
    return problem._replace(pose_q=pose_q, pose_t=pose_t, pose_idx=pose_idx), rename


# ORB-SLAM2's chi2 thresholds (Optimizer.cc: 95% of chi2 with 2 and 3
# degrees of freedom): the outlier thresholds of its mono and stereo edges,
# and the squares of their Huber deltas (thHuberMono, thHuberStereo)
ORBSLAM_CHI2 = {"mono": 5.991, "stereo": 7.815}
# the second camera of kitti07_two_cams: fx, fy x 1.05, cx + 12, cy - 8
SECOND_CAMERA = ((1.05, 1.05, 1.0, 1.0, 1.0), (0.0, 0.0, 12.0, -8.0, 0.0))


def mono_depth_problem(problem, seed: int = 0):
    """A depth problem split as ``make_mixed_ba_problem`` splits a stereo one
    (RGB-D SLAM: a feature with a depth reading is a depth edge, the others
    mono): each edge is a depth edge where ``rng(seed + 1).random(E) < 0.5``,
    the others mono with ``meas[:, :2]``.  Returns a ``MixedBAProblem``."""
    import numpy as np

    from cuda_bundle_adjustment_tpu_torch.io.synthetic import MixedBAProblem

    is_depth = np.random.default_rng(seed + 1).random(problem.meas.shape[0]) < 0.5

    def part(rows, kind, cols):
        return dict(kind=kind, meas=problem.meas[rows][:, :cols], pose_idx=problem.pose_idx[rows],
                    lm_idx=problem.lm_idx[rows], omega=problem.omega[rows], cam=problem.cam)

    return MixedBAProblem(
        pose_q=problem.pose_q, pose_t=problem.pose_t, num_active_poses=problem.num_active_poses,
        landmarks=problem.landmarks, num_active_landmarks=problem.num_active_landmarks,
        cam=problem.cam, specs=(part(~is_depth, "mono", 2), part(is_depth, "depth", 3)))


def orbslam_problem(mixed):
    """A mono + stereo ``MixedBAProblem`` under ORB-SLAM2's settings: each
    set its Huber kernel (delta the square root of its chi2 threshold) and
    its outlier threshold, so that the two sets do not merge."""
    specs = tuple(dict(s, rk=3, delta=ORBSLAM_CHI2[s["kind"]] ** 0.5,
                       outlier_threshold=ORBSLAM_CHI2[s["kind"]]) for s in mixed.specs)
    return mixed._replace(specs=specs)


def two_camera_problem(problem):
    """A mono ``BAProblem`` whose edges of odd poses see through a second
    camera (``SECOND_CAMERA``): ``cam`` becomes ``[E, 5]`` and those edges'
    measurements are moved by the same affine map, ``u' = 1.05 (u - cx) +
    cx'``, so the graph's solution stays the same."""
    import numpy as np

    cam = np.asarray(problem.cam, dtype=np.float64)
    scale, shift = (np.asarray(a) for a in SECOND_CAMERA)
    cam2 = cam * scale + shift
    odd = (np.asarray(problem.pose_idx) % 2 == 1)[:, None]
    meas = problem.meas.copy()
    meas[:, :2] = np.where(odd, scale[:2] * (meas[:, :2] - cam[2:4]) + cam2[2:4], meas[:, :2])
    return problem._replace(meas=meas, cam=np.where(odd, cam2, cam))


def strided_camera(solver) -> None:
    """The landmark pack's one camera ``[5, 1]`` repacked as ``[5, E]``, each
    column the same camera, so that B1 and B3 run their per-edge-camera
    instantiation on the same values (packing collapses a uniform camera to
    one column, as the JAX package's does)."""
    packs = list(solver.packs)
    d = packs[solver.ba]
    packs[solver.ba] = d._replace(cam=d.cam.expand(5, d.pose_idx.shape[0]).contiguous())
    solver.packs = tuple(packs)


def borderline_population(rk: int, seeds, device="cpu") -> list[dict]:
    """The reduced systems ``Hsc xp = bsc`` that the port meets in
    ``optimize(10)`` on the 16-pose mono graph (120 landmarks, 4 observations
    a landmark) under robust kernel ``rk`` with ``delta = 3.0``, one graph a
    seed: late iterations reach systems on which two refinement rounds of an
    f32 factor end near the ``1e-8 ||b||`` residual limit.  Each entry holds
    the system (``blocks``, ``bsc``, ``plan``), the step ``xp`` and the
    verdict ``ok`` of ``solve_reduced_band`` on ``device``."""
    from cuda_bundle_adjustment_tpu_torch.io.synthetic import make_ba_problem

    systems = []
    for seed in seeds:
        problem = make_ba_problem(
            kind="mono", num_poses=16, num_landmarks=120, mean_obs_per_landmark=4.0, seed=seed
        )
        met = []
        small_trace(problem, device, systems=met, rk=rk, delta=3.0)
        systems += [dict(seed=seed, index=i, blocks=b, bsc=v, plan=p, xp=x, ok=ok)
                    for i, (b, v, p, x, ok) in enumerate(met)]
    return systems


def reduced_residual_ratio(blocks, bsc, plan, xp) -> float:
    """The residual of step ``xp`` on the Jacobi-scaled reduced system over
    its limit ``1e-8 ||b||``, in f64: at most 1 where the solve is taken."""
    import torch

    from cuda_bundle_adjustment_tpu_torch.ops import components as C
    from cuda_bundle_adjustment_tpu_torch.solver import block_solver as bs
    from cuda_bundle_adjustment_tpu_torch.solver.segments import segment_sum

    _, bl_s, bv, s = bs.scaled_band(blocks, bsc, plan)
    brow, bcol = plan.blk_row, plan.blk_col
    x = xp / s
    off = bl_s * (brow != bcol).to(bl_s.dtype)[:, None]
    y = segment_sum(C.flat_mv_6x6(bl_s, x[bcol]), plan.row_seg)
    y = y + segment_sum(C.flat_mtv_6x6(off, x[brow]), plan.col_seg)
    return (torch.linalg.vector_norm(bv - y) / (1e-8 * torch.linalg.vector_norm(bv))).item()


def _chunks_in_plan_order(stack, half):
    """Per-vertex sums of the rows of ``stack`` as kernel B3 takes them
    through one ``ChunkPlan``: every chunk's edges in order, then a vertex's
    chunks in order."""
    import torch

    from cuda_bundle_adjustment_tpu_torch.kernels.terms import TILE

    rows, chunks, tile_off, vertex_off = (t.long() for t in half)
    dev = stack.device
    tile_of_chunk = torch.repeat_interleave(
        torch.arange(tile_off.shape[0] - 1, device=dev), tile_off[1:] - tile_off[:-1])
    tile_of_row = torch.repeat_interleave(tile_of_chunk, chunks[:, 1] - chunks[:, 0])
    ends = torch.cat([chunks[:, 0], torch.tensor([rows.shape[0]], device=dev)])
    by_tile = torch.segment_reduce(stack[rows + TILE * tile_of_row], "sum", offsets=ends)
    # a chunk's number among its vertex's: a lone chunk's target is the vertex
    target = chunks[:, 2]
    number = torch.where(target >= 0, vertex_off[target.clamp(min=0)], -1 - target)
    by_vertex = torch.empty_like(by_tile)
    by_vertex[number] = by_tile
    return torch.segment_reduce(by_vertex, "sum", offsets=vertex_off)


def linearise_in_plan_order(qt, xw, data, pose_seg, lm_seg, plan=None):
    """B3's twin with the per-vertex sums associated as the kernel
    associates them (``make_linearise_plan``), in plain tensor code on any
    device: the kernel's result bit for bit."""
    from cuda_bundle_adjustment_tpu_torch.kernels import terms

    from cuda_bundle_adjustment_tpu_torch.kernels._types import narrow, wide, wide_edges

    plan = plan or terms.make_linearise_plan(pose_seg, lm_seg, qt.shape[0])
    pose_stack, lm_stack, hpl = terms._model(data).terms(
        None, wide_edges(data), 0, 1.0, state=(wide(qt), wide(xw)))
    return narrow(qt.dtype, _chunks_in_plan_order(pose_stack, plan.pose),
                  _chunks_in_plan_order(lm_stack, plan.lm), hpl)


def hpl_mv_in_plan_order(hpl, y, lm_idx, bp, pose_seg, plan=None):
    """B5's twin with the per-pose sums associated as the kernel associates
    them (the pose half of ``make_linearise_plan``): every chunk's products
    in order, then a pose's chunks in order; plain tensor code on any
    device, the kernel's result bit for bit."""
    from cuda_bundle_adjustment_tpu_torch.kernels import schurvec
    from cuda_bundle_adjustment_tpu_torch.kernels._types import narrow, wide
    from cuda_bundle_adjustment_tpu_torch.ops.components import flat_mv_6x3

    La = y.shape[0]
    plan = plan or schurvec.mv_plan(pose_seg, hpl.shape[0], La)
    rows = flat_mv_6x3(wide(hpl), wide(y)[lm_idx.clamp(0, La - 1)])
    return narrow(bp.dtype, wide(bp) - _chunks_in_plan_order(rows, plan.pose))


def hpl_mtv_in_plan_order(hpl, xp, pose_idx, bl, lm_seg, plan=None):
    """B9's twin walked as the kernel walks the landmark half of the plan:
    a landmark of one chunk summed over its chunk, the edges of the others
    put into their scratch slots (``lm_slot``) and summed slot by slot, in
    plain tensor code: the kernel's result and the plain twin's bit for
    bit."""
    import torch

    from cuda_bundle_adjustment_tpu_torch.kernels import schurvec
    from cuda_bundle_adjustment_tpu_torch.kernels._types import narrow, wide
    from cuda_bundle_adjustment_tpu_torch.kernels.terms import TILE
    from cuda_bundle_adjustment_tpu_torch.ops.components import flat_mtv_6x3

    Pa, dev = xp.shape[0], hpl.device
    dtype, bl = bl.dtype, wide(bl)
    plan = plan or schurvec.mtv_plan(lm_seg, hpl.shape[0], Pa)
    contrib = flat_mtv_6x3(wide(hpl), wide(xp)[pose_idx.clamp(0, Pa - 1)])
    rows, chunks, tile_off, vertex_off = (t.long() for t in plan.lm)
    slot = plan.lm_slot.long()
    length = chunks[:, 1] - chunks[:, 0]
    tile_of_chunk = torch.repeat_interleave(
        torch.arange(tile_off.shape[0] - 1, device=dev), tile_off[1:] - tile_off[:-1])
    chunk_of_row = torch.repeat_interleave(torch.arange(chunks.shape[0], device=dev), length)
    edge = rows + TILE * tile_of_chunk[chunk_of_row]
    target = chunks[:, 2]
    sums = torch.zeros_like(bl)
    lone = target >= 0
    ends = torch.cat([chunks[:, 0], torch.tensor([rows.shape[0]], device=dev)])
    sums[target[lone]] = torch.segment_reduce(contrib[edge], "sum", offsets=ends)[lone]
    if int(slot[-1]) > 0:
        shared = ~lone[chunk_of_row]
        rank = torch.arange(rows.shape[0], device=dev) - chunks[chunk_of_row, 0]
        at = slot[-1 - target[chunk_of_row[shared]]] + rank[shared]
        scratch = torch.empty((int(slot[-1]), 3), dtype=bl.dtype, device=dev)
        scratch[at] = contrib[edge[shared]]
        several = (vertex_off[1:] - vertex_off[:-1]) > 1
        by_slot = torch.segment_reduce(scratch, "sum", offsets=slot[vertex_off])
        sums[several] = by_slot[several]
    return narrow(dtype, bl - sums)


def pair_products_in_plan_order(hpl, inv_hll, lm_idx, tri_ei, tri_ej, offsets, plan=None):
    """B6's twin with the per-block sums associated as the kernel associates
    them (``make_pair_plan``): an item's triples dealt round 16 slots, each
    slot summed in order, the slots by a tree, a block's items in order."""
    import torch

    from cuda_bundle_adjustment_tpu_torch.kernels import pairprod
    from cuda_bundle_adjustment_tpu_torch.kernels._types import narrow, wide
    from cuda_bundle_adjustment_tpu_torch.ops.components import flat_mm_6x3_3x3

    plan = plan or pairprod.make_pair_plan(lm_idx, tri_ei, tri_ej, offsets)
    dtype, hpl, inv_hll = hpl.dtype, wide(hpl), wide(inv_hll)
    T = tri_ei.shape[0]
    W = flat_mm_6x3_3x3(hpl, inv_hll[lm_idx.clamp(0, max(inv_hll.shape[0] - 1, 0))])
    first, last = plan.items[:, 0].long(), plan.items[:, 1].long()
    slot = torch.arange(16, device=hpl.device)
    acc = torch.zeros((first.shape[0], 16, 36), dtype=hpl.dtype, device=hpl.device)
    for step in range(pairprod.ITEM // 16):
        t = first[:, None] + 16 * step + slot
        live = t < last[:, None]
        t = t.clamp(max=max(T - 1, 0))
        prod = torch.einsum("nsik,nsjk->nsij", W[tri_ei[t]].view(-1, 16, 6, 3),
                            hpl[tri_ej[t]].view(-1, 16, 6, 3)).reshape(-1, 16, 36)
        acc = acc + prod * live[:, :, None]
    for half in (8, 4, 2, 1):
        acc = acc[:, :half] + acc[:, half : 2 * half]
    return narrow(dtype, torch.segment_reduce(acc[:, 0], "sum", offsets=plan.block_off.long()))


def structure_agreement(native, plain) -> int:
    """The native symbolic structure against the numpy one
    (``build_schur_structure(..., use_native=False)``) of the same edges:
    the same pattern, the same triples per block as a multiset, and in the
    same order except in blocks where two both-free edges share a pose and a
    landmark, which must be diagonal blocks.  Returns the number of blocks
    whose order differs."""
    import numpy as np

    from cuda_bundle_adjustment_tpu_torch.solver.symbolic import sort_triples

    check(native.tri_sorted and not plain.tri_sorted, "structure_agreement: expects native, numpy")
    for name in ("nnz_blocks", "blk_row", "blk_col", "diag_pos", "rowptr", "nmul_blocks"):
        check(np.array_equal(getattr(native, name), getattr(plain, name)),
              f"symbolic: {name} differs between the native and the numpy pass")
    (ei, ej, off), (pei, pej, poff) = sort_triples(native), sort_triples(plain)
    check(np.array_equal(off, poff), "symbolic: the blocks' triple counts differ")
    k = np.repeat(np.arange(native.nnz_blocks), np.diff(off))
    check(np.array_equal(native.tri_k, k), "symbolic: the native triples are not in block order")
    a, b = np.lexsort((ej, ei, k)), np.lexsort((pej, pei, k))
    check(np.array_equal(ei[a], pei[b]) and np.array_equal(ej[a], pej[b]),
          "symbolic: a block's triples differ as a multiset")
    differ = np.unique(k[(ei != pei) | (ej != pej)])
    check(np.array_equal(native.blk_row[differ], native.blk_col[differ]),
          "symbolic: the order differs in an off-diagonal block")
    return int(differ.size)


def cpu_model() -> str:
    """The host CPU, where the host analysis runs: its model name from
    ``/proc/cpuinfo``, or its vendor, family and model numbers where the
    name reads "unknown" (as on the card's host), and the machine type."""
    import platform

    fields = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if not line.strip():
                    break  # the first processor's fields
                key, _, value = line.partition(":")
                fields[key.strip()] = value.strip()
    except OSError:
        pass
    model = fields.get("model name", "unknown")
    if model == "unknown" and "cpu family" in fields:
        model = (f"{fields.get('vendor_id', 'unknown vendor')} family {fields['cpu family']} "
                 f"model {fields.get('model', '?')} (model name not reported)")
    return f"{model}, {platform.machine()}"


def structure_phase(problem, label: str) -> dict:
    """The host symbolic analysis at one configuration's edges: the native
    pass (``build_schur_structure``, triples already in block order) and the
    numpy copy with its sort of the triples (the path before the native
    one), each a median of three on the host clock, the second held against
    the first (:func:`structure_agreement`)."""
    import numpy as np

    from cuda_bundle_adjustment_tpu_torch.io.arrays import optimizer_from_problem
    from cuda_bundle_adjustment_tpu_torch.solver.symbolic import build_schur_structure, sort_triples

    solver = optimizer_from_problem(problem).solver
    args = (*solver._host_idx[solver.ba], solver.Pa, solver.La)
    out, times = {}, {}
    for native in (True, False):
        runs = []
        for _ in range(3):
            t0 = time.perf_counter()
            st = build_schur_structure(*args, use_native=native)
            sort_triples(st)
            runs.append((time.perf_counter() - t0) * 1e3)
        out[native], times[native] = st, statistics.median(runs)
    differ = structure_agreement(out[True], out[False])
    pi, li = args[0], args[1]
    both = (pi < solver.Pa) & (li < solver.La)
    dup = int(both.sum() - np.unique(pi[both] * solver.La + li[both]).size)
    print(f"{label} symbolic analysis on the host ({cpu_model()}): native {times[True]:.1f} ms, "
          f"numpy + sort {times[False]:.1f} ms (medians of 3); T={out[True].nmul_blocks} "
          f"nnz={out[True].nnz_blocks}; {dup} duplicate observations, {differ} blocks whose "
          f"triple order differs (same multisets)")
    check(dup > 0 or differ == 0, f"{label}: triple order differs without a duplicate observation")
    return dict(native_ms=times[True], numpy_ms=times[False], blocks_reordered=differ)


def first_linearisation(problem, dev, options=None, prepare=None, **robust):
    """The solver at the problem's first linearisation (``options``: the
    solver's; ``robust``: ``rk`` and ``delta``; ``prepare``: called on the
    solver once packed), its system and the LM's first damping (TAU x max
    diagonal) as the loops hand it to the stages: a 0-d tensor of the
    working type on the device, which B4 reads through its pointer."""
    from cuda_bundle_adjustment_tpu_torch.io.arrays import optimizer_from_problem
    from cuda_bundle_adjustment_tpu_torch.solver import block_solver as bs
    from cuda_bundle_adjustment_tpu_torch.solver.fused import TAU

    solver = optimizer_from_problem(problem, options=options, device=dev, **robust).solver
    if prepare is not None:
        prepare(solver)
    solver.build_structure()
    _, sys_ = solver.head()
    return solver, sys_, TAU * bs.max_diagonal(sys_)


def _held(name, k_out, p_out, what, tol=F64_TOL) -> float:
    """Max abs error of a kernel's outputs against its twin's, each within
    ``tol`` x its largest magnitude (``tol = 0``: bit for bit)."""
    import torch

    errs = []
    for k, p, w in zip(k_out, p_out, what):
        err = (k - p).abs().max().item()
        scale = p.abs().max().item()
        check(k.shape == p.shape, f"{name}: {w} shape {tuple(k.shape)} != {tuple(p.shape)}")
        check(err <= tol * scale, f"{name}: {w} err {err} > {tol} x {scale}")
        if tol == 0:
            check(torch.equal(k, p), f"{name}: {w} not bit-exact against its twin")
        print(f"  {name} {w} {tuple(k.shape)}: max_abs_err {err:.3e} (max|value| {scale:.3e})")
        errs.append(err)
    return max(errs)


def _held_timed(res, name, kernel, plain, what, ins, flops, tol, reported, library=None):
    """``res[name]``: a kernel held against its twin within ``tol`` x max|value|
    (0: bit for bit), timed (fully where ``reported`` is None or names it)
    and bounded; the kernels compute in f64 in either working type, so their
    operations are bounded by the f64 rate, their bytes by the operands'
    type."""
    k_out, p_out = kernel(), plain()
    if not isinstance(k_out, tuple):
        k_out, p_out = (k_out,), (p_out,)
    res[name] = dict(
        max_abs_err=_held(name, k_out, p_out, what, tol),
        **timed(kernel, plain, library, full=reported is None or name in reported),
        **bound((*ins, *k_out), flops, "f64"),
    )


def terms_held(solver, label, reported=None) -> dict:
    """B1 and B3 against their twins at the solver's state, the model, the
    camera and the sets' robust kernels as the solver packed them: chi bit
    for bit; B3 with the weight each set's rho' rescales, as
    ``build_system`` hands it over, within 1e-12 (f32: one rounding), Hpl
    bit for bit, Hll|bl bit for bit for every landmark the plan sums as one
    chunk, exact zeros on rows of fixed vertices, a second launch bit for
    bit, and every row bit for bit the twin's stacks summed in the plan's
    order.  Where the pack's camera is a camera an edge whose columns are
    all one camera, the one-camera instantiation runs beside it on the same
    inputs: its outputs bit for bit the same, its device times printed
    beside.  ``reported`` as for :func:`path_kernel_checks`."""
    import torch

    from cuda_bundle_adjustment_tpu_torch.kernels import terms
    from cuda_bundle_adjustment_tpu_torch.models.ba import edge_state
    from cuda_bundle_adjustment_tpu_torch.solver import block_solver as bs

    plan, data, meta = solver.plan, solver.packed, solver.meta
    mdim, E = data.meas.shape
    qt, xw = edge_state(solver.graph, data)
    near = F64_TOL if qt.dtype == torch.float64 else F32_ROUND
    res = {}
    edge_in = (qt, xw, data.meas, data.omega, data.cam, data.active, data.mask3, data.code)
    _held_timed(res, "chi_edges", lambda: terms.chi_edges(qt, xw, data),
                lambda: terms.chi_edges_plain(qt, xw, data), ["chi"], edge_in,
                CHI_FLOPS[mdim] * E, 0.0, reported)
    segs = (plan.pose_seg, plan.lm_seg)
    lin = data
    if bs.is_robust(meta):  # B3 takes the weight rescaled by rho'(x), as build_system hands it
        x = terms.chi_edges(qt, xw, data)
        lin = data._replace(omega=bs.robust_weight(data, meta, x))
        share = (lin.omega != data.omega).double().mean().item()
        check(share > 0, f"{label}: the robust kernel rescales no edge's weight")
        print(f"{label}: rho' rescales the weight of {100 * share:.2f}% of the edges")
    lin_plan = plan.lin_plan

    def linearise(d=lin):
        return terms.linearise(qt, xw, d, *segs, lin_plan)

    _held_timed(res, "linearise", linearise, lambda: terms.linearise_plain(qt, xw, lin, *segs),
                ["Hpp|bp", "Hll|bl", "Hpl"],
                (*edge_in, lin.omega, data.both_free, *lin_plan.pose, *lin_plan.lm),
                LINEARISE_FLOPS[mdim] * E, near, reported)
    # B3 beyond 1e-12: Hpl bit for bit; Hll|bl bit for bit for every landmark
    # the plan sums as one chunk (the others associate their chunks' sums
    # differently from the twin's sequential sum); exact zeros on rows of
    # fixed vertices; a second launch bit for bit
    k_out, p_out = linearise(), terms.linearise_plain(qt, xw, lin, *segs)
    check(torch.equal(k_out[2], p_out[2]), f"{label} linearise: Hpl not bit for bit the twin's")
    lone = (lin_plan.lm.vertex_off[1:] - lin_plan.lm.vertex_off[:-1]) == 1
    check(torch.equal(k_out[1][lone], p_out[1][lone]),
          f"{label} linearise: Hll|bl of one-chunk landmarks not bit for bit the twin's")
    check(bool((k_out[2][data.both_free == 0] == 0).all()),
          f"{label} linearise: a row of a fixed vertex is not an exact zero")
    check(all(torch.equal(a, b) for a, b in zip(k_out, linearise())),
          f"{label} linearise: a second launch differs")
    # the kernel's per-vertex sums are the twin's per-edge stacks summed in the
    # plan's order, bit for bit: what differs from the twin is the association
    # of the chunks' sums and nothing else
    o_pose, o_lm, _ = linearise_in_plan_order(qt, xw, lin, *segs, lin_plan)
    check(torch.equal(k_out[0], o_pose) and torch.equal(k_out[1], o_lm),
          f"{label} linearise: Hpp|bp or Hll|bl is not the stacks' sum in the plan's order")
    passes = {}
    if reported is None:
        passes = {k: round(v, 5) for k, v in device_ms_by_kernel(linearise).items()}
    codes = None if data.code is None else torch.bincount(data.code.long(), minlength=3).tolist()
    print(f"{label} B1 chi_edges bit for bit its twin; B3 linearise ({data.kind} model, kind "
          f"codes mono/stereo/depth {codes}, camera {tuple(data.cam.shape)}): {int(lone.sum())} "
          f"of {lone.numel()} landmarks are one chunk (bit for bit the twin's; every row bit for "
          f"bit the sum in the plan's order), {lin_plan.pose.chunks.shape[0]} pose chunks; device "
          f"ms by pass: {json.dumps(passes)}")
    if data.cam.shape[1] > 1 and bool((data.cam == data.cam[:, :1]).all()):
        one = data._replace(cam=data.cam[:, :1].contiguous())
        lin_one = lin._replace(cam=one.cam)
        check(torch.equal(terms.chi_edges(qt, xw, one), terms.chi_edges(qt, xw, data))
              and all(torch.equal(a, b) for a, b in zip(linearise(lin_one), k_out)),
              f"{label}: the one-camera instantiation gives other bits")
        res["one_camera"] = dict(chi_device_ms=device_ms(lambda: terms.chi_edges(qt, xw, one)),
                                 linearise_device_ms=device_ms(lambda: linearise(lin_one)))
        print(f"{label}: the same camera as one column, bit for bit; device ms of B1, B3 with "
              f"the camera an edge {res['chi_edges']['device_ms']:.5f}, "
              f"{res['linearise']['device_ms']:.5f}; with one camera "
              f"{res['one_camera']['chi_device_ms']:.5f}, "
              f"{res['one_camera']['linearise_device_ms']:.5f} [{nvidia_smi_line()}]")
    return res


def path_kernel_checks(solver, sys_, lam, label, reported=None) -> dict:
    """B1, B3 (:func:`terms_held`), B4, B5, B9 and B10 against their twins
    at one linearisation, in the solver's working type (f64, or f32 in f32
    mode: the twins' tolerances then ``F32_ROUND``, the bit-for-bit checks
    unchanged).  ``reported``: the kernels whose times a table reports from
    this input (all of them by default); the others are held alike and
    timed briefly."""
    import torch

    from cuda_bundle_adjustment_tpu_torch.kernels import lminv, schurvec
    from cuda_bundle_adjustment_tpu_torch.solver import block_solver as bs

    plan, data = solver.plan, solver.packed
    mdim, E = data.meas.shape
    La = solver.La
    dtype = sys_.bp.dtype
    near = F64_TOL if dtype == torch.float64 else F32_ROUND
    m3 = 0 if data.mask3 is None else int(data.mask3.sum().item())
    print(f"{label}: {data.kind} model, mdim={mdim}, {m3} stereo rows of {E} (mask3), sets "
          f"{json.dumps(set_counts(solver))}, camera {tuple(data.cam.shape)}, {dtype}")
    res = terms_held(solver, label, reported)
    lin_plan = plan.lin_plan

    def held_timed(name, kernel, plain, what, ins, flops, tol=None, library=None):
        _held_timed(res, name, kernel, plain, what, ins, flops, near if tol is None else tol,
                    reported, library)

    # B4: bit for bit; one library yardstick is linalg.inv plus a batched
    # product on the damped [La, 3, 3] blocks
    diag9 = torch.tensor([1.0, 0, 0, 0, 1.0, 0, 0, 0, 1.0], dtype=dtype, device=sys_.bp.device)
    damped = (sys_.Hll + lam * diag9).view(La, 3, 3)
    bl3 = sys_.bl.view(La, 3, 1)

    def library_inverse():
        inv = torch.linalg.inv(damped)
        return inv, torch.bmm(inv, bl3)

    def damped_inverse():
        return lminv.damped_inverse(sys_.Hll, sys_.bl, lam)

    held_timed("damped_inverse", damped_inverse,
               lambda: lminv.damped_inverse_plain(sys_.Hll, sys_.bl, lam), ["inv(Hll)", "y"],
               (sys_.Hll, sys_.bl), 60 * La, tol=0.0, library=library_inverse)
    # the solver's Hll and bl are column blocks of B3's [La, 12] rows: B4 reads
    # them in place, one device kernel a call
    hv, ldh, bv, ldb = lminv.damped_inverse_operands(sys_.Hll, sys_.bl)
    check(hv.data_ptr() == sys_.Hll.data_ptr() and bv.data_ptr() == sys_.bl.data_ptr()
          and (ldh, ldb) == (12, 12), f"{label} damped_inverse: the solver's views are copied")
    check(all(torch.equal(a, b) for a, b in zip(damped_inverse(), damped_inverse())),
          f"{label} damped_inverse: a second launch differs")
    # lam reaches the kernel as a device pointer: a captured launch replayed
    # after lam changed gives the twin at the new value, bit for bit
    lam_at = lam.clone()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        g_out = lminv.damped_inverse(sys_.Hll, sys_.bl, lam_at)
    for factor in (1.0, 7.0):
        lam_at.copy_(lam * factor)
        graph.replay()
        want = lminv.damped_inverse_plain(sys_.Hll, sys_.bl, lam_at)
        check(all(torch.equal(a, b) for a, b in zip(g_out, want)),
              f"{label} damped_inverse: a replay at lam x {factor} differs from the twin")
    del graph
    if reported is None:
        split = {k: round(v, 5) for k, v in device_ms_by_kernel(damped_inverse).items()}
        check(len(split) == 1 and next(iter(split)).startswith("damped_inverse_kernel"),
              f"{label} damped_inverse: device kernels of one call {split}, not one")
        copies = [device_ms(lambda t=t: t.contiguous()) for t in (sys_.Hll, sys_.bl)]
        print(f"{label} B4 damped_inverse on the solver's views (row stride 12): device kernels "
              f"of one call {json.dumps(split)}; the copies of Hll and bl that its wrapper made "
              f"before, on the device: {copies[0]:.5f}, {copies[1]:.5f} ms")
    invHll, y = damped_inverse()
    # the library's inverse in f64 (in f32 mode of the upcast blocks: the
    # kernel's is the f64 inverse rounded once)
    lib_inv = torch.linalg.inv(damped.double()).reshape(La, 9)
    rel = ((lib_inv - invHll.double()).abs().max() / invHll.abs().max()).item()
    lib_tol = 1e-9 if dtype == torch.float64 else 1e-6
    check(rel <= lib_tol, f"damped_inverse: torch.linalg.inv differs by {rel} of max|inv|")

    # B5 and B9: the bound from the operands of the twins' function (Hpl, the
    # vectors, the index, the right-hand side, the segment plan); the library
    # yardstick is cuSPARSE's SpMV on Hpl as a CSR matrix [6 Pa, 3 La] (its
    # transpose for B9), built once
    Pa = solver.Pa
    A = hpl_csr(sys_.Hpl, plan.ba_pose_idx, plan.ba_lm_idx, Pa, La)
    At = hpl_csr(sys_.Hpl, plan.ba_pose_idx, plan.ba_lm_idx, Pa, La, transpose=True)
    mv = (sys_.Hpl, y, plan.ba_lm_idx, sys_.bp, plan.pose_seg)
    bp_flat, y_flat = sys_.bp.reshape(-1), y.reshape(-1)

    def library_mv():
        return torch.addmv(bp_flat, A, y_flat, alpha=-1)

    held_timed("hpl_mv_segment_sum", lambda: schurvec.hpl_mv_segment_sum(*mv, lin_plan),
               lambda: schurvec.hpl_mv_segment_sum_plain(*mv), ["bsc"],
               (*mv[:4], *plan.pose_seg), 36 * E, library=library_mv)
    blocks, bsc, _ = bs.schur_reduce(sys_, lam, plan)
    xp, ok = bs.solve_reduced(blocks, bsc, plan)
    check(bool(ok), f"{label}: the first trial's reduced solve ({plan.route}) was rejected")
    mtv = (sys_.Hpl, xp, plan.ba_pose_idx, sys_.bl, plan.lm_seg)
    bl_flat, xp_flat = sys_.bl.reshape(-1), xp.reshape(-1)

    def library_mtv():
        return torch.addmv(bl_flat, At, xp_flat, alpha=-1)

    held_timed("hpl_mtv_segment_sum", lambda: schurvec.hpl_mtv_segment_sum(*mtv, lin_plan),
               lambda: schurvec.hpl_mtv_segment_sum_plain(*mtv), ["cl"],
               (*mtv[:4], *plan.lm_seg), 36 * E, tol=0.0, library=library_mtv)
    cl = schurvec.hpl_mtv_segment_sum(*mtv, lin_plan)
    schurvec_checks(label, mv, mtv, lin_plan, library_mv(), library_mtv(), E, res)
    inv3, cl3 = invHll.view(La, 3, 3), cl.view(La, 3, 1)
    held_timed("sym3x3_mv", lambda: lminv.sym3x3_mv(invHll, cl),
               lambda: lminv.sym3x3_mv_plain(invHll, cl), ["xl"],
               (invHll, cl), 15 * La, tol=0.0, library=lambda: torch.bmm(inv3, cl3))
    for name, r in res.items():
        report(label, name, r)
    return res


def hpl_csr(hpl, pose_idx, lm_idx, Pa: int, La: int, transpose: bool = False):
    """The edges' Hpl blocks of free pairs as one sparse CSR matrix
    ``[6 Pa, 3 La]`` (``transpose``: ``[3 La, 6 Pa]``), duplicates summed:
    the library's operand for B5's and B9's function."""
    import torch

    free = (pose_idx < Pa) & (lm_idx < La)
    p, l, h = pose_idx[free], lm_idx[free], hpl[free].view(-1, 6, 3)
    i6 = torch.arange(6, device=hpl.device)
    j3 = torch.arange(3, device=hpl.device)
    rows = (6 * p[:, None, None] + i6[None, :, None]).expand_as(h).reshape(-1)
    cols = (3 * l[:, None, None] + j3[None, None, :]).expand_as(h).reshape(-1)
    idx, shape = torch.stack([rows, cols]), (6 * Pa, 3 * La)
    if transpose:
        idx, shape = idx.flip(0), shape[::-1]
    return torch.sparse_coo_tensor(idx, h.reshape(-1), shape).coalesce().to_sparse_csr()


def schurvec_checks(label, mv, mtv, lin_plan, lib_bsc, lib_cl, E, res) -> None:
    """B5 and B9 beyond their twins: B5 bit for bit the twin's products
    summed in the plan's order, B9 bit for bit the plan walked as the kernel
    walks it; a second launch bit for bit and the counters back at zero;
    the library's SpMV within 1e-12 x max|value|; the bound from the
    operands the kernels read (the plan's, not the segment plan's)
    printed beside the row's."""
    import torch

    from cuda_bundle_adjustment_tpu_torch.kernels import schurvec

    bsc = schurvec.hpl_mv_segment_sum(*mv, lin_plan)
    cl = schurvec.hpl_mtv_segment_sum(*mtv, lin_plan)
    check(torch.equal(bsc, hpl_mv_in_plan_order(*mv, lin_plan)),
          f"{label} hpl_mv_segment_sum: bsc is not the products summed in the plan's order")
    check(torch.equal(cl, hpl_mtv_in_plan_order(*mtv, lin_plan)),
          f"{label} hpl_mtv_segment_sum: cl is not the plan walked as the kernel walks it")
    check(torch.equal(bsc, schurvec.hpl_mv_segment_sum(*mv, lin_plan))
          and torch.equal(cl, schurvec.hpl_mtv_segment_sum(*mtv, lin_plan)),
          f"{label} B5/B9: a second launch differs")
    check(not bool(lin_plan.count.any()), f"{label} B5/B9: a counter was left above zero")
    lib = []
    # the library's SpMV runs in the operands' type: in f32 mode its f32 sums
    # against the kernel's f64 ones rounded once
    lib_tol = F64_TOL if bsc.dtype == torch.float64 else F32_STAGE_TOL
    for name, k, want in (("hpl_mv_segment_sum", bsc, lib_bsc),
                          ("hpl_mtv_segment_sum", cl, lib_cl)):
        rel = ((k.reshape(-1) - want).abs().max() / k.abs().max()).item()
        check(rel <= lib_tol, f"{label} {name}: the library's SpMV differs by {rel} of max|value|")
        lib.append(rel)
    off = lin_plan.pose.vertex_off
    lone = int(((off[1:] - off[:-1]) == 1).sum())
    several = int(((lin_plan.lm.vertex_off[1:] - lin_plan.lm.vertex_off[:-1]) > 1).sum())
    walked = [bound((*ops[:4], *half, lin_plan.count, out), 36 * E, "f64")["bound_ms"]
              for ops, half, out in ((mv, lin_plan.pose, bsc), (mtv, lin_plan.lm, cl))]
    print(f"{label} B5/B9: {lone} of {off.shape[0] - 1} poses one chunk, "
          f"{lin_plan.pose.chunks.shape[0]} pose chunks; {several} landmarks of several chunks "
          f"({int(lin_plan.lm_slot[-1])} scratch slots); library SpMV rel diff {lib[0]:.2e}, "
          f"{lib[1]:.2e}; bound from the plan's operands {walked[0]:.5f}, {walked[1]:.5f} ms "
          f"(rows: {res['hpl_mv_segment_sum']['bound_ms']:.5f}, "
          f"{res['hpl_mtv_segment_sum']['bound_ms']:.5f})")


def band_kernel_checks(solver, sys_, lam, label, reported=None) -> dict:
    """B7 and B8 against their twins at the solver's band height, and the
    refined f64 pose step against the CPU twin path (``reported``: as in
    ``path_kernel_checks``)."""
    import torch

    from cuda_bundle_adjustment_tpu_torch.kernels import bandchol
    from cuda_bundle_adjustment_tpu_torch.solver import block_solver as bs

    plan = solver.plan
    Pa, SB, bw = solver.Pa, plan.band.sb, plan.band.bw
    res = {}
    blocks, bsc, _ = bs.schur_reduce(sys_, lam, plan)
    band, _, bv, _ = bs.scaled_band(blocks, bsc, plan)
    # the library yardsticks: cuSOLVER's dense f32 Cholesky of the same
    # scaled system and the dense solve with that factor
    dense = dense_from_band(band, Pa, SB)
    b32 = bv.to(torch.float32)
    lib_L = torch.linalg.cholesky(dense)
    lib_x = torch.cholesky_solve(b32.reshape(-1, 1), lib_L).view(Pa, 6)
    k_L = bandchol.band_factor(band, Pa, SB)
    p_L = bandchol.band_factor_plain(band, Pa, SB)
    err = (k_L - p_L).abs().max().item()
    scale = p_L.abs().max().item()
    check(bool(torch.isfinite(k_L).all()), f"{label} band_factor: non-finite factor")
    check(err <= F32_TOL * scale, f"{label} band_factor: err {err} > {F32_TOL} x {scale}")
    check(torch.equal(k_L, bandchol.band_factor(band, Pa, SB)),
          f"{label} band_factor: a second launch differs")
    # per column: the 6x6 Cholesky and inverse (~300), bw products
    # inv(L) U_d and bw (bw + 1) / 2 trailing products of 432 operations
    flops = Pa * (300 + 432 * (bw + bw * (bw + 1) // 2))
    res["band_factor"] = dict(
        max_abs_err=err,
        **timed(lambda: bandchol.band_factor(band, Pa, SB),
                lambda: bandchol.band_factor_plain(band, Pa, SB), plain_reps=3,
                library=lambda: torch.linalg.cholesky(dense),
                full=reported is None or "band_factor" in reported),
        **bound((band, k_L), flops, "f32"),
    )
    lib_err = (band_from_dense_factor(lib_L, Pa, SB, bw) - k_L).abs().max().item()
    check(lib_err <= F32_TOL * scale, f"{label} band_factor: err {lib_err} against the "
          f"library's dense factor > {F32_TOL} x {scale}")
    print(f"{label} B7 band_factor SB={SB}: max_abs_err {err:.3e} "
          f"(max|L| {scale:.3e}, tol {F32_TOL} rel); against the library's dense factor "
          f"{lib_err:.3e}")

    k_x = bandchol.band_solve(k_L, b32, Pa, SB, bw)
    p_x = bandchol.band_solve_plain(k_L, b32, Pa, SB, bw)
    err = (k_x - p_x).abs().max().item()
    scale = p_x.abs().max().item()
    check(err <= F32_TOL * scale, f"{label} band_solve: err {err} > {F32_TOL} x {scale}")
    check(torch.equal(k_x, bandchol.band_solve(k_L, b32, Pa, SB, bw)),
          f"{label} band_solve: a second launch differs")
    # forward and back: two 6x6 products and 2 bw 6x6 products a column
    res["band_solve"] = dict(
        max_abs_err=err,
        **timed(lambda: bandchol.band_solve(k_L, b32, Pa, SB, bw),
                lambda: bandchol.band_solve_plain(k_L, b32, Pa, SB, bw), plain_reps=3,
                library=lambda: torch.cholesky_solve(b32.reshape(-1, 1), lib_L),
                full=reported is None or "band_solve" in reported),
        **bound((k_L, b32, k_x), Pa * 72 * 2 * (1 + bw), "f32"),
    )
    lib_err = (lib_x - k_x).abs().max().item()
    check(lib_err <= F32_TOL * scale, f"{label} band_solve: err {lib_err} against the "
          f"library's dense solve > {F32_TOL} x {scale}")
    print(f"{label} B8 band_solve SB={SB}: max_abs_err {err:.3e} "
          f"(max|x| {scale:.3e}, tol {F32_TOL} rel); against the library's dense solve "
          f"{lib_err:.3e}")

    xp_k, ok_k = bs.solve_reduced_band(blocks, bsc, plan)
    cpu_plan = _to_device(plan, "cpu")
    xp_p, ok_p = bs.solve_reduced_band(blocks.cpu(), bsc.cpu(), cpu_plan)
    rel = ((xp_k.cpu() - xp_p).norm() / xp_p.norm()).item()
    check(bool(ok_k) and bool(ok_p), f"{label}: refined solve rejected on the first linearisation")
    check(rel <= 1e-9, f"{label} refined xp: kernel path vs twin path rel {rel} > 1e-9")
    print(f"{label} refined f64 xp (B7+B8 vs CPU twins): rel diff {rel:.3e} (tol 1e-9)")
    for name, r in res.items():
        report(f"{label} SB={SB}", name, r)
    return res


def dense_from_band(band, Pa: int, SB: int):
    """The symmetric dense matrix ``[6 Pa, 6 Pa]`` of a block-row band (the
    upper blocks ``(c, c + d)`` at row ``c SB + d``), in the band's dtype."""
    import torch

    c = torch.arange(Pa, device=band.device).repeat_interleave(SB)
    d = torch.arange(SB, device=band.device).repeat(Pa)
    inside = c + d < Pa
    c, d = c[inside], d[inside]
    blk = band.view(-1, 6, 6)[c * SB + d]
    A = torch.zeros((Pa, Pa, 6, 6), dtype=band.dtype, device=band.device)
    A[c + d, c] = blk.transpose(1, 2)
    A[c, c + d] = blk
    return A.permute(0, 2, 1, 3).reshape(6 * Pa, 6 * Pa)


def band_from_dense_factor(L, Pa: int, SB: int, bw: int):
    """A dense lower Cholesky factor in the band factor's storage:
    ``inv(L_cc)`` at ``d = 0``, ``L_{(c+d), c}^T`` at ``1 <= d <= bw``."""
    import torch

    L4 = L.view(Pa, 6, Pa, 6).permute(0, 2, 1, 3)
    out = torch.zeros(((Pa + SB) * SB, 36), dtype=L.dtype, device=L.device)
    c = torch.arange(Pa, device=L.device)
    out[c * SB] = torch.linalg.inv(L4[c, c].double()).to(L.dtype).reshape(Pa, 36)
    for d in range(1, bw + 1):
        cd = c[: Pa - d]
        out[cd * SB + d] = L4[cd + d, cd].transpose(1, 2).reshape(-1, 36)
    return out


def gather_held(solver, label, reported=None) -> dict:
    """B2 on the solver's two tables, the pose state ``[P, 12]`` and the
    landmarks ``graph.Xw`` ``[L, 3]``, each bit for bit against its masked
    gather twin and ``table[idx]``, timed beside ``index_select``, and the
    pose table again 8 bytes off a 16-byte boundary (the kernel's element
    loads), bit for bit.  Returns the pose gather's row with the landmark
    gather's under ``landmark`` (``reported`` as in ``path_kernel_checks``)."""
    import torch

    from cuda_bundle_adjustment_tpu_torch.kernels import gather
    from cuda_bundle_adjustment_tpu_torch.models.ba import _pose_state_table

    data, graph = solver.packed, solver.graph
    full = reported is None or "gather_rows" in reported
    rows = {}
    for name, table, idx in (("pose", _pose_state_table(graph), data.pose_idx),
                             ("landmark", graph.Xw, data.lm_idx)):
        k = gather.gather_rows(table, idx)
        p = gather.gather_rows_plain(table, idx)
        check(torch.equal(k, p), f"{label} gather_rows ({name}): not bit-exact against its twin")
        check(torch.equal(k, table[idx]), f"{label} gather_rows ({name}): differs from table[idx]")
        rows[name] = dict(
            max_abs_err=(k - p).abs().max().item(),
            **timed(lambda t=table, i=idx: gather.gather_rows(t, i),
                    lambda t=table, i=idx: gather.gather_rows_plain(t, i),
                    lambda t=table, i=idx: torch.index_select(t, 0, i), full=full),
            **bound((table, idx, k), 0, "f64"),
        )
        print(f"{label} B2 gather_rows ({name}) [{table.shape[0]},{table.shape[1]}]->"
              f"[{k.shape[0]},{k.shape[1]}] {table.dtype}: bit-exact")
        del k, p
    # the pose table 8 bytes off a 16-byte boundary: element loads, same bits
    table = _pose_state_table(graph)
    skip = 8 // table.element_size()
    off = torch.empty(table.numel() + skip, dtype=table.dtype, device=table.device)
    off = off[skip:].view(table.shape)
    off.copy_(table)
    check(off.data_ptr() % 16 == 8, f"{label} gather_rows: the offset table is not 8 bytes off")
    check(torch.equal(gather.gather_rows(off, data.pose_idx),
                      gather.gather_rows(table, data.pose_idx)),
          f"{label} gather_rows: a table 8 bytes off a 16-byte boundary gives other bits")
    misaligned = ""
    if full:
        ms = device_ms(lambda: gather.gather_rows(off, data.pose_idx))
        rows["pose"]["misaligned_device_ms"] = ms
        misaligned = f", on the device {ms:.4f} ms"
    print(f"{label} B2 gather_rows (pose) from a table 8 bytes off a 16-byte boundary: "
          f"bit-exact{misaligned}")
    report(f"{label} (landmark)", "gather_rows", rows["landmark"])
    return dict(rows["pose"], landmark=rows["landmark"])


def pair_products_held(solver, sys_, lam, label, reported=None) -> tuple:
    """B6 on the solver's triples within 1e-12 x max|block| (f32: one
    rounding) of its twin and of the twin's products summed in the plan's
    order, a second launch bit for bit.  Returns the row and the kernel's
    blocks."""
    import torch

    from cuda_bundle_adjustment_tpu_torch.kernels import lminv, pairprod

    plan = solver.plan
    near = F32_ROUND if sys_.bp.dtype == torch.float32 else F64_TOL
    E, T = solver.packed.pose_idx.shape[0], plan.tri_ei.shape[0]
    # Operations: W = Hpl inv(Hll) once an edge (108) and W Hpl^T once a
    # triple (216)
    invHll, _ = lminv.damped_inverse(sys_.Hll, sys_.bl, lam)
    args = (sys_.Hpl, invHll, plan.ba_lm_idx, plan.tri_ei, plan.tri_ej, plan.tri_offsets)
    pair_plan = plan.pair_plan

    def pair_products():
        return pairprod.schur_pair_products(*args, pair_plan)

    k_pp = pair_products()
    p_pp = pairprod.schur_pair_products_plain(*args)
    err = (k_pp - p_pp).abs().max().item()
    scale = p_pp.abs().max().item()
    del p_pp
    check(err <= near * scale, f"schur_pair_products: err {err} > {near} x {scale}")
    check(torch.equal(k_pp, pair_products()), f"{label} schur_pair_products: a second launch differs")
    # the function's inputs as the kernel reads them: the plan's int32 indices
    row = dict(
        max_abs_err=err,
        **timed(pair_products, lambda: pairprod.schur_pair_products_plain(*args),
                full=reported is None or "schur_pair_products" in reported),
        **bound((sys_.Hpl, invHll, *pair_plan[:5], k_pp), 108 * E + 216 * T, "f64"),
    )
    # against the twin's products summed in the plan's order: what is left is
    # the kernel's fused multiply-adds inside a product
    o_pp = pair_products_in_plan_order(*args, pair_plan)
    err_o = (k_pp - o_pp).abs().max().item()
    check(err_o <= near * scale, f"schur_pair_products: err {err_o} against the sum in the plan's order")
    print(f"{label} B6 schur_pair_products: max_abs_err {err:.3e} (max|block| {scale:.3e}, tol {near:.3g} "
          f"rel); {err_o:.3e} against the twin's products summed in the plan's order")
    return row, k_pp


def kernel_checks(problem, dev, label, reported=None, options=None, **robust) -> dict:
    """Phase 3: each of the ten kernels against its twin at the shapes and
    values of one configuration's first linearisation.  ``reported``: the
    kernels whose ``device_ms`` and ``host_ms`` are read at this input (all
    by default).  ``options``: the solver's; in f32 mode the eight retyped
    kernels are held (B7 and B8 take f32 in either mode and are held at the
    f64 inputs)."""
    import torch

    solver, sys_, lam = first_linearisation(problem, dev, options, **robust)
    f32 = solver.dtype == torch.float32
    plan = solver.plan
    E, T = solver.packed.pose_idx.shape[0], plan.tri_ei.shape[0]
    print(
        f"{label} shapes: P={solver.P} Pa={solver.Pa} L={solver.L} La={solver.La} E={E} "
        f"nnz={plan.blk_row.shape[0]} T={T} bw={plan.band.bw} SB={plan.band.sb}"
    )
    res = path_kernel_checks(solver, sys_, lam, label, reported)
    res["gather_rows"] = gather_held(solver, label, reported)
    res["schur_pair_products"], _ = pair_products_held(solver, sys_, lam, label, reported)

    if not f32 and plan.route == "band":
        res.update(band_kernel_checks(solver, sys_, lam, label, reported))
    for name in ("gather_rows", "schur_pair_products"):
        report(label, name, res[name])
    res["SB"] = plan.band.sb
    res["route"] = plan.route
    return res


def random_banded_spd(Pa: int, bw: int, SB: int, rng):
    """A random banded SPD block matrix (a third of the off-diagonal blocks
    are holes) as the f64 dense matrix and the f32 block-row band."""
    import numpy as np

    n = Pa * 6
    A = np.zeros((n, n))
    for c in range(Pa):
        for d in range(min(bw + 1, Pa - c)):
            if d > 0 and rng.random() < 0.3:
                continue
            A[c * 6 : (c + 1) * 6, (c + d) * 6 : (c + d + 1) * 6] = rng.normal(size=(6, 6))
    A = A + A.T
    A += np.eye(n) * (np.abs(A).sum(axis=1).max() + 1.0)
    band = np.zeros(((Pa + SB) * SB, 36), np.float32)
    for c in range(Pa):
        for d in range(min(bw + 1, Pa - c)):
            band[c * SB + d] = A[c * 6 : (c + 1) * 6, (c + d) * 6 : (c + d + 1) * 6].reshape(-1)
    return A, band


def tall_band_checks(dev, Pa: int = 300, bw: int = 47, SB: int = 48) -> dict:
    """B7 and B8 at band height 48 (the top of the TPU's v1 range, where the
    factor's window is f32) against their twins within 1e-5, against the f64
    dense solve within 5e-5, and a second launch bit for bit."""
    import numpy as np
    import torch

    from cuda_bundle_adjustment_tpu_torch.kernels import bandchol

    rng = np.random.default_rng(SB)
    A, band = random_banded_spd(Pa, bw, SB, rng)
    band = torch.as_tensor(band, device=dev)
    b = torch.as_tensor(rng.normal(size=(Pa, 6)).astype(np.float32), device=dev)
    k_L, p_L = bandchol.band_factor(band, Pa, SB), bandchol.band_factor_plain(band, Pa, SB)
    err_f = ((k_L - p_L).abs().max() / p_L.abs().max()).item()
    k_x, p_x = bandchol.band_solve(k_L, b, Pa, SB, bw), bandchol.band_solve_plain(k_L, b, Pa, SB, bw)
    err_s = ((k_x - p_x).norm() / p_x.norm()).item()
    x_dense = np.linalg.solve(A, b.cpu().numpy().reshape(-1).astype(np.float64)).reshape(Pa, 6)
    err_d = np.linalg.norm(k_x.cpu().numpy() - x_dense) / np.linalg.norm(x_dense)
    check(bool(torch.isfinite(k_L).all()) and err_f <= 1e-5, f"SB={SB} band_factor: err {err_f} > 1e-5")
    check(err_s <= 1e-5, f"SB={SB} band_solve: err {err_s} > 1e-5")
    check(err_d <= 5e-5, f"SB={SB} band_solve vs the f64 dense solve: {err_d} > 5e-5")
    check(torch.equal(k_L, bandchol.band_factor(band, Pa, SB))
          and torch.equal(k_x, bandchol.band_solve(k_L, b, Pa, SB, bw)),
          f"SB={SB}: a second launch of a band kernel differs")
    res = dict(
        Pa=Pa, bw=bw, SB=SB, factor_rel_err=err_f, solve_rel_err=err_s, dense_rel_err=err_d,
        factor_ms=cuda_ms(lambda: bandchol.band_factor(band, Pa, SB)),
        solve_ms=cuda_ms(lambda: bandchol.band_solve(k_L, b, Pa, SB, bw)),
    )
    print("band kernels at height 48 (random banded SPD system):", json.dumps(res))
    return res


def population_on_card(dev) -> None:
    """Phase 4, second part: every reduced system of the borderline
    population, recorded on the CPU with the twins' verdicts, solved again
    on the card.  Kernel and twin round in another order, so a verdict may
    differ where the twins' residual lies within a factor of two of its
    limit; everywhere else the card must take what the twins take and refuse
    what they refuse."""
    from cuda_bundle_adjustment_tpu_torch.solver import block_solver as bs

    for rname in ("cauchy", "tukey"):
        systems = borderline_population(ROBUST[rname], range(16))
        taken = {"cpu": 0, "card": 0}
        near, differ = [], []
        for s in systems:
            ratio = reduced_residual_ratio(s["blocks"], s["bsc"], s["plan"], s["xp"])
            plan = _to_device(s["plan"], dev)
            xp, ok = bs.solve_reduced_band(s["blocks"].to(dev), s["bsc"].to(dev), plan)
            ok = bool(ok)
            card_ratio = reduced_residual_ratio(
                s["blocks"], s["bsc"], s["plan"], xp.cpu()) if ok else float("inf")
            taken["cpu"] += s["ok"]
            taken["card"] += ok
            tag = (s["seed"], s["index"], round(ratio, 3), round(card_ratio, 3))
            if 0.5 < ratio < 2.0:
                near.append(tag)
            elif ok != s["ok"]:
                differ.append(tag)
        print(f"borderline population, {rname}: {len(systems)} reduced systems, taken by the CPU "
              f"twins {taken['cpu']}, by the card {taken['card']}; (seed, solve, twins' "
              f"residual/limit, card's) within a factor two of the limit: {near}")
        check(not differ, f"population {rname}: the card's verdict differs away from the limit: {differ}")


def _to_device(x, dev):
    import torch

    if isinstance(x, torch.Tensor):
        return x.to(dev)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_to_device(v, dev) for v in x))
    return x


def dense_scaled_condition(blocks, bsc, plan) -> float:
    """2-norm condition number of the Jacobi-scaled reduced system, from its
    dense f64 form on the host (small graphs only)."""
    import numpy as np

    from cuda_bundle_adjustment_tpu_torch.solver import block_solver as bs

    _, bl_s, _, _ = bs.scaled_band(blocks.cpu(), bsc.cpu(), _to_device(plan, "cpu"))
    Pa = bsc.shape[0]
    A = np.zeros((Pa, 6, Pa, 6))
    brow, bcol = plan.blk_row.cpu().numpy(), plan.blk_col.cpu().numpy()
    B = bl_s.numpy().reshape(-1, 6, 6)
    A[bcol, :, brow, :] = B.transpose(0, 2, 1)
    A[brow, :, bcol, :] = B
    return float(np.linalg.cond(A.reshape(Pa * 6, Pa * 6)))


def small_trace(problem, device, niter: int = 10, in_plan_order: bool = False,
                systems: list | None = None, **robust):
    """The chi2 trace of ``optimize(niter)`` on ``device`` and the solver.
    ``in_plan_order``: B3's, B5's and B6's twins sum as the kernels do
    (``linearise_in_plan_order``, ``hpl_mv_in_plan_order``,
    ``pair_products_in_plan_order``; B9's twin already does).
    ``systems``: a list that receives every reduced system and its step,
    read on the host where it is made: such a run takes the host loop (the
    fused loop's trace is the same bit for bit, but a captured trial cannot
    read its verdict back)."""
    from cuda_bundle_adjustment_tpu_torch.io.arrays import optimizer_from_problem
    from cuda_bundle_adjustment_tpu_torch.solver import block_solver as bs

    kept = bs.linearise, bs.hpl_mv_segment_sum, bs.schur_pair_products, bs.solve_reduced_band
    if in_plan_order:
        bs.linearise, bs.hpl_mv_segment_sum, bs.schur_pair_products = (
            linearise_in_plan_order, hpl_mv_in_plan_order, pair_products_in_plan_order)
    if systems is not None:
        def recording(blocks, bsc, plan):
            xp, ok = kept[3](blocks, bsc, plan)
            systems.append((blocks, bsc, plan, xp, bool(ok)))
            return xp, ok

        bs.solve_reduced_band = recording
    try:
        opt = optimizer_from_problem(problem, device=device, **robust)
        opt.use_fused_loop = systems is None
        opt.optimize(niter)
    finally:
        bs.linearise, bs.hpl_mv_segment_sum, bs.schur_pair_products, bs.solve_reduced_band = kept
    return [s.chi2 for s in opt.batch_statistics().get()], opt.solver


def order_sensitivity(problem, dev, card_trace, cpu_trace, dense_trace, **robust) -> dict:
    """Why a small graph's late iterations are held at a looser tolerance:
    per iteration, how far the trace moves (relative to the CPU's) on the
    card, on the CPU with B3's, B5's and B6's sums associated as the kernels
    associate them and nothing else changed, and in the f64 oracle, beside
    the condition number of the card's scaled reduced system and its
    residual over the limit."""
    import numpy as np

    systems = []
    small_trace(problem, dev, systems=systems, **robust)
    ordered, _ = small_trace(problem, "cpu", in_plan_order=True, **robust)
    cpu = np.array(cpu_trace)

    def moved(trace):
        return [float(f"{x:.3e}") for x in np.abs(np.array(trace) - cpu) / cpu]

    return dict(
        card=moved(card_trace), cpu_in_plan_order=moved(ordered), dense_oracle=moved(dense_trace),
        condition=[float(f"{dense_scaled_condition(b, v, p):.3e}") for b, v, p, _, _ in systems],
        residual_over_limit=[
            round(reduced_residual_ratio(b.cpu(), v.cpu(), _to_device(p, "cpu"), x.cpu()), 4)
            for b, v, p, x, _ in systems],
    )


def small_problem_checks(dev) -> None:
    """Phase 4: card vs CPU vs the numpy DenseLM oracle on a small mono,
    stereo and mixed graph, without a robust kernel and under each of them,
    over 10 iterations.  Card against CPU at rtol 1e-9 (``log`` and ``sqrt``
    may differ in the last place between host and card, so not bit for
    bit), card against the oracle at 1e-6.  Two exceptions.  Under Tukey the
    mono graph reaches, from its seventh iteration, reduced systems that are
    singular to working precision, on which steps that all meet the residual
    limit differ by more than the traces' tolerance, and card and CPU both
    stop at the eighth where the f64 oracle goes on: it is held over 6
    iterations (``HELD_SHORT``) and what each does over 10 is printed.  The
    mixed graph under Tukey is held over all 10, card against CPU at 1e-9
    over the first 7 and at 1e-8 after (``HELD_LOOSER``): its systems stay
    well conditioned, but every iteration multiplies a rounding difference
    by about ten (Tukey's weight is not convex), so that from the eighth
    iteration any other association of the f64 sums, on the CPU alone,
    moves the trace by 1e-9 of its value, and so does the oracle;
    ``order_sensitivity`` prints that beside the card's own difference."""
    import numpy as np

    from cuda_bundle_adjustment_tpu_torch.io.synthetic import (
        make_ba_problem,
        make_mixed_ba_problem,
    )
    from cuda_bundle_adjustment_tpu_torch.utils.dense_reference import DenseLM

    kw = dict(num_poses=16, num_landmarks=120, mean_obs_per_landmark=4.0, seed=13)
    for kind in ("mono", "stereo", "mixed"):
        if kind == "mixed":
            problem = make_mixed_ba_problem(**kw)
        else:
            problem = make_ba_problem(kind=kind, **kw)
        for rname, rk in ROBUST.items():
            robust = dict(rk=rk, delta=3.0)
            niter = HELD_SHORT.get((kind, rname), 10)
            tight, late_tol = HELD_LOOSER.get((kind, rname), (niter, 1e-9))
            traces, solvers = {}, {}
            for d in (dev, "cpu"):
                traces[d], solvers[d] = small_trace(problem, d, niter, **robust)
            ref = DenseLM(problem, **robust)
            want = ref.optimize(niter)
            check(len(want) == len(traces[dev]) == len(traces["cpu"]) == niter,
                  f"small {kind} {rname}: trace length differs from DenseLM")
            if tight < niter:
                print(f"small {kind} {rname}, movement of the trace by iteration:",
                      json.dumps(order_sensitivity(problem, dev, traces[dev], traces["cpu"], want,
                                                   **robust)))
            np.testing.assert_allclose(traces[dev][:tight], traces["cpu"][:tight], rtol=1e-9)
            np.testing.assert_allclose(traces[dev][tight:], traces["cpu"][tight:], rtol=late_tol)
            np.testing.assert_allclose(traces[dev], want, rtol=1e-6)
            s = solvers[dev]
            q, t = s.result_poses()
            Pa, La = s.Pa, s.La
            np.testing.assert_allclose(q[:Pa], ref.q[:Pa], atol=1e-7)
            np.testing.assert_allclose(t[:Pa], ref.t[:Pa], atol=1e-6)
            np.testing.assert_allclose(s.result_landmarks()[:La], ref.Xw[:La], atol=1e-6)
            held = f"{niter} iterations held" + (
                f" ({tight} at 1e-9, {niter - tight} at {late_tol:g} against the CPU)"
                if tight < niter else "")
            print(
                f"small {kind} problem, robust kernel {rname} (16 poses, 120 landmarks, "
                f"seed 13): {held}, cuda/cpu/DenseLM agree; chi2 "
                f"{traces[dev][0]:.6f} -> {traces[dev][-1]:.6f}"
            )
            if niter < 10:
                long = {"DenseLM": DenseLM(problem, **robust).optimize(10)}
                for d in (dev, "cpu"):
                    long[str(d)] = small_trace(problem, d, **robust)[0]
                print(f"small {kind} {rname}, last of 10 iterations (not held):",
                      json.dumps({k: (len(v), v[-2], v[-1]) for k, v in long.items()}))


def expected_launches(counts: dict, iters: int, trials: int, robust: bool, carried: bool,
                      solver=None, thresholds: int = 0) -> dict:
    """The launch counts a run of ``iters`` iterations and ``trials`` trials
    must show: a trial launches B4-B7, B9, B10 once, B8 three times (once in
    f32 mode: no refinement round) and B1 once (its chi) with two B2
    gathers; on the dense and PCG routes no B7 or B8, on the pose-only
    solve none of B4-B10; an iteration's linearisation B3 once with two B2
    (and B1 under a robust kernel).  ``carried``: F is carried from the
    accepted trial, as both one-card loops do: one chi pass (B1 + 2 B2)
    before the first iteration and none after; False: a rank's, whose head
    makes a chi pass at every iteration.  ``thresholds``: the outlier passes of
    ``update_edges`` (B1 + 2 B2 each).  ``solver``: the run's, for its route
    and type (the f64 band route by default)."""
    head = 1 if carried else iters
    route = "band" if solver is None else solver.plan.route
    solves = 3 if solver is None or solver.mixed else 1
    want = {k: 0 if route == "pose_only" else trials for k in counts}
    want.update(chi_edges=head + trials + (iters if robust else 0) + thresholds,
                gather_rows=2 * (head + iters + trials + thresholds), linearise=iters,
                band_factor=trials if route == "band" else 0,
                band_solve=solves * trials if route == "band" else 0)
    return want


def set_counts(solver) -> list:
    """``[kind, edges, active edges]`` of every edge set the solver packed,
    in packed order (a landmark pack's sets one by one)."""
    out = []
    for data, meta in zip(solver.packs, solver.metas):
        E = int(data.pose_idx.shape[0])
        parts = meta.parts or ((meta, 0, E),)
        out += [[m.kind, b - a, m.nedges] for m, a, b in parts]
    return out


def main_path(problem, label: str, warm_runs: int, options=None, profiled: bool = True,
              niter: int = 10, falls: bool = True, prepare=None, **robust) -> dict:
    """Phase 5: one configuration's optimize(10) on the default device (the
    card) through the default loop (the fused loop), counted, repeated and
    timed.  The structure cache is emptied before the cold run, which must
    miss it; every warm run must hit it and repeat the cold run's trace and
    final state bit for bit (the first warm run keeps its loop, every later
    one replays it, iteration 0 included), and so must a run of the host loop (in f32
    mode the host loop keeps lambda as a Python float, as the JAX package's
    does, while the fused loop keeps it in f32: the two may take different
    steps where a verdict lies within f32 rounding, so the host loop's
    trace is printed beside the fused loop's and not held).  Each loop's launch counts must follow from its iterations
    and trials (``expected_launches``), so the fused loop's replays were
    counted.  ``options``: the solver's; ``profiled=False`` leaves out the
    two profiled runs; ``niter``: the iterations a run; ``falls=False``: the
    chi2 is not held to fall (a depth graph's does not, in either package);
    ``prepare``: called on every run's solver once packed.  On the PCG route
    each trial's CG iterations are printed, the same in both loops, and the
    host reads count one a CG block.  Returns the launch counts and chi2
    trace of its first run, that run's solver and the allocator's peak over
    it."""
    import numpy as np
    import torch

    from cuda_bundle_adjustment_tpu_torch import kernels
    from cuda_bundle_adjustment_tpu_torch.io.arrays import optimizer_from_problem
    from cuda_bundle_adjustment_tpu_torch.solver import block_solver as bs
    from cuda_bundle_adjustment_tpu_torch.utils import profiling as prof

    def cache_delta(fn):
        before = bs.structure_cache_info()
        out = fn()
        after = bs.structure_cache_info()
        return out, (after["hits"] - before["hits"], after["misses"] - before["misses"])

    def run(fused_loop=True):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        opt = optimizer_from_problem(problem, options=options, **robust)
        if prepare is not None:
            prepare(opt.solver)
        opt.use_fused_loop = fused_loop
        opt.optimize(niter)
        torch.cuda.synchronize()
        return opt, time.perf_counter() - t0

    def state(o):
        g = o.solver.graph
        return g.q, g.t, g.Xw

    # earlier phases built this structure: the cold run starts from nothing
    bs.clear_structure_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    kernels.reset_launch_counts()
    (opt, cold_s), hm = cache_delta(run)
    counts = kernels.launch_counts()
    peak_gib = (torch.cuda.max_memory_allocated() - base) / 2**30
    check(hm == (0, 1), f"{label}: the cold run did not miss the structure cache (hits, misses {hm})")
    check(opt.device.type == "cuda", f"{label}: the default device is {opt.device}, not the card")
    trace = [s.chi2 for s in opt.batch_statistics().get()]
    iters, st = len(trace), opt.loop_stats
    check(st is not None, f"{label}: the default run did not take the fused loop")
    check(st["reads"] == st["trials"] + 1 + st["cg_reads"],
          f"{label}: {st['reads']} host reads for {st['trials']} trials and {st['cg_reads']} CG "
          f"blocks, not one a trial, one a block and one")
    check(len(st["cg_iterations"]) == (st["trials"] if opt.solver.plan.route == "pcg" else 0),
          f"{label}: {len(st['cg_iterations'])} CG solves in {st['trials']} trials")
    robust_run = bs.is_robust(opt.solver.meta)
    check(counts == expected_launches(counts, iters, st["trials"], robust_run, True, opt.solver),
          f"{label}: fused launch counts {counts} do not follow from {iters} iterations and "
          f"{st['trials']} trials")
    warm, traces, stats = [], [], [st]
    for _ in range(warm_runs):
        (o, sec), hm = cache_delta(run)
        check(hm == (1, 0), f"{label}: a warm run did not hit the structure cache (hits, misses {hm})")
        check(o.solver.symbolic_ms == 0.0, f"{label}: a warm run ran the symbolic analysis")
        check(all(torch.equal(a, b) for a, b in zip(state(o), state(opt))),
              f"{label}: a warm run's final state differs from the cold run's")
        warm.append(sec)
        traces.append([s.chi2 for s in o.batch_statistics().get()])
        stats.append(o.loop_stats)
    # a new loop (the cold run's, and the first hit's, which keeps it) runs
    # iteration 0 eagerly (the captures' warm-up) and replays every later
    # trial (a run that ends in iteration 0 captures nothing before it is
    # kept); every later hit replays the kept loop, iteration 0 included,
    # and captures nothing it kept
    for i, s in enumerate(stats):
        check(s["captures"] + s["reused"] >= min(1, iters - 1) and s["replays"] >= iters - 1
              and s["reused"] == int(i >= 2) and (s["replays"] == s["trials"]) == (i >= 2),
              f"{label}: run {i} did not replay captured graphs as its cache reading asks: {s}")
    # the host loop, the fused loop's oracle: the same trace and final state
    # bit for bit, its launches as its own loop makes them
    kernels.reset_launch_counts()
    ho, host_s = run(fused_loop=False)
    host_counts = kernels.launch_counts()
    check(ho.loop_stats is None, f"{label}: use_fused_loop=False ran the fused loop")
    host_trace = [s.chi2 for s in ho.batch_statistics().get()]
    f32 = opt.solver.dtype == torch.float32
    if f32:
        host_trials = host_counts["sym3x3_mv"]  # one B10 a trial
    else:
        check(host_trace == trace, f"{label}: the host loop's trace differs from the fused loop's")
        check(all(torch.equal(a, b) for a, b in zip(state(ho), state(opt))),
              f"{label}: the host loop's final state differs from the fused loop's")
        check(ho.cg_iterations == opt.cg_iterations,
              f"{label}: the host loop's CG iterations differ from the fused loop's")
        host_trials = st["trials"]
    check(host_counts == expected_launches(host_counts, len(host_trace), host_trials,
                                           robust_run, True, ho.solver),
          f"{label}: host launch counts {host_counts} do not follow from its iterations")

    # separate profiled runs for the per-stage breakdown (each stage ends in
    # a device synchronise, so the timed runs above stay untraced): one that
    # hits the cache, then one that misses it
    stages = {}
    for case in ("hit", "miss") if profiled else ():
        if case == "miss":
            bs.clear_structure_cache()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        po = optimizer_from_problem(problem, options=options, **robust)
        if prepare is not None:
            prepare(po.solver)
        torch.cuda.synchronize()
        pack_ms = (time.perf_counter() - t0) * 1e3
        po.set_profile(True)
        _, hm = cache_delta(lambda: po.optimize(niter))
        check(hm == ((1, 0) if case == "hit" else (0, 1)),
              f"{label}: the profiled {case} run read the cache as (hits, misses) {hm}")
        if not f32:  # the host loop's trace: in f32 held above
            traces.append([s.chi2 for s in po.batch_statistics().get()])
        tp = po.time_profile()
        stages[case] = {k: tp[k] for k in (prof.PROF_BUILD_STRUCTURE, prof.PROF_SYMBOLIC_DECOMP)}
        print(f"{label} stage profile of one profiled {case} of the structure cache (ms; packing "
              f"{pack_ms:.1f}):", json.dumps(tp))

    band = opt.solver.plan.band
    shape = "no Schur pattern" if band is None else f"bw={band.bw} SB={band.sb}"
    print(f"{label}: Pa={opt.solver.Pa} La={opt.solver.La} "
          f"E={opt.solver.packed.pose_idx.shape[0]} {shape}, "
          f"{opt.solver.dtype}, reduced route {opt.solver.plan.route} "
          f"(factor {opt.solver.plan.target}); allocator peak over the cold run "
          f"{peak_gib:.3f} GiB above what was allocated before it")
    print(f"{label} chi2 trace:", json.dumps(trace))
    print(f"{label} edge sets [kind, edges, active]: {json.dumps(set_counts(opt.solver))}; "
          f"the landmark pack's model {opt.solver.packed.kind}, camera "
          f"{tuple(opt.solver.packed.cam.shape)}")
    print(f"{label} stages 1 and 5 (ms), structure cache miss and hit:", json.dumps(stages))
    check(all(tr == trace for tr in traces), f"{label}: traces differ between runs")
    check(np.all(np.isfinite(trace)), f"{label}: non-finite chi2")
    check(trace[-1] < trace[0] or not falls, f"{label}: chi2 did not fall")
    g = opt.solver.graph
    check(
        g.q.shape == (problem.pose_q.shape[0], 4)
        and g.Xw.shape == problem.landmarks.shape
        and bool(torch.isfinite(g.q).all() and torch.isfinite(g.t).all() and torch.isfinite(g.Xw).all()),
        f"{label}: final state has the wrong shape or non-finite values",
    )
    route = opt.solver.plan.route
    for name, n in counts.items():
        check(n > 0 or route in ("dense", "pcg") and name.startswith("band_")
              or route == "pose_only" and name not in ("chi_edges", "gather_rows", "linearise"),
              f"{label}: kernel {name} was not launched")
    print(f"{label} launch counts (one optimize({niter}) run, fused loop, {iters} iterations, "
          f"{st['trials']} trials): {json.dumps(counts)}")
    print(f"{label} launch counts (host loop, same run): {json.dumps(host_counts)}")
    print(f"{label} fused loop on the {route} route, cold then warm runs (trials, host reads, "
          f"captures, replays, a kept loop reused, ms of the eager iteration 0 with a kept "
          f"loop's copies, the captures, the replays, CG blocks read, pose-only trials):",
          json.dumps([[s["trials"], s["reads"], s["captures"], s["replays"], s["reused"],
                       round(s["eager_ms"], 2), round(s["capture_ms"], 2),
                       round(s["replay_ms"], 2), s["cg_reads"],
                       s["trials"] if route == "pose_only" else 0] for s in stats]))
    if route == "pcg":
        print(f"{label} CG iterations a trial (cold run; the host loop's the same):",
              json.dumps(st["cg_iterations"]))
    if f32:
        print(f"{label} host loop (lambda a Python float, not held in f32): its trace",
              json.dumps(host_trace), "; the warm fused runs bit for bit the cold one")
    else:
        print(f"{label} host loop: its trace and final state equal the fused loop's bit for bit")
    print(
        f"{label} optimizer_from_problem+optimize({niter}): cold {cold_s:.4f} s, "
        f"warm median {statistics.median(warm):.4f} s over {len(warm)} runs "
        f"{json.dumps([round(w, 4) for w in warm])}, host loop (warm) {host_s:.4f} s; the "
        f"allocator holds {torch.cuda.memory_reserved() / 2**30:.2f} GiB "
        f"[{nvidia_smi_line()}]"
    )
    return dict(counts=counts, trace=trace, solver=opt.solver, stages=stages, peak_gib=peak_gib,
                warm_s=statistics.median(warm) if warm else None, cold_s=cold_s, host_s=host_s,
                loop_stats=st, host_counts=host_counts)


def cpu_twin_agreement(problem, run: dict, label: str) -> None:
    """A full-size run on the card against the same run through the plain
    twins on the CPU: chi2 trace at rtol 1e-9 (the tolerance of the small
    graphs), final poses and landmarks at 1e-9 of the state's scale."""
    import numpy as np

    from cuda_bundle_adjustment_tpu_torch.io.arrays import optimizer_from_problem

    t0 = time.perf_counter()
    opt = optimizer_from_problem(problem, device="cpu")
    opt.optimize(10)
    sec = time.perf_counter() - t0
    trace = [s.chi2 for s in opt.batch_statistics().get()]
    check(len(trace) == len(run["trace"]), f"{label}: the CPU twins' trace has another length")
    np.testing.assert_allclose(run["trace"], trace, rtol=1e-9)
    cs, gs = opt.solver, run["solver"]
    pairs = [*zip(gs.result_poses(), cs.result_poses()),
             (gs.result_landmarks(), cs.result_landmarks())]
    for got, want in pairs:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-9 * np.abs(want).max())
    rel = max(abs(a - b) / b for a, b in zip(run["trace"], trace))
    print(f"{label} on the card vs the plain twins on the CPU ({sec:.1f} s): {len(trace)} "
          f"iterations, trace max rel diff {rel:.3e} (tol 1e-9), state within 1e-9 of its scale")


def wide_band_agreement(narrow: dict, wide: dict, rename) -> None:
    """``kitti07_mono_wide`` against ``kitti07_mono``: the same graph with
    its poses renamed.  The f32 band factor runs in another order, so the
    traces agree to 1e-8 relative and the un-renamed states to 1e-7."""
    import numpy as np

    ns, ws = narrow["solver"], wide["solver"]
    check(ns.plan.band.sb <= 16 < ws.plan.band.sb,
          f"band heights {ns.plan.band.sb} and {ws.plan.band.sb}: not a narrow and a wide path")
    check(ws.pose_perm is None, "kitti07_mono_wide was reordered back by the solver")
    np.testing.assert_allclose(wide["trace"], narrow["trace"], rtol=1e-8)
    Pa = ns.Pa
    (wq, wt), (nq, nt) = ws.result_poses(), ns.result_poses()
    np.testing.assert_allclose(wq[:Pa][rename], nq[:Pa], rtol=0, atol=1e-7)
    np.testing.assert_allclose(wt[:Pa][rename], nt[:Pa], rtol=0, atol=1e-7)
    np.testing.assert_allclose(ws.result_landmarks(), ns.result_landmarks(), rtol=0, atol=1e-7)
    rel = max(abs(a - b) / b for a, b in zip(wide["trace"], narrow["trace"]))
    print(f"kitti07_mono_wide (SB={ws.plan.band.sb}) vs kitti07_mono (SB={ns.plan.band.sb}): "
          f"trace max rel diff {rel:.3e} (tol 1e-8), poses and landmarks within 1e-7")


def object_api_phase(mono, kitti07, runs: dict) -> dict:
    """The object_api phase: the object-graph API and the graph files on the
    card, against the array path's runs of phase 5.

    ``kitti00_mono`` through the bulk constructors (``add_vertices_bulk``,
    ``add_edges_bulk``), ``initialize()`` and ``optimize(10)``, with the
    launch counters zeroed just before and read just after: the trace, the
    final state and the launch counts must equal the array path's bit for
    bit (the same packed arrays; the index dtype differs, so the structure
    cache misses), and the estimates written back into the vertex sets must
    equal ``result_poses()`` / ``result_landmarks()`` exactly; then, with
    the estimates reset through ``write_back``, a second ``initialize()`` +
    ``optimize(10)`` must hit the structure cache and repeat the trace.
    ``kitti07_mono`` written with ``write_graph`` and read back with
    ``read_graph`` (one ``MonoEdge`` object an edge, each edge's own
    information) and with ``read_problem``: the two traces within rtol 1e-9.
    The committed fixture through ``read_graph``: its golden trace at rtol
    1e-6.  Returns the bulk run's launch counts."""
    import tempfile

    import numpy as np
    import torch

    import cuda_bundle_adjustment_tpu_torch as tbt
    from cuda_bundle_adjustment_tpu_torch import kernels
    from cuda_bundle_adjustment_tpu_torch.io import opencv_json
    from cuda_bundle_adjustment_tpu_torch.io.arrays import optimizer_from_problem
    from cuda_bundle_adjustment_tpu_torch.solver import block_solver as bs
    from cuda_bundle_adjustment_tpu_torch.utils import profiling as prof

    def ms_since(t0):
        return (time.perf_counter() - t0) * 1e3

    def optimiser(vertex_sets, edge_sets, options=None):
        opt = tbt.TorchGraphOptimisation.create(options)
        for vs in vertex_sets:
            opt.add_vertex_set(vs)
        for es in edge_sets:
            opt.add_edge_set(es)
        return opt

    def run(opt):
        """initialize() + optimize(10): wall s, initialize()'s host ms, the
        structure cache's (hits, misses) and the trace."""
        before = bs.structure_cache_info()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        opt.initialize()
        opt.optimize(10)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        after = bs.structure_cache_info()
        return (sec, opt.time_profile()[prof.PROF_INITIALIZE],
                (after["hits"] - before["hits"], after["misses"] - before["misses"]),
                [s.chi2 for s in opt.batch_statistics().get()])

    label = "object_api kitti00_mono (bulk API)"
    p, arr = mono, runs["kitti00_mono"]
    P, L = p.pose_q.shape[0], p.landmarks.shape[0]
    t0 = time.perf_counter()
    poses, landmarks = tbt.PoseVertexSet(), tbt.LandmarkVertexSet()
    poses.add_vertices_bulk(np.arange(P), p.pose_q, p.pose_t, np.arange(P) >= p.num_active_poses)
    landmarks.add_vertices_bulk(P + np.arange(L), p.landmarks,
                                np.arange(L) >= p.num_active_landmarks)
    edges = tbt.MonoEdgeSet()
    edges.set_information(1.0)
    edges.set_camera(tbt.Camera(*p.cam.tolist()))
    edges.add_edges_bulk(p.meas, p.pose_idx, P + p.lm_idx)
    build_ms = ms_since(t0)
    opt = optimiser((poses, landmarks), (edges,))
    kernels.reset_launch_counts()
    cold_s, cold_init_ms, hm, trace = run(opt)
    counts = kernels.launch_counts()
    check(opt.device.type == "cuda", f"{label}: the default device is {opt.device}")
    check(hm == (0, 1), f"{label}: the first initialize read the structure cache as {hm}")
    check(counts == arr["counts"],
          f"{label}: launch counts {counts} differ from the array path's {arr['counts']}")
    check(trace == arr["trace"], f"{label}: the trace differs from the array path's")
    check(all(torch.equal(a, b) for a, b in zip(opt.solver.graph, arr["solver"].graph)),
          f"{label}: the final state differs from the array path's")
    (q, t), X = opt.solver.result_poses(), opt.solver.result_landmarks()
    (bq, bt), bX = poses.bulk_estimates(), landmarks.bulk_estimates()
    check(np.array_equal(bq, q) and np.array_equal(bt, t) and np.array_equal(bX, X),
          f"{label}: the written-back estimates differ from result_poses()/result_landmarks()")
    poses.write_back(p.pose_q, p.pose_t)  # the starting estimates again
    landmarks.write_back(p.landmarks)
    warm_s, warm_init_ms, hm, again = run(opt)
    check(hm == (1, 0) and opt.solver.symbolic_ms == 0.0,
          f"{label}: the re-initialize did not hit the structure cache ({hm})")
    check(again == trace, f"{label}: the re-initialized run's trace differs from the first")
    print(f"{label}: bulk sets built in {build_ms:.1f} ms; initialize()+optimize(10) cold "
          f"{cold_s:.4f} s (initialize() {cold_init_ms:.2f} ms on the host, structure cache "
          f"miss), re-initialized {warm_s:.4f} s (initialize() {warm_init_ms:.2f} ms, cache hit, "
          f"symbolic_ms 0); trace, final state and launch counts bit for bit the array path's, "
          f"estimates written back exactly [{nvidia_smi_line()}]")

    label = "object_api kitti07_mono (graph file)"
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "kitti07_mono.json")
        t0 = time.perf_counter()
        opencv_json.write_graph(path, problem=kitti07)
        write_ms = ms_since(t0)
        t0 = time.perf_counter()
        g_poses, g_landmarks, edge_sets, _ = opencv_json.read_graph(path)
        read_graph_ms = ms_since(t0)
        t0 = time.perf_counter()
        problem = opencv_json.read_problem(path)
        read_problem_ms = ms_since(t0)
    n_objects = sum(len(es.edges) for es in edge_sets)
    check(n_objects == kitti07.meas.shape[0] and all(es.KIND == "mono" for es in edge_sets),
          f"{label}: read_graph made {n_objects} edge objects")
    gopt = optimiser((g_poses, g_landmarks), edge_sets,
                     tbt.GraphOptimisationOptions(per_edge_information=True))
    g_s, g_init_ms, _, g_trace = run(gopt)
    aopt = optimizer_from_problem(problem)
    aopt.optimize(10)
    a_trace = [s.chi2 for s in aopt.batch_statistics().get()]
    check(len(g_trace) == len(a_trace), f"{label}: the traces have different lengths")
    np.testing.assert_allclose(g_trace, a_trace, rtol=1e-9)
    rel = max(abs(a - b) / b for a, b in zip(g_trace, a_trace))
    print(f"{label}: write_graph {write_ms:.0f} ms, read_graph {read_graph_ms:.0f} ms "
          f"({n_objects} MonoEdge objects), read_problem {read_problem_ms:.0f} ms; "
          f"initialize() {g_init_ms:.2f} ms on the host, initialize()+optimize(10) {g_s:.4f} s; "
          f"trace against read_problem's: max rel diff {rel:.3e} (tol 1e-9), "
          f"bit for bit: {g_trace == a_trace} [{nvidia_smi_line()}]")

    label = "object_api fixture (read_graph)"
    f_poses, f_landmarks, f_sets, _ = opencv_json.read_graph(FIXTURE)
    fopt = optimiser((f_poses, f_landmarks), f_sets,
                     tbt.GraphOptimisationOptions(per_edge_information=True))
    *_, f_trace = run(fopt)
    check(fopt.solver.packed.mask3 is not None, f"{label}: not one merged masked stereo set")
    check(len(f_trace) == len(GOLDEN_MIXED_TRACE), f"{label}: {len(f_trace)} iterations, not 10")
    np.testing.assert_allclose(f_trace, GOLDEN_MIXED_TRACE, rtol=1e-6)
    rel = max(abs(a - b) / b for a, b in zip(f_trace, GOLDEN_MIXED_TRACE))
    print(f"{label}: {sum(es.nedges() for es in f_sets)} edges (mono and stereo merged), "
          f"trace max rel diff {rel:.3e} from the golden trace (tol 1e-6)")
    return counts


def dense_cells(runs: dict) -> dict:
    """The dense route at full size: ``kitti00_mono`` under ``"exact"`` (an
    f64 factor of the 7926-row scaled matrix, one solve a trial) against
    ``kitti00_mono`` under ``"mixed"`` (the band route: f32 factor, two f64
    refinement rounds), and the 800-pose loop-closure graph (band over 48
    after RCM) under ``"mixed"`` (dense f32 factor, two rounds) against
    ``"exact"``, each pair's traces within rtol 1e-8 (a refined step is
    within ~1e-11 of the f64 one, and both runs take the same steps).
    Prints each dense cell's factor, matrix build and whole solve times at
    one trial, and its allocator peak."""
    import numpy as np
    import torch

    from cuda_bundle_adjustment_tpu_torch.solver import block_solver as bs
    from cuda_bundle_adjustment_tpu_torch.solver.fused import TAU

    out = {}
    for dense, other in (("kitti00_mono_exact", "kitti00_mono"),
                         ("loop800_mixed", "loop800_exact")):
        a, b = runs[dense], runs[other]
        s = a["solver"]
        check(s.plan.route == "dense", f"{dense}: the reduced route is {s.plan.route}, not dense")
        check(len(a["trace"]) == len(b["trace"]), f"{dense}: another number of iterations "
              f"than {other}")
        np.testing.assert_allclose(a["trace"], b["trace"], rtol=1e-8)
        rel = max(abs(x - y) / y for x, y in zip(a["trace"], b["trace"]))
        # one trial's reduced system at the final state, as the loop forms it
        _, sys_ = s.head()
        blocks, bsc, _ = bs.schur_reduce(sys_, TAU * bs.max_diagonal(sys_), s.plan)
        bl_s, _, _ = bs.scaled_blocks(blocks, bsc, s.plan)
        A = bs.dense_scaled(bl_s, s.plan, s.plan.target)
        r = dict(
            n=A.shape[0], factor=str(s.plan.target), band_height=s.plan.band.bw + 1,
            factor_ms=cuda_ms(lambda: torch.linalg.cholesky_ex(A), reps=5),
            build_ms=cuda_ms(lambda: bs.dense_scaled(bl_s, s.plan, s.plan.target), reps=5),
            solve_ms=cuda_ms(lambda: bs.solve_reduced_dense(blocks, bsc, s.plan), reps=5),
            peak_gib=a["peak_gib"], trace_rel_diff=rel,
        )
        del A
        print(f"{dense} against {other}: trace max rel diff {rel:.3e} (tol 1e-8); one trial's "
              f"dense solve [{nvidia_smi_line()}]:", json.dumps(r))
        out[dense] = r
    return out


def exact_route_check(runs: dict) -> None:
    """The f64 factor's route rule (``block_solver.reduced_route``): the two
    ``"exact"`` cells keep the dense route, ``kitti00_mono_exact`` because
    its band passes the JAX package's VMEM test and ``loop800_exact``
    because it has fewer than ``PCG_MIN_POSES`` poses."""
    import torch

    from cuda_bundle_adjustment_tpu_torch.solver import block_solver as bs

    for label in ("kitti00_mono_exact", "loop800_exact"):
        s = runs[label]["solver"]
        Pa, sb = s.Pa, s.plan.band.sb
        check(s.plan.route == "dense" and s.plan.target == torch.float64,
              f"{label}: route {s.plan.route} with a {s.plan.target} factor, not dense in f64")
        print(f"{label}: the f64 factor's route dense (Pa={Pa}, SB={sb}: (Pa + SB) SB 512 B = "
              f"{(Pa + sb) * sb * 512} against {bs.DENSE_BAND_BYTES}; PCG_MIN_POSES "
              f"{bs.PCG_MIN_POSES})")


def graph_nodes(graph) -> dict:
    """A captured CUDA graph's node count, and its nodes by type (kernel,
    memcpy, memset, other), read with ``cuGraphGetNodes`` and
    ``cuGraphNodeGetType`` of ``libcuda`` (the graph is captured with
    ``keep_graph=True``)."""
    import ctypes

    cuda = ctypes.CDLL("libcuda.so.1")
    g = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    check(cuda.cuGraphGetNodes(g, None, ctypes.byref(n)) == 0, "cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    check(cuda.cuGraphGetNodes(g, nodes, ctypes.byref(n)) == 0, "cuGraphGetNodes failed")
    names = {0: "kernel", 1: "memcpy", 2: "memset"}
    out = dict(nodes=n.value)
    for h in nodes:
        t = ctypes.c_int(-1)
        check(cuda.cuGraphNodeGetType(ctypes.c_void_p(h), ctypes.byref(t)) == 0,
              "cuGraphNodeGetType failed")
        kind = names.get(t.value, f"type {t.value}")
        out[kind] = out.get(kind, 0) + 1
    return out


# the 5000-pose loop-closure graph's trace as the JAX package's acceptance run
# logged it (tools/loop_closure_demo.py; a TPU run, history: printed beside
# the port's trace, not held)
LOOP_CLOSURE_LOG = os.path.join(os.path.dirname(os.path.abspath(__file__)), "artifacts",
                                "LOOP_CLOSURE.log")
PCG_ORACLE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "data",
                          "pcg_1000pose_oracle.json")
CHI2_2DOF = 5.991  # ORB-SLAM2's outlier threshold: the 95% chi2 quantile of 2 dof


def logged_trace(path: str) -> list:
    """The ``chi2=`` values of a log, in order."""
    with open(path) as f:
        return [float(line.split("chi2=")[1].split()[0]) for line in f if "chi2=" in line]


def rel_diff(a, b) -> float:
    return max(abs(x - y) / abs(y) for x, y in zip(a, b))


def pcg_phase(problem, label: str, dev) -> dict:
    """``loop5000_pcg``: the JAX package's acceptance graph (5000 poses, 5%
    long-range co-visibility: no pose order gives a band of 48) through the
    PCG route, ``optimize(8)`` f64 ``"mixed"``.  The kernels on its path
    (B1-B6, B9, B10) held against their twins at its first linearisation;
    ``main_path`` (fused cold and warm, the host loop bit for bit, the CG
    iterations of each trial the same in both loops, launches as the route
    says: no B7 or B8); the device ms of a CG iteration (one CG block of
    the first trial captured and replayed) and of the preconditioner's
    assembly and batched factor; then the same graph on the port's f64
    dense route (``PCG_MIN_POSES`` raised for the phase, ``"exact"``, the
    host loop: a 6 Pa-row f64 matrix a trial), the two traces within rtol
    1e-6; the JAX package's logged trace printed beside, not held."""
    import numpy as np
    import torch

    from cuda_bundle_adjustment_tpu_torch import GraphOptimisationOptions
    from cuda_bundle_adjustment_tpu_torch.io.arrays import optimizer_from_problem
    from cuda_bundle_adjustment_tpu_torch.solver import block_solver as bs
    from cuda_bundle_adjustment_tpu_torch.solver import pcg

    res = kernel_checks(problem, dev, label, reported=set())
    check(res["route"] == "pcg", f"{label}: the reduced route is {res['route']}, not pcg")
    run = main_path(problem, label, warm_runs=1, profiled=False, niter=8)
    s = run["solver"]
    check(s.plan.route == "pcg" and s.plan.band.bw + 1 > bs.MAX_BAND and s.Pa >= bs.PCG_MIN_POSES,
          f"{label}: not a wide pattern on {bs.PCG_MIN_POSES} poses or more")
    check(run["counts"]["band_factor"] == run["counts"]["band_solve"] == 0,
          f"{label}: a band kernel launched on the PCG route")
    its = run["loop_stats"]["cg_iterations"]

    # one CG block of the first trial, and the preconditioner, on the device
    solver, sys_, lam = first_linearisation(problem, dev)
    blocks, bsc, _ = bs.schur_reduce(sys_, lam, solver.plan)
    bl_s, bv, _ = bs.scaled_blocks(blocks, bsc, solver.plan)
    pc = solver.plan.pcg
    st = pcg.cg_start(bv, bs.block_matvec(bl_s, solver.plan),
                      pcg.preconditioner(bl_s, solver.Pa, pc)[0], pc)
    it_ms = device_ms(lambda: pcg.cg_block(st), calls=2) / pcg.CG_BLOCK
    pre_ms = device_ms(lambda: pcg.preconditioner(bl_s, solver.Pa, pc), calls=2)
    del solver, sys_, blocks, bl_s, st

    # the port's own f64 dense route on the same graph
    old = bs.PCG_MIN_POSES
    bs.PCG_MIN_POSES = 1 << 30
    try:
        dense = optimizer_from_problem(problem,
                                       options=GraphOptimisationOptions(solver_precision="exact"))
        dense.use_fused_loop = False
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dense.optimize(8)
        torch.cuda.synchronize()
        dense_s = time.perf_counter() - t0
    finally:
        bs.PCG_MIN_POSES = old
    check(dense.solver.plan.route == "dense" and dense.solver.plan.target == torch.float64,
          f"{label}: the oracle did not take the f64 dense route")
    dtrace = [x.chi2 for x in dense.batch_statistics().get()]
    trace = run["trace"]
    check(len(dtrace) == len(trace), f"{label}: {len(trace)} iterations, the dense route "
          f"{len(dtrace)}")
    np.testing.assert_allclose(trace, dtrace, rtol=1e-6)
    jtrace = logged_trace(LOOP_CLOSURE_LOG)
    out = dict(Pa=s.Pa, La=s.La, E=int(s.packed.pose_idx.shape[0]), bw=s.plan.band.bw,
               nnz=int(s.plan.blk_row.shape[0]), triples=int(s.plan.tri_ei.shape[0]),
               chunks=pc.nch, cg_iterations=its, cg_iteration_ms=it_ms, preconditioner_ms=pre_ms,
               dense_rel_diff=rel_diff(trace, dtrace), dense_s=dense_s,
               jax_log_rel_diff=rel_diff(trace, jtrace) if len(jtrace) == len(trace) else None)
    del dense
    torch.cuda.empty_cache()
    print(f"{label}: Pa={out['Pa']} La={out['La']} E={out['E']} bandwidth after RCM {out['bw']}, "
          f"{out['nnz']} Hsc blocks, {out['triples']} triples, {pc.nch} preconditioner chunks; "
          f"CG iterations a trial {json.dumps(its)} (mean {statistics.mean(its):.1f}); device ms a "
          f"CG iteration {it_ms:.4f}, the preconditioner's assembly and factor {pre_ms:.3f} "
          f"[{nvidia_smi_line()}]")
    print(f"{label} against the f64 dense route (exact, host loop, {dense_s:.2f} s): trace max "
          f"rel diff {out['dense_rel_diff']:.3e} (tol 1e-6); dense trace {json.dumps(dtrace)}")
    print(f"{label} beside the JAX package's logged trace ({os.path.relpath(LOOP_CLOSURE_LOG)}, "
          f"not held): {json.dumps(jtrace)}, max rel diff {out['jax_log_rel_diff']}")
    return dict(run, **out)


def pcg_oracle_phase() -> dict:
    """``pcg1000_oracle``: ``tests/data/pcg_1000pose_oracle.json``'s graph
    on the PCG route (``PCG_MIN_POSES`` 0 and ``CG_MAXITER`` the oracle's,
    for the phase) through the fused loop and the host loop on the card:
    bit for bit each other, launches as the route says, within rtol 1e-6
    of the stored dense f64 trace, as the JAX package's
    ``tests/test_pcg.py`` holds it."""
    import numpy as np
    import torch

    from cuda_bundle_adjustment_tpu_torch import kernels
    from cuda_bundle_adjustment_tpu_torch.io.arrays import optimizer_from_problem
    from cuda_bundle_adjustment_tpu_torch.io.synthetic import make_loop_closure_problem
    from cuda_bundle_adjustment_tpu_torch.solver import block_solver as bs
    from cuda_bundle_adjustment_tpu_torch.solver import pcg

    with open(PCG_ORACLE) as f:
        gold = json.load(f)
    p = make_loop_closure_problem(
        num_poses=gold["num_poses"], num_landmarks=gold["num_landmarks"],
        mean_obs_per_landmark=gold["mean_obs_per_landmark"],
        long_range_fraction=gold["long_range_fraction"], seed=gold["seed"])
    old = bs.PCG_MIN_POSES, pcg.CG_MAXITER
    bs.PCG_MIN_POSES, pcg.CG_MAXITER = 0, int(gold["cg_maxiter"])
    try:
        runs, seconds, counts = [], [], []
        for fused in (True, False):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            opt = optimizer_from_problem(p)
            opt.use_fused_loop = fused
            kernels.reset_launch_counts()
            opt.optimize(gold["niterations"])
            torch.cuda.synchronize()
            runs.append(opt)
            seconds.append(time.perf_counter() - t0)
            counts.append(kernels.launch_counts())
    finally:
        bs.PCG_MIN_POSES, pcg.CG_MAXITER = old
    f, h = runs
    trace = [x.chi2 for x in f.batch_statistics().get()]
    check(f.solver.plan.route == "pcg" and f.solver.plan.pcg.maxiter == gold["cg_maxiter"],
          "pcg1000_oracle: not the PCG route at the oracle's CG_MAXITER")
    check(trace == [x.chi2 for x in h.batch_statistics().get()]
          and f.cg_iterations == h.cg_iterations, "pcg1000_oracle: the host loop differs")
    check(len(trace) == len(gold["oracle_trace"]), "pcg1000_oracle: another number of iterations")
    trials = f.loop_stats["trials"]
    for c, s in ((counts[0], f.solver), (counts[1], h.solver)):
        check(c == expected_launches(c, len(trace), trials, False, True, s),
              f"pcg1000_oracle: launch counts {c} do not follow from {len(trace)} iterations and "
              f"{trials} trials")
    np.testing.assert_allclose(trace, gold["oracle_trace"], rtol=1e-6)
    rel = rel_diff(trace, gold["oracle_trace"])
    print(f"pcg1000_oracle: trace max rel diff {rel:.3e} from the stored dense f64 oracle (tol "
          f"1e-6); CG iterations a trial {json.dumps(f.cg_iterations)}; fused loop "
          f"{json.dumps({k: f.loop_stats[k] for k in ('trials', 'reads', 'captures', 'replays')})}")
    print(f"pcg1000_oracle chi2 trace {json.dumps(trace)}; optimizer_from_problem+optimize("
          f"{gold['niterations']}) with the structure cold: fused {seconds[0]:.4f} s, host loop "
          f"{seconds[1]:.4f} s (a cache hit) [{nvidia_smi_line()}]; launch counts (fused): "
          f"{json.dumps(counts[0])}")
    return dict(rel_diff=rel, cg_iterations=f.cg_iterations)


def outlier_problem(mono, every: int = 100, shift: float = 30.0, seed: int = 0):
    """``kitti00_mono`` with every ``every``-th measurement moved by
    ``shift`` pixels in a seeded direction, and the rows moved."""
    import numpy as np

    rng = np.random.default_rng(seed)
    meas = mono.meas.copy()
    rows = np.arange(0, meas.shape[0], every)
    angle = rng.uniform(0.0, 2 * np.pi, rows.size)
    meas[rows] += shift * np.stack([np.cos(angle), np.sin(angle)], axis=1)
    return mono._replace(meas=meas), rows


def outliers_phase(mono) -> dict:
    """``kitti00_mono_outliers``: ORB-SLAM2's local-BA pattern at full
    size.  ``kitti00_mono`` with every 100th measurement moved by 30 px,
    Huber (delta sqrt(5.991)) and threshold 5.991: ``optimize(5)``, then
    ``optimize(10)`` on the inliers, through the fused loop and again
    through the host loop (bit for bit: traces, states, masks), launch
    counters zeroed before each ``optimize()`` and read after (the
    threshold's pass: one B1 and two B2).  The mask must equal the plain
    twins' robustified per-edge chi2 (B2's and B1's twins and rho, on the
    card) at the first run's final state thresholded; only edges active
    before count (``kitti00_mono`` has no edge whose vertices are all
    fixed: every landmark is free); the second run must hit the structure
    cache and keep the masked edges out; both traces must fall."""
    import numpy as np
    import torch

    from cuda_bundle_adjustment_tpu_torch import kernels
    from cuda_bundle_adjustment_tpu_torch.io.arrays import optimizer_from_problem
    from cuda_bundle_adjustment_tpu_torch.kernels import terms
    from cuda_bundle_adjustment_tpu_torch.models.ba import _pose_state_table
    from cuda_bundle_adjustment_tpu_torch.ops.robust import robustify
    from cuda_bundle_adjustment_tpu_torch.solver import block_solver as bs

    label = "kitti00_mono_outliers"
    problem, moved = outlier_problem(mono)
    robust = dict(rk=ROBUST["huber"], delta=float(np.sqrt(CHI2_2DOF)),
                  outlier_threshold=CHI2_2DOF)
    out = {}
    for fused in (True, False):
        bs.clear_structure_cache()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        opt = optimizer_from_problem(problem, **robust)
        opt.use_fused_loop = fused
        kernels.reset_launch_counts()
        opt.optimize(5)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        c1 = kernels.launch_counts()
        s = opt.solver
        first = [x.chi2 for x in opt.batch_statistics().get()]
        keep = s.packed.active > 0
        # the twins' robustified chi2 of every edge at this state
        g, d = s.graph, s.packed
        qt, xw = _pose_state_table(g)[d.pose_idx], g.Xw[d.lm_idx]
        chi = robustify(robust["rk"], robust["delta"],
                        terms.chi_edges_plain(qt, xw, d._replace(active=torch.ones_like(d.active))))
        check(torch.equal(keep, chi <= CHI2_2DOF),
              f"{label}: the mask is not the twins' robustified chi2 thresholded")
        check(s._outlier_counts == [int((~keep).sum())], f"{label}: outlier count "
              f"{s._outlier_counts}, the mask {int((~keep).sum())}")
        hits = bs.structure_cache_info()["hits"]
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        opt.optimize(10)
        torch.cuda.synchronize()
        second_s = time.perf_counter() - t0
        c2 = kernels.launch_counts()
        check(bs.structure_cache_info()["hits"] == hits + 1 and s.symbolic_ms == 0.0,
              f"{label}: the second optimize() did not hit the structure cache")
        check(not bool((s.packed.active > 0)[~keep].any()),
              f"{label}: a masked edge came back in the second run")
        second = [x.chi2 for x in opt.batch_statistics().get()][len(first):]
        check(first[-1] < first[0] and second[-1] < second[0] < first[-1],
              f"{label}: a trace did not fall ({first}, {second})")
        for c, n_iter, st in ((c1, len(first), None), (c2, len(second), opt.loop_stats)):
            trials = c["sym3x3_mv"]  # B10: once a trial on the band route
            check(c == expected_launches(c, n_iter, trials, True, True, s, thresholds=1),
                  f"{label}: launch counts {c} do not follow from {n_iter} iterations, "
                  f"{trials} trials and one threshold pass")
        out[fused] = dict(first=first, second=second, state=[a.clone() for a in s.graph],
                          active=s.packed.active.clone(), counts=(c1, c2),
                          outliers=int((~keep).sum()), moved_flagged=int((~keep)[moved].sum()),
                          times=(first_s, second_s), stats=opt.loop_stats)
        del opt, s
    f, h = out[True], out[False]
    check(f["first"] == h["first"] and f["second"] == h["second"]
          and torch.equal(f["active"], h["active"])
          and all(torch.equal(a, b) for a, b in zip(f["state"], h["state"])),
          f"{label}: the host loop differs from the fused loop")
    print(f"{label}: {moved.size} measurements moved by 30 px; {f['outliers']} edges masked, "
          f"{f['moved_flagged']} of them moved; the mask the twins' robustified chi2 at the first "
          f"run's final state thresholded at {CHI2_2DOF}; the host loop bit for bit (traces, state, "
          f"masks)")
    print(f"{label} chi2 traces, optimize(5) then optimize(10) on the inliers:",
          json.dumps(f["first"]), json.dumps(f["second"]))
    print(f"{label} launch counts (fused; each optimize() with the counters zeroed before it):",
          json.dumps(f["counts"]))
    print(f"{label} seconds (fused, host loop): optimize(5) with the structure cold "
          f"{f['times'][0]:.4f}, {h['times'][0]:.4f}; optimize(10) on the inliers "
          f"{f['times'][1]:.4f}, {h['times'][1]:.4f}; fused loop of the second run "
          f"{json.dumps({k: f['stats'][k] for k in ('trials', 'reads', 'captures', 'replays')})} "
          f"[{nvidia_smi_line()}]")
    for name, n in f["counts"][0].items():
        check(n > 0, f"{label}: kernel {name} was not launched")
    return f


def motion_only_phase(mono, kitti07) -> dict:
    """``kitti00_motion_only``: ``kitti00_mono`` with every landmark fixed
    (motion-only BA for a whole sequence: 1321 free poses, 559679 edges):
    ``main_path``, where B1, B2 and B3 (its landmark side empty) launch and
    B4-B10 do not, the fused loop bit for bit the host loop, the trace
    falling; the same setup on ``kitti07_mono`` on the card and on the CPU
    (the twins), traces within rtol 1e-9."""
    import numpy as np

    from cuda_bundle_adjustment_tpu_torch.io.arrays import optimizer_from_problem

    label = "kitti00_motion_only"
    run = main_path(mono._replace(num_active_landmarks=0), label, warm_runs=1, profiled=False)
    s = run["solver"]
    check(s.plan.route == "pose_only" and s.La == 0 and s.schur is None,
          f"{label}: not the pose-only solve")
    check(all(run["counts"][k] > 0 for k in ("chi_edges", "gather_rows", "linearise"))
          and all(n == 0 for k, n in run["counts"].items()
                  if k not in ("chi_edges", "gather_rows", "linearise")),
          f"{label}: launch counts {run['counts']}: not B1-B3 alone")
    small = kitti07._replace(num_active_landmarks=0)
    traces = {}
    for d in ("cuda", "cpu"):
        opt = optimizer_from_problem(small, device=d)
        opt.optimize(10)
        traces[d] = [x.chi2 for x in opt.batch_statistics().get()]
    check(len(traces["cuda"]) == len(traces["cpu"]), "kitti07 motion-only: iterations differ")
    np.testing.assert_allclose(traces["cuda"], traces["cpu"], rtol=1e-9)
    rel = rel_diff(traces["cuda"], traces["cpu"])
    print(f"kitti07_mono motion-only (247 free poses, every landmark fixed) on the card against the "
          f"CPU twins: trace max rel diff {rel:.3e} (tol 1e-9)")
    return dict(run, kitti07_rel_diff=rel)


def icp_scan_problem(n_plane: int = 50_000, n_line: int = 5_000, seed: int = 0):
    """A LOAM-style scan registration: one free pose, ``n_plane``
    point-to-plane and ``n_line`` point-to-line matches, made with numpy
    from ``seed``.  World points out to 50 m on random planes and lines;
    the scan's points are the world points in the true pose's frame plus
    1 cm of noise; the start is 5 cm and 1 degree off.  Returns the plane
    and line measurement rows, the start and the true pose."""
    import numpy as np

    rng = np.random.default_rng(seed)

    def quat(axis, angle):
        axis = axis / np.linalg.norm(axis)
        return np.concatenate([np.sin(angle / 2) * axis, [np.cos(angle / 2)]])

    def rotmat(q):
        x, y, z, w = q
        return np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)]])

    def qmul(a, b):
        ax, ay, az, aw = a
        bx, by, bz, bw = b
        return np.array([aw * bx + ax * bw + ay * bz - az * by,
                         aw * by - ax * bz + ay * bw + az * bx,
                         aw * bz + ax * by - ay * bx + az * bw,
                         aw * bw - ax * bx - ay * by - az * bz])

    def unit(n):
        v = rng.normal(size=(n, 3))
        return v / np.linalg.norm(v, axis=1, keepdims=True)

    q_true, t_true = quat(rng.normal(size=3), np.deg2rad(10.0)), np.array([1.0, -2.0, 0.5])
    R = rotmat(q_true)

    def scan(w):  # world points in the true pose's frame, with 1 cm of noise
        return (w - t_true) @ R + rng.normal(scale=0.01, size=w.shape)

    w = unit(n_plane) * rng.uniform(1.0, 50.0, (n_plane, 1))
    n = unit(n_plane)
    planes = np.concatenate([n, np.sum(n * w, axis=1, keepdims=True), scan(w)], axis=1)
    a = unit(n_line) * rng.uniform(1.0, 50.0, (n_line, 1))
    u = unit(n_line)
    w = a + u * rng.uniform(-5.0, 5.0, (n_line, 1))
    lines = np.concatenate([a, a + u, np.ones((n_line, 1)), scan(w)], axis=1)
    q0 = qmul(quat(rng.normal(size=3), np.deg2rad(1.0)), q_true)
    t0 = t_true + 0.05 * unit(1)[0]
    return planes, lines, (q0, t0), (q_true, t_true)


def icp_optimizer(planes, lines, start, device="cuda"):
    """One free pose at ``start`` and a plane and a line edge set of bulk
    matches, ``initialize()``d, on ``device``."""
    import numpy as np

    import cuda_bundle_adjustment_tpu_torch as tbt

    poses = tbt.PoseVertexSet()
    poses.add_vertices_bulk([0], start[0][None], start[1][None], [False])
    opt = tbt.TorchGraphOptimisation.create(device=device)
    opt.add_vertex_set(poses)
    for es, rows in ((tbt.PlaneEdgeSet(), planes), (tbt.LineEdgeSet(), lines)):
        es.set_information(1.0)
        es.add_edges_bulk(rows, np.zeros(rows.shape[0], dtype=np.int64))
        opt.add_edge_set(es)
    opt.initialize()
    return opt, poses


def pose_error(q, t, truth) -> tuple:
    """Translation error (m) and rotation angle (rad) of ``(q, t)``."""
    import numpy as np

    q_true, t_true = truth
    dot = min(1.0, abs(float(np.dot(q / np.linalg.norm(q), q_true))))
    return float(np.linalg.norm(t - t_true)), 2.0 * float(np.arccos(dot))


def icp_scan_phase() -> dict:
    """``icp_scan``: one scan registered against 50 000 planes and 5 000
    lines (plain torch, no kernel of the table: the JAX package's ICP
    models are XLA), ``optimize(10)`` through the fused loop and the host
    loop on the card (bit for bit) and on the CPU (rtol 1e-9); the pose
    recovered to the noise: within 1 mm and 0.01 degree of the truth."""
    import numpy as np
    import torch

    from cuda_bundle_adjustment_tpu_torch import kernels

    label = "icp_scan"
    planes, lines, start, truth = icp_scan_problem()
    runs = {}
    for device, fused in (("cuda", True), ("cuda", False), ("cpu", True)):
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        opt, poses = icp_optimizer(planes, lines, start, device)
        opt.use_fused_loop = fused
        opt.optimize(10)
        torch.cuda.synchronize()
        runs[device, fused] = dict(
            trace=[x.chi2 for x in opt.batch_statistics().get()], s=time.perf_counter() - t0,
            pose=poses.bulk_estimates(), stats=opt.loop_stats, counts=kernels.launch_counts(),
            route=opt.solver.plan.route)
    f, h, c = runs["cuda", True], runs["cuda", False], runs["cpu", True]
    check(f["route"] == "pose_only", f"{label}: not the pose-only solve")
    check(f["trace"] == h["trace"] and all(np.array_equal(a, b) for a, b in
                                            zip(f["pose"], h["pose"])),
          f"{label}: the host loop differs from the fused loop")
    np.testing.assert_allclose(f["trace"], c["trace"], rtol=1e-9)
    check(f["trace"][-1] < f["trace"][0], f"{label}: chi2 did not fall")
    err0 = pose_error(start[0], start[1], truth)
    err = pose_error(f["pose"][0][0], f["pose"][1][0], truth)
    check(err[0] < 1e-3 and err[1] < np.deg2rad(0.01),
          f"{label}: pose off by {err[0]:.3e} m, {np.rad2deg(err[1]):.3e} deg")
    print(f"{label}: {planes.shape[0]} planes + {lines.shape[0]} lines, one free pose; start off by "
          f"{err0[0]:.4f} m, {np.rad2deg(err0[1]):.3f} deg; after optimize(10) {err[0]:.3e} m, "
          f"{np.rad2deg(err[1]):.3e} deg; trace {json.dumps(f['trace'])}; CPU max rel diff "
          f"{rel_diff(f['trace'], c['trace']):.3e} (tol 1e-9); host loop bit for bit")
    print(f"{label} seconds (object graph built, initialize() + optimize(10)): card fused "
          f"{f['s']:.4f}, card host loop {h['s']:.4f}, CPU {c['s']:.4f}; fused loop "
          f"{json.dumps({k: f['stats'][k] for k in ('trials', 'reads', 'captures', 'replays')})}; "
          f"hand-kernel launches {sum(f['counts'].values())} [{nvidia_smi_line()}]")
    return f


def terms_checks(problem, dev, label, options=None, prepare=None) -> dict:
    """B1 and B3 alone at one configuration's first linearisation
    (:func:`terms_held`, every time read), for a path whose other kernels
    see nothing new: ``options`` the solver's, ``prepare`` called on it once
    packed."""
    solver, _, _ = first_linearisation(problem, dev, options, prepare)
    print(f"{label}: sets {json.dumps(set_counts(solver))}, {solver.dtype}")
    res = terms_held(solver, label)
    for name in ("chi_edges", "linearise"):
        report(label, name, res[name])
    return res


def depth_phase(depth, dev) -> dict:
    """``kitti00_depth``: one depth set at kitti00 size.  The ten kernels
    held against their twins at its first linearisation (B1 bit for bit; B1
    and B3 timed), B1 and B3 in f32 mode bit for bit their twins, then
    ``main_path``: fused bit for bit the host loop, the warm run the cold
    trace.  The reference's depth residual climbs against its Jacobian, so
    every trial of the first iteration is rejected: the trace is not held to
    fall."""
    from cuda_bundle_adjustment_tpu_torch import GraphOptimisationOptions

    label = "kitti00_depth"
    b1b3 = {"chi_edges", "linearise"}
    res = kernel_checks(depth, dev, label, b1b3)
    res32 = terms_checks(depth, dev, f"{label}_f32", GraphOptimisationOptions(dtype="float32"))
    run = main_path(depth, label, warm_runs=1, profiled=False, falls=False)
    check(run["solver"].packed.kind == "depth" and run["solver"].plan.route == "band",
          f"{label}: not one depth set on the band route")
    return dict(run, terms=res, terms_f32=res32)


def mono_depth_phase(depth, kitti07_depth, dev) -> dict:
    """``kitti00_mono_depth``: the depth problem split into a mono and a
    depth set (``mono_depth_problem``, about 280k edges each), one landmark
    pack of the mixed model: B1 and B3 at its first linearisation, then
    ``main_path`` on the band route with one B3 launch a linearisation over
    both sets (the chi2 not held to fall: the depth rows' steps climb, as in
    the JAX package); the same split at kitti07 size on the card against the
    plain twins on the CPU (``cpu_twin_agreement``)."""
    import torch

    from cuda_bundle_adjustment_tpu_torch.io.arrays import optimizer_from_problem

    label = "kitti00_mono_depth"
    problem = mono_depth_problem(depth)
    res = terms_checks(problem, dev, label)
    # the depth half's steps climb (the reference's model): the joint trace is
    # not held to fall
    run = main_path(problem, label, warm_runs=1, profiled=False, falls=False)
    s = run["solver"]
    check(len(s.packs) == 1 and s.packed.kind == "mixed" and len(s.meta.parts) == 2
          and s.plan.route == "band", f"{label}: not one mixed pack of two sets on the band route")
    small = mono_depth_problem(kitti07_depth)
    opt = optimizer_from_problem(small)
    opt.optimize(10)
    torch.cuda.synchronize()
    cpu_twin_agreement(small, dict(trace=[x.chi2 for x in opt.batch_statistics().get()],
                                   solver=opt.solver), "kitti07_mono_depth")
    return dict(run, terms=res)


def orbslam_phase(mixed, dev) -> dict:
    """``kitti00_mixed_orbslam``: ``kitti00_mixed``'s mono and stereo sets
    under ORB-SLAM2's settings (``orbslam_problem``: Huber at sqrt(5.991)
    and sqrt(7.815), thresholds 5.991 and 7.815), so they do not merge:
    B1 and B3 at the first linearisation with the two sets' weights, then
    ``optimize(5)`` and ``optimize(10)`` on the inliers, through the fused
    loop and again through the host loop (bit for bit: traces, states,
    masks), launch counters zeroed before each ``optimize()``.  Each set's
    mask must equal its own rho of the twins' per-edge chi2 at the first
    run's final state thresholded at its threshold, and its count the
    mask's; the second run must hit the structure cache and keep the masked
    edges out; both traces must fall."""
    import torch

    from cuda_bundle_adjustment_tpu_torch import kernels
    from cuda_bundle_adjustment_tpu_torch.io.arrays import optimizer_from_problem
    from cuda_bundle_adjustment_tpu_torch.kernels import terms
    from cuda_bundle_adjustment_tpu_torch.models.ba import _pose_state_table
    from cuda_bundle_adjustment_tpu_torch.ops.robust import robustify
    from cuda_bundle_adjustment_tpu_torch.solver import block_solver as bs

    label = "kitti00_mixed_orbslam"
    problem = orbslam_problem(mixed)
    res = terms_checks(problem, dev, label)
    out = {}
    for fused in (True, False):
        bs.clear_structure_cache()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        opt = optimizer_from_problem(problem)
        opt.use_fused_loop = fused
        kernels.reset_launch_counts()
        opt.optimize(5)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        c1 = kernels.launch_counts()
        s = opt.solver
        check(len(s.packs) == 1 and s.packed.kind == "stereo" and len(s.meta.parts) == 2,
              f"{label}: not one landmark pack of two sets")
        first = [x.chi2 for x in opt.batch_statistics().get()]
        keep = s.packed.active > 0
        g, d = s.graph, s.packed
        qt, xw = _pose_state_table(g)[d.pose_idx], g.Xw[d.lm_idx]
        x = terms.chi_edges_plain(qt, xw, d._replace(active=torch.ones_like(d.active)))
        counts = []
        for (m, a, b), spec in zip(s.meta.parts, problem.specs):
            thr = spec["outlier_threshold"]
            check(torch.equal(keep[a:b], robustify(m.rk, m.delta, x[a:b]) <= thr),
                  f"{label}: the {m.kind} set's mask is not its rho of the twins' chi2 "
                  f"thresholded at {thr}")
            counts.append(int((~keep[a:b]).sum()))
        check(s._outlier_counts == counts and all(counts),
              f"{label}: outlier counts {s._outlier_counts}, the masks {counts}")
        hits = bs.structure_cache_info()["hits"]
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        opt.optimize(10)
        torch.cuda.synchronize()
        second_s = time.perf_counter() - t0
        c2 = kernels.launch_counts()
        check(bs.structure_cache_info()["hits"] == hits + 1 and s.symbolic_ms == 0.0,
              f"{label}: the second optimize() did not hit the structure cache")
        check(not bool((s.packed.active > 0)[~keep].any()),
              f"{label}: a masked edge came back in the second run")
        second = [x.chi2 for x in opt.batch_statistics().get()][len(first):]
        check(first[-1] < first[0] and second[-1] < second[0] < first[-1],
              f"{label}: a trace did not fall ({first}, {second})")
        for c, n_iter in ((c1, len(first)), (c2, len(second))):
            trials = c["sym3x3_mv"]  # B10: once a trial on the band route
            check(c == expected_launches(c, n_iter, trials, True, True, s, thresholds=1),
                  f"{label}: launch counts {c} do not follow from {n_iter} iterations, "
                  f"{trials} trials and one threshold pass")
        out[fused] = dict(first=first, second=second, state=[a.clone() for a in s.graph],
                          active=s.packed.active.clone(), counts=(c1, c2), outliers=counts,
                          times=(first_s, second_s), stats=opt.loop_stats, sets=set_counts(s))
        del opt, s
    f, h = out[True], out[False]
    check(f["first"] == h["first"] and f["second"] == h["second"]
          and torch.equal(f["active"], h["active"])
          and all(torch.equal(a, b) for a, b in zip(f["state"], h["state"])),
          f"{label}: the host loop differs from the fused loop")
    print(f"{label}: edge sets [kind, edges, active when packed] {json.dumps(f['sets'])}; "
          f"outliers masked by set {f['outliers']}, each set's mask its rho of the twins' chi2 "
          f"thresholded; the host loop bit for bit (traces, state, masks)")
    print(f"{label} chi2 traces, optimize(5) then optimize(10) on the inliers:",
          json.dumps(f["first"]), json.dumps(f["second"]))
    print(f"{label} launch counts (fused; each optimize() with the counters zeroed before it):",
          json.dumps(f["counts"]))
    print(f"{label} seconds (fused, host loop): optimize(5) with the structure cold "
          f"{f['times'][0]:.4f}, {h['times'][0]:.4f}; optimize(10) on the inliers "
          f"{f['times'][1]:.4f}, {h['times'][1]:.4f}; fused loop of the second run "
          f"{json.dumps({k: f['stats'][k] for k in ('trials', 'reads', 'captures', 'replays')})} "
          f"[{nvidia_smi_line()}]")
    for name, n in f["counts"][0].items():
        check(n > 0, f"{label}: kernel {name} was not launched")
    return dict(f, terms=res)


def percam_phase(mono, mono_run, dev) -> dict:
    """``kitti00_mono_percam``: ``kitti00_mono`` with its camera given as
    ``[E, 5]``, every row the global camera.  Packing collapses it to one
    column, as the JAX package's does, so the phase repacks it as ``[5, E]``
    (``strided_camera``) and B1 and B3 run their per-edge-camera
    instantiation: held at the first linearisation (against the one-camera
    instantiation too, bit for bit, its device times beside), then
    ``main_path``, whose trace and final state must be ``kitti00_mono``'s
    bit for bit."""
    import numpy as np
    import torch

    label = "kitti00_mono_percam"
    E = mono.meas.shape[0]
    problem = mono._replace(cam=np.tile(np.asarray(mono.cam, dtype=np.float64), (E, 1)))

    def prepare(solver):
        check(solver.packed.cam.shape == (5, 1), f"{label}: the uniform camera was not collapsed")
        strided_camera(solver)
        check(solver.packed.cam.shape == (5, E), f"{label}: the camera is not packed [5, E]")

    res = terms_checks(problem, dev, label, prepare=prepare)
    run = main_path(problem, label, warm_runs=1, profiled=False, prepare=prepare)
    s, ref = run["solver"], mono_run["solver"]
    check(s.packed.cam.shape == (5, E) and run["counts"]["linearise"] > 0,
          f"{label}: B3 did not run the strided camera")
    check(run["trace"] == mono_run["trace"]
          and all(torch.equal(a, b) for a, b in zip(s.graph, ref.graph)),
          f"{label}: the trace or final state differs from kitti00_mono's")
    print(f"{label}: trace and final state bit for bit kitti00_mono's")
    return dict(run, terms=res)


def two_cams_phase(kitti07, dev) -> dict:
    """``kitti07_two_cams``: ``kitti07_mono`` whose odd poses' edges see
    through a second camera (``two_camera_problem``): B1 and B3 with a
    camera an edge at the first linearisation, ``main_path`` (the trace
    falls), and the card's run within 1e-9 of the plain twins on the CPU."""
    label = "kitti07_two_cams"
    problem = two_camera_problem(kitti07)
    res = terms_checks(problem, dev, label)
    run = main_path(problem, label, warm_runs=1, profiled=False)
    check(run["solver"].packed.cam.shape == (5, problem.meas.shape[0]),
          f"{label}: not a camera an edge")
    cpu_twin_agreement(problem, run, label)
    return dict(run, terms=res)


CITY_SCALE_LOG = os.path.join(os.path.dirname(os.path.abspath(__file__)), "artifacts",
                              "CITY_SCALE.log")
# the LM iterations of the distributed cells (the JAX package's logged run)
DIST_ITERS = 5


def once_ms(fn) -> tuple:
    """``(fn(), ms)``: one call timed by CUDA events, for a twin too slow
    to call twice."""
    import torch

    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    out = fn()
    b.record()
    b.synchronize()
    return out, a.elapsed_time(b)


def band_held_once(solver, sys_, lam, label) -> dict:
    """B7 and B8 against their twins at a large band (the city-scale
    replicated solve, Pa=9999): each twin called once and timed as it runs
    (B7's takes tens of seconds there), the kernels over five calls after a
    warm-up, the library yardstick (cuSOLVER's dense f32 Cholesky of the same
    scaled system, and the dense solve with it) once after a warm-up, and the
    bounds as in ``band_kernel_checks``."""
    import torch

    from cuda_bundle_adjustment_tpu_torch.kernels import bandchol
    from cuda_bundle_adjustment_tpu_torch.solver import block_solver as bs

    plan = solver.plan
    Pa, SB, bw = solver.Pa, plan.band.sb, plan.band.bw
    blocks, bsc, _ = bs.schur_reduce(sys_, lam, plan)
    band, _, bv, _ = bs.scaled_band(blocks, bsc, plan)
    del blocks, bsc
    b32 = bv.to(torch.float32)
    res = {}
    k_L = bandchol.band_factor(band, Pa, SB)
    p_L, p_ms = once_ms(lambda: bandchol.band_factor_plain(band, Pa, SB))
    err = (k_L - p_L).abs().max().item()
    scale = p_L.abs().max().item()
    del p_L
    check(bool(torch.isfinite(k_L).all()), f"{label} band_factor: non-finite factor")
    check(err <= F32_TOL * scale, f"{label} band_factor: err {err} > {F32_TOL} x {scale}")
    check(torch.equal(k_L, bandchol.band_factor(band, Pa, SB)),
          f"{label} band_factor: a second launch differs")
    res["band_factor"] = dict(
        max_abs_err=err, ms=cuda_ms(lambda: bandchol.band_factor(band, Pa, SB), reps=5),
        plain_ms=p_ms, **bound((band, k_L), Pa * (300 + 432 * (bw + bw * (bw + 1) // 2)), "f32"))
    print(f"{label} B7 band_factor Pa={Pa} SB={SB}: max_abs_err {err:.3e} (max|L| {scale:.3e}, "
          f"tol {F32_TOL} rel); the twin once {p_ms:.1f} ms")
    k_x = bandchol.band_solve(k_L, b32, Pa, SB, bw)
    p_x, p_ms = once_ms(lambda: bandchol.band_solve_plain(k_L, b32, Pa, SB, bw))
    err = (k_x - p_x).abs().max().item()
    scale = p_x.abs().max().item()
    check(err <= F32_TOL * scale, f"{label} band_solve: err {err} > {F32_TOL} x {scale}")
    check(torch.equal(k_x, bandchol.band_solve(k_L, b32, Pa, SB, bw)),
          f"{label} band_solve: a second launch differs")
    res["band_solve"] = dict(
        max_abs_err=err, ms=cuda_ms(lambda: bandchol.band_solve(k_L, b32, Pa, SB, bw), reps=5),
        plain_ms=p_ms, **bound((k_L, b32, k_x), Pa * 72 * 2 * (1 + bw), "f32"))
    print(f"{label} B8 band_solve Pa={Pa} SB={SB}: max_abs_err {err:.3e} (max|x| {scale:.3e}, "
          f"tol {F32_TOL} rel); the twin once {p_ms:.1f} ms")
    # the library yardsticks on the dense [6 Pa, 6 Pa] f32 matrix (14.4 GB at
    # Pa=9999), freed before the rank goes on
    dense = dense_from_band(band, Pa, SB)
    res["band_factor"]["library_ms"] = cuda_ms(lambda: torch.linalg.cholesky(dense), reps=1)
    lib_L = torch.linalg.cholesky(dense)
    del dense
    rhs = b32.reshape(-1, 1)
    res["band_solve"]["library_ms"] = cuda_ms(lambda: torch.cholesky_solve(rhs, lib_L), reps=1)
    del lib_L
    torch.cuda.empty_cache()
    for name, r in res.items():
        report(f"{label} SB={SB}", name, r)
    return res


def shard_kernel_checks(rs, sys_, lam, label) -> dict:
    """Every kernel of one rank's shard at the first linearisation of the
    distributed path, against its twin: ``path_kernel_checks`` (B1, B3, B4,
    B5 with the summed ``bp``, B9, B10, and the one-card reduce and solve of
    the rank's share, which must be taken) and B2, then the two inputs only
    this path gives: B5 with a zero ``bp`` (a rank's ``-sum Hpl y``, within
    1e-12 of its twin and bit for bit the products summed in the plan's
    order) and B6 on the rank's triples over the global pattern
    (``pair_products_held``; the blocks without a triple on this rank exact
    zeros); and the replicated solve every rank repeats, B7 and B8 at the
    global band (``band_held_once``).  Timed briefly (five calls, the twin
    once)."""
    import torch

    from cuda_bundle_adjustment_tpu_torch.kernels import lminv, schurvec

    res = path_kernel_checks(rs, sys_, lam, label, reported=set())
    res["gather_rows"] = gather_held(rs, label, reported=set())
    plan = rs.plan
    E = rs.packed.pose_idx.shape[0]
    invHll, y = lminv.damped_inverse(sys_.Hll, sys_.bl, lam)
    mv = (sys_.Hpl, y, plan.ba_lm_idx, rs.zero_bp, plan.pose_seg)
    part = {}
    _held_timed(part, "hpl_mv_segment_sum", lambda: schurvec.hpl_mv_segment_sum(*mv, plan.lin_plan),
                lambda: schurvec.hpl_mv_segment_sum_plain(*mv), ["-sum Hpl y"],
                (*mv[:4], *plan.pose_seg), 36 * E, F64_TOL, set())
    check(torch.equal(schurvec.hpl_mv_segment_sum(*mv, plan.lin_plan),
                      hpl_mv_in_plan_order(*mv, plan.lin_plan)),
          f"{label} hpl_mv_segment_sum (zero bp): not the products summed in the plan's order")
    res["hpl_mv_segment_sum_zero_bp"] = part["hpl_mv_segment_sum"]
    del invHll, y, mv
    res["schur_pair_products"], k_pp = pair_products_held(rs, sys_, lam, label, reported=set())
    empty = (plan.tri_offsets[1:] == plan.tri_offsets[:-1])
    check(bool((k_pp[empty] == 0).all()), f"{label} schur_pair_products: a block without a "
          f"triple on this rank is not an exact zero")
    print(f"{label} rank 0: B5 with a zero bp bit for bit the products in the plan's order; B6 on "
          f"{plan.tri_ei.shape[0]} triples over {k_pp.shape[0]} global blocks, "
          f"{int(empty.sum())} of them without a triple on this rank (exact zeros)")
    del k_pp
    for name in ("gather_rows", "hpl_mv_segment_sum_zero_bp", "schur_pair_products"):
        report(label, name, res[name])
    torch.cuda.empty_cache()
    res.update(band_held_once(rs, sys_, lam, label))
    print(f"[{nvidia_smi_line()}]")
    return res


class AllReduceTimer:
    """``torch.distributed.all_reduce`` wrapped while in the block: ``ms``
    adds the host-clock time inside each call, the device synchronised on
    each side (what a trial waits for its collectives)."""

    def __enter__(self):
        import torch
        import torch.distributed as dist

        self.dist, self.orig, self.ms = dist, dist.all_reduce, 0.0

        def timed_call(tensor, *args, **kwargs):
            if tensor.is_cuda:
                torch.cuda.synchronize(tensor.device)
            t0 = time.perf_counter()
            out = self.orig(tensor, *args, **kwargs)
            if tensor.is_cuda:
                torch.cuda.synchronize(tensor.device)
            self.ms += (time.perf_counter() - t0) * 1e3
            return out

        dist.all_reduce = timed_call
        return self

    def __exit__(self, *exc):
        self.dist.all_reduce = self.orig


def timed_run(rs, niter: int) -> tuple:
    """``rs.optimize(niter)`` under :class:`AllReduceTimer`: ``(trace,
    graph, stats)`` with the ms inside ``all_reduce`` in the stats' count
    of the run's collectives."""
    with AllReduceTimer() as timer:
        trace, graph = rs.optimize(niter)
    return trace, graph, dict(rs.stats, all_reduce=dict(rs.stats["all_reduce"], ms=timer.ms))


def distributed_rank(rank: int, world: int, init: str, cells, out_dir: str) -> None:
    """One gloo rank of the distributed phase on the card: for each
    ``(label, ShardedProblem)`` of ``cells`` a ``RankSolver`` (the rank's
    shard uploaded, its plan made); on the first cell rank 0 holds its
    shard's kernels against their twins at the first linearisation
    (``shard_kernel_checks``) while rank 1 waits; then the launch counters
    zeroed, ``optimize(DIST_ITERS)`` (the cold run: the fused loop, its
    steps eager under gloo, 0 captures), the counters read, a second run
    (warm) that must repeat the first bit for bit, and a run of the host
    loop (``use_fused_loop = False``) whose trace and final state must be
    the fused loop's bit for bit.  Writes what it holds to a pickle; a
    failure raises and ends the rank, and the parent's spawn with it."""
    import pickle

    import torch
    import torch.distributed as dist

    from cuda_bundle_adjustment_tpu_torch import kernels
    from cuda_bundle_adjustment_tpu_torch.parallel import RankSolver
    from cuda_bundle_adjustment_tpu_torch.solver.fused import TAU

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world)
    out = {}
    try:
        for i, (label, sp) in enumerate(cells):
            rs = RankSolver(None, sp)
            dev = rs.device
            checks = None
            if i == 0:
                sys_ = rs.linearise()
                lam = TAU * float(rs.top_diagonal(sys_))
                if rank == 0:
                    checks = shard_kernel_checks(
                        rs, sys_, torch.full((), lam, dtype=torch.float64, device=rs.device), label)
                del sys_
                torch.cuda.empty_cache()
                dist.barrier()
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            trace, graph = rs.optimize(DIST_ITERS)
            counts = kernels.launch_counts()
            cold = rs.stats
            check(cold["fused"] and not cold["capture"] and cold["captures"] == 0
                  and cold["reads"] == cold["trials"] + 1 + cold["cg_reads"],
                  f"{label} rank {rank}: not the fused loop's eager steps: {cold}")
            graph = [a.clone() for a in graph]
            trace_w, graph_w, warm = timed_run(rs, DIST_ITERS)
            check(trace_w == trace and all(torch.equal(a, b) for a, b in zip(graph, graph_w)),
                  f"{label} rank {rank}: the warm run differs from the cold run")
            rs.use_fused_loop = False
            trace_h, graph_h, host = timed_run(rs, DIST_ITERS)
            check(trace_h == trace and all(torch.equal(a, b) for a, b in zip(graph, graph_h)),
                  f"{label} rank {rank}: the host loop's trace or final state is not the fused "
                  f"loop's bit for bit")
            check(host["all_reduce"]["calls"] == warm["all_reduce"]["calls"]
                  and host["all_reduce"]["bytes"] == warm["all_reduce"]["bytes"],
                  f"{label} rank {rank}: the fused loop's collectives are not the host loop's")
            graph = type(graph_h)(*graph)
            q, t = rs.caller_poses(graph)
            sh = sp.shards[rank]
            out[label] = dict(
                trace=trace, q=q.cpu().numpy(), t=t.cpu().numpy(), Xw=graph.Xw.cpu().numpy(),
                counts=counts, cold=cold, warm=warm, host=host, route=rs.plan.route,
                checks=checks,
                E=int(sh.pose_idx.shape[0]), L=int(sh.Xw.shape[0]), T=int(sh.tri_ei.shape[0]),
                peak_gib=torch.cuda.max_memory_allocated() / 2**30)
            del rs, graph, graph_w, graph_h
            torch.cuda.empty_cache()
        # the collective alone: a trial's all-reduce of the Schur blocks and
        # bsc (the largest of the three), both ranks lined up by a barrier
        sp = cells[0][1]
        buf = torch.zeros(36 * sp.nnz_blocks + 6 * sp.num_active_poses, dtype=torch.float64,
                          device=dev)
        times = []
        for _ in range(6):
            dist.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            dist.all_reduce(buf)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        out["all_reduce_alone"] = dict(mb=buf.numel() * 8 / 1e6, ms=times[1:])
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def _dist_solver(route: str):
    """What ``expected_launches`` reads of a solver: the route, f64 "mixed"."""
    from types import SimpleNamespace

    return SimpleNamespace(plan=SimpleNamespace(route=route), mixed=True)


def distributed_phase(city, kitti07, runs: dict) -> dict:
    """Phase 7, the distributed path (``parallel/distributed.py``):

    * ``city_scale_1card``: the city-scale graph (10k poses, 1M landmarks,
      4.18M edges; ``city_scale_problem(scale=1)``) on one card through
      ``main_path`` (``optimize(DIST_ITERS)``, fused and host loops), and
      its kernels but B7/B8 held against their twins at its first
      linearisation (B7/B8 are held on rank 0's replicated solve: the same
      global band);
    * ``city_scale_d2``: the same graph dealt to two gloo ranks sharing the
      card (``shard_problem(city, 2)``, the band route), spawned after the
      kernels were built (``distributed_rank``): rank 0's ten kernels held
      against their twins at its shard's first linearisation
      (``shard_kernel_checks``), each rank's
      cold run counted (launches as the host loop's rule says) and its warm
      run timed; the ranks' traces and poses bit for bit one another's, the
      trace within rtol 1e-7 of the one-card run's;
    * ``city_scale_d2_pcg``: the same with ``pose_solver="pcg"``, its trace
      within rtol 1e-6 of the JAX package's logged PCG run
      (``artifacts/CITY_SCALE.log``, a virtual 8-device CPU mesh);
    * one NCCL rank in this process (``nccl_rank_cell``: the fused loop
      captured, cold and warm, beside the host loop, bit for bit):
      ``kitti07_nccl_d1`` (``kitti07_mono``) and ``city_scale_nccl_d1``
      (``shard_problem(city, 1)``), their traces and final states bit for
      bit the one-card runs' (whose host loops ``main_path`` held bit for
      bit their fused loops), and ``city_scale_nccl_d1_pcg`` (PCG forced),
      within rtol 1e-6 of the JAX package's logged trace.

    Prints each rank's launch counts, warm wall time, the all-reduces a
    trial (calls, bytes, the host-clock ms inside ``all_reduce`` with the
    device synchronised on each side) and the allocator's peak."""
    import pickle
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    from cuda_bundle_adjustment_tpu_torch import kernels
    from cuda_bundle_adjustment_tpu_torch.parallel import (
        RankSolver,
        gather_landmarks,
        shard_problem,
    )
    from cuda_bundle_adjustment_tpu_torch.solver.block_solver import band_meta

    # the collectives' sockets on the loopback device: the ranks share a host
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    smi = nvidia_smi_line()
    one = main_path(city, "city_scale_1card", warm_runs=1, profiled=False, niter=DIST_ITERS)
    one_trace = one["trace"]
    one_state = (*one["solver"].result_poses(), one["solver"].result_landmarks())
    del one["solver"]
    torch.cuda.empty_cache()
    # the one-card run's kernels at its first linearisation (4.18M edges):
    # every kernel but B7/B8, which rank 0 holds below on the same global
    # band (Pa=9999, SB=16), the system every rank solves
    solver, sys_, lam = first_linearisation(city, "cuda")
    one["checks"] = path_kernel_checks(solver, sys_, lam, "city_scale_1card", reported=set())
    one["checks"]["gather_rows"] = gather_held(solver, "city_scale_1card", reported=set())
    one["checks"]["schur_pair_products"], _ = pair_products_held(
        solver, sys_, lam, "city_scale_1card", reported=set())
    for name in ("gather_rows", "schur_pair_products"):
        report("city_scale_1card", name, one["checks"][name])
    del solver, sys_, lam
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    sp = shard_problem(city, 2)
    shard_s = time.perf_counter() - t0
    sp_pcg = shard_problem(city, 2, pose_solver="pcg")
    band = band_meta(sp.blk_row, sp.blk_col)
    check(sp.route == "band" and band.sb == 16 and sp_pcg.route == "pcg",
          f"city_scale: routes {sp.route} (SB {band.sb}) and {sp_pcg.route}, not band and pcg")
    print(f"city_scale_d2: shard_problem {shard_s:.2f} s; P={city.pose_q.shape[0]} "
          f"Pa={sp.num_active_poses} L={sp.num_landmarks} E={city.meas.shape[0]}, {sp.nnz_blocks} "
          f"Hsc blocks, bw={band.bw} SB={band.sb}; a rank's edges {sp.edges_per_shard}, "
          f"landmarks {sp.lms_per_shard}, triples {sp.tris_per_shard}")
    cells = (("city_scale_d2", sp), ("city_scale_d2_pcg", sp_pcg))
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as out_dir:
        t0 = time.perf_counter()
        mp.spawn(distributed_rank, args=(2, "file://" + os.path.join(out_dir, "store"), cells,
                                         out_dir), nprocs=2, join=True)
        spawn_s = time.perf_counter() - t0
        ranks = []
        for r in range(2):
            with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
                ranks.append(pickle.load(f))
    print(f"distributed ranks: two spawned gloo ranks on one card ran both cells in "
          f"{spawn_s:.1f} s (spawn, CUDA start, upload, plans, rank 0's checks, four runs each)")
    for r, rk in enumerate(ranks):
        alone = rk["all_reduce_alone"]
        print(f"gloo all_reduce of {alone['mb']:.3f} MB of CUDA tensors alone (after a barrier), "
              f"rank {r}: {json.dumps([round(x, 3) for x in alone['ms']])} ms [{smi}]")
    logged = logged_trace(CITY_SCALE_LOG)
    out = {}
    for label, cell in cells:
        r0, r1 = ranks[0][label], ranks[1][label]
        check(r0["trace"] == r1["trace"], f"{label}: the ranks' traces differ")
        check(np.array_equal(r0["q"], r1["q"]) and np.array_equal(r0["t"], r1["t"]),
              f"{label}: rank 1's poses are not rank 0's bit for bit")
        trace = r0["trace"]
        check(len(trace) == DIST_ITERS and np.all(np.isfinite(trace)) and trace[-1] < trace[0],
              f"{label}: trace {trace}")
        Xw = gather_landmarks(cell, [r["Xw"] for r in (r0, r1)])
        check(Xw.shape == city.landmarks.shape and np.all(np.isfinite(Xw)),
              f"{label}: the gathered landmarks")
        for r, rk in enumerate((r0, r1)):
            st = rk["cold"]
            want = expected_launches(rk["counts"], st["iterations"], st["trials"], False, False,
                                     _dist_solver(rk["route"]))
            check(rk["counts"] == want, f"{label} rank {r}: launch counts {rk['counts']} do not "
                  f"follow from {st['iterations']} iterations and {st['trials']} trials")
            for name, n in rk["counts"].items():
                check(n > 0 or rk["route"] == "pcg" and name.startswith("band_"),
                      f"{label} rank {r}: kernel {name} was not launched")
            ar, w = rk["warm"]["all_reduce"], rk["warm"]
            print(f"{label} rank {r}: E={rk['E']} L={rk['L']} triples={rk['T']}, route "
                  f"{rk['route']}; cold run launch counts {json.dumps(rk['counts'])}; the fused "
                  f"loop, its steps eager under gloo: {w['captures']} captures, {w['reads']} host "
                  f"reads; cold {st['seconds']:.4f} s, warm {w['seconds']:.4f} s (eager "
                  f"{w['eager_ms']:.1f} ms), the host loop warm {rk['host']['seconds']:.4f} s, "
                  f"bit for bit ({w['iterations']} "
                  f"iterations, {w['trials']} trials); all-reduce a trial: "
                  f"{ar['calls'] / w['trials']:.2f} calls, {ar['bytes'] / w['trials'] / 1e6:.3f} "
                  f"MB, {ar['ms'] / w['trials']:.3f} ms inside all_reduce (the run's "
                  f"{ar['ms']:.1f} of {w['seconds'] * 1e3:.1f} ms); CG iterations "
                  f"{json.dumps(w['cg_iterations'])}; allocator peak {rk['peak_gib']:.2f} GiB "
                  f"[{smi}]")
        if label == "city_scale_d2":
            check(len(one_trace) == len(trace), f"{label}: {len(trace)} iterations, one card "
                  f"{len(one_trace)}")
            np.testing.assert_allclose(trace, one_trace, rtol=1e-7)
            diff = rel_diff(trace, one_trace)
            print(f"{label} chi2 trace {json.dumps(trace)}; the one-card run's "
                  f"{json.dumps(one_trace)}: max rel diff {diff:.3e} (tol 1e-7)")
        else:
            check(len(logged) == len(trace), f"{label}: {len(trace)} iterations, the log "
                  f"{len(logged)}")
            np.testing.assert_allclose(trace, logged, rtol=1e-6)
            diff = rel_diff(trace, logged)
            print(f"{label} chi2 trace {json.dumps(trace)}; the JAX package's logged PCG trace "
                  f"({os.path.relpath(CITY_SCALE_LOG)}) {json.dumps(logged)}: max rel diff "
                  f"{diff:.3e} (tol 1e-6); against the one-card band run "
                  f"{rel_diff(trace, one_trace):.3e}")
        out[label] = dict(counts=r0["counts"], counts_rank1=r1["counts"], trace=trace,
                          rel_diff=diff, warm_s=[r0["warm"]["seconds"], r1["warm"]["seconds"]],
                          host_s=[r0["host"]["seconds"], r1["host"]["seconds"]],
                          all_reduce=[r0["warm"]["all_reduce"], r1["warm"]["all_reduce"]],
                          trials=r0["warm"]["trials"], checks=r0["checks"])
    out["city_scale_1card"] = one

    # one NCCL rank in this process, the binding a user with a card a rank
    # runs: the captured loop beside the host loop on each cell
    sp1 = shard_problem(city, 1)
    with tempfile.TemporaryDirectory(dir=build) as store:
        dist.init_process_group("nccl", init_method="file://" + os.path.join(store, "store"),
                                rank=0, world_size=1)
        try:
            check(dist.get_backend() == "nccl", f"NCCL rank: backend {dist.get_backend()}")
            nccl = {
                "kitti07_nccl_d1": nccl_rank_cell("kitti07_nccl_d1", shard_problem(kitti07, 1),
                                                  10, smi),
                "city_scale_nccl_d1": nccl_rank_cell("city_scale_nccl_d1", sp1, DIST_ITERS, smi),
                "city_scale_nccl_d1_pcg": nccl_rank_cell(
                    "city_scale_nccl_d1_pcg", sp1._replace(route="pcg"), DIST_ITERS, smi),
            }
        finally:
            dist.destroy_process_group()
    run = runs["kitti07_mono"]
    oq, ot = run["solver"].result_poses()
    for label, (trace, state, name) in {
            "kitti07_nccl_d1": (run["trace"], (oq, ot, run["solver"].result_landmarks()),
                                "the one-card run"),
            "city_scale_nccl_d1": (one_trace, one_state, "city_scale_1card")}.items():
        cell = nccl[label]
        check(cell["trace"] == trace, f"{label}: trace {cell['trace']} is not {name}'s {trace}")
        check(all(np.array_equal(a, b) for a, b in zip(cell["state"], state)),
              f"{label}: the final state is not {name}'s bit for bit")
        print(f"{label}: trace and final state bit for bit {name}'s")
    pcg_trace = nccl["city_scale_nccl_d1_pcg"]["trace"]
    check(len(logged) == len(pcg_trace), f"city_scale_nccl_d1_pcg: {len(pcg_trace)} iterations, "
          f"the log {len(logged)}")
    np.testing.assert_allclose(pcg_trace, logged, rtol=1e-6)
    print(f"city_scale_nccl_d1_pcg chi2 trace {json.dumps(pcg_trace)}: max rel diff "
          f"{rel_diff(pcg_trace, logged):.3e} from the JAX package's logged PCG trace (tol 1e-6)")
    for label, cell in nccl.items():
        del cell["state"]
        out[label] = cell
    return out


def nccl_rank_cell(label: str, sp, niter: int, smi: str) -> dict:
    """One NCCL rank (the caller's group of one) over ``sp``: the fused
    loop, its steps captured into CUDA graphs with their all-reduces, cold
    (launches counted) then warm, and the host loop (``use_fused_loop =
    False``) warm under :class:`AllReduceTimer` on the same ``RankSolver``.
    The three runs' traces and final states are one another's bit for bit;
    the fused runs capture and replay, read one flag a trial and the trace
    once (and one a CG block), and make the host loop's all-reduces
    (``comm``, counted per replay: one a linearisation, two a trial, one
    MAX); the launch counts follow the host loop's rule (a rank's head
    computes chi every iteration).  Prints warm seconds, the loop's eager,
    capture and replay ms and the all-reduces a trial.  Returns the trace,
    the final state in the caller's order (numpy), the counts and the
    stats."""
    import torch

    from cuda_bundle_adjustment_tpu_torch import kernels
    from cuda_bundle_adjustment_tpu_torch.parallel import RankSolver

    rs = RankSolver(None, sp)
    check(rs.capturable, f"{label}: the steps of an NCCL rank on the card are not capturable")
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    trace, graph = rs.optimize(niter)
    counts = kernels.launch_counts()
    cold = dict(rs.stats)
    graph = [a.clone() for a in graph]
    trace_w, graph_w = rs.optimize(niter)
    warm = dict(rs.stats)
    rs.use_fused_loop = False
    kernels.reset_launch_counts()
    trace_h, graph_h, host = timed_run(rs, niter)
    host_counts = kernels.launch_counts()
    for what, tr, g in (("the warm run", trace_w, graph_w), ("the host loop", trace_h, graph_h)):
        check(tr == trace and all(torch.equal(a, b) for a, b in zip(graph, g)),
              f"{label}: {what}'s trace or final state is not the cold run's bit for bit")
    iters, trials = cold["iterations"], cold["trials"]
    for st in (cold, warm):
        check(st["capture"] and st["captures"] >= min(1, iters - 1)
              and st["replays"] >= iters - 1 and st["reads"] == st["trials"] + 1 + st["cg_reads"],
              f"{label}: the fused loop did not capture and replay with one read a trial: {st}")
        check(st["all_reduce"] == {k: host["all_reduce"][k] for k in ("calls", "bytes")}
              and st["all_reduce"]["calls"] == iters + 2 * trials + 1
              and st["cg_iterations"] == host["cg_iterations"],
              f"{label}: the fused loop's collectives {st['all_reduce']} are not the host "
              f"loop's {host['all_reduce']}")
    want = expected_launches(counts, iters, trials, False, False, _dist_solver(rs.plan.route))
    check(counts == want == host_counts, f"{label}: launch counts {counts} (host loop "
          f"{host_counts}) do not follow from {iters} iterations and {trials} trials")
    ar = warm["all_reduce"]
    print(f"{label}: one NCCL rank, route {rs.plan.route}, the fused loop captured ({iters} "
          f"iterations, {trials} trials; {warm['captures']} captures, {warm['replays']} replays, "
          f"{warm['reads']} host reads), bit for bit the host loop; launch counts "
          f"{json.dumps(counts)}; cold {cold['seconds']:.4f} s, warm {warm['seconds']:.4f} s "
          f"(eager {warm['eager_ms']:.2f} ms, capture {warm['capture_ms']:.2f}, replays "
          f"{warm['replay_ms']:.2f}), the host loop warm {host['seconds']:.4f} s "
          f"({host['all_reduce']['ms'] / trials:.3f} ms a trial inside all_reduce); all-reduce a "
          f"trial {ar['calls'] / trials:.2f} calls, {ar['bytes'] / trials / 1e6:.3f} MB; CG "
          f"iterations {json.dumps(warm['cg_iterations'])} [{smi}]")
    q, t = rs.caller_poses(type(graph_h)(*graph))
    return dict(trace=trace, state=(q.cpu().numpy(), t.cpu().numpy(), graph[2].cpu().numpy()),
                counts=counts, cold=cold, warm=warm, host=host, cold_s=cold["seconds"],
                warm_s=warm["seconds"], host_s=host["seconds"], all_reduce=ar, route=rs.plan.route)


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    smi = nvidia_smi_line()
    print(smi)
    print(
        f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {nvcc_version()}"
    )
    from cuda_bundle_adjustment_tpu_torch import GraphOptimisationOptions
    from cuda_bundle_adjustment_tpu_torch.io.synthetic import (
        kitti00_scale_mixed_problem,
        city_scale_problem,
        kitti00_scale_problem,
        kitti07_scale_problem,
        make_loop_closure_problem,
    )
    from cuda_bundle_adjustment_tpu_torch.kernels import _build

    from cuda_bundle_adjustment_tpu_torch.native import build as native

    print(f"host CPU: {cpu_model()}, {os.cpu_count()} cores")
    dev = torch.device("cuda", 0)
    start = time.perf_counter()

    def native_build() -> float:
        native.load()
        return time.perf_counter() - start

    with ThreadPoolExecutor(1) as pool:  # g++ beside the six nvcc processes
        native_s = pool.submit(native_build)
        _build.build_all()
        print(f"kernel build: {time.perf_counter() - start:.2f} s")
        print(f"native symbolic library build ({native.compiler_version()}): "
              f"{native_s.result():.2f} s, {native.library_path().name}")
    with ThreadPoolExecutor(6) as pool:  # six more compiles, side by side
        for lines in pool.map(ptxas_report, ("gather", "terms", "lminv", "schurvec", "pairprod",
                                             "bandchol")):
            print("\n".join(lines))

    def lap(what: str) -> None:
        print(f"[{time.perf_counter() - start:.0f} s since the start] {what} done")

    mono = kitti00_scale_problem(kind="mono", seed=0)
    mixed = kitti00_scale_mixed_problem(seed=0)
    kitti07 = kitti07_scale_problem(kind="mono", seed=0)
    kitti07_wide, rename = reverse_pose_blocks(kitti07)
    huber = dict(rk=ROBUST["huber"], delta=10.0)
    # bench.py's kitti00_huber_f32, and the dense route's two cells
    f32 = GraphOptimisationOptions(dtype="float32")
    exact = GraphOptimisationOptions(solver_precision="exact")
    loop800 = make_loop_closure_problem(num_poses=800, num_landmarks=80_000,
                                        long_range_fraction=0.05, seed=0)
    # the JAX package's loop-closure acceptance graph (tools/loop_closure_demo.py)
    loop5000 = make_loop_closure_problem(num_poses=5000, num_landmarks=60_000,
                                         long_range_fraction=0.05, seed=7)
    structure_phase(mono, "kitti00_mono")
    structure_phase(mixed, "kitti00_mixed")
    lap("symbolic analysis, native against numpy")
    res = kernel_checks(mono, dev, "kitti00_mono")
    lap("kernel checks at kitti00_mono")
    # every other input the full-size paths hand the kernels (kitti00_stereo
    # has kitti00_mixed's shapes without the mask): all ten kernels held
    # against their twins, device and host times read for the redesigned B3,
    # B6 and, at kitti00_mixed and kitti07_mono, B5 and B9, and at the wide
    # band for B7 and B8
    b3_b6 = {"linearise", "schur_pair_products"}
    b5_b9 = b3_b6 | {"hpl_mv_segment_sum", "hpl_mtv_segment_sum"}
    also = {
        "kitti00_huber": kernel_checks(mono, dev, "kitti00_huber", b3_b6, **huber),
        "kitti00_mixed": kernel_checks(mixed, dev, "kitti00_mixed", b5_b9),
        "kitti07_mono": kernel_checks(kitti07, dev, "kitti07_mono", b5_b9),
        "kitti07_mono_wide": kernel_checks(
            kitti07_wide, dev, "kitti07_mono_wide", b3_b6 | {"band_factor", "band_solve"}),
    }
    for label, r in also.items():
        print(f"{label} kernel checks:", json.dumps(r))
    wide_res = also["kitti07_mono_wide"]
    wide_sb = wide_res["SB"]
    check(wide_sb > 16, f"kitti07_mono_wide has band height {wide_sb}: not the wide-band path")
    check(also["kitti07_mono"]["SB"] <= 16, "kitti07_mono is not on the narrow-band path")
    tall = tall_band_checks(dev)
    lap("kernel checks at the other inputs")
    # f32 mode: the eight retyped kernels at kitti00_huber_f32's first
    # linearisation, every time read
    res32 = kernel_checks(mono, dev, "kitti00_huber_f32", options=f32, **huber)
    print("kitti00_huber_f32 kernel checks:", json.dumps(res32))
    lap("f32 kernel checks at kitti00_huber_f32")
    small_problem_checks(dev)
    lap("small graphs")
    population_on_card(dev)
    lap("borderline population")

    # hand the checks' memory back (the graphs of device_ms held a pool each),
    # so that no main path pays for its release in the middle of a stage
    torch.cuda.empty_cache()
    runs = {
        "kitti00_mono": main_path(mono, "kitti00_mono", warm_runs=3),
        "kitti00_huber": main_path(mono, "kitti00_huber", warm_runs=2, **huber),
        "kitti00_stereo": main_path(
            kitti00_scale_problem(kind="stereo", seed=0), "kitti00_stereo", warm_runs=1),
        "kitti00_mixed": main_path(mixed, "kitti00_mixed", warm_runs=1),
        "kitti07_mono": main_path(kitti07, "kitti07_mono", warm_runs=2),
        "kitti07_mono_wide": main_path(kitti07_wide, "kitti07_mono_wide", warm_runs=2),
    }
    lap("six full-size paths")
    object_counts = object_api_phase(mono, kitti07, runs)
    lap("object_api")
    runs["kitti00_huber_f32"] = main_path(mono, "kitti00_huber_f32", warm_runs=2, options=f32,
                                          profiled=False, **huber)
    f32_trace, f64_trace = runs["kitti00_huber_f32"]["trace"], runs["kitti00_huber"]["trace"]
    check(len(f32_trace) == len(f64_trace) == 10, "kitti00_huber_f32: not 10 iterations as f64")
    np.testing.assert_allclose(f32_trace, f64_trace, rtol=1e-3)
    print(f"kitti00_huber_f32 against kitti00_huber (f64): trace max rel diff "
          f"{max(abs(a - b) / b for a, b in zip(f32_trace, f64_trace)):.3e} (tol 1e-3)")
    lap("kitti00_huber_f32")
    runs["kitti00_mono_exact"] = main_path(mono, "kitti00_mono_exact", warm_runs=1,
                                           options=exact, profiled=False)
    runs["loop800_mixed"] = main_path(loop800, "loop800_mixed", warm_runs=1, profiled=False)
    runs["loop800_exact"] = main_path(loop800, "loop800_exact", warm_runs=1, options=exact,
                                      profiled=False)
    check(runs["loop800_mixed"]["solver"].plan.band.bw + 1 > 48,
          "loop800: the band after RCM is not over 48")
    dense = dense_cells(runs)
    exact_route_check(runs)
    lap("the dense cells")
    cpu_twin_agreement(kitti07, runs["kitti07_mono"], "kitti07_mono")
    wide_band_agreement(runs["kitti07_mono"], runs["kitti07_mono_wide"], rename)
    lap("agreement")

    # PCG, the pose-only solve and outlier thresholding
    runs["loop5000_pcg"] = pcg_phase(loop5000, "loop5000_pcg", dev)
    lap("loop5000_pcg")
    pcg_oracle_phase()
    lap("pcg1000_oracle")
    runs["kitti00_mono_outliers"] = outliers_phase(mono)
    lap("kitti00_mono_outliers")
    runs["kitti00_motion_only"] = motion_only_phase(mono, kitti07)
    lap("kitti00_motion_only")
    icp_scan_phase()
    lap("icp_scan")

    # depth edges, landmark sets that do not merge and a camera an edge
    depth = kitti00_scale_problem(kind="depth", seed=0)
    runs["kitti00_depth"] = depth_phase(depth, dev)
    lap("kitti00_depth")
    runs["kitti00_mono_depth"] = mono_depth_phase(
        depth, kitti07_scale_problem(kind="depth", seed=0), dev)
    lap("kitti00_mono_depth")
    runs["kitti00_mixed_orbslam"] = orbslam_phase(mixed, dev)
    lap("kitti00_mixed_orbslam")
    runs["kitti00_mono_percam"] = percam_phase(mono, runs["kitti00_mono"], dev)
    lap("kitti00_mono_percam")
    runs["kitti07_two_cams"] = two_cams_phase(kitti07, dev)
    lap("kitti07_two_cams")

    # the distributed path: the city-scale graph on two gloo ranks sharing the
    # card, and one NCCL rank
    dist_out = distributed_phase(city_scale_problem(kind="mono", seed=0, scale=1.0), kitti07,
                                 runs)
    runs.update(dist_out)
    runs["city_scale_d2_rank1"] = dict(counts=dist_out["city_scale_d2"]["counts_rank1"])
    lap("the distributed phase")

    def path_count(label, name):
        """One optimize() of a later path, counters zeroed just before."""
        c = runs[label]["counts"]
        return (c[0] if isinstance(c, tuple) else c)[name]

    # B1 and B3 at the new paths' inputs, each row as the table's
    terms_rows = {"depth": "kitti00_depth", "mixed_kinds": "kitti00_mono_depth",
                  "two_weights": "kitti00_mixed_orbslam", "per_edge_camera": "kitti00_mono_percam",
                  "two_cams": "kitti07_two_cams"}
    counts = runs["kitti00_mono"]["counts"]
    timed_keys = ("max_abs_err", "ms", "device_ms", "host_ms", "plain_ms", "bound_ms", "bound_by",
                  "library_ms")
    brief_keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")

    def numbers(r, keys):
        """A row's numbers; B2's landmark gather beside its pose gather, and
        the pose gather's device time from a misaligned table."""
        out = {k: r[k] for k in keys}
        if "misaligned_device_ms" in r:
            out["misaligned_device_ms"] = r["misaligned_device_ms"]
        if "landmark" in r:
            out["landmark"] = {k: r["landmark"][k] for k in keys}
        return out

    rows = []
    for name, (src, replaces) in KERNEL_INFO.items():
        r = res[name]
        row = dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=counts[name], object_api_launches=object_counts[name],
            # one optimize() of each later path, counters zeroed just before
            path_launches={label: path_count(label, name) for label in (
                "loop5000_pcg", "kitti00_motion_only", "kitti00_mono_outliers", "kitti00_depth",
                "kitti00_mono_depth", "kitti00_mixed_orbslam", "kitti00_mono_percam",
                "kitti07_two_cams", "city_scale_1card", "city_scale_d2", "city_scale_d2_rank1",
                "city_scale_d2_pcg", "kitti07_nccl_d1", "city_scale_nccl_d1",
                "city_scale_nccl_d1_pcg")},
            **numbers(r, timed_keys),
        )
        if name in res32:
            # the same kernel in f32 mode (kitti00_huber_f32)
            row["f32"] = dict(
                config="kitti00_huber_f32", launches=runs["kitti00_huber_f32"]["counts"][name],
                **numbers(res32[name], timed_keys),
            )
        if name in ("chi_edges", "linearise"):
            # the instantiations of the new paths, at their first linearisation
            for key, label in terms_rows.items():
                t = runs[label]["terms"][name]
                row[key] = dict(config=label, launches=path_count(label, name),
                                **numbers(t, timed_keys))
            t = runs["kitti00_depth"]["terms_f32"][name]
            row["depth_f32"] = dict(config="kitti00_depth_f32", **numbers(t, timed_keys))
        one_card = runs["city_scale_1card"]["checks"]
        if name in one_card:
            # the one-card city-scale run at its first linearisation
            row["city_scale_1card"] = dict(
                config="city_scale_1card", launches=path_count("city_scale_1card", name),
                **numbers(one_card[name], brief_keys))
        shard = runs["city_scale_d2"]["checks"]
        for key, check_name in ((name, "city_scale_d2_shard"),
                                (f"{name}_zero_bp", "city_scale_d2_shard_zero_bp")):
            if key in shard:
                # rank 0's shard of the distributed path, at its first linearisation
                row[check_name] = dict(
                    config="city_scale_d2 rank 0", launches=path_count("city_scale_d2", name),
                    **numbers(shard[key], brief_keys))
        if name in ("band_factor", "band_solve"):
            # the same kernel at the wide-band path's height (the v1 range)
            w = wide_res[name]
            row["wide_band"] = dict(
                config="kitti07_mono_wide", SB=wide_sb,
                launches=runs["kitti07_mono_wide"]["counts"][name],
                max_abs_err=w["max_abs_err"], ms=w["ms"], device_ms=w["device_ms"],
                plain_ms=w["plain_ms"],
                bound_ms=w["bound_ms"], bound_by=w["bound_by"],
            )
            # and at the tallest band it takes (a random system, no twin time)
            row["tall_band"] = dict(
                config="random banded SPD", SB=tall["SB"], Pa=tall["Pa"],
                max_rel_err=tall[name.removeprefix("band_") + "_rel_err"],
                ms=tall[name.removeprefix("band_") + "_ms"],
            )
        rows.append(row)
    print("dense route:", json.dumps(dense))
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
