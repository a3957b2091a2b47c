#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card.  It imports
nothing of JAX.  In order, each phase failing the run (no phase's failure is
caught):

1. prints the card's name and power limit and the torch/CUDA/nvcc versions;
2. builds the eight kernels from ``cuda_bundle_adjustment_tpu_torch/csrc``
   (one ``nvcc`` per source, all started together);
3. holds each kernel against its plain PyTorch twin on the card, at the
   shapes of the ``kitti00_mono`` problem's first linearisation, and B1, B3,
   B5 and B9 again at those of ``kitti00_mixed``; times both (median of
   CUDA-event-timed calls);
4. runs a small mono, stereo and mixed problem on the card and on the CPU
   and holds both chi2 traces and the card's final state against the numpy
   ``DenseLM`` oracle;
5. runs ``kitti00_mono``, ``kitti00_stereo`` and ``kitti00_mixed``
   (``optimizer_from_problem(...).optimize(10)``), each with the launch
   counters zeroed just before its first run and read just after: every
   kernel must have been launched, the later runs' traces must repeat the
   first bit for bit and the chi2 must fall; prints cold and warm times and
   a per-stage profile.

The last two lines are a JSON line describing the kernels and the JSON
result line ``{"ok": true, "device": {...}}``.  Without a CUDA device, or
without the package beside it, the script exits non-zero and prints no
result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

SRC = "cuda_bundle_adjustment_tpu_torch/csrc"
# file:line of the pallas_call each kernel replaces
KERNEL_INFO = {
    "chi_edges": (f"{SRC}/terms.cu", "cuda_bundle_adjustment_tpu/pallas/terms.py:549"),
    "gather_rows": (f"{SRC}/gather.cu", "cuda_bundle_adjustment_tpu/pallas/onehot.py:243"),
    "linearise": (f"{SRC}/terms.cu", "cuda_bundle_adjustment_tpu/pallas/terms.py:461"),
    "hpl_mv_segment_sum": (f"{SRC}/schurvec.cu", "cuda_bundle_adjustment_tpu/pallas/schurvec.py:128"),
    "schur_pair_products": (f"{SRC}/pairprod.cu", "cuda_bundle_adjustment_tpu/pallas/pairprod.py:201"),
    "band_factor": (f"{SRC}/bandchol.cu", "cuda_bundle_adjustment_tpu/pallas/bandchol.py:412"),
    "band_solve": (f"{SRC}/bandchol.cu", "cuda_bundle_adjustment_tpu/pallas/bandchol.py:275"),
    "hpl_mtv_segment_sum": (f"{SRC}/schurvec.cu", "cuda_bundle_adjustment_tpu/pallas/schurvec.py:152"),
}
# f64 kernels against their twins: the same terms, fused multiply-adds and
# another summation order, as a fraction of the largest magnitude
F64_TOL = 1e-12
# f32 factor/solve agreement between the kernel and its twin (two f32
# implementations of the same recurrence, different rounding order), as a
# fraction of the largest magnitude
F32_TOL = 1e-3
TIMED_REPS = 5


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


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def first_linearisation(problem, dev):
    """The solver at the problem's first linearisation, its system and the
    LM's first damping (TAU x max diagonal)."""
    from cuda_bundle_adjustment_tpu_torch.io.arrays import optimizer_from_problem
    from cuda_bundle_adjustment_tpu_torch.optimizer import TAU

    solver = optimizer_from_problem(problem, device=dev).solver
    solver.build_structure()
    _, sys_ = solver.head()
    return solver, sys_, TAU * solver.max_diagonal(sys_)


def _held(name, k_out, p_out, what) -> float:
    """Max abs error of a kernel's outputs against its twin's, each within
    ``F64_TOL`` x its largest magnitude."""
    errs = []
    for k, p, w in zip(k_out, p_out, what):
        err = (k - p).abs().max().item()
        scale = p.abs().max().item()
        check(k.shape == p.shape, f"{name}: {w} shape {tuple(k.shape)} != {tuple(p.shape)}")
        check(err <= F64_TOL * scale, f"{name}: {w} err {err} > {F64_TOL} x {scale}")
        print(f"  {name} {w} {tuple(k.shape)}: max_abs_err {err:.3e} (max|value| {scale:.3e})")
        errs.append(err)
    return max(errs)


def path_kernel_checks(solver, sys_, lam, label) -> dict:
    """B1, B3, B5 and B9 against their twins at one linearisation."""
    from cuda_bundle_adjustment_tpu_torch.kernels import schurvec, terms
    from cuda_bundle_adjustment_tpu_torch.models.ba import edge_state
    from cuda_bundle_adjustment_tpu_torch.ops.components import flat_mv_3x3
    from cuda_bundle_adjustment_tpu_torch.solver import block_solver as bs

    plan, data, graph = solver.plan, solver.packed, solver.graph
    mdim = data.meas.shape[0]
    m3 = 0 if data.mask3 is None else int(data.mask3.sum().item())
    print(f"{label}: mdim={mdim}, {m3} stereo rows of {data.meas.shape[1]} (mask3)")
    res = {}
    qt, xw = edge_state(graph, data)

    def held_timed(name, kernel, plain, what):
        k_out, p_out = kernel(), plain()
        if not isinstance(k_out, tuple):
            k_out, p_out = (k_out,), (p_out,)
        res[name] = dict(
            max_abs_err=_held(name, k_out, p_out, what),
            ms=cuda_ms(kernel), plain_ms=cuda_ms(plain),
        )

    held_timed("chi_edges", lambda: terms.chi_edges(qt, xw, data),
               lambda: terms.chi_edges_plain(qt, xw, data), ["chi"])
    segs = (plan.pose_seg, plan.lm_seg)
    held_timed("linearise", lambda: terms.linearise(qt, xw, data, *segs),
               lambda: terms.linearise_plain(qt, xw, data, *segs),
               ["Hpp|bp", "Hll|bl", "Hpl"])
    blocks, bsc, invHll = bs.schur_reduce(sys_, lam, plan)
    y = flat_mv_3x3(invHll, sys_.bl)
    mv = (sys_.Hpl, y, plan.ba_lm_idx, sys_.bp, plan.pose_seg)
    held_timed("hpl_mv_segment_sum", lambda: schurvec.hpl_mv_segment_sum(*mv),
               lambda: schurvec.hpl_mv_segment_sum_plain(*mv), ["bsc"])
    xp, ok = bs.solve_reduced_band(blocks, bsc, plan)
    check(bool(ok), f"{label}: the first trial's reduced solve was rejected")
    mtv = (sys_.Hpl, xp, plan.ba_pose_idx, sys_.bl, plan.lm_seg)
    held_timed("hpl_mtv_segment_sum", lambda: schurvec.hpl_mtv_segment_sum(*mtv),
               lambda: schurvec.hpl_mtv_segment_sum_plain(*mtv), ["cl"])
    for name, r in res.items():
        print(f"{label} {name}: kernel {r['ms']:.4f} ms, twin {r['plain_ms']:.4f} ms")
    return res


def kernel_checks(problem, dev) -> dict:
    """Phase 3: each kernel against its twin at the problem's shapes."""
    import torch

    from cuda_bundle_adjustment_tpu_torch.kernels import bandchol, gather, pairprod
    from cuda_bundle_adjustment_tpu_torch.models.ba import _pose_state_table
    from cuda_bundle_adjustment_tpu_torch.ops.components import flat_sym3x3_inv
    from cuda_bundle_adjustment_tpu_torch.solver import block_solver as bs

    solver, sys_, lam = first_linearisation(problem, dev)
    plan, data, graph = solver.plan, solver.packed, solver.graph
    Pa, SB, bw = solver.Pa, plan.band.sb, plan.band.bw
    print(
        f"shapes: P={solver.P} Pa={Pa} L={solver.L} E={data.pose_idx.shape[0]} "
        f"nnz={plan.blk_row.shape[0]} T={plan.tri_ei.shape[0]} bw={bw} SB={SB}"
    )
    res = path_kernel_checks(solver, sys_, lam, "kitti00_mono")

    # B2: bit-exact against the masked gather
    table = _pose_state_table(graph)
    k_pose = gather.gather_rows(table, data.pose_idx)
    k_lm = gather.gather_rows(graph.Xw, data.lm_idx)
    err = max(
        (k_pose - gather.gather_rows_plain(table, data.pose_idx)).abs().max().item(),
        (k_lm - gather.gather_rows_plain(graph.Xw, data.lm_idx)).abs().max().item(),
    )
    check(
        torch.equal(k_pose, gather.gather_rows_plain(table, data.pose_idx))
        and torch.equal(k_lm, gather.gather_rows_plain(graph.Xw, data.lm_idx)),
        "gather_rows: not bit-exact against its twin",
    )
    res["gather_rows"] = dict(
        max_abs_err=err,
        ms=cuda_ms(lambda: gather.gather_rows(table, data.pose_idx)),
        plain_ms=cuda_ms(lambda: gather.gather_rows_plain(table, data.pose_idx)),
    )
    print(f"B2 gather_rows [{table.shape[0]},12]->[{k_pose.shape[0]},12]: bit-exact")

    # B6: within 1e-12 x max|block|
    diag9 = torch.tensor([1.0, 0, 0, 0, 1.0, 0, 0, 0, 1.0], dtype=torch.float64, device=dev)
    invHll = flat_sym3x3_inv(sys_.Hll + lam * diag9)
    args = (sys_.Hpl, invHll, plan.ba_lm_idx, plan.tri_ei, plan.tri_ej, plan.tri_offsets)
    k_pp = pairprod.schur_pair_products(*args)
    p_pp = pairprod.schur_pair_products_plain(*args)
    err = (k_pp - p_pp).abs().max().item()
    scale = p_pp.abs().max().item()
    check(err <= 1e-12 * scale, f"schur_pair_products: err {err} > 1e-12 x {scale}")
    res["schur_pair_products"] = dict(
        max_abs_err=err,
        ms=cuda_ms(lambda: pairprod.schur_pair_products(*args)),
        plain_ms=cuda_ms(lambda: pairprod.schur_pair_products_plain(*args)),
    )
    print(f"B6 schur_pair_products: max_abs_err {err:.3e} (max|block| {scale:.3e}, tol 1e-12 rel)")

    # B7/B8: f32 against the twins; the refined f64 xp against the CPU twin path
    blocks, bsc, _ = bs.schur_reduce(sys_, lam, plan)
    band, _, bv, _ = bs.scaled_band(blocks, bsc, plan)
    k_L = bandchol.band_factor(band, Pa, SB)
    p_L = bandchol.band_factor_plain(band, Pa, SB)
    err = (k_L - p_L).abs().max().item()
    scale = p_L.abs().max().item()
    check(bool(torch.isfinite(k_L).all()), "band_factor: non-finite factor")
    check(err <= F32_TOL * scale, f"band_factor: err {err} > {F32_TOL} x {scale}")
    res["band_factor"] = dict(
        max_abs_err=err,
        ms=cuda_ms(lambda: bandchol.band_factor(band, Pa, SB)),
        plain_ms=cuda_ms(lambda: bandchol.band_factor_plain(band, Pa, SB), reps=3),
    )
    print(f"B7 band_factor: max_abs_err {err:.3e} (max|L| {scale:.3e}, tol {F32_TOL} rel)")

    b32 = bv.to(torch.float32)
    k_x = bandchol.band_solve(k_L, b32, Pa, SB, bw)
    p_x = bandchol.band_solve_plain(k_L, b32, Pa, SB, bw)
    err = (k_x - p_x).abs().max().item()
    scale = p_x.abs().max().item()
    check(err <= F32_TOL * scale, f"band_solve: err {err} > {F32_TOL} x {scale}")
    res["band_solve"] = dict(
        max_abs_err=err,
        ms=cuda_ms(lambda: bandchol.band_solve(k_L, b32, Pa, SB, bw)),
        plain_ms=cuda_ms(lambda: bandchol.band_solve_plain(k_L, b32, Pa, SB, bw), reps=3),
    )
    print(f"B8 band_solve: max_abs_err {err:.3e} (max|x| {scale:.3e}, tol {F32_TOL} rel)")

    xp_k, ok_k = bs.solve_reduced_band(blocks, bsc, plan)
    cpu_plan = _to_device(plan, "cpu")
    xp_p, ok_p = bs.solve_reduced_band(blocks.cpu(), bsc.cpu(), cpu_plan)
    rel = ((xp_k.cpu() - xp_p).norm() / xp_p.norm()).item()
    check(bool(ok_k) and bool(ok_p), "refined solve rejected on the first linearisation")
    check(rel <= 1e-9, f"refined xp: kernel path vs twin path rel {rel} > 1e-9")
    print(f"refined f64 xp (B7+B8 vs CPU twins): rel diff {rel:.3e} (tol 1e-9)")
    return res


def _to_device(x, dev):
    import torch

    if isinstance(x, torch.Tensor):
        return x.to(dev)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_to_device(v, dev) for v in x))
    return x


def small_problem_checks(dev) -> None:
    """Phase 4: card vs CPU vs the numpy DenseLM oracle on a small mono,
    stereo and mixed graph."""
    import numpy as np

    from cuda_bundle_adjustment_tpu_torch.io.arrays import optimizer_from_problem
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
        traces, solvers = {}, {}
        for d in (dev, "cpu"):
            opt = optimizer_from_problem(problem, device=d)
            opt.optimize(10)
            traces[d] = [s.chi2 for s in opt.batch_statistics().get()]
            solvers[d] = opt.solver
        np.testing.assert_allclose(traces[dev], traces["cpu"], rtol=1e-9)
        ref = DenseLM(problem)
        want = ref.optimize(10)
        check(len(want) == len(traces[dev]), f"small {kind}: trace length differs from DenseLM")
        np.testing.assert_allclose(traces[dev], want, rtol=1e-6)
        s = solvers[dev]
        q, t = s.result_poses()
        Pa, La = s.Pa, s.La
        np.testing.assert_allclose(q[:Pa], ref.q[:Pa], atol=1e-7)
        np.testing.assert_allclose(t[:Pa], ref.t[:Pa], atol=1e-6)
        np.testing.assert_allclose(s.result_landmarks()[:La], ref.Xw[:La], atol=1e-6)
        print(
            f"small {kind} problem (16 poses, 120 landmarks, seed 13): {len(want)} "
            f"iterations, cuda/cpu/DenseLM agree; chi2 {traces[dev][0]:.6f} -> "
            f"{traces[dev][-1]:.6f}"
        )


def main_path(problem, dev, label: str, warm_runs: int) -> dict:
    """Phase 5: one configuration's optimize(10), counted, repeated and
    timed.  Returns the launch counts of its first run."""
    import numpy as np
    import torch

    from cuda_bundle_adjustment_tpu_torch import kernels
    from cuda_bundle_adjustment_tpu_torch.io.arrays import optimizer_from_problem

    def run():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        opt = optimizer_from_problem(problem, device=dev)
        opt.optimize(10)
        torch.cuda.synchronize()
        return opt, time.perf_counter() - t0

    kernels.reset_launch_counts()
    opt, cold_s = run()
    counts = kernels.launch_counts()
    trace = [s.chi2 for s in opt.batch_statistics().get()]
    warm, traces = [], []
    for _ in range(warm_runs):
        o, sec = run()
        warm.append(sec)
        traces.append([s.chi2 for s in o.batch_statistics().get()])

    # a separate profiled run for the per-stage breakdown (each stage ends in
    # a device synchronise, so the timed runs above stay untraced)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    po = optimizer_from_problem(problem, device=dev)
    torch.cuda.synchronize()
    pack_ms = (time.perf_counter() - t0) * 1e3
    po.set_profile(True)
    po.optimize(10)
    traces.append([s.chi2 for s in po.batch_statistics().get()])

    print(f"{label} chi2 trace:", json.dumps(trace))
    print(
        f"{label} stage profile of one profiled run (ms; packing {pack_ms:.1f}):",
        json.dumps(po.time_profile()),
    )
    check(all(tr == trace for tr in traces), f"{label}: traces differ between runs")
    check(np.all(np.isfinite(trace)), f"{label}: non-finite chi2")
    check(trace[-1] < trace[0], f"{label}: chi2 did not fall")
    g = opt.solver.graph
    check(
        g.q.shape == (problem.pose_q.shape[0], 4)
        and g.Xw.shape == problem.landmarks.shape
        and bool(torch.isfinite(g.q).all() and torch.isfinite(g.t).all() and torch.isfinite(g.Xw).all()),
        f"{label}: final state has the wrong shape or non-finite values",
    )
    for name, n in counts.items():
        check(n > 0, f"{label}: kernel {name} was not launched")
    print(f"{label} launch counts (one optimize(10) run): {json.dumps(counts)}")
    print(
        f"{label} optimizer_from_problem+optimize(10): cold {cold_s:.4f} s, "
        f"warm median {statistics.median(warm):.4f} s over {len(warm)} runs "
        f"{json.dumps([round(w, 4) for w in warm])} [{nvidia_smi_line()}]"
    )
    return counts


def main() -> int:
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
    from cuda_bundle_adjustment_tpu_torch.io.synthetic import (
        kitti00_scale_mixed_problem,
        kitti00_scale_problem,
    )
    from cuda_bundle_adjustment_tpu_torch.kernels import _build

    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    _build.build_all()
    print(f"kernel build: {time.perf_counter() - t0:.2f} s")

    mono = kitti00_scale_problem(kind="mono", seed=0)
    mixed = kitti00_scale_mixed_problem(seed=0)
    res = kernel_checks(mono, dev)
    mixed_res = path_kernel_checks(*first_linearisation(mixed, dev), "kitti00_mixed")
    print("kitti00_mixed kernel checks:", json.dumps(mixed_res))
    small_problem_checks(dev)
    counts = main_path(mono, dev, "kitti00_mono", warm_runs=3)
    main_path(kitti00_scale_problem(kind="stereo", seed=0), dev, "kitti00_stereo", warm_runs=2)
    main_path(mixed, dev, "kitti00_mixed", warm_runs=2)

    rows = []
    for name, (src, replaces) in KERNEL_INFO.items():
        r = res[name]
        rows.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=counts[name], max_abs_err=r["max_abs_err"],
            ms=r["ms"], plain_ms=r["plain_ms"],
        ))
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
