#!/usr/bin/env python3
"""Host time of the wrappers of kernels B3 ``linearise``, B4
``damped_inverse``, B5 ``hpl_mv_segment_sum``, B6 ``schur_pair_products``
and B9 ``hpl_mtv_segment_sum`` of the PyTorch + CUDA port, apart from the
device.

    python3 tools/torch_wrapper_host.py [rounds]

Run from the root of any tree of the port (it reads the package and
``chip_smoke.py`` beside the working directory, so two trees unpacked side
by side can be compared in one session on one card).  At the first
linearisation of ``kitti00_mono`` and ``kitti07_mono`` it times each
wrapper's Python body with the host clock, 100 calls back to back without a
synchronise (median, ``host_ms``), and the call between two CUDA events
(``ms``), ``rounds`` times (default 3), and prints one JSON line a round.
Where the device finishes a call before the host has issued the next
(kitti07 shapes), ``ms`` is the wrapper's host time too.  Then, for B4 on
the solver's ``Hll``/``bl`` views at each shape, one more line: every
device kernel that one wrapper call launches, in launch order, with its
mean device time from a ``torch.profiler`` trace of ten calls, and the
call's device time under CUDA-graph replay (``chip_smoke.device_ms``).
"""

from __future__ import annotations

import inspect
import json
import statistics
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path.cwd()))


def host_ms(fn, reps: int = 100) -> float:
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


def kernels_in_launch_order(fn, reps: int = 10) -> list:
    """``[name, mean device ms]`` of each device kernel one call of ``fn``
    launches, in launch order (two launches of one kernel stay apart)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    for _ in range(3):  # a trace that comes back empty is taken again
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        evs = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                     key=lambda e: e.time_range.start)
        if evs:
            break
    if not evs or len(evs) % reps:
        raise RuntimeError(f"{len(evs)} device kernels in {reps} calls")
    k = len(evs) // reps
    return [[evs[i].name.split("(anonymous namespace)::", 1)[-1].split("(")[0][:90],
             round(sum(evs[r * k + i].device_time_total for r in range(reps)) / reps / 1e3, 5)]
            for i in range(k)]


def main() -> int:
    import torch

    import chip_smoke as cs
    from cuda_bundle_adjustment_tpu_torch.io.synthetic import (
        kitti00_scale_problem,
        kitti07_scale_problem,
    )
    from cuda_bundle_adjustment_tpu_torch.kernels import _build, lminv, pairprod, schurvec, terms
    from cuda_bundle_adjustment_tpu_torch.models.ba import edge_state
    from cuda_bundle_adjustment_tpu_torch.solver import block_solver as bs

    if not torch.cuda.is_available():
        print("torch_wrapper_host: no CUDA device", file=sys.stderr)
        return 1
    rounds = int(sys.argv[1]) if len(sys.argv) > 1 else 3
    dev = torch.device("cuda", 0)
    _build.build_all()
    calls = {}
    for label, problem in (("kitti00_mono", kitti00_scale_problem(kind="mono", seed=0)),
                           ("kitti07_mono", kitti07_scale_problem(kind="mono", seed=0))):
        solver, sys_, lam = cs.first_linearisation(problem, dev)
        plan, data = solver.plan, solver.packed
        qt, xw = edge_state(solver.graph, data)
        inv, y = lminv.damped_inverse(sys_.Hll, sys_.bl, lam)
        blocks, bsc, _ = bs.schur_reduce(sys_, lam, plan)
        xp, _ = bs.solve_reduced_band(blocks, bsc, plan)
        # a tree whose kernels walk a plan made once a structure hands it over
        lin = (plan.lin_plan,) if hasattr(plan, "lin_plan") else ()
        pair = (plan.pair_plan,) if hasattr(plan, "pair_plan") else ()
        vec = lin if "plan" in inspect.signature(schurvec.hpl_mv_segment_sum).parameters else ()
        calls[label] = dict(
            linearise=lambda a=(qt, xw, data, plan.pose_seg, plan.lm_seg, *lin): terms.linearise(*a),
            damped_inverse=lambda a=(sys_.Hll, sys_.bl, lam): lminv.damped_inverse(*a),
            hpl_mv_segment_sum=lambda a=(sys_.Hpl, y, plan.ba_lm_idx, sys_.bp, plan.pose_seg, *vec):
                schurvec.hpl_mv_segment_sum(*a),
            schur_pair_products=lambda a=(sys_.Hpl, inv, plan.ba_lm_idx, plan.tri_ei, plan.tri_ej,
                                          plan.tri_offsets, *pair): pairprod.schur_pair_products(*a),
            hpl_mtv_segment_sum=lambda a=(sys_.Hpl, xp, plan.ba_pose_idx, sys_.bl, plan.lm_seg,
                                          *vec): schurvec.hpl_mtv_segment_sum(*a),
        )
    for r in range(rounds):
        out = {label: {name: dict(host_ms=round(host_ms(fn), 4), ms=round(cs.cuda_ms(fn), 4))
                       for name, fn in fns.items()} for label, fns in calls.items()}
        print(json.dumps(dict(tree=str(Path.cwd().name), round=r, card=cs.nvidia_smi_line(), **out)))
    for label, fns in calls.items():
        fn = fns["damped_inverse"]
        print(json.dumps(dict(tree=str(Path.cwd().name), shape=label, wrapper="damped_inverse",
                              device_ms=round(cs.device_ms(fn), 5),
                              kernels=kernels_in_launch_order(fn))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
