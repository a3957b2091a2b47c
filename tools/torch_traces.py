#!/usr/bin/env python3
"""The chi2 traces and launch counts of the PyTorch + CUDA port's six f64
full-size configurations on one card, to hold two trees against each other.

    python3 tools/torch_traces.py

Run from the root of any tree of the port (it imports the package and
``chip_smoke.py`` of the working directory, so a tree unpacked with ``git
archive`` beside another can be compared in one run on one card).
Builds the kernels, runs ``optimizer_from_problem(...).optimize(10)``
through the fused loop for ``kitti00_mono``, ``kitti00_huber``,
``kitti00_stereo``, ``kitti00_mixed``, ``kitti07_mono`` and
``kitti07_mono_wide``, the launch counters zeroed before each, and prints
one JSON line: each configuration's trace (as ``float.hex``, so that equal
lines mean equal bits) and launch counts.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path.cwd()))


def main() -> int:
    import torch

    from chip_smoke import ROBUST, reverse_pose_blocks
    from cuda_bundle_adjustment_tpu_torch import kernels
    from cuda_bundle_adjustment_tpu_torch.io.arrays import optimizer_from_problem
    from cuda_bundle_adjustment_tpu_torch.io.synthetic import (
        kitti00_scale_mixed_problem,
        kitti00_scale_problem,
        kitti07_scale_problem,
    )
    from cuda_bundle_adjustment_tpu_torch.kernels import _build

    if not torch.cuda.is_available():
        print("torch_traces: no CUDA device", file=sys.stderr)
        return 1
    _build.build_all()
    mono = kitti00_scale_problem(kind="mono", seed=0)
    kitti07 = kitti07_scale_problem(kind="mono", seed=0)
    configs = {
        "kitti00_mono": (mono, {}),
        "kitti00_huber": (mono, dict(rk=ROBUST["huber"], delta=10.0)),
        "kitti00_stereo": (kitti00_scale_problem(kind="stereo", seed=0), {}),
        "kitti00_mixed": (kitti00_scale_mixed_problem(seed=0), {}),
        "kitti07_mono": (kitti07, {}),
        "kitti07_mono_wide": (reverse_pose_blocks(kitti07)[0], {}),
    }
    out = {}
    for label, (problem, robust) in configs.items():
        kernels.reset_launch_counts()
        opt = optimizer_from_problem(problem, **robust)
        opt.optimize(10)
        torch.cuda.synchronize()
        out[label] = dict(trace=[float(s.chi2).hex() for s in opt.batch_statistics().get()],
                          launches=kernels.launch_counts())
    print(json.dumps(out, sort_keys=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
