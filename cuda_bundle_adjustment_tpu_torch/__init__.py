"""PyTorch + CUDA port of the bundle-adjustment engine (NVIDIA Hopper).

The JAX package ``cuda_bundle_adjustment_tpu`` is the reference; this
package mirrors its module and function names so each counterpart is easy to
find, but imports ``torch`` and never ``jax``.

The port runs the ``bench.py`` configurations end to end: one mono or
stereo edge set, or a mono and a stereo set merged into one masked stereo
set, with one global camera, a robust kernel or none, f64 or f32 state
(``GraphOptimisationOptions(dtype=...)``), ``solver_precision="mixed"`` or
``"exact"``, through the device-resident LM loop.  The reduced system is
solved on a band (Hsc band up to 48 blocks) or densely (``"exact"`` at f64,
and wider bands below 1024 poses).  Ten kernels on that path are
hand-written CUDA C++ for ``sm_90a`` (``csrc/``, listed in ``kernels``);
every other stage is plain PyTorch.
Everything outside the slice raises ``NotImplementedError`` naming its open
ROADMAP item.

Quick start::

    from cuda_bundle_adjustment_tpu_torch.io.arrays import optimizer_from_problem
    from cuda_bundle_adjustment_tpu_torch.io.synthetic import kitti00_scale_problem

    opt = optimizer_from_problem(kitti00_scale_problem(), device="cuda")
    opt.optimize(10)
    trace = [s.chi2 for s in opt.batch_statistics().get()]
"""

import torch

# f32 products must stay IEEE f32 (the mixed solve's refinement assumes it)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from .graph import Camera, GraphOptimisationOptions  # noqa: E402
from .ops.robust import RobustKernelType  # noqa: E402
from .optimizer import TorchGraphOptimisation  # noqa: E402

__version__ = "0.1.0"

__all__ = [
    "Camera",
    "GraphOptimisationOptions",
    "RobustKernelType",
    "TorchGraphOptimisation",
]
