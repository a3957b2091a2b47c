"""Build optimisers directly from raw problem arrays (counterpart of
``io/arrays.py``)."""

from __future__ import annotations

from typing import Optional, Union

import torch

from ..graph import GraphOptimisationOptions
from ..optimizer import TorchGraphOptimisation
from .synthetic import BAProblem, MixedBAProblem


def optimizer_from_problem(
    problem: Union[BAProblem, MixedBAProblem],
    options: Optional[GraphOptimisationOptions] = None,
    rk: int = 0,
    delta: float = 1.0,
    outlier_threshold: float = 0.0,
    device: Union[str, torch.device] = "cuda",
) -> TorchGraphOptimisation:
    """Create an optimiser on ``device`` packed from a :class:`BAProblem`
    (one edge set) or a :class:`MixedBAProblem` (several edge sets over
    shared vertices; a mono and a stereo set merge into one masked stereo
    set).  The device is the CUDA card unless the caller asks for
    ``device="cpu"``; without a card the default raises ``RuntimeError``.
    ``rk`` (a ``RobustKernelType`` value), ``delta`` and
    ``outlier_threshold`` apply to every edge set that does not name its
    own (a :class:`MixedBAProblem` spec may carry ``rk``, ``delta`` and
    ``outlier_threshold``, as ORB-SLAM2's mono and stereo sets differ).

    Call ``optimize(n)`` directly on the result; estimates stay in
    ``opt.solver.graph`` (``q``/``t``/``Xw`` tensors on ``device``), and
    ``opt.solver.result_poses()`` / ``result_landmarks()`` return them in
    the problem's order.
    """
    opt = TorchGraphOptimisation(options, device)
    if isinstance(problem, MixedBAProblem):
        specs = [
            dict(dict(rk=rk, delta=delta, outlier_threshold=outlier_threshold), **s)
            for s in problem.specs
        ]
    else:
        specs = [
            dict(
                kind=problem.kind,
                meas=problem.meas,
                pose_idx=problem.pose_idx,
                lm_idx=problem.lm_idx,
                omega=problem.omega,
                cam=problem.cam,
                rk=rk,
                delta=delta,
                outlier_threshold=outlier_threshold,
            )
        ]
    opt.solver.initialize_from_arrays(
        pose_q=problem.pose_q,
        pose_t=problem.pose_t,
        num_active_poses=problem.num_active_poses,
        landmarks=problem.landmarks,
        num_active_landmarks=problem.num_active_landmarks,
        edge_specs=specs,
    )
    return opt
