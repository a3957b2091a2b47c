"""The mono bundle-adjustment model (counterpart of ``models/ba.py``).

Two batched stage functions, in the JAX package's component form (every
intermediate an ``[E]`` vector) and with its g2o Jacobian convention
``J = -d(proj)/d(state)``, so ``b = sum w J^T e`` is the negative gradient:

* ``MonoModel.chi(graph, data, rk, delta)``   -> per-edge robustified chi2
  ``[E]``
* ``MonoModel.terms(graph, data, rk, delta)`` -> ``(pose_stack [E,42],
  lm_stack [E,12], hpl [E,18])``

The per-edge pose and landmark state comes in through kernel B2
(``kernels.gather_rows``).  Stereo and depth wait for ROADMAP A8/A9; the
solver admits only ``rk = 0`` until A8.
"""

from __future__ import annotations

import torch

from ..kernels import gather_rows
from ..ops import components as C
from ..ops.robust import robust_derivative, robustify
from ..types import GraphArrays, PackedEdges


def _pose_state_table(graph: GraphArrays) -> torch.Tensor:
    """[P, 12] per-pose state: translation + rotation matrix (row-major),
    computed once per pose rather than per edge."""
    q = graph.q
    R = C.rotmat_comps(q[:, 0], q[:, 1], q[:, 2], q[:, 3])
    return torch.stack([graph.t[:, 0], graph.t[:, 1], graph.t[:, 2], *R], dim=1)


def _edge_inputs(graph: GraphArrays, data: PackedEdges):
    """Per-edge component vectors (all [E]) gathered from the state tables."""
    qt = gather_rows(_pose_state_table(graph), data.pose_idx).T  # [12, E]
    Xw3 = gather_rows(graph.Xw, data.lm_idx).T  # [3, E]
    t = (qt[0], qt[1], qt[2])
    R = tuple(qt[3 + i] for i in range(9))
    cam = tuple(data.cam[i] for i in range(5))
    Xc = C.project_w2c_comps(R, t[0], t[1], t[2], Xw3[0], Xw3[1], Xw3[2])
    # mask 1/z at the source: inert rows with degenerate geometry must not
    # inject inf/NaN downstream.  A magnitude test, not ``!= 0``, keeps inv_z
    # an exact 0 for every degenerate row (NaN z also fails the comparison)
    safe_z = torch.abs(Xc[2]) > 1e-30
    inv_z = data.active * torch.where(
        safe_z, 1.0 / torch.where(safe_z, Xc[2], 1.0), 0.0
    )
    return R, Xc, cam, inv_z


def _chi_projective(graph: GraphArrays, data: PackedEdges, rk: int, delta: float):
    # inactive rows produce finite garbage (inv_z is zeroed at the source)
    # and the trailing ``* active`` zeroes their chi exactly
    _, Xc, cam, inv_z = _edge_inputs(graph, data)
    e = C.mono_residual_comps(Xc, cam, data.meas[0], data.meas[1], inv_z)
    x = data.omega * (e[0] * e[0] + e[1] * e[1])
    return robustify(rk, delta, x) * data.active


def _terms_projective(graph: GraphArrays, data: PackedEdges, rk: int, delta: float):
    R, Xc, cam, inv_z = _edge_inputs(graph, data)
    e = C.mono_residual_comps(Xc, cam, data.meas[0], data.meas[1], inv_z)
    x = data.omega * (e[0] * e[0] + e[1] * e[1])
    # ``* active`` in w zeroes every stack contribution of inactive rows
    w = data.omega * robust_derivative(rk, delta, x) * data.active
    JP, JL = C.mono_jacobian_comps(Xc, R, cam, inv_z)
    pose_stack, lm_stack, hpl = C.weighted_block_stacks(JP, JL, e, w)
    return pose_stack, lm_stack, hpl * (w * data.both_free)[:, None]


class MonoModel:
    MDIM = 2
    HAS_LANDMARK = True

    @staticmethod
    def chi(graph: GraphArrays, data: PackedEdges, rk: int, delta: float):
        return _chi_projective(graph, data, rk, delta)

    @staticmethod
    def terms(graph: GraphArrays, data: PackedEdges, rk: int, delta: float):
        return _terms_projective(graph, data, rk, delta)
