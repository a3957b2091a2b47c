"""The mono, stereo and depth bundle-adjustment models (counterpart of
``models/ba.py``).

Two batched stage functions per model, in the JAX package's component form
(every intermediate an ``[E]`` vector) and with its g2o Jacobian convention
``J = -d(proj)/d(state)``, so ``b = sum w J^T e`` is the negative gradient:

* ``Model.chi(graph, data, rk, delta)``   -> per-edge robustified chi2 ``[E]``
* ``Model.terms(graph, data, rk, delta)`` -> ``(pose_stack [E,42],
  lm_stack [E,12], hpl [E,18])``

The per-edge pose and landmark state comes in through kernel B2
(:func:`edge_state`); ``state=`` hands in a state gathered already, as the
JAX package's ``pose_state=`` does.  These functions are the plain twins of
kernels B1 and B3 (``kernels/terms.py``), one model for each of the
kernels' instantiations.  A pack of mono and stereo rows (``data.mask3``)
runs the stereo model with the third residual component and Jacobian row
masked per edge.  The depth model is the reference's: the residual ``meas -
proj`` (the sign flipped) with the stereo Jacobian, ``bf`` row included
(JAX ``models/ba.py``); it is kept so.  A pack of depth rows beside mono or
stereo rows (``MixedModel``) reads each edge's kind from ``data.code``: the
depth residual on depth rows, the stereo model elsewhere, the third row
masked on mono rows.  The kernels take the robust kernel from outside: the
solver applies rho to B1's per-edge chi and hands B3 the weight rescaled by
rho', which equals ``Model.chi`` / ``Model.terms`` at that ``rk, delta``
with the original weight.

The user-facing edge and edge-set classes of the object API follow the
models.  ``MODEL_REGISTRY`` also holds the pose-only ICP models of
``models/icp.py``.
"""

from __future__ import annotations

import torch

from ..graph import BaseEdge, EdgeSet
from ..kernels.gather import gather_rows
from ..ops import components as C
from ..ops.robust import robust_derivative, robustify
from ..types import KIND_CODES, GraphArrays, PackedEdges
from .icp import LineModel, PlaneModel


def _pose_state_table(graph: GraphArrays) -> torch.Tensor:
    """[P, 12] per-pose state: translation + rotation matrix (row-major),
    computed once per pose rather than per edge."""
    q = graph.q
    R = C.rotmat_comps(q[:, 0], q[:, 1], q[:, 2], q[:, 3])
    return torch.stack([graph.t[:, 0], graph.t[:, 1], graph.t[:, 2], *R], dim=1)


def edge_state(graph: GraphArrays, data: PackedEdges):
    """Per-edge pose state ``[E, 12]`` (t | R) and landmark ``[E, 3]``,
    gathered by kernel B2."""
    return (
        gather_rows(_pose_state_table(graph), data.pose_idx),
        gather_rows(graph.Xw, data.lm_idx),
    )


def _edge_inputs(graph, data: PackedEdges, state=None):
    """Per-edge component vectors (all [E]) from the gathered state."""
    if state is None:
        state = edge_state(graph, data)
    qt, Xw3 = state[0].T, state[1].T  # [12, E], [3, E]
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


def mask3(data: PackedEdges):
    """The third-row mask of a pack: ``mask3`` of a mono+stereo pack, 0.0 on
    the mono rows of a "mixed" pack (``code``), else None."""
    if data.code is None:
        return data.mask3
    return (data.code != KIND_CODES["mono"]).to(data.meas.dtype)


def _residual(kind: str, Xc, cam, data: PackedEdges, inv_z):
    """Residual components, the third masked per edge where the pack says
    so (a mono row of a pack with stereo or depth rows drops it)."""
    meas = data.meas
    if kind == "mono":
        return C.mono_residual_comps(Xc, cam, meas[0], meas[1], inv_z)
    if kind == "stereo":
        e = C.stereo_residual_comps(Xc, cam, meas[0], meas[1], meas[2], inv_z)
    elif kind == "depth":
        e = C.depth_residual_comps(Xc, cam, meas[0], meas[1], meas[2], inv_z)
    elif kind == "mixed":
        depth = data.code == KIND_CODES["depth"]
        e = tuple(torch.where(depth, d, s) for s, d in zip(
            C.stereo_residual_comps(Xc, cam, meas[0], meas[1], meas[2], inv_z),
            C.depth_residual_comps(Xc, cam, meas[0], meas[1], meas[2], inv_z)))
    else:
        raise ValueError(kind)
    m3 = mask3(data)
    if m3 is not None:
        # mono rows (mask 0) drop the third residual component
        e = e[:2] + (e[2] * m3,)
    return e


def _chi_projective(kind, graph, data, rk, delta, state=None):
    # inactive rows produce finite garbage (inv_z is zeroed at the source)
    # and the trailing ``* active`` zeroes their chi exactly
    _, Xc, cam, inv_z = _edge_inputs(graph, data, state)
    e = _residual(kind, Xc, cam, data, inv_z)
    x = data.omega * C._sum(c * c for c in e)
    return robustify(rk, delta, x) * data.active


def _terms_projective(kind, jac_fn, graph, data, rk, delta, state=None):
    R, Xc, cam, inv_z = _edge_inputs(graph, data, state)
    e = _residual(kind, Xc, cam, data, inv_z)
    x = data.omega * C._sum(c * c for c in e)
    # ``* active`` in w zeroes every stack contribution of inactive rows
    w = data.omega * robust_derivative(rk, delta, x) * data.active
    JP, JL = jac_fn(Xc, R, cam, inv_z)
    m3 = mask3(data)
    if m3 is not None:
        # zero the third Jacobian row too: J^T J and J^T e then reduce to
        # the mono quadratic form for mono rows
        JP = (JP[0], JP[1], tuple(m3 * c for c in JP[2]))
        JL = (JL[0], JL[1], tuple(m3 * c for c in JL[2]))
    pose_stack, lm_stack, hpl = C.weighted_block_stacks(JP, JL, e, w)
    return pose_stack, lm_stack, hpl * (w * data.both_free)[:, None]


class MonoModel:
    MDIM = 2
    HAS_LANDMARK = True

    @staticmethod
    def chi(graph, data, rk, delta, state=None):
        return _chi_projective("mono", graph, data, rk, delta, state)

    @staticmethod
    def terms(graph, data, rk, delta, state=None):
        return _terms_projective(
            "mono", C.mono_jacobian_comps, graph, data, rk, delta, state
        )


class StereoModel:
    MDIM = 3
    HAS_LANDMARK = True

    @staticmethod
    def chi(graph, data, rk, delta, state=None):
        return _chi_projective("stereo", graph, data, rk, delta, state)

    @staticmethod
    def terms(graph, data, rk, delta, state=None):
        return _terms_projective(
            "stereo", C.stereo_jacobian_comps, graph, data, rk, delta, state
        )


class DepthModel:
    """Inverse-depth edge ``[u, v, 1/z]``: the reference's residual ``meas -
    proj`` with the stereo Jacobian (the twin of B1/B3's depth
    instantiation)."""

    MDIM = 3
    HAS_LANDMARK = True

    @staticmethod
    def chi(graph, data, rk, delta, state=None):
        return _chi_projective("depth", graph, data, rk, delta, state)

    @staticmethod
    def terms(graph, data, rk, delta, state=None):
        return _terms_projective(
            "depth", C.stereo_jacobian_comps, graph, data, rk, delta, state
        )


class MixedModel:
    """A landmark pack of depth rows beside mono or stereo rows, each edge's
    kind read from ``data.code`` (the twin of B1/B3's mixed instantiation):
    :class:`DepthModel` on depth rows, :class:`StereoModel` on the others,
    the third row masked on mono rows."""

    MDIM = 3
    HAS_LANDMARK = True

    @staticmethod
    def chi(graph, data, rk, delta, state=None):
        return _chi_projective("mixed", graph, data, rk, delta, state)

    @staticmethod
    def terms(graph, data, rk, delta, state=None):
        return _terms_projective(
            "mixed", C.stereo_jacobian_comps, graph, data, rk, delta, state
        )


MODEL_REGISTRY = {"mono": MonoModel, "stereo": StereoModel, "depth": DepthModel,
                  "mixed": MixedModel, "line": LineModel, "plane": PlaneModel}


# ---------------------------------------------------------------------------
# user-facing edge / edge-set classes
# ---------------------------------------------------------------------------


class MonoEdge(BaseEdge):
    """Monocular projection edge (pose, landmark) with a 2D pixel measurement."""

    NVERTS = 2


class StereoEdge(BaseEdge):
    """Stereo projection edge with a ``[u_l, v, u_r]`` measurement."""

    NVERTS = 2


class DepthEdge(BaseEdge):
    """Depth edge with a ``[u, v, 1/z]`` measurement."""

    NVERTS = 2


class MonoEdgeSet(EdgeSet):
    KIND = "mono"
    MDIM = 2
    NVERTS = 2


class StereoEdgeSet(EdgeSet):
    KIND = "stereo"
    MDIM = 3
    NVERTS = 2


class DepthEdgeSet(EdgeSet):
    KIND = "depth"
    MDIM = 3
    NVERTS = 2
