"""Measurement models (edge types): the user-facing edge and edge-set
classes, and the stage functions of the models the solver runs."""

from .ba import (
    MODEL_REGISTRY,
    DepthEdge,
    DepthEdgeSet,
    DepthModel,
    MixedModel,
    MonoEdge,
    MonoEdgeSet,
    MonoModel,
    StereoEdge,
    StereoEdgeSet,
    StereoModel,
)
from .icp import LineEdge, LineEdgeSet, LineModel, PlaneEdge, PlaneEdgeSet, PlaneModel
from .measurements import PointToLineMatch, PointToPlaneMatch

__all__ = [
    "MODEL_REGISTRY",
    "MonoEdge",
    "MonoEdgeSet",
    "MonoModel",
    "StereoEdge",
    "StereoEdgeSet",
    "StereoModel",
    "DepthEdge",
    "DepthEdgeSet",
    "DepthModel",
    "MixedModel",
    "LineEdge",
    "LineEdgeSet",
    "LineModel",
    "PlaneEdge",
    "PlaneEdgeSet",
    "PlaneModel",
    "PointToLineMatch",
    "PointToPlaneMatch",
]
