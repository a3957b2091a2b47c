"""Array containers passed between solver stages (counterpart of ``types.py``).

Same fields and row-major block contract as the JAX package's XLA path;
the TPU-only fields (one-hot expand plans, group-layout metadata, the
component-major landmark copy) have no counterpart here.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class PackedEdges(NamedTuple):
    """Struct-of-arrays packed edge set, resident on the solver's device.

    ``active`` is a float mask (1.0 active, 0.0 masked).  CONTRACT: ``meas``
    of rows with ``active == 0`` is undefined; every consumer multiplies by
    ``active``.
    """

    meas: torch.Tensor  # [K, E] measurement payload, component-first
    omega: torch.Tensor  # [E] or [1] scalar information
    # [5, 1] fx fy cx cy bf: one camera for every edge; or [5, E], a camera
    # an edge
    cam: torch.Tensor
    pose_idx: torch.Tensor  # [E] int64 dense pose index
    lm_idx: torch.Tensor  # [E] int64 dense landmark index
    both_free: torch.Tensor  # [E] float mask: pose AND landmark free
    active: torch.Tensor  # [E] float mask: 1.0 active, 0.0 masked
    # the model the set runs (``models.MODEL_REGISTRY``): "mono", "stereo",
    # "depth", "line", "plane", or "mixed" for a landmark pack whose kind is
    # read per edge from ``code``
    kind: str
    # [E] float mask of a pack of mono and stereo rows: 1.0 stereo row, 0.0
    # mono row.  The set runs the stereo model with the third residual
    # component and Jacobian row masked per edge, which reduces exactly to
    # the mono model on mono rows (the mono Jacobian is, in exact
    # arithmetic, the stereo one's rows 0-1)
    mask3: Optional[torch.Tensor] = None
    # [E] uint8 per-edge kind of a "mixed" pack (one with depth rows beside
    # mono or stereo rows): ``KIND_CODES``.  Its mono/stereo case is mask3:
    # a mono row runs the stereo model with its third row masked
    code: Optional[torch.Tensor] = None


# the per-edge kind codes of a "mixed" pack (``PackedEdges.code``)
KIND_CODES = {"mono": 0, "stereo": 1, "depth": 2}


class GraphArrays(NamedTuple):
    """Packed vertex state, active vertices first."""

    q: torch.Tensor  # [P, 4] pose quaternions (xyzw)
    t: torch.Tensor  # [P, 3] pose translations
    Xw: torch.Tensor  # [L, 3] landmarks


class SystemBlocks(NamedTuple):
    """The assembled block system for one LM iteration (undamped), with the
    large per-landmark / per-edge blocks stored flat row-major."""

    Hpp: torch.Tensor  # [Pa, 6, 6]
    bp: torch.Tensor  # [Pa, 6]
    Hll: torch.Tensor  # [La, 9] flat symmetric blocks
    bl: torch.Tensor  # [La, 3]
    Hpl: torch.Tensor  # [E, 18] flat 6x3 per-edge blocks
