"""Kernels B1 (per-edge chi) and B3 (linearisation) (``csrc/terms.cu``) and
their plain twins.

Counterparts of ``pallas/terms.py`` ``chi_class_call`` and
``terms_class_call``.  Both take the per-edge state that kernel B2 gathers
(``models/ba.py edge_state``: pose ``[E, 12]``, landmark ``[E, 3]``) and the
edge payload of :class:`PackedEdges`: ``meas [mdim, E]``, the model
``kind`` (one instantiation each: ``"mono"`` with mdim 2; ``"stereo"``,
with ``mask3`` masking the third row of a pack of mono and stereo rows;
``"depth"``; ``"mixed"``, each edge's kind read from ``code``), ``omega
[1] or [E]``, ``active``, ``both_free`` and the camera ``[5, 1]`` or ``[5,
E]`` (one an edge, read with a stride).  Neither kernel knows a robust kernel: B1 returns
``x = omega * active * |e|^2`` per edge, to which the solver applies rho for
chi and rho' for the ``[E]`` weight it hands B3 in ``omega``
(``solver/block_solver.py build_system``).  The wrappers dispatch on
the tensor's device only: a CPU tensor runs the plain PyTorch twin (the
models of ``models/ba.py``), a CUDA tensor launches the kernel (or raises).
Both take f64 or f32 (f32 mode) edge data and state and return that type;
in f32 they compute in f64 and round each output once
(``kernels/_types.py``).

B3 runs one pass over tiles of ``TILE`` consecutive edges and sums the
per-vertex blocks through a :class:`LinearisePlan`, which cuts every vertex's
run of edges (in segment order) into chunks that lie in one tile
(:func:`make_linearise_plan`, once a structure; ``csrc/terms.cu`` has the
design).  Kernels B5 and B9 (``kernels/schurvec.py``) walk the same plan.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..solver.segments import Segments, segment_sum
from ..types import PackedEdges
from . import _build
from ._types import check_floats, f32_flag, narrow, wide, wide_edges

# the kernels' models (csrc/terms.cu Kind)
_KINDS = {"mono": 0, "stereo": 1, "depth": 2, "mixed": 3}


def _model(data: PackedEdges):
    """The twin of the kernels' instantiation for ``data.kind``."""
    from ..models.ba import MODEL_REGISTRY

    if data.kind not in _KINDS:
        raise ValueError(f"B1/B3 run the models {sorted(_KINDS)}, not {data.kind!r}")
    return MODEL_REGISTRY[data.kind]


def chi_edges_plain(qt: torch.Tensor, xw: torch.Tensor, data: PackedEdges) -> torch.Tensor:
    """Plain PyTorch twin of B1: the model's per-edge chi without a robust
    kernel (``rk = 0``), in f64, rounded to the state's type."""
    chi = _model(data).chi(None, wide_edges(data), 0, 1.0, state=(wide(qt), wide(xw)))
    return narrow(qt.dtype, chi)


def linearise_plain(qt, xw, data: PackedEdges, pose_seg: Segments, lm_seg: Segments):
    """Plain PyTorch twin of B3: the model's per-edge stacks with the
    weight as given (``rk = 0``; a robust set's ``omega`` comes in rescaled),
    then fixed-order segment sums per pose and per landmark, in f64, each
    output rounded to the state's type."""
    pose_stack, lm_stack, hpl = _model(data).terms(
        None, wide_edges(data), 0, 1.0, state=(wide(qt), wide(xw)))
    return narrow(qt.dtype, segment_sum(pose_stack, pose_seg),
                  segment_sum(lm_stack, lm_seg), hpl)


# edges a block of B3's tile kernel (kTile in csrc/terms.cu)
TILE = 128


class ChunkPlan(NamedTuple):
    """One vertex kind's share of B3's plan.  A chunk is a maximal stretch
    of a vertex's run in the segment plan's order whose edges lie in one
    tile.  Chunks are numbered by vertex (``vertex_off``) and listed by tile
    (``chunks``, ``tile_off``), and ``rows`` lists their edges in that order,
    each as its row of the tile."""

    rows: torch.Tensor  # [n] uint8: edge id - TILE x tile, by tile, chunk after chunk
    chunks: torch.Tensor  # [chunks, 4] int32 by tile: first, last + 1 (in rows), target, vertex
    tile_off: torch.Tensor  # [tiles + 1] int32: a tile's stretch of ``chunks``
    vertex_off: torch.Tensor  # [vertices + 1] int32: a vertex's stretch of chunk numbers


class LinearisePlan(NamedTuple):
    """B3's plan, with the sizes of the structure it was made for: the
    wrappers compare these three integers a call and nothing else.  B5 and
    B9 finish a vertex of several chunks in the launch that sums its last
    chunk: they hold per-vertex counters (zero between launches, so calls
    with one plan must not overlap: one stream) and a scratch, B5's chunk
    sums by chunk number, then B9's per-edge slots."""

    pose: ChunkPlan
    lm: ChunkPlan
    E: int
    Pa: int
    La: int
    # [lm chunks + 1] int32 by chunk number: B9's first scratch slot of a
    # chunk; a landmark of one chunk takes none, so landmark v's slots are
    # lm_slot[vertex_off[v]] .. lm_slot[vertex_off[v + 1]]
    lm_slot: torch.Tensor
    count: torch.Tensor  # [Pa + La] int32: B5's counters, then B9's
    # [pose chunks x 6 + lm_slot[-1] x 3] f64 in either working type (the
    # kernels' partial sums), so a plan serves f64 and f32 solvers alike
    scratch: torch.Tensor


def _chunk_plan(seg: Segments, ntiles: int) -> ChunkPlan:
    """Cut each segment's run into per-tile chunks.  A chunk's target is its
    vertex's output row where the vertex has no other chunk, else ``-1 -
    number`` for scratch row ``number``: the order of every sum is fixed by
    the segment plan and ``TILE`` alone."""
    order, offsets = seg
    dev, n, nseg = order.device, order.shape[0], offsets.shape[0] - 1
    pos = torch.arange(n, device=dev)
    seg_of = torch.searchsorted(offsets[1:].contiguous(), pos, right=True)
    tile_of = torch.div(order, TILE, rounding_mode="floor")
    first = torch.ones(n, dtype=torch.bool, device=dev)
    first[1:] = (seg_of[1:] != seg_of[:-1]) | (tile_of[1:] != tile_of[:-1])
    start = torch.nonzero(first)[:, 0]
    end = torch.cat([start[1:], torch.full((min(n, 1),), n, device=dev)])
    cseg, ctile = seg_of[start], tile_of[start]
    vertex_off = torch.searchsorted(cseg, torch.arange(nseg + 1, device=dev))
    per_vertex = vertex_off[1:] - vertex_off[:-1]
    number = torch.arange(start.shape[0], device=dev)
    target = torch.where(per_vertex[cseg] == 1, cseg, -1 - number)
    by_tile = torch.argsort(ctile, stable=True)
    length = (end - start)[by_tile]
    first = length.cumsum(0) - length
    rows = (order - tile_of * TILE)[torch.repeat_interleave(start[by_tile] - first, length) + pos]
    chunks = torch.stack([first, first + length, target[by_tile], cseg[by_tile]], dim=1)
    tile_off = torch.searchsorted(ctile[by_tile], torch.arange(ntiles + 1, device=dev))
    i32 = torch.int32
    return ChunkPlan(rows.to(torch.uint8), chunks.to(i32).contiguous(), tile_off.to(i32),
                     vertex_off.to(i32))


def _edge_slots(half: ChunkPlan) -> torch.Tensor:
    """B9's scratch slots (``LinearisePlan.lm_slot``): the edges of every
    landmark of several chunks, in segment order, numbered from 0."""
    chunks, vertex_off = half.chunks.long(), half.vertex_off.long()
    target = chunks[:, 2]
    number = torch.where(target >= 0, vertex_off[target.clamp(min=0)], -1 - target)
    width = torch.zeros(chunks.shape[0] + 1, dtype=torch.int64, device=chunks.device)
    width[number + 1] = torch.where(target >= 0, 0, chunks[:, 1] - chunks[:, 0])
    return width.cumsum(0).to(torch.int32)


def make_linearise_plan(pose_seg: Segments, lm_seg: Segments, E: int) -> LinearisePlan:
    """B3's plan for ``E`` edges summed per pose and per landmark through
    the two segment plans.  Made once a structure (``build_structure``);
    :func:`linearise` makes it itself when it is given none."""
    if E * 18 >= 2**31:
        raise ValueError(f"linearise: {E} edges exceed the kernel's 32-bit indices")
    ntiles = -(-E // TILE)
    pose, lm = _chunk_plan(pose_seg, ntiles), _chunk_plan(lm_seg, ntiles)
    Pa, La = pose_seg.offsets.shape[0] - 1, lm_seg.offsets.shape[0] - 1
    lm_slot = _edge_slots(lm)
    dev = lm_slot.device
    work = pose.chunks.shape[0] * 6 + int(lm_slot[-1]) * 3
    return LinearisePlan(
        pose, lm, E, Pa, La, lm_slot, torch.zeros(Pa + La, dtype=torch.int32, device=dev),
        torch.empty(work, dtype=torch.float64, device=dev),
    )


def _ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def _check(name, qt, xw, data: PackedEdges, segs=()):
    """Validate the operands of a CUDA launch; returns them contiguous."""
    E = qt.shape[0]
    mdim = _model(data).MDIM
    floats = [qt, xw, data.meas, data.omega, data.cam, data.active, data.both_free, data.mask3]
    floats = [t for t in floats if t is not None]
    ints = [t for s in segs for t in s]
    check_floats(name, *floats)
    if any(t.dtype != torch.int64 for t in ints):
        raise TypeError(f"{name}: expects int64 segment plans")
    if any(t.device != qt.device for t in floats + ints + [data.code] if t is not None):
        raise ValueError(f"{name}: all operands must be on one device")
    if data.meas.shape != (mdim, E):
        raise ValueError(f"{name}: the {data.kind} model expects meas [{mdim}, E]")
    if qt.shape != (E, 12) or xw.shape != (E, 3) or data.cam.shape not in ((5, 1), (5, E)):
        raise ValueError(f"{name}: expects pose state [E, 12], landmark [E, 3], camera [5, 1] "
                         "or [5, E]")
    if data.omega.shape not in ((1,), (E,)):
        raise ValueError(f"{name}: expects omega [1] or [E]")
    for t in (data.active, data.both_free, data.mask3, data.code):
        if t is not None and t.shape != (E,):
            raise ValueError(f"{name}: expects active, both_free, mask3 and code of shape [E]")
    if data.mask3 is not None and data.kind != "stereo":
        raise ValueError(f"{name}: mask3 belongs to a stereo pack, not {data.kind!r}")
    if (data.code is not None) != (data.kind == "mixed") or (
            data.code is not None and data.code.dtype != torch.uint8):
        raise ValueError(f"{name}: a mixed pack, and only one, carries a uint8 kind code")
    return (
        qt.contiguous(), xw.contiguous(),
        data._replace(
            meas=data.meas.contiguous(), omega=data.omega.contiguous(),
            cam=data.cam.contiguous(), active=_contiguous(data.active),
            both_free=_contiguous(data.both_free), mask3=_contiguous(data.mask3),
            code=_contiguous(data.code),
        ),
    )


def _strides(d: PackedEdges) -> tuple:
    """The launchers' ``omega_stride, cam_stride, kind`` of checked operands."""
    return int(d.omega.shape[0] != 1), int(d.cam.shape[1] != 1), _KINDS[d.kind]


def _contiguous(t):
    return None if t is None else t.contiguous()


_VP, _LL, _INT = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_ARGTYPES = {
    # qt xw meas omega active m3 code cam | E omega_stride cam_stride kind f32
    # | out stream
    "tba_chi_edges": [_VP] * 8 + [_LL, _INT, _INT, _INT, _INT, _VP, _VP],
    # qt xw meas omega active both_free m3 code cam | E omega_stride
    # cam_stride kind f32 | pose rows, chunks, tile_off, vertex_off, scratch,
    # Pa | the same of the landmarks, La | 3 outputs, stream
    "tba_linearise": [_VP] * 9 + [_LL, _INT, _INT, _INT, _INT] + ([_VP] * 5 + [_LL]) * 2
    + [_VP] * 4,
}


def _fn(name: str):
    fn = getattr(_build.load("terms"), name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
    return fn


def chi_edges(qt: torch.Tensor, xw: torch.Tensor, data: PackedEdges) -> torch.Tensor:
    """Per-edge ``omega * active * |e|^2`` ``[E]`` in the state's type
    (kernel B1 on CUDA)."""
    if qt.device.type == "cpu":
        return chi_edges_plain(qt, xw, data)
    if qt.device.type != "cuda":
        raise NotImplementedError(f"chi_edges: no kernel for device {qt.device}")
    qt, xw, d = _check("chi_edges", qt, xw, data)
    E = qt.shape[0]
    out = torch.empty(E, dtype=qt.dtype, device=qt.device)
    if E == 0:
        return out
    status = _fn("tba_chi_edges")(
        qt.data_ptr(), xw.data_ptr(), d.meas.data_ptr(), d.omega.data_ptr(),
        _ptr(d.active), _ptr(d.mask3), _ptr(d.code), d.cam.data_ptr(), E, *_strides(d),
        f32_flag(qt.dtype), out.data_ptr(), _build.stream_ptr(qt),
    )
    _build.check(status, "chi_edges")
    chi_edges.launches += 1
    return out


def linearise(qt, xw, data: PackedEdges, pose_seg: Segments, lm_seg: Segments,
              plan: LinearisePlan | None = None):
    """``(Hpp|bp [Pa, 42], Hll|bl [La, 12], Hpl [E, 18])`` in the state's
    type, summed in segment order (kernel B3 on CUDA).  ``plan``: the segment plans'
    :func:`make_linearise_plan`, for a caller that launches more than once."""
    if qt.device.type == "cpu":
        return linearise_plain(qt, xw, data, pose_seg, lm_seg)
    if qt.device.type != "cuda":
        raise NotImplementedError(f"linearise: no kernel for device {qt.device}")
    qt, xw, d = _check("linearise", qt, xw, data, (pose_seg, lm_seg))
    E = qt.shape[0]
    Pa, La = pose_seg.offsets.shape[0] - 1, lm_seg.offsets.shape[0] - 1
    if plan is None:
        plan = make_linearise_plan(pose_seg, lm_seg, E)
    if (plan.E, plan.Pa, plan.La) != (E, Pa, La) or plan.pose.rows.device != qt.device:
        raise ValueError("linearise: the plan belongs to another structure or device")
    # the tile kernel loads the pose rows 16 bytes at a time (decided once
    # under CUDA-graph capture: see kernels/schurvec.py _operands)
    if qt.data_ptr() % 16:
        qt = qt.clone()
    kw = dict(dtype=qt.dtype, device=qt.device)
    pose, lm, hpl = torch.empty((Pa, 42), **kw), torch.empty((La, 12), **kw), torch.empty((E, 18), **kw)
    if E + Pa + La == 0:
        return pose, lm, hpl
    # the chunks' partial rows, f64 in either working type: [pose chunks, 27]
    # then [landmark chunks, 9]
    pose_rows = plan.pose.chunks.shape[0] * 27
    scratch = torch.empty(pose_rows + plan.lm.chunks.shape[0] * 9, dtype=torch.float64,
                          device=qt.device)
    status = _fn("tba_linearise")(
        qt.data_ptr(), xw.data_ptr(), d.meas.data_ptr(), d.omega.data_ptr(),
        _ptr(d.active), _ptr(d.both_free), _ptr(d.mask3), _ptr(d.code), d.cam.data_ptr(), E,
        *_strides(d), f32_flag(qt.dtype),
        *(t.data_ptr() for t in plan.pose), scratch.data_ptr(), Pa,
        *(t.data_ptr() for t in plan.lm), scratch.data_ptr() + 8 * pose_rows, La,
        pose.data_ptr(), lm.data_ptr(), hpl.data_ptr(), _build.stream_ptr(qt),
    )
    _build.check(status, "linearise")
    linearise.launches += 1
    return pose, lm, hpl


chi_edges.launches = 0
linearise.launches = 0
