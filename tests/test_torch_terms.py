"""Kernels B1, B3, B5 and B9: the port's plain twins against the JAX package
on the CPU, on the same seeded numpy inputs.

* The B1/B3 twins (the port's ``MonoModel``/``StereoModel``) against the JAX
  package's XLA models at 1e-12 x max|value|: the same expressions in real
  f64, summed per vertex in another order.
* One interpret-mode call each of ``terms_class_call``, ``chi_class_call``,
  ``hpl_mv_class_call`` and ``hpl_mtv_class_call`` at ``d = gc = 1`` (one
  edge per lane, so the outputs are per edge), against the twins over
  identity segment plans.  Tolerance 1e-9, as tests/test_terms_kernel.py:
  interpret mode loses part of the kernels' double-float compensation.
  Each interpret call compiles for tens of seconds, so there are four.
* Inert and degenerate rows give exact zeros.
* The shapes a tiled kernel is fragile at (one edge, a ragged last tile, a
  pose with over 1000 edges beside poses with none, landmarks without an
  edge, sorted and unsorted edges, fixed vertices): the twins against the
  JAX XLA models, and kernel B3's plan (``make_linearise_plan``), walked in
  numpy as kernels B3, B5 and B9 walk it, against the twins' segment sums.

The CUDA kernels themselves are held against these twins on the card by
tests/test_torch_gpu.py and chip_smoke.py.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from chip_smoke import _chunks_in_plan_order, hpl_mtv_in_plan_order, hpl_mv_in_plan_order
from torch_fragile import FRAGILE_EDGE_PATTERNS, fragile_edge_pattern
from cuda_bundle_adjustment_tpu.models.ba import MonoModel as JaxMono
from cuda_bundle_adjustment_tpu.models.ba import StereoModel as JaxStereo
from cuda_bundle_adjustment_tpu.types import GraphArrays as JaxGraph
from cuda_bundle_adjustment_tpu.types import PackedEdges as JaxEdges
from cuda_bundle_adjustment_tpu_torch.kernels import schurvec, terms
from cuda_bundle_adjustment_tpu_torch.models.ba import MODEL_REGISTRY, edge_state
from cuda_bundle_adjustment_tpu_torch.ops.components import flat_mtv_6x3, flat_mv_6x3
from cuda_bundle_adjustment_tpu_torch.solver.segments import make_segments, segment_sum
from cuda_bundle_adjustment_tpu_torch.types import GraphArrays, PackedEdges

torch.set_num_threads(1)

CAM = np.array([718.856, 718.856, 607.1928, 185.2157, 386.1448])


def _close(got, want, rtol):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=rtol * np.abs(want).max())


def _rotmats(rng, n):
    q = rng.normal(0, 0.1, (n, 4)) + np.array([0, 0, 0, 1.0])
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    x, y, z, w = q.T
    R = np.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w),
        2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w),
        2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y),
    ], axis=1)
    return q, R


# -- the twins against the JAX package's XLA models ----------------------------


def _graph_problem(rng, kind, masked, P=12, L=150, E=900, pose_idx=None, lm_idx=None):
    """A graph state and an edge set over it.  Pose 0 has the identity
    rotation and landmark 0 sits on its z = 0 plane, so the first six edges,
    the only ones between them, are degenerate; a tenth of the rows are
    inert; vertices P - 2.. and L - 2.. are fixed.  A caller that gives the
    edges' vertices (``pose_idx``, ``lm_idx``) gets exactly those, on a
    state without the degenerate pair."""
    given = pose_idx is not None
    q, _ = _rotmats(rng, P)
    t = rng.normal(0, 1.0, (P, 3))
    Xw = rng.normal(0, 2.0, (L, 3))
    Xw[:, 2] += 10.0
    if given:
        pose_idx, lm_idx = np.array(pose_idx), np.array(lm_idx)
        assert pose_idx.shape == lm_idx.shape == (E,)
    else:
        q[0] = [0, 0, 0, 1.0]
        t[0] = [0.0, 0.0, -Xw[0, 2]]
        pose_idx = rng.integers(0, P, E)
        lm_idx = rng.integers(1, L, E)
        pose_idx[:6], lm_idx[:6] = 0, 0
    mdim = 2 if kind == "mono" else 3
    meas = rng.normal(0, 30.0, (mdim, E)) + np.array([600.0, 180.0, 560.0])[:mdim, None]
    active = (rng.uniform(size=E) > 0.1).astype(np.float64)
    active[:3] = 1.0
    return dict(
        q=q, t=t, Xw=Xw, meas=meas, omega=np.abs(rng.normal(1.0, 0.2, E)),
        pose_idx=pose_idx, lm_idx=lm_idx, active=active,
        both_free=((pose_idx < P - 2) & (lm_idx < L - 2)).astype(np.float64),
        mask3=(rng.uniform(size=E) > 0.5).astype(np.float64) if masked else None,
        P=P, L=L, kind=kind,
    )


def _jax_side(d):
    graph = JaxGraph(jnp.asarray(d["q"]), jnp.asarray(d["t"]), jnp.asarray(d["Xw"]))
    data = JaxEdges(
        meas=jnp.asarray(d["meas"]), omega=jnp.asarray(d["omega"]),
        cam=jnp.asarray(CAM[:, None]), pose_idx=jnp.asarray(d["pose_idx"], jnp.int32),
        lm_idx=jnp.asarray(d["lm_idx"], jnp.int32), both_free=jnp.asarray(d["both_free"]),
        active=jnp.asarray(d["active"]),
        mask3=None if d["mask3"] is None else jnp.asarray(d["mask3"]),
    )
    return graph, data


def _port_side(d):
    T = torch.as_tensor
    graph = GraphArrays(T(d["q"]), T(d["t"]), T(d["Xw"]))
    data = PackedEdges(
        meas=T(d["meas"]), omega=T(d["omega"]), cam=T(CAM[:, None]),
        pose_idx=T(d["pose_idx"]), lm_idx=T(d["lm_idx"]), both_free=T(d["both_free"]),
        active=T(d["active"]), kind=d["kind"],
        mask3=None if d["mask3"] is None else T(d["mask3"]),
    )
    return graph, data


@pytest.mark.parametrize(
    "kind,masked", [("mono", False), ("stereo", False), ("stereo", True)],
    ids=["mono", "stereo", "mixed"],
)
def test_twins_match_jax_xla_models(kind, masked):
    """B1/B3 twins against the JAX XLA ``MonoModel``/``StereoModel`` per edge,
    and B3's per-vertex sums against numpy sums of the JAX stacks."""
    d = _graph_problem(np.random.default_rng(len(kind) + masked), kind, masked)
    jgraph, jdata = _jax_side(d)
    graph, data = _port_side(d)
    jmodel = JaxMono if kind == "mono" else JaxStereo

    qt, xw = edge_state(graph, data)
    _close(terms.chi_edges(qt, xw, data).numpy(), jmodel.chi(jgraph, jdata, 0, 1.0), 1e-12)
    want = [np.asarray(a) for a in jmodel.terms(jgraph, jdata, 0, 1.0)]
    got = MODEL_REGISTRY[kind].terms(graph, data, 0, 1.0)
    for g, w in zip(got, want):
        _close(g.numpy(), w, 1e-12)

    P, L = d["P"], d["L"]
    Pa, La = P - 2, L - 2
    segs = make_segments(d["pose_idx"], Pa, "cpu"), make_segments(d["lm_idx"], La, "cpu")
    pose, lm, hpl = terms.linearise(qt, xw, data, *segs)
    want_pose, want_lm = np.zeros((Pa, 42)), np.zeros((La, 12))
    pi, li = d["pose_idx"], d["lm_idx"]
    np.add.at(want_pose, pi[pi < Pa], want[0][pi < Pa])
    np.add.at(want_lm, li[li < La], want[1][li < La])
    _close(pose.numpy(), want_pose, 1e-12)
    _close(lm.numpy(), want_lm, 1e-12)
    _close(hpl.numpy(), want[2], 1e-12)


@pytest.mark.parametrize("rk", [1, 2, 3], ids=["tukey", "cauchy", "huber"])
@pytest.mark.parametrize(
    "kind,masked", [("mono", False), ("stereo", False), ("stereo", True)],
    ids=["mono", "stereo", "mixed"],
)
def test_robust_route_equals_robust_models(kind, masked, rk):
    """The solver's robust route (rho on B1's per-edge x; B3 with the weight
    rescaled by rho'(x)) against the port's own ``Model.chi`` / ``Model.terms``
    at that ``rk, delta`` with the original weight, bit for bit, and against
    the JAX XLA models at 1e-12 x max|value|.  Both sides of delta occur."""
    from cuda_bundle_adjustment_tpu_torch.ops.robust import robust_derivative, robustify

    delta = 150.0
    d = _graph_problem(np.random.default_rng(10 * rk + len(kind) + masked), kind, masked)
    jgraph, jdata = _jax_side(d)
    graph, data = _port_side(d)
    model = MODEL_REGISTRY[kind]
    jmodel = JaxMono if kind == "mono" else JaxStereo

    qt, xw = edge_state(graph, data)
    x = terms.chi_edges(qt, xw, data)
    live = x[x > 0]
    assert bool((live > delta**2).any()) and bool((live <= delta**2).any())
    chi = robustify(rk, delta, x)
    assert torch.equal(chi, model.chi(graph, data, rk, delta))
    _close(chi.numpy(), jmodel.chi(jgraph, jdata, rk, delta), 1e-12)

    rescaled = data._replace(omega=data.omega * robust_derivative(rk, delta, x))
    got = model.terms(graph, rescaled, 0, 1.0)
    want = model.terms(graph, data, rk, delta)
    jwant = jmodel.terms(jgraph, jdata, rk, delta)
    for g, w, jw in zip(got, want, jwant):
        assert torch.equal(g, w)
        _close(g.numpy(), jw, 1e-12)


def test_inert_and_degenerate_rows_give_exact_zeros():
    """Inert rows: exact zeros in chi, Hpl, Hpp|bp and Hll|bl.  Degenerate
    active rows (z = 0): an exact zero inv_z, so JL, Hll|bl and Hpl are exact
    zeros and everything else is finite."""
    d = _graph_problem(np.random.default_rng(3), "stereo", True)
    graph, data = _port_side(d)
    qt, xw = edge_state(graph, data)
    inert = d["active"] == 0
    degenerate = d["lm_idx"] == 0
    assert degenerate[:3].all() and not inert[:3].any() and d["both_free"][:6].all()
    chi = terms.chi_edges(qt, xw, data).numpy()
    pose, lm, hpl = terms.linearise(
        qt, xw, data, make_segments(d["pose_idx"], d["P"], "cpu"),
        make_segments(d["lm_idx"], d["L"], "cpu"),
    )
    assert np.all(chi[inert] == 0) and np.all(hpl.numpy()[inert | degenerate] == 0)
    assert np.all(lm.numpy()[0] == 0)
    assert np.all(np.isfinite(chi)) and bool(torch.isfinite(pose).all())
    # inert rows alone: their per-edge stacks are exact zeros
    stacks = MODEL_REGISTRY["stereo"].terms(graph, data, 0, 1.0)
    for s in stacks:
        assert np.all(s.numpy()[inert] == 0)


# -- the shapes a tiled kernel is fragile at --------------------------------------


def _walk_plan(stack, plan, nseg, width, free):
    """Segment sums of ``stack`` rows as kernel B3 forms them: every tile's
    chunks summed in order over the tile's rows, a lone chunk straight into
    its vertex's row, the others into scratch rows that are then added in
    chunk order; a vertex without a chunk gets zeros.  ``free [E]``: whether
    the edge's vertex of this kind is free (it is then in exactly one chunk)."""
    rows, chunks, tile_off, vertex_off = (t.numpy() for t in plan)
    out = np.full((nseg, width), np.nan)
    scratch = np.full((chunks.shape[0], width), np.nan)
    seen = np.zeros(stack.shape[0], dtype=int)
    for tile in range(tile_off.shape[0] - 1):
        mine = chunks[tile_off[tile] : tile_off[tile + 1]]
        # a tile's stretch of rows is contiguous and at most a tile long
        assert np.all(mine[1:, 0] == mine[:-1, 1])
        assert mine.shape[0] == 0 or mine[-1, 1] - mine[0, 0] <= terms.TILE
        for first, last, target, _ in mine:
            assert last > first and rows[first:last].max() < terms.TILE
            edges = tile * terms.TILE + rows[first:last].astype(np.int64)
            seen[edges] += 1
            acc = np.zeros(width)
            for r in edges:
                acc = acc + stack[r]
            if target < 0:
                scratch[-1 - target] = acc
            else:
                out[target] = acc
    assert np.all(seen == free)
    for v in range(nseg):
        c0, c1 = vertex_off[v], vertex_off[v + 1]
        if c1 - c0 != 1:
            out[v] = scratch[c0:c1].sum(axis=0) if c1 > c0 else 0.0
    return out


FRAGILE = list(FRAGILE_EDGE_PATTERNS)


@pytest.mark.parametrize("case", FRAGILE)
def test_twins_match_jax_at_fragile_shapes(case):
    """B1/B3 twins against the JAX XLA models at 1e-12 x max|value| on the
    shapes of ``torch_fragile.fragile_edge_pattern`` (masked stereo rows: the widest model)."""
    rng = np.random.default_rng(FRAGILE.index(case))
    P, L, pi, li = fragile_edge_pattern(case, rng)
    d = _graph_problem(rng, "stereo", True, P=P, L=L, E=len(pi), pose_idx=pi, lm_idx=li)
    np.testing.assert_array_equal(d["pose_idx"], pi)
    np.testing.assert_array_equal(d["lm_idx"], li)
    jgraph, jdata = _jax_side(d)
    graph, data = _port_side(d)
    qt, xw = edge_state(graph, data)
    _close(terms.chi_edges(qt, xw, data).numpy(), JaxStereo.chi(jgraph, jdata, 0, 1.0), 1e-12)
    want = [np.asarray(a) for a in JaxStereo.terms(jgraph, jdata, 0, 1.0)]
    Pa, La = P - 2, L - 2
    pi, li = d["pose_idx"], d["lm_idx"]
    segs = make_segments(pi, Pa, "cpu"), make_segments(li, La, "cpu")
    pose, lm, hpl = terms.linearise(qt, xw, data, *segs)
    want_pose, want_lm = np.zeros((Pa, 42)), np.zeros((La, 12))
    np.add.at(want_pose, pi[pi < Pa], want[0][pi < Pa])
    np.add.at(want_lm, li[li < La], want[1][li < La])
    assert pose.shape == want_pose.shape and lm.shape == want_lm.shape
    for got, ref in ((pose, want_pose), (lm, want_lm), (hpl, want[2])):
        _close(got.numpy(), ref, 1e-12)
    # rows of fixed vertices and vertices without an edge
    fixed = (pi >= Pa) | (li >= La)
    assert np.all(hpl.numpy()[fixed] == 0)
    assert np.all(pose.numpy()[np.setdiff1d(np.arange(Pa), pi)] == 0)
    assert np.all(lm.numpy()[np.setdiff1d(np.arange(La), li)] == 0)


@pytest.mark.parametrize("case", FRAGILE)
def test_linearise_plan_walk_matches_segment_sums(case):
    """Kernel B3's plan, walked in numpy, against the twins' segment sums:
    bit for bit where a vertex is one chunk, else 1e-12 x max|value| (the
    chunks associate the sum differently); every edge of a free vertex is in
    exactly one chunk, and a chunk lies in one tile."""
    rng = np.random.default_rng(FRAGILE.index(case))
    P, L, pi, li = fragile_edge_pattern(case, rng)
    pi, li = np.asarray(pi), np.asarray(li)
    E = len(pi)
    Pa, La = P - 2, L - 2
    segs = make_segments(pi, Pa, "cpu"), make_segments(li, La, "cpu")
    plan = terms.make_linearise_plan(*segs, E)
    assert all(t.dtype == torch.int32 for half in plan[:2] for t in half[1:])
    assert plan.pose.rows.dtype == plan.lm.rows.dtype == torch.uint8
    for half, seg, nseg, width, ids in (
        (plan.pose, segs[0], Pa, 27, pi), (plan.lm, segs[1], La, 9, li)
    ):
        stack = rng.normal(size=(E, width)) * 10.0 ** rng.integers(-3, 4, (E, 1))
        want = segment_sum(torch.as_tensor(stack), seg).numpy().reshape(nseg, width)
        got = _walk_plan(stack, half, nseg, width, ids < nseg)
        _close(got, want, 1e-12)
        off = half.vertex_off.numpy()
        lone = off[1:] - off[:-1] == 1
        np.testing.assert_array_equal(got[lone], want[lone])
        assert half.tile_off.shape[0] == -(-E // terms.TILE) + 1
        # chip_smoke.py's tensor form of the same walk, which the card holds
        # the kernel against bit for bit
        ordered = _chunks_in_plan_order(torch.as_tensor(stack), half).numpy()
        np.testing.assert_array_equal(ordered.reshape(nseg, width), got)
    assert (plan.E, plan.Pa, plan.La) == (E, Pa, La)


def _walk_schurvec(prods, base, plan, half, per_chunk, rng):
    """Kernel B5 (``per_chunk``) or B9 as it walks its half of B3's plan:
    the tiles in a random order (the blocks run in no order), each tile's
    chunks summed in segment order; a vertex of one chunk gets base - sum at
    once, a chunk of any other leaves its partial (B5: the chunk's sum, by
    chunk number; B9: its edges' products, in their slots) and adds one to
    the vertex's counter, and the tile that completes the vertex sums its
    partials in order; a vertex without a chunk gets base - 0."""
    rows, chunks, tile_off, vertex_off = (t.numpy() for t in half)
    slot = plan.lm_slot.numpy()
    V, N = base.shape
    out = np.full_like(base, np.nan)
    scratch = np.full((chunks.shape[0] if per_chunk else slot[-1], N), np.nan)
    count = np.zeros(V, dtype=int)
    for tile in rng.permutation(tile_off.shape[0] - 1):
        for first, last, target, v in chunks[tile_off[tile] : tile_off[tile + 1]]:
            edges = tile * terms.TILE + rows[first:last].astype(np.int64)
            acc = np.zeros(N)
            for e in edges:
                acc = acc + prods[e]
            if target >= 0:
                assert v == target and vertex_off[v + 1] - vertex_off[v] == 1
                out[v] = base[v] - acc
                continue
            if per_chunk:
                scratch[-1 - target] = acc
            else:
                scratch[slot[-1 - target] + np.arange(edges.size)] = prods[edges]
            count[v] += 1
            if count[v] == vertex_off[v + 1] - vertex_off[v]:
                count[v] = 0
                k0, k1 = vertex_off[v], vertex_off[v + 1]
                if not per_chunk:
                    k0, k1 = slot[k0], slot[k1]
                acc = np.zeros(N)
                for k in range(k0, k1):
                    acc = acc + scratch[k]
                out[v] = base[v] - acc
    empty = vertex_off[1:] == vertex_off[:-1]
    out[empty] = base[empty] - 0.0
    assert not count.any()
    return out


@pytest.mark.parametrize("case", FRAGILE)
def test_schurvec_plan_walk_matches_twins(case):
    """Kernels B5 and B9 walked in numpy as they walk B3's plan against
    their twins: B9 bit for bit; B5 bit for bit against the twin summed in
    the plan's order (``hpl_mv_in_plan_order``), and against the plain twin
    bit for bit at a pose of one chunk, else within 1e-12 x max|value|.
    The plan-order twins agree with the kernels' walk and give the same with
    the plan that a wrapper makes for itself."""
    rng = np.random.default_rng(FRAGILE.index(case))
    P, L, pi, li = fragile_edge_pattern(case, rng)
    pi, li = np.asarray(pi), np.asarray(li)
    E = len(pi)
    Pa, La = P - 2, L - 2
    segs = make_segments(pi, Pa, "cpu"), make_segments(li, La, "cpu")
    plan = terms.make_linearise_plan(*segs, E)
    hpl = rng.normal(size=(E, 18)) * 10.0 ** rng.integers(-3, 4, (E, 1))
    hpl[(pi >= Pa) | (li >= La)] = 0.0  # as B3 leaves the rows of fixed vertices
    y, xp = rng.normal(size=(La, 3)), rng.normal(size=(Pa, 6))
    bp, bl = rng.normal(size=(Pa, 6)) * 1e3, rng.normal(size=(La, 3)) * 1e3
    T = torch.as_tensor
    pi_t, li_t = T(pi), T(li)

    mv = (T(hpl), T(y), li_t, T(bp), segs[0])
    plain = schurvec.hpl_mv_segment_sum(*mv).numpy()
    ordered = hpl_mv_in_plan_order(*mv, plan).numpy()
    prods = flat_mv_6x3(T(hpl), T(y)[li_t.clamp(0, La - 1)]).numpy()
    walked = _walk_schurvec(prods, bp, plan, plan.pose, True, rng)
    np.testing.assert_array_equal(walked, ordered)
    np.testing.assert_array_equal(hpl_mv_in_plan_order(*mv).numpy(), ordered)
    _close(walked, plain, 1e-12)
    off = plan.pose.vertex_off.numpy()
    np.testing.assert_array_equal(walked[off[1:] - off[:-1] <= 1], plain[off[1:] - off[:-1] <= 1])

    mtv = (T(hpl), T(xp), pi_t, T(bl), segs[1])
    plain = schurvec.hpl_mtv_segment_sum(*mtv).numpy()
    prods = flat_mtv_6x3(T(hpl), T(xp)[pi_t.clamp(0, Pa - 1)]).numpy()
    walked = _walk_schurvec(prods, bl, plan, plan.lm, False, rng)
    np.testing.assert_array_equal(walked, plain)
    np.testing.assert_array_equal(hpl_mtv_in_plan_order(*mtv, plan).numpy(), plain)
    np.testing.assert_array_equal(hpl_mtv_in_plan_order(*mtv).numpy(), plain)
    assert plan.count.shape == (Pa + La,) and not plan.count.any()
    slots = plan.lm_slot.numpy()
    several = np.diff(plan.lm.vertex_off.numpy()) > 1
    assert slots[-1] == np.diff(segs[1].offsets.numpy())[several].sum()
    assert plan.scratch.numel() == plan.pose.chunks.shape[0] * 6 + slots[-1] * 3


def test_linearise_plan_refuses_too_many_edges():
    empty = make_segments(np.zeros(0, dtype=np.int64), 1, "cpu")
    with pytest.raises(ValueError):
        terms.make_linearise_plan(empty, empty, 2**31 // 18 + 1)


# -- the twins against the Pallas kernels in interpret mode ---------------------


def _lane_inputs(rng, E=128):
    """One class of 128 lanes at d = gc = 1: per-edge state, stereo
    measurements and a mono/stereo mask, with inert and degenerate rows."""
    _, R = _rotmats(rng, E)
    t = rng.normal(0, 1.0, (E, 3))
    xw = rng.normal(0, 2.0, (E, 3))
    xw[:, 2] += 10.0
    R[:4] = np.eye(3).reshape(-1)
    t[:4] = 0.0
    t[:4, 2] = -xw[:4, 2]  # z = 0 exactly
    active = (rng.uniform(size=E) > 0.1).astype(np.float64)
    active[:2], active[2:4] = 1.0, 0.0
    meas = rng.normal(0, 30.0, (3, E)) + np.array([600.0, 180.0, 560.0])[:, None]
    m3 = (rng.uniform(size=E) > 0.5).astype(np.float64)
    return np.concatenate([t, R], axis=1), xw, meas, np.abs(rng.normal(1.0, 0.2, E)), active, m3


def _ff(x):
    """(hi, lo) f32 pair of ``x`` with a [k, 1, 128] lane layout."""
    from cuda_bundle_adjustment_tpu.pallas.terms import split_ff

    h, lo = split_ff(jnp.asarray(x))
    return h.reshape(x.shape[0], 1, -1), lo.reshape(x.shape[0], 1, -1)


def _unff(h, lo):
    return np.asarray(h, np.float64) + np.asarray(lo, np.float64)


def test_terms_twins_match_pallas_interpret():
    """``terms_class_call`` and ``chi_class_call`` (mdim 3, has_m3) against the
    B3/B1 twins, per edge."""
    from cuda_bundle_adjustment_tpu.pallas.terms import chi_class_call, terms_class_call

    qt, xw, meas, omega, active, m3 = _lane_inputs(np.random.default_rng(7))
    E = qt.shape[0]
    hi = CAM.astype(np.float32)
    lo = (CAM - hi.astype(np.float64)).astype(np.float32)
    cam = jnp.asarray(np.broadcast_to(np.concatenate([hi, lo])[:, None], (10, 128)))
    args = (
        cam, *_ff(qt.T), *_ff(xw.T), *_ff(meas), *_ff((omega * active)[None]),
        jnp.asarray(active, jnp.float32).reshape(1, E), jnp.asarray(m3, jnp.float32).reshape(1, E),
    )
    kw = dict(d=1, gc=1, mdim=3, has_m3=True, interpret=True)
    ph, pl_, lh, ll, hh, hl = terms_class_call(*args, **kw)
    ch, cl = chi_class_call(*args, **kw)

    T = torch.as_tensor
    data = PackedEdges(
        meas=T(meas), omega=T(omega), cam=T(CAM[:, None]), pose_idx=T(np.arange(E)),
        lm_idx=T(np.arange(E)), both_free=T(np.ones(E)), active=T(active), kind="stereo",
        mask3=T(m3),
    )
    ident = make_segments(np.arange(E), E, "cpu")
    pose, lm, hpl = terms.linearise(T(qt), T(xw), data, ident, ident)
    for got, want in ((pose, _unff(ph, pl_)), (lm, _unff(lh, ll)), (hpl, _unff(hh, hl))):
        want = want.reshape(want.shape[0], E).T
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-9, atol=1e-9 * np.abs(want).max())
    want = _unff(ch, cl).reshape(E)
    got = terms.chi_edges(T(qt), T(xw), data).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9 * np.abs(want).max())
    assert np.all(want[active == 0] == 0) and np.all(got[active == 0] == 0)


def test_schurvec_twins_match_pallas_interpret():
    """``hpl_mv_class_call`` and ``hpl_mtv_class_call`` against the B5/B9
    twins, per edge (identity segments, zero right-hand sides: the twins
    return ``-Hpl y`` and ``-Hpl^T xp``)."""
    from cuda_bundle_adjustment_tpu.pallas.schurvec import hpl_mtv_class_call, hpl_mv_class_call

    rng = np.random.default_rng(11)
    E = 128
    hpl = rng.normal(size=(E, 18)) * 1e3
    y, xp = rng.normal(size=(E, 3)), rng.normal(size=(E, 6)) * 1e-2
    mv = _unff(*hpl_mv_class_call(*_ff(hpl.T), *_ff(y.T), d=1, gc=1, interpret=True))
    mtv = _unff(*hpl_mtv_class_call(*_ff(hpl.T), *_ff(xp.T), d=1, gc=1, interpret=True))

    T = torch.as_tensor
    idx = T(np.arange(E))
    ident = make_segments(np.arange(E), E, "cpu")
    got = schurvec.hpl_mv_segment_sum(T(hpl), T(y), idx, T(np.zeros((E, 6))), ident)
    want = -mv.reshape(6, E).T
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-9, atol=1e-9 * np.abs(want).max())
    got = schurvec.hpl_mtv_segment_sum(T(hpl), T(xp), idx, T(np.zeros((E, 3))), ident)
    want = -mtv.reshape(3, E).T
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-9, atol=1e-9 * np.abs(want).max())
    # the twins as the CUDA kernels walk B3's plan
    got = hpl_mtv_in_plan_order(T(hpl), T(xp), idx, T(np.zeros((E, 3))), ident)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-9, atol=1e-9 * np.abs(want).max())
    got = hpl_mv_in_plan_order(T(hpl), T(y), idx, T(np.zeros((E, 6))), ident)
    want = -mv.reshape(6, E).T
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-9, atol=1e-9 * np.abs(want).max())
