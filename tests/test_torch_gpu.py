"""The port's CUDA kernels against their plain twins on the card.

Every test here is marked ``gpu`` and skips without a CUDA device.  The file
imports no JAX, so it also runs on a GPU host without it:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q

(``--noconftest``: the suite's conftest configures JAX.)
"""

import numpy as np
import pytest
import torch

from chip_smoke import (
    graph_nodes,
    hpl_mtv_in_plan_order,
    hpl_mv_in_plan_order,
    random_banded_spd,
    reverse_pose_blocks,
)
from test_torch_pack import CASES as PACK_CASES
from test_torch_pack import pack_case, packed_solver
from torch_fragile import (
    FRAGILE_EDGE_PATTERNS,
    FRAGILE_PAIR_PROBLEMS,
    fragile_edge_pattern,
    fragile_pair_problem,
)
from cuda_bundle_adjustment_tpu_torch import GraphOptimisationOptions
from cuda_bundle_adjustment_tpu_torch.io.arrays import optimizer_from_problem
from cuda_bundle_adjustment_tpu_torch.io import synthetic
from cuda_bundle_adjustment_tpu_torch.io.synthetic import make_ba_problem
from cuda_bundle_adjustment_tpu_torch.io.synthetic import make_loop_closure_problem
from cuda_bundle_adjustment_tpu_torch.io.synthetic import make_mixed_ba_problem
from cuda_bundle_adjustment_tpu_torch.kernels import (
    bandchol, gather, lminv, pairprod, schurvec, terms,
)
from cuda_bundle_adjustment_tpu_torch.ops.components import flat_mv_3x3, flat_sym3x3_inv
from cuda_bundle_adjustment_tpu_torch.solver import block_solver as bs
from cuda_bundle_adjustment_tpu_torch.solver.segments import make_segments
from cuda_bundle_adjustment_tpu_torch.types import PackedEdges

torch.set_num_threads(1)


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def empty_structure_cache():
    """Each test starts from an empty structure cache: a structure that an
    earlier test solved twice would hand it a kept loop, whose runs capture
    nothing and run no eager iteration."""
    bs.clear_structure_cache()
    yield


CAM = (718.856, 718.856, 607.1928, 185.2157, 386.1448)


def _random_edges(rng, E, P, L, mdim, masked, dev, pose_idx=None, lm_idx=None):
    """Seeded edge inputs around a plausible BA state: a tenth of the rows
    inert, a few degenerate (z = 0 exactly, half of them active), some
    vertices fixed (index past the free range).  Inert rows alone observe
    pose P - 1, inert and degenerate rows alone landmark L - 1, unless the
    caller gives the edges' vertices (``pose_idx``, ``lm_idx``; P and L free)."""
    q = rng.normal(0, 0.1, (E, 4)) + np.array([0, 0, 0, 1.0])
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    x, y, z, w = q.T
    R = np.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w),
        2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w),
        2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y),
    ], axis=1)
    t = rng.normal(0, 1.0, (E, 3))
    xw = rng.normal(0, 2.0, (E, 3))
    xw[:, 2] += 10.0
    bad = rng.choice(E, min(E, max(4, E // 50)), replace=False)
    R[bad] = np.eye(3).reshape(-1)
    t[bad] = 0.0
    t[bad, 2] = -xw[bad, 2]
    active = (rng.uniform(size=E) > 0.1).astype(np.float64)
    active[bad[::2]] = 1.0
    active[bad[1::2]] = 0.0
    meas = rng.normal(0, 30.0, (mdim, E)) + np.array([600.0, 180.0, 560.0])[:mdim, None]
    given_pose, given_lm = pose_idx, lm_idx
    pose_idx = rng.integers(0, P + 1, E)
    pose_idx[pose_idx == P - 1] = P + 1
    pose_idx[active == 0] = P - 1
    lm_idx = rng.integers(0, L + 1, E)
    lm_idx[lm_idx == L - 1] = L + 1
    lm_idx[active == 0] = L - 1
    lm_idx[bad] = L - 1
    if given_pose is not None:
        pose_idx, lm_idx = np.asarray(given_pose), np.asarray(given_lm)

    def T(a, dt=torch.float64):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dt, device=dev)

    data = PackedEdges(
        meas=T(meas), omega=T(np.abs(rng.normal(1.0, 0.2, E))),
        cam=T(np.array(CAM)[:, None]), pose_idx=T(pose_idx, torch.int64),
        lm_idx=T(lm_idx, torch.int64),
        both_free=T((pose_idx < P) & (lm_idx < L)), active=T(active),
        kind="mono" if mdim == 2 else "stereo",
        mask3=T(rng.uniform(size=E) > 0.5) if masked else None,
    )
    qt = T(np.concatenate([t, R], axis=1))
    segs = (make_segments(pose_idx, P, dev), make_segments(lm_idx, L, dev))
    return qt, T(xw), data, segs, active == 0


def _close_rel(got, want, rtol=1e-12):
    return (got - want).abs().max().item() <= rtol * want.abs().max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("mdim,masked", [(2, False), (3, False), (3, True)],
                         ids=["mono", "stereo", "mixed"])
def test_terms_kernels_match_twins(mdim, masked):
    """B1 and B3 against their twins within 1e-12 x max|value| (same
    expressions, fused multiply-adds and another summation order), inert
    rows exact zeros everywhere, degenerate rows exact zeros in Hpl and
    Hll|bl, and a second launch bit for bit."""
    dev = _cuda()
    rng = np.random.default_rng(mdim + 10 * masked)
    P, L = 300, 4000
    qt, xw, data, (ps, ls), inert = _random_edges(rng, 20_000, P, L, mdim, masked, dev)
    chi = terms.chi_edges(qt, xw, data)
    assert _close_rel(chi, terms.chi_edges_plain(qt, xw, data))
    got = terms.linearise(qt, xw, data, ps, ls)
    want = terms.linearise_plain(qt, xw, data, ps, ls)
    for g, w in zip(got, want):
        assert g.shape == w.shape and _close_rel(g, w)
    assert all(torch.equal(a, b) for a, b in zip(got, terms.linearise(qt, xw, data, ps, ls)))
    inert = torch.as_tensor(inert, device=dev)
    assert bool((chi[inert] == 0).all()) and bool((got[2][inert] == 0).all())
    dead = data.lm_idx == L - 1  # inert and degenerate rows
    assert bool((got[2][dead] == 0).all())
    assert bool((got[0][P - 1] == 0).all()) and bool((got[1][L - 1] == 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("case", FRAGILE_EDGE_PATTERNS)
def test_linearise_kernel_at_fragile_shapes(case):
    """B3 against its twin on the shapes of ``fragile_edge_pattern`` (masked
    stereo rows): Hpl bit for bit; Hll|bl and Hpp|bp bit for bit where the
    plan sums a vertex as one chunk, else within 1e-12 x max|value| (the
    chunks associate the sum differently); zeros for vertices without an
    edge and for rows of fixed vertices; a second launch, and a launch with
    the plan handed in, bit for bit."""
    dev = _cuda()
    rng = np.random.default_rng(FRAGILE_EDGE_PATTERNS.index(case))
    P, L, pi, li = fragile_edge_pattern(case, rng)
    Pa, La = P - 2, L - 2
    qt, xw, data, (ps, ls), _ = _random_edges(rng, len(pi), Pa, La, 3, True, dev, pi, li)
    got = terms.linearise(qt, xw, data, ps, ls)
    want = terms.linearise_plain(qt, xw, data, ps, ls)
    plan = terms.make_linearise_plan(ps, ls, len(pi))
    for g, w, half in zip(got, want, (plan.pose, plan.lm, None)):
        assert g.shape == w.shape and bool(torch.isfinite(g).all())
        if half is None:
            assert torch.equal(g, w)
            continue
        assert _close_rel(g, w) or float(w.abs().max()) == 0.0
        lone = (half.vertex_off[1:] - half.vertex_off[:-1]) == 1
        assert torch.equal(g[lone], w[lone])
        none = (half.vertex_off[1:] - half.vertex_off[:-1]) == 0
        assert bool((g[none] == 0).all())
    fixed = torch.as_tensor((np.asarray(pi) >= Pa) | (np.asarray(li) >= La), device=dev)
    assert bool((got[2][fixed] == 0).all())
    for again in (terms.linearise(qt, xw, data, ps, ls), terms.linearise(qt, xw, data, ps, ls, plan)):
        assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.gpu
@pytest.mark.parametrize("case", FRAGILE_PAIR_PROBLEMS)
def test_pairprod_kernel_at_fragile_shapes(case):
    """B6 against its twin within 1e-12 x max|block| on the shapes of
    ``fragile_pair_problem`` (duplicate observations; a block of one triple
    beside blocks of thousands, summed over 21 items), and a second launch
    bit for bit."""
    dev = _cuda()
    s = optimizer_from_problem(fragile_pair_problem(case), device=dev).solver
    s.build_structure()
    _, sys_ = s.head()
    lam = 1e-5 * s.max_diagonal(sys_)
    diag9 = torch.tensor([1.0, 0, 0, 0, 1, 0, 0, 0, 1], dtype=torch.float64, device=dev)
    p = s.plan
    args = (sys_.Hpl, flat_sym3x3_inv(sys_.Hll + lam * diag9), p.ba_lm_idx,
            p.tri_ei, p.tri_ej, p.tri_offsets)
    got = pairprod.schur_pair_products(*args, p.pair_plan)
    want = pairprod.schur_pair_products_plain(*args)
    assert got.shape == want.shape
    assert (got - want).abs().max() <= 1e-12 * want.abs().max()
    assert torch.equal(got, pairprod.schur_pair_products(*args))


def _schurvec_inputs(case, dev):
    """Hpl, y, xp, the segment plans and the index arrays of a fragile edge
    pattern (random blocks, zero on rows of fixed vertices), or of a mixed
    problem's first linearisation (``"mixed_problem"``)."""
    if case == "mixed_problem":
        s = optimizer_from_problem(
            make_mixed_ba_problem(num_poses=40, num_landmarks=1500, seed=2), device=dev).solver
        s.build_structure()
        _, sys_ = s.head()
        p = s.plan
        lam = 1e-5 * s.max_diagonal(sys_)
        diag9 = torch.tensor([1.0, 0, 0, 0, 1, 0, 0, 0, 1], dtype=torch.float64, device=dev)
        y = flat_mv_3x3(flat_sym3x3_inv(sys_.Hll + lam * diag9), sys_.bl)
        xp = torch.as_tensor(np.random.default_rng(3).normal(size=(s.Pa, 6)), device=dev)
        return (sys_.Hpl, y, xp, sys_.bp, sys_.bl, p.ba_pose_idx, p.ba_lm_idx,
                p.pose_seg, p.lm_seg)
    rng = np.random.default_rng(FRAGILE_EDGE_PATTERNS.index(case))
    P, L, pi, li = fragile_edge_pattern(case, rng)
    Pa, La, E = P - 2, L - 2, len(pi)
    pi, li = np.asarray(pi), np.asarray(li)
    hpl = rng.normal(size=(E, 18)) * 10.0 ** rng.integers(-3, 4, (E, 1))
    hpl[(pi >= Pa) | (li >= La)] = 0.0

    def T(a):
        return torch.as_tensor(a, device=dev)

    return (T(hpl), T(rng.normal(size=(La, 3))), T(rng.normal(size=(Pa, 6))),
            T(rng.normal(size=(Pa, 6)) * 1e3), T(rng.normal(size=(La, 3)) * 1e3), T(pi), T(li),
            make_segments(pi, Pa, dev), make_segments(li, La, dev))


@pytest.mark.gpu
@pytest.mark.parametrize("case", [*FRAGILE_EDGE_PATTERNS, "mixed_problem"])
def test_schurvec_kernels_match_twins(case):
    """B5 and B9 on the shapes of ``fragile_edge_pattern`` and at a mixed
    problem's first linearisation: B9 bit for bit its twin, B5 bit for bit
    its twin summed in the plan's order and within 1e-12 x max|value| of
    the plain twin; a second launch, a launch with a plan made per call, and
    ten launches captured in a CUDA graph and replayed twice bit for bit, the
    counters back at zero; a plan of another structure is refused, and an
    Hpl view off a 16-byte boundary gives the same bits."""
    dev = _cuda()
    hpl, y, xp, bp, bl, pi, li, ps, ls = _schurvec_inputs(case, dev)
    plan = terms.make_linearise_plan(ps, ls, hpl.shape[0])
    mv = (hpl, y, li, bp, ps)
    mtv = (hpl, xp, pi, bl, ls)
    bsc = schurvec.hpl_mv_segment_sum(*mv, plan)
    assert torch.equal(bsc, hpl_mv_in_plan_order(*mv, plan))
    assert _close_rel(bsc, schurvec.hpl_mv_segment_sum_plain(*mv))
    cl = schurvec.hpl_mtv_segment_sum(*mtv, plan)
    assert torch.equal(cl, schurvec.hpl_mtv_segment_sum_plain(*mtv))
    assert torch.equal(cl, hpl_mtv_in_plan_order(*mtv, plan))
    for _ in range(2):
        assert torch.equal(bsc, schurvec.hpl_mv_segment_sum(*mv, plan))
        assert torch.equal(cl, schurvec.hpl_mtv_segment_sum(*mtv, plan))
    assert torch.equal(bsc, schurvec.hpl_mv_segment_sum(*mv))
    assert torch.equal(cl, schurvec.hpl_mtv_segment_sum(*mtv))

    outs = []
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(10):
            outs.append((schurvec.hpl_mv_segment_sum(*mv, plan),
                         schurvec.hpl_mtv_segment_sum(*mtv, plan)))
    for _ in range(2):
        for a, b in outs:
            a.zero_(), b.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, bsc) and torch.equal(b, cl) for a, b in outs)
    assert not plan.count.any()

    n = hpl.shape[0]
    off = torch.empty(n * 18 + 1, dtype=torch.float64, device=dev)[1:].view(n, 18)
    off.copy_(hpl)
    assert off.data_ptr() % 16 == 8
    assert torch.equal(bsc, schurvec.hpl_mv_segment_sum(off, *mv[1:], plan))
    assert torch.equal(cl, schurvec.hpl_mtv_segment_sum(off, *mtv[1:], plan))
    foreign = terms.make_linearise_plan(ps, ls, n + 1)
    with pytest.raises(ValueError):
        schurvec.hpl_mv_segment_sum(*mv, foreign)
    with pytest.raises(ValueError):
        schurvec.hpl_mtv_segment_sum(*mtv, foreign)


@pytest.mark.gpu
@pytest.mark.parametrize("lam", [1e-6, 0.37, 1e4])
def test_lminv_kernels_match_twins_bit_for_bit(lam):
    """B4 and B10 evaluate their twins' expressions operation for operation
    (no fused multiply-add): equal bit for bit, zero blocks (every 17th row)
    included, and a zero block inverts to I / lam."""
    dev = _cuda()
    rng = np.random.default_rng(3)
    La = 40_001
    G = rng.normal(size=(La, 3, 3))
    H9 = (np.einsum("nij,nkj->nik", G, G) + np.eye(3) * 1e-3).reshape(La, 9)
    H9 *= 10.0 ** rng.uniform(-3, 6, (La, 1))
    bl = rng.normal(size=(La, 3))
    H9[::17] = 0.0
    H9, bl = torch.as_tensor(H9, device=dev), torch.as_tensor(bl, device=dev)
    lam_f, lam = lam, torch.tensor(lam, dtype=torch.float64, device=dev)  # B4 reads it on the card
    before = lminv.damped_inverse.launches, lminv.sym3x3_mv.launches
    inv, y = lminv.damped_inverse(H9, bl, lam)
    inv_p, y_p = lminv.damped_inverse_plain(H9, bl, lam)
    assert all(torch.equal(a, b) for a, b in zip((inv_p, y_p),
                                                 lminv.damped_inverse_plain(H9, bl, lam_f)))
    assert torch.equal(inv, inv_p) and torch.equal(y, y_p)
    assert bool(torch.isfinite(inv).all()) and bool(torch.isfinite(y).all())
    eye = torch.tensor([1.0, 0, 0, 0, 1, 0, 0, 0, 1], dtype=torch.float64, device=dev)
    assert torch.allclose(inv[::17], (eye / lam_f).expand(inv[::17].shape), rtol=1e-15, atol=0)
    cl = torch.as_tensor(rng.normal(size=(La, 3)), device=dev)
    assert torch.equal(lminv.sym3x3_mv(inv, cl), lminv.sym3x3_mv_plain(inv, cl))
    after = lminv.damped_inverse.launches, lminv.sym3x3_mv.launches
    assert after == (before[0] + 1, before[1] + 1)

    # B4 on the solver's views: column blocks of one [La, 12] buffer, read in
    # place (at the buffer's start, and 8 and 40 bytes off a 16-byte
    # boundary), ragged last tiles, one tile and less
    for n, offset in ((La, 0), (La, 1), (129, 5), (128, 0), (1, 3)):
        buf = torch.empty(offset + n * 12, dtype=torch.float64, device=dev)
        lm_acc = buf[offset:].view(n, 12)
        lm_acc.copy_(torch.cat([H9[:n], bl[:n]], dim=1))
        Hv, bv = lm_acc[:, :9], lm_acc[:, 9:]
        got = lminv.damped_inverse(Hv, bv, lam)
        assert got[0].is_contiguous() and got[1].is_contiguous()
        assert torch.equal(got[0], inv[:n]) and torch.equal(got[1], y[:n])
        again = lminv.damped_inverse(Hv, bv, lam)
        assert torch.equal(again[0], got[0]) and torch.equal(again[1], got[1])

    # a CUDA-graph replay gives the same bits, and reads lam where it lies:
    # a replay after lam changed gives the twin at the new value
    lm_acc = torch.cat([H9, bl], dim=1)
    Hv, bv = lm_acc[:, :9], lm_acc[:, 9:]
    lminv.damped_inverse(Hv, bv, lam)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        g_inv, g_y = lminv.damped_inverse(Hv, bv, lam)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(g_inv, inv) and torch.equal(g_y, y)
    lam.mul_(3.0)
    graph.replay()
    torch.cuda.synchronize()
    want = lminv.damped_inverse_plain(H9, bl, lam)
    assert torch.equal(g_inv, want[0]) and torch.equal(g_y, want[1])
    lam.fill_(lam_f)

    # one device kernel a call on the solver's views: no copies
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    # the profiler's trace has come back short (2 of 3 events): a short trace
    # is taken again, up to three times, and each attempt's reading printed;
    # a device kernel of another name, or more than three, fails at once
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                lminv.damped_inverse(Hv, bv, lam)
            torch.cuda.synchronize()
        names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
        print(f"B4 profiler trace, attempt {attempt + 1}: {names}")
        assert len(names) <= 3 and all("damped_inverse_kernel" in n for n in names), names
        if len(names) == 3:
            break
    assert len(names) == 3, names


@pytest.mark.gpu
def test_lminv_kernels_refuse_what_they_do_not_take():
    dev = _cuda()
    H9 = torch.zeros((4, 9), dtype=torch.float64, device=dev)
    one = torch.ones((), dtype=torch.float64, device=dev)
    with pytest.raises(TypeError):
        lminv.damped_inverse(H9.float(), torch.zeros((4, 3), device=dev), one)
    with pytest.raises(ValueError):
        lminv.damped_inverse(H9, torch.zeros((5, 3), dtype=torch.float64, device=dev), one)
    with pytest.raises(TypeError, match="0-d f64 tensor"):
        lminv.damped_inverse(H9, torch.zeros((4, 3), dtype=torch.float64, device=dev), 1.0)
    with pytest.raises(ValueError, match="device"):
        lminv.damped_inverse(H9, torch.zeros((4, 3), dtype=torch.float64, device=dev), one.cpu())
    with pytest.raises(ValueError):
        lminv.sym3x3_mv(H9, torch.zeros((4, 3), dtype=torch.float64))


@pytest.mark.gpu
def test_gather_kernel_matches_twin():
    """Bit-exact, out-of-range indices (-1 and M) included."""
    dev = _cuda()
    rng = np.random.default_rng(0)
    table = torch.as_tensor(rng.standard_normal((1322, 12)), device=dev)
    idx = torch.as_tensor(rng.integers(-1, 1323, 50_000), device=dev)
    assert torch.equal(gather.gather_rows(table, idx), gather.gather_rows_plain(table, idx))


def _table_at(values: torch.Tensor, offset: int) -> torch.Tensor:
    """``values`` copied into a table whose first element lies ``offset``
    bytes past a 16-byte boundary."""
    M, K = values.shape
    skip = offset // values.element_size()
    buf = torch.empty(M * K + 4, dtype=values.dtype, device=values.device)
    table = buf[skip:skip + M * K].view(M, K)
    table.copy_(values)
    assert table.data_ptr() % 16 == offset
    return table


@pytest.mark.gpu
@pytest.mark.parametrize("E", [0, 1, 2, 3, 7, 50001])
@pytest.mark.parametrize("K", [1, 3, 5, 12])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_gather_kernel_edges(dtype, K, E):
    """B2 at the edges of its chunked design, each call ``torch.equal`` its
    twin and ``table[idx]``: row widths with and without a compile-time
    instantiation (3 and 12; 1 and 5), output lengths that end inside a
    16-byte chunk, a table at and 8 bytes off a 16-byte boundary, the
    sentinels -1, M and +-2^40 (a zero row), one launch counted a call, and
    a CUDA-graph capture replayed after the table changed in place (as the
    fused loop replays B2)."""
    dev = _cuda()
    rng = np.random.default_rng(100 * K + E)
    M = 1322 if K == 12 else 997
    values = torch.as_tensor(rng.standard_normal((M, K)), dtype=dtype, device=dev)
    idx = rng.integers(0, M, E)
    idx[: min(E, 4)] = [-1, M, 2**40, -2**40][: min(E, 4)]
    idx = torch.as_tensor(idx, device=dev)
    valid = (idx >= 0) & (idx < M)
    for offset in (0, 8):
        table = _table_at(values, offset)
        before = gather.gather_rows.launches
        got = gather.gather_rows(table, idx)
        assert gather.gather_rows.launches - before == (1 if E else 0)
        assert got.dtype == dtype and got.shape == (E, K)
        assert torch.equal(got, gather.gather_rows_plain(table, idx))
        assert torch.equal(got[valid], table[idx[valid]])
        assert not got[~valid].any()
    if E == 0:
        return
    table = _table_at(values, 8)
    got = gather.gather_rows(table, idx)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = gather.gather_rows(table, idx)
    table.mul_(-3.0)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(replayed, gather.gather_rows_plain(table, idx))
    assert not valid.any() or not torch.equal(replayed, got)


@pytest.mark.gpu
def test_gather_kernel_refuses_what_it_does_not_take():
    """A gather whose elements or rows a 32-bit index cannot reach is
    refused before anything is allocated; so are other index types."""
    dev = _cuda()
    table = torch.zeros((4, 12), dtype=torch.float64, device=dev)
    wide = torch.zeros((1,), dtype=torch.int64, device=dev).expand(2**31 // 12 + 1)
    with pytest.raises(ValueError, match="32-bit"):
        gather.gather_rows(table, wide)
    with pytest.raises(TypeError):
        gather.gather_rows(table, torch.zeros(3, dtype=torch.int32, device=dev))


@pytest.mark.gpu
def test_pairprod_kernel_matches_twin():
    """Within 1e-12 x max|block| (same products, different summation order),
    at the first LM trial's damping (TAU x max diagonal).  A far smaller
    damping makes inv(Hll) of once-observed landmarks huge and the products
    cancel, so the error would no longer be small against max|block|."""
    dev = _cuda()
    s = optimizer_from_problem(make_ba_problem(num_poses=40, num_landmarks=1500, seed=2),
                               device=dev).solver
    s.build_structure()
    _, sys_ = s.head()
    lam = 1e-5 * s.max_diagonal(sys_)
    diag9 = torch.tensor([1.0, 0, 0, 0, 1, 0, 0, 0, 1], dtype=torch.float64, device=dev)
    p = s.plan
    args = (sys_.Hpl, flat_sym3x3_inv(sys_.Hll + lam * diag9), p.ba_lm_idx,
            p.tri_ei, p.tri_ej, p.tri_offsets)
    got = pairprod.schur_pair_products(*args)
    want = pairprod.schur_pair_products_plain(*args)
    assert (got - want).abs().max() <= 1e-12 * want.abs().max()
    assert torch.equal(got, pairprod.schur_pair_products(*args, p.pair_plan))


@pytest.mark.gpu
def test_b3_b6_take_unaligned_views_and_refuse_a_foreign_plan():
    """B3 loads the pose rows and B6 copies the Hpl rows 16 bytes at a time:
    a contiguous view that starts 8 bytes into its storage gives the same
    bits as an aligned tensor.  A plan made for a structure of other sizes
    is refused."""
    dev = _cuda()
    rng = np.random.default_rng(21)
    P, L, E = 40, 700, 3000
    qt, xw, data, (ps, ls), _ = _random_edges(rng, E, P, L, 3, True, dev)
    want = terms.linearise(qt, xw, data, ps, ls)
    off = torch.empty(E * 12 + 1, dtype=torch.float64, device=dev)[1:].view(E, 12)
    off.copy_(qt)
    assert off.is_contiguous() and off.data_ptr() % 16 == 8
    assert all(torch.equal(a, b) for a, b in zip(want, terms.linearise(off, xw, data, ps, ls)))
    _, _, _, (ps2, ls2), _ = _random_edges(rng, E - 1, P, L, 3, True, dev)
    with pytest.raises(ValueError):
        terms.linearise(qt, xw, data, ps, ls, terms.make_linearise_plan(ps2, ls2, E - 1))

    s = optimizer_from_problem(make_ba_problem(num_poses=12, num_landmarks=300, seed=4),
                               device=dev).solver
    s.build_structure()
    _, sys_ = s.head()
    p = s.plan
    inv = flat_sym3x3_inv(sys_.Hll + 1e-5 * s.max_diagonal(sys_) * torch.tensor(
        [1.0, 0, 0, 0, 1, 0, 0, 0, 1], dtype=torch.float64, device=dev))
    idx = (p.ba_lm_idx, p.tri_ei, p.tri_ej, p.tri_offsets)
    want = pairprod.schur_pair_products(sys_.Hpl, inv, *idx, p.pair_plan)
    n = sys_.Hpl.shape[0]
    off = torch.empty(n * 18 + 1, dtype=torch.float64, device=dev)[1:].view(n, 18)
    off.copy_(sys_.Hpl)
    assert off.data_ptr() % 16 == 8
    assert torch.equal(want, pairprod.schur_pair_products(off, inv, *idx, p.pair_plan))
    foreign = pairprod.make_pair_plan(p.ba_lm_idx, p.tri_ei[:-1], p.tri_ej[:-1], p.tri_offsets)
    with pytest.raises(ValueError):
        pairprod.schur_pair_products(sys_.Hpl, inv, *idx, foreign)


@pytest.mark.gpu
@pytest.mark.parametrize(
    "Pa,bw,SB",
    [(60, 5, 8), (60, 11, 16), (60, 20, 24), (100, 31, 32), (60, 47, 48),
     (7, 11, 16), (1, 3, 8), (40, 0, 1)],
)
def test_band_kernels_match_twins(Pa, bw, SB):
    """f32 factor within 1e-5 x max|L| and solve within 1e-5 relative of the
    twins, 5e-5 of the f64 dense solve, and a second launch of each bit for
    bit.  SB = 24..48 is the range of the TPU's v1 factor (B11), which this
    one kernel family also covers; SB <= 32 accumulates in an f64 window, 48
    in f32; Pa = 60 and 100 exceed the window length, Pa = 7 and 1 stay
    inside it."""
    dev = _cuda()
    rng = np.random.default_rng(SB)
    A, band = random_banded_spd(Pa, bw, SB, rng)
    b = torch.as_tensor(rng.normal(size=(Pa, 6)).astype(np.float32), device=dev)
    band = torch.as_tensor(band, device=dev)
    L = bandchol.band_factor(band, Pa, SB)
    L_p = bandchol.band_factor_plain(band, Pa, SB)
    assert bool(torch.isfinite(L).all())
    assert (L - L_p).abs().max() <= 1e-5 * L_p.abs().max()
    assert torch.equal(L, bandchol.band_factor(band, Pa, SB))
    x = bandchol.band_solve(L, b, Pa, SB, bw)
    x_p = bandchol.band_solve_plain(L, b, Pa, SB, bw)
    assert (x - x_p).norm() <= 1e-5 * x_p.norm()
    assert torch.equal(x, bandchol.band_solve(L, b, Pa, SB, bw))
    x_dense = np.linalg.solve(A, b.cpu().numpy().reshape(-1)).reshape(Pa, 6)
    assert np.linalg.norm(x.cpu().numpy() - x_dense) <= 5e-5 * np.linalg.norm(x_dense)


@pytest.mark.gpu
def test_wide_band_path_on_gpu():
    """The renamed graph reaches band height 32: the band kernels against
    their twins on its first linearisation's band (f32, 1e-3 x max|value|),
    and its optimize(5) trace on the card against the CPU at rtol 1e-9."""
    from cuda_bundle_adjustment_tpu_torch.solver import block_solver as bs

    dev = _cuda()
    problem, _ = reverse_pose_blocks(make_ba_problem(num_poses=80, num_landmarks=1500, seed=2))
    s = optimizer_from_problem(problem, device=dev).solver
    s.build_structure()
    Pa, (bw, SB) = s.Pa, s.plan.band
    assert (bw, SB) == (31, 32)
    _, sys_ = s.head()
    blocks, bsc, _ = bs.schur_reduce(sys_, 1e-5 * s.max_diagonal(sys_), s.plan)
    band, _, bv, _ = bs.scaled_band(blocks, bsc, s.plan)
    L, L_p = bandchol.band_factor(band, Pa, SB), bandchol.band_factor_plain(band, Pa, SB)
    assert (L - L_p).abs().max() <= 1e-3 * L_p.abs().max()
    b32 = bv.to(torch.float32)
    x, x_p = bandchol.band_solve(L, b32, Pa, SB, bw), bandchol.band_solve_plain(L, b32, Pa, SB, bw)
    assert (x - x_p).abs().max() <= 1e-3 * x_p.abs().max()
    traces = []
    for d in (dev, "cpu"):
        opt = optimizer_from_problem(problem, device=d)
        opt.optimize(5)
        traces.append([st.chi2 for st in opt.batch_statistics().get()])
    np.testing.assert_allclose(traces[0], traces[1], rtol=1e-9)


@pytest.mark.gpu
def test_band_kernel_nonspd_goes_nonfinite():
    dev = _cuda()
    rng = np.random.default_rng(1)
    Pa, bw, SB = 9, 2, 8
    _, band = random_banded_spd(Pa, bw, SB, rng)
    band[0] = -np.eye(6).reshape(-1)
    band = torch.as_tensor(band, device=dev)
    b = torch.as_tensor(rng.normal(size=(Pa, 6)).astype(np.float32), device=dev)
    x = bandchol.band_solve(bandchol.band_factor(band, Pa, SB), b, Pa, SB, bw)
    assert not bool(torch.isfinite(x).all())


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["mono", "stereo", "mixed"])
def test_slice_on_gpu_matches_cpu_and_repeats(kind):
    """The slice on the card against the CPU twins at rtol 1e-9, and a second
    run on the card bit for bit."""
    dev = _cuda()
    kw = dict(num_poses=16, num_landmarks=120, seed=13)
    problem = make_mixed_ba_problem(**kw) if kind == "mixed" else make_ba_problem(kind=kind, **kw)
    traces = []
    for d in (dev, dev, "cpu"):
        opt = optimizer_from_problem(problem, device=d)
        opt.optimize(10)
        traces.append([s.chi2 for s in opt.batch_statistics().get()])
    assert traces[0] == traces[1]
    np.testing.assert_allclose(traces[0], traces[2], rtol=1e-9)


@pytest.mark.gpu
@pytest.mark.parametrize("rk", [1, 2, 3], ids=["tukey", "cauchy", "huber"])
@pytest.mark.parametrize("kind", ["mono", "stereo", "mixed"])
def test_robust_slice_on_gpu_matches_cpu_and_repeats(kind, rk):
    """Robust kernels on the card against the CPU at rtol 1e-9 (log and sqrt
    may differ in the last place between host and card), a second run on the
    card bit for bit, and the default device is the card."""
    dev = _cuda()
    kw = dict(num_poses=16, num_landmarks=120, seed=13)
    problem = make_mixed_ba_problem(**kw) if kind == "mixed" else make_ba_problem(kind=kind, **kw)
    traces = []
    for d in ({}, {}, dict(device="cpu")):
        opt = optimizer_from_problem(problem, rk=rk, delta=3.0, **d)
        assert opt.device.type == d.get("device", "cuda")
        opt.optimize(5)
        traces.append([s.chi2 for s in opt.batch_statistics().get()])
    assert traces[0] == traces[1]
    np.testing.assert_allclose(traces[0], traces[2], rtol=1e-9)


@pytest.mark.gpu
def test_structure_cache_hit_on_the_card():
    """A second optimiser on the card hits the structure cache and gives the
    miss's trace and final state bit for bit; the plan lives on the card,
    its triples are B6's int32 ones (no int64 copy), each solver has its own
    B5/B9 counters and scratch, and a CPU solver of the same structure
    misses (another device)."""
    from cuda_bundle_adjustment_tpu_torch.solver import block_solver as bs

    dev = _cuda()
    problem = make_ba_problem(num_poses=40, num_landmarks=1500, seed=2)
    bs.clear_structure_cache()
    runs = []
    for expect in ((0, 1), (1, 1)):
        opt = optimizer_from_problem(problem, device=dev)
        opt.optimize(8)
        info = bs.structure_cache_info()
        assert (info["hits"], info["misses"]) == expect
        runs.append(opt)
    miss, hit = runs
    assert hit.solver.symbolic_ms == 0.0
    assert [s.chi2 for s in hit.batch_statistics().get()] == [
        s.chi2 for s in miss.batch_statistics().get()]
    gm, gh = miss.solver.graph, hit.solver.graph
    assert torch.equal(gm.q, gh.q) and torch.equal(gm.t, gh.t) and torch.equal(gm.Xw, gh.Xw)
    p = hit.solver.plan
    assert p.tri_ei is p.pair_plan.tri_ei and p.tri_ej is p.pair_plan.tri_ej
    assert p.tri_ei.dtype == p.tri_ej.dtype == torch.int32
    assert p.pair_plan is miss.solver.plan.pair_plan
    assert p.lin_plan.count is not miss.solver.plan.lin_plan.count
    tensors = [t for f in p for t in (f if isinstance(f, tuple) else (f,))
               if isinstance(t, torch.Tensor)]
    tensors += [t for half in (p.lin_plan.pose, p.lin_plan.lm) for t in half]
    assert tensors and all(t.device.type == "cuda" for t in tensors)
    optimizer_from_problem(problem, device="cpu").solver.build_structure()
    info = bs.structure_cache_info()
    assert (info["hits"], info["misses"]) == (1, 2)
    bs.clear_structure_cache()


def _fused_and_host(problem, niter, **robust):
    """The same problem on the card through the fused loop and the host
    loop, with the launch counts of each run."""
    from cuda_bundle_adjustment_tpu_torch import kernels

    runs = []
    for fused_loop in (True, False):
        opt = optimizer_from_problem(problem, **robust)
        opt.use_fused_loop = fused_loop
        kernels.reset_launch_counts()
        opt.optimize(niter)
        torch.cuda.synchronize()
        runs.append((opt, kernels.launch_counts()))
    return runs


@pytest.mark.gpu
@pytest.mark.parametrize("rk", [0, 1], ids=["mono", "mono-tukey"])
def test_fused_loop_on_the_card_equals_the_host_loop(rk):
    """The fused loop on the card (iteration 0 eager, then CUDA-graph
    replays) against the host loop on the card: trace and final state bit
    for bit; one flag read a trial and one for the trace."""
    _cuda()
    problem = make_ba_problem(num_poses=16, num_landmarks=120, seed=13)
    robust = dict(rk=rk, delta=3.0) if rk else {}
    (f, _), (h, _) = _fused_and_host(problem, 6, **robust)
    tf = [s.chi2 for s in f.batch_statistics().get()]
    assert tf == [s.chi2 for s in h.batch_statistics().get()] and len(tf) == 6
    assert all(torch.equal(a, b) for a, b in zip(f.solver.graph, h.solver.graph))
    st = f.loop_stats
    assert st["captures"] >= 1 and st["replays"] >= 5 and st["reads"] == st["trials"] + 1


@pytest.mark.gpu
def test_launch_counters_count_replays():
    """A captured launch counts once for every replay and not at capture:
    the fused run's counts follow from its iterations and trials (F once
    before the loop, no chi pass at the head) and equal the host loop's,
    which carries F as well."""
    _cuda()
    problem = make_ba_problem(num_poses=16, num_landmarks=120, seed=13)
    (f, cf), (h, ch) = _fused_and_host(problem, 8)
    iters, trials = len(f.batch_statistics().get()), f.loop_stats["trials"]
    assert f.loop_stats["replays"] == trials - 1 >= 7  # iteration 0 of one trial runs eagerly
    assert cf["chi_edges"] == 1 + trials and cf["gather_rows"] == 2 + 2 * iters + 2 * trials
    assert ch["chi_edges"] == cf["chi_edges"] and ch["gather_rows"] == cf["gather_rows"]
    assert cf["linearise"] == ch["linearise"] == iters
    for name in ("damped_inverse", "hpl_mv_segment_sum", "schur_pair_products", "band_factor",
                 "hpl_mtv_segment_sum", "sym3x3_mv"):
        assert cf[name] == ch[name] == trials, name
    assert cf["band_solve"] == ch["band_solve"] == 3 * trials


@pytest.mark.gpu
def test_a_host_read_under_capture_raises_and_runs_nothing_else(monkeypatch):
    """A stage that reads a device value on the host (``.item()``) cannot be
    captured: ``optimize()`` raises, and it does not finish on the host
    loop or eagerly.  The card works afterwards."""
    from cuda_bundle_adjustment_tpu_torch import optimizer as topt
    from cuda_bundle_adjustment_tpu_torch.solver import block_solver as bs

    _cuda()
    problem = make_ba_problem(num_poses=16, num_landmarks=120, seed=13)
    real = bs.compute_scale

    def reads_back(xp, xl, sys, lam):
        scale = real(xp, xl, sys, lam)
        scale.item()
        return scale

    class NoHostLoop:
        def __init__(self, *a, **k):
            raise AssertionError("the host loop ran")

    from cuda_bundle_adjustment_tpu_torch import kernels

    with monkeypatch.context() as mp:
        mp.setattr(bs, "compute_scale", reads_back)
        mp.setattr(topt, "HostLoop", NoHostLoop)
        opt = optimizer_from_problem(problem)
        kernels.reset_launch_counts()
        with pytest.raises(RuntimeError, match="capturing|capture"):
            opt.optimize(4)
        assert opt.loop_stats is None and not opt.batch_statistics().get()
        # the eager iteration 0 launched; the failed capture counted nothing
        assert kernels.launch_counts()["linearise"] == 1
    # later loops capture and replay (into a new pool: the failed capture may
    # stay registered with the allocator as recording to the old one)
    for _ in range(2):
        opt = optimizer_from_problem(problem)
        opt.optimize(4)
        assert opt.loop_stats["replays"] >= 3 and len(opt.batch_statistics().get()) == 4


@pytest.mark.gpu
def test_repeated_optimize_reuses_the_capture_pool():
    """Every loop on a device captures into the device's one pool: once a
    loop of a size has run, the next one's graphs take the blocks the last
    one gave back, so repeated ``optimize()`` calls hold the allocator's
    reservation where it was, and each later run replays again.  The
    structure cache hits from the second run: that run captures and keeps
    its loop, the later ones replay it and capture nothing."""
    dev = _cuda()
    problem = make_ba_problem(num_poses=40, num_landmarks=1500, seed=2)
    reserved = []
    for _ in range(4):
        opt = optimizer_from_problem(problem, device=dev)
        opt.optimize(5)
        torch.cuda.synchronize()
        st = opt.loop_stats
        assert st["captures"] + st["reused"] >= 1 and st["replays"] >= 4
        del opt
        reserved.append(torch.cuda.memory_reserved(dev))
    assert reserved[3] == reserved[2], reserved


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["band", "pcg"])
def test_a_resolved_graph_replays_its_kept_loop_bit_for_bit(monkeypatch, route):
    """One graph solved three times: a miss, a first hit that captures and
    keeps its loop (``first`` too), and a second hit that replays it, with
    no capture, no eager step and one replay a trial; each run's trace and
    final state the host loop's bit for bit, and the reused run's launch
    counts a new loop's.  On the PCG route the kept CG blocks run under a
    new runner: the CG iterations are the host loop's."""
    from cuda_bundle_adjustment_tpu_torch import kernels

    _cuda()
    if route == "pcg":
        monkeypatch.setattr(bs, "PCG_MIN_POSES", 0)
        problem = make_loop_closure_problem(num_poses=160, num_landmarks=500,
                                            mean_obs_per_landmark=4.0, long_range_fraction=0.3,
                                            seed=21)
    else:
        problem = make_mixed_ba_problem(num_poses=16, num_landmarks=200, seed=13)
    runs = []
    for fused_loop in (True, True, True, False):
        opt = optimizer_from_problem(problem)
        opt.use_fused_loop = fused_loop
        kernels.reset_launch_counts()
        opt.optimize(6)
        torch.cuda.synchronize()
        runs.append((opt, kernels.launch_counts()))
    (miss, c0), (keep, _), (hit, c2), (host, _) = runs
    assert hit.solver.plan.route == route
    want = [s.chi2 for s in host.batch_statistics().get()]
    for o in (miss, keep, hit):
        assert [s.chi2 for s in o.batch_statistics().get()] == want
        assert all(torch.equal(a, b) for a, b in zip(o.solver.graph, host.solver.graph))
        assert o.cg_iterations == host.cg_iterations
    assert [o.loop_stats["reused"] for o in (miss, keep, hit)] == [0, 0, 1]
    assert keep.loop_stats["captures"] >= 2  # "first" at the end of its run
    st = hit.loop_stats
    assert st["captures"] == 0 and st["replays"] == st["trials"] and st["reused"] == 1
    assert st["reads"] == st["trials"] + 1 + st["cg_reads"] and c2 == c0
    assert hit.span_profile().get("loop/eager", 0.0) == 0.0
    assert 0 < st["eager_ms"] == hit.span_profile()["loop/bind"]


@pytest.mark.gpu
def test_reused_loops_hold_the_allocators_reservation():
    """Twenty solves of one graph through its kept loop: the copies in and
    out allocate only the result, so the allocator's reservation stays
    where the first reused run left it."""
    dev = _cuda()
    problem = make_mixed_ba_problem(num_poses=16, num_landmarks=200, seed=13)
    reserved = []
    for i in range(22):
        opt = optimizer_from_problem(problem, device=dev)
        opt.optimize(5)
        torch.cuda.synchronize()
        assert opt.loop_stats["reused"] == int(i >= 2)
        del opt
        reserved.append(torch.cuda.memory_reserved(dev))
    assert len(set(reserved[2:])) == 1, reserved


# -- f32 mode and the dense route ----------------------------------------------

# an f32 kernel and its twin are each the f64 computation rounded once: where
# the f64 values agree within 1e-12 the f32 ones agree within one rounding
F32_ROUND = 2.0**-23


def _f32_edges(qt, xw, data):
    f = torch.float32
    return qt.to(f), xw.to(f), data._replace(
        meas=data.meas.to(f), omega=data.omega.to(f), cam=data.cam.to(f),
        both_free=data.both_free.to(f), active=data.active.to(f),
        mask3=None if data.mask3 is None else data.mask3.to(f), code=data.code)


@pytest.mark.gpu
@pytest.mark.parametrize("mdim,masked", [(2, False), (3, False), (3, True)],
                         ids=["mono", "stereo", "mixed"])
def test_f32_terms_and_gather_kernels_match_twins(mdim, masked):
    """B1, B2 and B3 on f32 operands: f32 outputs within one rounding of
    their twins (Hpl bit for bit), B3's sums bit for bit the twin's stacks
    summed in the plan's order, B2 bit for bit, a second launch bit for
    bit, and an f32 pose state 8 bytes off a 16-byte boundary gives the
    same bits."""
    from chip_smoke import linearise_in_plan_order

    dev = _cuda()
    rng = np.random.default_rng(40 + mdim + 10 * masked)
    P, L, E = 300, 4000, 20_000
    qt, xw, data, (ps, ls), _ = _random_edges(rng, E, P, L, mdim, masked, dev)
    qt, xw, data = _f32_edges(qt, xw, data)
    chi = terms.chi_edges(qt, xw, data)
    assert chi.dtype == torch.float32
    assert _close_rel(chi, terms.chi_edges_plain(qt, xw, data), F32_ROUND)
    plan = terms.make_linearise_plan(ps, ls, E)
    got = terms.linearise(qt, xw, data, ps, ls, plan)
    want = terms.linearise_plain(qt, xw, data, ps, ls)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape and _close_rel(g, w, F32_ROUND)
    assert torch.equal(got[2], want[2])
    ordered = linearise_in_plan_order(qt, xw, data, ps, ls, plan)
    assert torch.equal(got[0], ordered[0]) and torch.equal(got[1], ordered[1])
    assert all(torch.equal(a, b) for a, b in zip(got, terms.linearise(qt, xw, data, ps, ls, plan)))
    off = torch.empty(E * 12 + 2, dtype=torch.float32, device=dev)[2:].view(E, 12)
    off.copy_(qt)
    assert off.data_ptr() % 16 == 8
    assert all(torch.equal(a, b) for a, b in zip(got, terms.linearise(off, xw, data, ps, ls, plan)))
    table = torch.as_tensor(rng.standard_normal((1322, 12)), dtype=torch.float32, device=dev)
    idx = torch.as_tensor(rng.integers(-1, 1323, 50_000), device=dev)
    assert torch.equal(gather.gather_rows(table, idx), gather.gather_rows_plain(table, idx))


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["mono", "stereo", "mixed"])
def test_f32_schur_kernels_match_twins(kind):
    """B4, B5, B6, B9 and B10 in f32 at an f32 solver's first linearisation
    on the card: B4, B9 and B10 bit for bit their twins, B5 bit for bit its
    twin summed in the plan's order, B6 within one rounding of its twin and
    of the twin's products summed in the plan's order; a captured B4 replayed
    after ``lam`` changed gives the twin at the new value; f64 operands with
    an f32 ``lam`` are refused."""
    from chip_smoke import pair_products_in_plan_order

    dev = _cuda()
    kw = dict(num_poses=40, num_landmarks=1500, mean_obs_per_landmark=4.0, seed=2)
    problem = make_mixed_ba_problem(**kw) if kind == "mixed" else make_ba_problem(kind=kind, **kw)
    s = optimizer_from_problem(problem, options=GraphOptimisationOptions(dtype="float32"),
                               device=dev).solver
    s.build_structure()
    _, sys_ = s.head()
    p = s.plan
    assert sys_.Hpl.dtype == torch.float32
    lam = 1e-5 * bs.max_diagonal(sys_)
    assert lam.dtype == torch.float32
    inv, y = lminv.damped_inverse(sys_.Hll, sys_.bl, lam)
    want = lminv.damped_inverse_plain(sys_.Hll, sys_.bl, lam)
    assert torch.equal(inv, want[0]) and torch.equal(y, want[1])
    mv = (sys_.Hpl, y, p.ba_lm_idx, sys_.bp, p.pose_seg)
    bsc = schurvec.hpl_mv_segment_sum(*mv, p.lin_plan)
    assert torch.equal(bsc, hpl_mv_in_plan_order(*mv, p.lin_plan))
    assert _close_rel(bsc, schurvec.hpl_mv_segment_sum_plain(*mv), F32_ROUND)
    xp = (bsc * 1e-6).contiguous()
    mtv = (sys_.Hpl, xp, p.ba_pose_idx, sys_.bl, p.lm_seg)
    cl = schurvec.hpl_mtv_segment_sum(*mtv, p.lin_plan)
    assert torch.equal(cl, schurvec.hpl_mtv_segment_sum_plain(*mtv))
    assert torch.equal(cl, hpl_mtv_in_plan_order(*mtv, p.lin_plan))
    assert not p.lin_plan.count.any()
    assert torch.equal(lminv.sym3x3_mv(inv, cl), lminv.sym3x3_mv_plain(inv, cl))
    args = (sys_.Hpl, inv, p.ba_lm_idx, p.tri_ei, p.tri_ej, p.tri_offsets)
    got = pairprod.schur_pair_products(*args, p.pair_plan)
    assert got.dtype == torch.float32
    assert _close_rel(got, pairprod.schur_pair_products_plain(*args), F32_ROUND)
    assert _close_rel(got, pair_products_in_plan_order(*args, p.pair_plan), F32_ROUND)
    assert torch.equal(got, pairprod.schur_pair_products(*args, p.pair_plan))

    lam_at = lam.clone()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        g_inv, g_y = lminv.damped_inverse(sys_.Hll, sys_.bl, lam_at)
    lam_at.mul_(7.0)
    graph.replay()
    torch.cuda.synchronize()
    want = lminv.damped_inverse_plain(sys_.Hll, sys_.bl, lam_at)
    assert torch.equal(g_inv, want[0]) and torch.equal(g_y, want[1])
    with pytest.raises(TypeError, match="lam"):
        lminv.damped_inverse(sys_.Hll.double(), sys_.bl.double(), lam)


def _card_and_cpu(problem, niter, options=None, **robust):
    out = {}
    for d in ("cuda", "cpu"):
        opt = optimizer_from_problem(problem, options=options, device=d, **robust)
        opt.optimize(niter)
        out[d] = opt
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("kind,rk", [("mono", 3), ("stereo", 0)], ids=["mono-huber", "stereo"])
def test_f32_fused_loop_on_the_card(kind, rk):
    """f32 mode through the fused loop's replays on the card: the trace
    against the f32 twins on the CPU at rtol 1e-4 (the same f64 arithmetic
    rounded once, sums in another order, so the two f32 band factors differ
    in the last bit of their systems and each step by about kappa x 2^-24;
    the JAX package's f32 tolerance) and against the card's f64 trace at
    rtol 1e-3, one B8 solve a trial, and a second run bit for bit."""
    from cuda_bundle_adjustment_tpu_torch import kernels

    _cuda()
    problem = make_ba_problem(num_poses=16, num_landmarks=400, mean_obs_per_landmark=4.0,
                              kind=kind, seed=13)
    robust = dict(rk=rk, delta=3.0) if rk else {}
    f32 = GraphOptimisationOptions(dtype="float32")
    kernels.reset_launch_counts()
    runs = _card_and_cpu(problem, 5, f32, **robust)
    card, cpu = runs["cuda"], runs["cpu"]
    counts = kernels.launch_counts()
    trace = [s.chi2 for s in card.batch_statistics().get()]
    st = card.loop_stats
    assert st["captures"] >= 1 and st["replays"] >= 4
    assert counts["band_solve"] == counts["band_factor"] == st["trials"]
    np.testing.assert_allclose(trace, [s.chi2 for s in cpu.batch_statistics().get()], rtol=1e-4)
    o64 = optimizer_from_problem(problem, **robust)
    o64.optimize(5)
    np.testing.assert_allclose(trace, [s.chi2 for s in o64.batch_statistics().get()], rtol=1e-3)
    again = optimizer_from_problem(problem, options=f32, **robust)
    again.optimize(5)
    assert [s.chi2 for s in again.batch_statistics().get()] == trace
    assert all(torch.equal(a, b) for a, b in zip(again.solver.graph, card.solver.graph))


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["exact", "loop-mixed", "loop-f32"])
def test_dense_route_in_the_fused_loop_on_the_card(case):
    """The dense route (``cholesky_ex`` and two triangular solves) inside
    the fused loop's captured graphs: ``"exact"`` on a banded graph and the
    120-pose loop-closure graph under ``"mixed"`` and in f32, each against
    the CPU at rtol 1e-9 (1e-4 in f32), no band kernel launched, captures
    replayed, and the card's host loop bit for bit (f64)."""
    from cuda_bundle_adjustment_tpu_torch import kernels

    _cuda()
    if case == "exact":
        problem = make_ba_problem(num_poses=16, num_landmarks=400, seed=13)
        options = GraphOptimisationOptions(solver_precision="exact")
    else:
        problem = make_loop_closure_problem(num_poses=120, num_landmarks=1200,
                                            long_range_fraction=0.3, seed=2)
        options = GraphOptimisationOptions(dtype="float32" if case == "loop-f32" else "float64")
    kernels.reset_launch_counts()
    runs = _card_and_cpu(problem, 6, options)
    counts = kernels.launch_counts()
    card, cpu = runs["cuda"], runs["cpu"]
    assert card.solver.plan.route == "dense"
    assert counts["band_factor"] == counts["band_solve"] == 0
    st = card.loop_stats
    assert st["captures"] >= 1 and st["replays"] >= 5
    trace = [s.chi2 for s in card.batch_statistics().get()]
    rtol = 1e-4 if case == "loop-f32" else 1e-9
    np.testing.assert_allclose(trace, [s.chi2 for s in cpu.batch_statistics().get()], rtol=rtol)
    if case != "loop-f32":
        host = optimizer_from_problem(problem, options=options)
        host.use_fused_loop = False
        host.optimize(6)
        assert [s.chi2 for s in host.batch_statistics().get()] == trace


def _bulk_object_graph(problem, device):
    """An optimiser on ``device`` holding ``problem`` as a bulk object graph
    (pose ids ``0..P-1``, landmark ids ``P..``), its sets returned beside it."""
    import cuda_bundle_adjustment_tpu_torch as tbt

    P, L = problem.pose_q.shape[0], problem.landmarks.shape[0]
    poses, landmarks = tbt.PoseVertexSet(), tbt.LandmarkVertexSet()
    poses.add_vertices_bulk(np.arange(P), problem.pose_q, problem.pose_t,
                            np.arange(P) >= problem.num_active_poses)
    landmarks.add_vertices_bulk(P + np.arange(L), problem.landmarks,
                                np.arange(L) >= problem.num_active_landmarks)
    edges = tbt.MonoEdgeSet() if problem.kind == "mono" else tbt.StereoEdgeSet()
    edges.set_information(1.0)
    edges.set_camera(tbt.Camera(*problem.cam.tolist()))
    edges.add_edges_bulk(problem.meas, problem.pose_idx, P + problem.lm_idx)
    opt = tbt.TorchGraphOptimisation.create(device=device)
    for s in (poses, landmarks):
        opt.add_vertex_set(s)
    opt.add_edge_set(edges)
    return opt, poses, landmarks


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["mono", "stereo"])
def test_object_api_on_the_card_equals_the_array_path(kind):
    """The bulk object graph on the card: the array path's trace, final state
    and launch counts bit for bit, the estimates written back exactly, and a
    re-initialize with the estimates reset hits the structure cache and
    repeats the trace."""
    from cuda_bundle_adjustment_tpu_torch import kernels

    _cuda()
    problem = make_ba_problem(num_poses=16, num_landmarks=400, kind=kind, seed=13)
    kernels.reset_launch_counts()
    arr = optimizer_from_problem(problem)
    arr.optimize(8)
    arr_counts = kernels.launch_counts()
    kernels.reset_launch_counts()
    opt, poses, landmarks = _bulk_object_graph(problem, "cuda")
    opt.initialize()
    opt.optimize(8)
    assert kernels.launch_counts() == arr_counts
    trace = [s.chi2 for s in opt.batch_statistics().get()]
    assert trace == [s.chi2 for s in arr.batch_statistics().get()]
    assert all(torch.equal(a, b) for a, b in zip(opt.solver.graph, arr.solver.graph))
    q, t = opt.solver.result_poses()
    assert np.array_equal(poses.bulk_estimates()[0], q)
    assert np.array_equal(poses.bulk_estimates()[1], t)
    assert np.array_equal(landmarks.bulk_estimates(), opt.solver.result_landmarks())

    poses.write_back(problem.pose_q, problem.pose_t)
    landmarks.write_back(problem.landmarks)
    hits = bs.structure_cache_info()["hits"]
    opt.initialize()
    opt.optimize(8)
    assert opt.solver.symbolic_ms == 0.0 and bs.structure_cache_info()["hits"] == hits + 1
    assert [s.chi2 for s in opt.batch_statistics().get()] == trace


# -- PCG, the pose-only solve and outliers ---------------------------------------


@pytest.mark.gpu
def test_pcg_route_in_the_fused_loop_on_the_card(monkeypatch):
    """The PCG route on the card (``PCG_MIN_POSES`` 0, the 160-pose
    loop-closure graph): each step captured as three graphs (up to the first
    CG block, one block, the rest), the block replayed until it reports
    done; trace, final state and CG iterations bit for bit the card's host
    loop, the trace at rtol 1e-9 of the CPU's; one host read a trial, one a
    CG block and one a run; no band kernel launched."""
    from cuda_bundle_adjustment_tpu_torch import kernels

    _cuda()
    monkeypatch.setattr(bs, "PCG_MIN_POSES", 0)
    problem = make_loop_closure_problem(num_poses=160, num_landmarks=500,
                                        mean_obs_per_landmark=4.0, long_range_fraction=0.3,
                                        seed=21)
    (f, cf), (h, ch) = _fused_and_host(problem, 6)
    assert f.solver.plan.route == "pcg" and cf["band_factor"] == cf["band_solve"] == 0
    tf = [s.chi2 for s in f.batch_statistics().get()]
    assert tf == [s.chi2 for s in h.batch_statistics().get()] and len(tf) == 6
    assert all(torch.equal(a, b) for a, b in zip(f.solver.graph, h.solver.graph))
    st = f.loop_stats
    assert f.cg_iterations == h.cg_iterations and len(f.cg_iterations) == st["trials"]
    assert st["reads"] == st["trials"] + 1 + st["cg_reads"] and st["replays"] >= 5
    cpu = optimizer_from_problem(problem, device="cpu")
    cpu.optimize(6)
    np.testing.assert_allclose(tf, [s.chi2 for s in cpu.batch_statistics().get()], rtol=1e-9)
    for name in ("damped_inverse", "hpl_mv_segment_sum", "schur_pair_products",
                 "hpl_mtv_segment_sum", "sym3x3_mv"):
        assert cf[name] == ch[name] == st["trials"], name


@pytest.mark.gpu
def test_fused_pcg_step_is_three_graphs(monkeypatch):
    """A PCG trial's capture: the graph before the CG, the CG block (with
    the status its runner reads) and the rest, in that order, after the
    linearisation's graph in ``linearise_and_trial``."""
    from cuda_bundle_adjustment_tpu_torch.solver.fused import FusedLoop

    _cuda()
    monkeypatch.setattr(bs, "PCG_MIN_POSES", 0)
    problem = make_loop_closure_problem(num_poses=160, num_landmarks=500,
                                        mean_obs_per_landmark=4.0, long_range_fraction=0.3,
                                        seed=21)
    opt = optimizer_from_problem(problem)
    opt.solver.build_structure()
    loop = FusedLoop(opt.solver, 4)
    loop.run()
    # a trial is three graphs; linearise_and_trial the linearisation's first
    blocks = {"linearise_and_trial": [False, False, True, False],
              "retry": [False, True, False]}
    assert loop.graphs and set(loop.graphs) <= set(blocks)
    for name, parts in loop._parts.items():
        assert [status is not None for _, _, status in parts] == blocks[name], name


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["band", "pcg"])
def test_a_profiled_solve_replays_the_kept_loop(monkeypatch, route):
    """A solve run under a torch profiler (CPU and CUDA activities) after
    two unprofiled solves of its structure replays the loop the second one
    kept: no capture, no event-record node in any of the loop's graphs, and
    the trace and final state the unprofiled solves' bit for bit.  The
    loop's spans time its copies in and out and its replays."""
    from torch.profiler import ProfilerActivity, profile

    _cuda()
    if route == "pcg":
        monkeypatch.setattr(bs, "PCG_MIN_POSES", 0)
        problem = make_loop_closure_problem(num_poses=160, num_landmarks=500,
                                            mean_obs_per_landmark=4.0, long_range_fraction=0.3,
                                            seed=21)
    else:
        problem = make_mixed_ba_problem(num_poses=16, num_landmarks=200, seed=13)

    def solve():
        opt = optimizer_from_problem(problem)
        opt.optimize(6)
        torch.cuda.synchronize()
        return opt

    plain = [solve() for _ in range(2)]  # a miss, then the first hit, which keeps its loop
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        traced = solve()
    assert traced.solver.plan.route == route
    st = traced.loop_stats
    want = [s.chi2 for s in plain[1].batch_statistics().get()]
    assert st["reused"] == 1 and st["captures"] == 0 and st["replays"] == st["trials"] >= len(want)
    assert st["replay_ms"] == traced.span_profile()["loop/replay"] > 0
    assert 0 < st["eager_ms"] == traced.span_profile()["loop/bind"]
    assert [s.chi2 for s in traced.batch_statistics().get()] == want
    assert all(torch.equal(a, b) for a, b in zip(traced.solver.graph, plain[1].solver.graph))
    loops = list(traced.solver._struct_bundle["loops"].values())
    assert len(loops) == 1 and loops[0].graphs
    for name, graphs in loops[0].graphs.items():
        # CU_GRAPH_NODE_TYPE_EVENT_RECORD
        assert all(graph_nodes(g).get("type 7", 0) == 0 for g in graphs), name


@pytest.mark.gpu
def test_pose_only_solve_on_the_card():
    """Motion-only BA (a mono graph with every landmark fixed) on the card:
    B1, B2 and B3 (its landmark side empty) launch, B4-B10 do not; the
    fused loop bit for bit the host loop, the trace at rtol 1e-9 of the
    CPU's."""
    _cuda()
    p = make_ba_problem(num_poses=16, num_landmarks=200, seed=13)
    p = p._replace(num_active_landmarks=0)
    (f, cf), (h, ch) = _fused_and_host(p, 8)
    assert f.solver.plan.route == "pose_only"
    tf = [s.chi2 for s in f.batch_statistics().get()]
    assert tf == [s.chi2 for s in h.batch_statistics().get()] and tf[-1] < tf[0]
    assert all(torch.equal(a, b) for a, b in zip(f.solver.graph, h.solver.graph))
    assert cf["linearise"] == len(tf) and cf["chi_edges"] > 0 and cf["gather_rows"] > 0
    for name in ("damped_inverse", "hpl_mv_segment_sum", "schur_pair_products", "band_factor",
                 "band_solve", "hpl_mtv_segment_sum", "sym3x3_mv"):
        assert cf[name] == ch[name] == 0, name
    cpu = optimizer_from_problem(p, device="cpu")
    cpu.optimize(8)
    np.testing.assert_allclose(tf, [s.chi2 for s in cpu.batch_statistics().get()], rtol=1e-9)


@pytest.mark.gpu
def test_outliers_on_the_card_mask_as_the_cpu_and_capture_anew():
    """Outlier thresholds on the card: the mask and counts the CPU's; a
    second ``optimize()`` reads the new mask, hits the structure cache and
    captures anew; its trace at rtol 1e-9 of the CPU's."""
    _cuda()
    p = make_ba_problem(num_poses=16, num_landmarks=400, seed=13, noise_px=0.5)
    meas = p.meas.copy()
    meas[::20] += 30.0
    p = p._replace(meas=meas)
    robust = dict(rk=3, delta=float(np.sqrt(5.991)), outlier_threshold=5.991)
    runs, masks = {}, {}
    for d in ("cuda", "cpu"):  # one device after the other: the cache keys on it
        o = runs[d] = optimizer_from_problem(p, device=d, **robust)
        o.optimize(5)
        active, first = o.solver.packed.active.clone(), o.loop_stats
        masks[d] = (active.cpu(), list(o.solver._outlier_counts))
        hits = bs.structure_cache_info()["hits"]
        o.optimize(10)
        assert bs.structure_cache_info()["hits"] == hits + 1
        assert not bool((o.solver.packed.active > 0)[active == 0].any())  # masked stay out
        # a new loop, which captured its own graphs
        assert d == "cpu" or o.loop_stats is not first and o.loop_stats["captures"] >= 1
    card, cpu = runs["cuda"], runs["cpu"]
    assert masks["cuda"][1] == masks["cpu"][1] and sum(masks["cuda"][1]) > 0
    assert torch.equal(masks["cuda"][0], masks["cpu"][0])
    np.testing.assert_allclose([s.chi2 for s in card.batch_statistics().get()],
                               [s.chi2 for s in cpu.batch_statistics().get()], rtol=1e-9)


@pytest.mark.gpu
@pytest.mark.parametrize("f32", [False, True], ids=["f64", "f32"])
@pytest.mark.parametrize("case", ["depth", "mono-per-edge-camera", "mixed", "mixed-per-edge-camera"])
def test_terms_kernels_of_depth_cameras_and_kinds_match_twins(case, f32):
    """B1 and B3's depth, per-edge-camera and mixed-kind instantiations
    against their twins (``DepthModel``, ``MixedModel``, a ``[5, E]``
    camera) in f64 and f32: chi and Hpl bit for bit, the per-vertex sums bit
    for bit the twin's stacks summed in the plan's order, a second launch
    bit for bit; a camera an edge whose columns are all one camera gives the
    one-camera instantiation's bits."""
    from chip_smoke import linearise_in_plan_order

    dev = _cuda()
    rng = np.random.default_rng(["depth", "mono-per-edge-camera", "mixed",
                                 "mixed-per-edge-camera"].index(case) + 7 * f32)
    P, L, E = 300, 4000, 20_000
    mdim = 2 if case.startswith("mono") else 3
    qt, xw, data, (ps, ls), _ = _random_edges(rng, E, P, L, mdim, False, dev)
    if case == "depth":
        data = data._replace(kind="depth")
    elif case.startswith("mixed"):
        code = torch.as_tensor(rng.integers(0, 3, E).astype(np.uint8), device=dev)
        data = data._replace(kind="mixed", code=code)
    one_cam = data
    if case.endswith("per-edge-camera"):
        data = data._replace(cam=data.cam * torch.as_tensor(
            rng.uniform(0.95, 1.05, (5, E)), device=dev))
    if f32:
        qt, xw, data = _f32_edges(qt, xw, data)
        _, _, one_cam = _f32_edges(qt, xw, one_cam)
    chi = terms.chi_edges(qt, xw, data)
    assert chi.dtype == qt.dtype and torch.equal(chi, terms.chi_edges_plain(qt, xw, data))
    plan = terms.make_linearise_plan(ps, ls, E)
    got = terms.linearise(qt, xw, data, ps, ls, plan)
    want = terms.linearise_plain(qt, xw, data, ps, ls)
    assert torch.equal(got[2], want[2])
    for g, w in zip(got, want):
        assert g.shape == w.shape and _close_rel(g, w, F32_ROUND if f32 else 1e-12)
    ordered = linearise_in_plan_order(qt, xw, data, ps, ls, plan)
    assert torch.equal(got[0], ordered[0]) and torch.equal(got[1], ordered[1])
    assert all(torch.equal(a, b) for a, b in zip(got, terms.linearise(qt, xw, data, ps, ls, plan)))
    wide = one_cam._replace(cam=one_cam.cam.expand(5, E).contiguous())
    assert torch.equal(terms.chi_edges(qt, xw, wide), terms.chi_edges(qt, xw, one_cam))
    assert all(torch.equal(a, b) for a, b in zip(terms.linearise(qt, xw, wide, ps, ls, plan),
                                                 terms.linearise(qt, xw, one_cam, ps, ls, plan)))


@pytest.mark.gpu
def test_mono_plus_depth_fused_loop_on_the_card():
    """A mono set beside a depth set: one landmark pack, one B3 launch an
    iteration over both sets, the fused loop bit for bit the host loop, the
    trace at rtol 1e-9 of the CPU's."""
    from chip_smoke import mono_depth_problem
    from cuda_bundle_adjustment_tpu_torch import kernels

    _cuda()
    p = mono_depth_problem(make_ba_problem(num_poses=16, num_landmarks=400, kind="depth", seed=3))
    runs = {}
    for fused in (True, False):
        kernels.reset_launch_counts()
        o = optimizer_from_problem(p)
        o.use_fused_loop = fused
        o.optimize(8)
        runs[fused] = (o, kernels.launch_counts())
    (f, cf), (h, _) = runs[True], runs[False]
    assert f.solver.packed.kind == "mixed" and len(f.solver.packs) == 1
    tf = [s.chi2 for s in f.batch_statistics().get()]
    assert tf == [s.chi2 for s in h.batch_statistics().get()]
    assert all(torch.equal(a, b) for a, b in zip(f.solver.graph, h.solver.graph))
    assert cf["linearise"] == len(tf)
    cpu = optimizer_from_problem(p, device="cpu")
    cpu.optimize(8)
    np.testing.assert_allclose(tf, [s.chi2 for s in cpu.batch_statistics().get()], rtol=1e-9)


@pytest.mark.gpu
def test_cpu_and_card_solvers_of_one_graph_keep_their_plans():
    """A CPU and a card solver of one graph, interleaved: one structure-cache
    miss each, then hits."""
    _cuda()
    p = make_ba_problem(num_poses=12, num_landmarks=150, seed=4)
    bs.clear_structure_cache()
    for _ in range(3):
        for d in ("cpu", "cuda"):
            optimizer_from_problem(p, device=d).solver.build_structure()
    info = bs.structure_cache_info()
    assert (info["hits"], info["misses"]) == (4, 2)


@pytest.mark.gpu
def test_a_pack_is_one_copy_from_a_pinned_block_the_next_pack_reuses():
    """Packing a graph copies from the host to the card once (the
    profiler's host-to-device copies while it packs, and ``pack_stats``); a
    re-sent graph's pack takes the pinned block the first one gave back
    (``pinned_new`` 0).  The very first pack of the process initialises
    CUDA."""
    dev = _cuda()
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    p = make_mixed_ba_problem(num_poses=40, num_landmarks=600, mean_obs_per_landmark=3.5, seed=2)
    first = optimizer_from_problem(p, device=dev)
    torch.cuda.synchronize()
    assert first.pack_stats["copies"] == 1 and first.pack_stats["bytes"] > 0
    del first
    # the profiler's trace has come back short (the B4 test above): device work
    # without a copy goes first, and a trace without the copy is taken again,
    # up to three times
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.ones(1, device=dev).add_(1)
            torch.cuda.synchronize()
            opt = optimizer_from_problem(p, device=dev)
            torch.cuda.synchronize()
        device = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
        copies = [n for n in device if "HtoD" in n]
        print(f"pack's host-to-device copies, attempt {attempt + 1}: {copies} "
              f"({len(device)} device events)")
        assert len(copies) <= 1, copies
        assert opt.pack_stats == dict(bytes=opt.pack_stats["bytes"], copies=1, pinned_new=0)
        del opt
        if copies:
            break
    assert len(copies) == 1, (copies, sorted(set(device)))


@pytest.mark.gpu
@pytest.mark.parametrize("case", PACK_CASES)
def test_the_cards_pack_equals_the_cpus(case):
    """The pack built on the card, every field, the state, the metas and the
    host indices a miss reads, bit for bit the CPU's (which
    ``tests/test_torch_pack.py`` holds against the host packing)."""
    dev = _cuda()
    p, specs, options = pack_case(case)
    cpu, card = (packed_solver(p, specs, d, **options) for d in ("cpu", dev))
    for a, b in zip(cpu.graph, card.graph):
        assert a.dtype == b.dtype and a.stride() == b.stride() and torch.equal(a, b.cpu())
    assert len(cpu.packs) == len(card.packs) and cpu.metas == card.metas
    for x, y in zip(cpu.packs, card.packs):
        assert x.kind == y.kind
        for f in ("meas", "omega", "cam", "pose_idx", "lm_idx", "both_free", "active", "mask3",
                  "code"):
            a, b = getattr(x, f), getattr(y, f)
            assert (a is None) == (b is None), f
            if a is not None:
                assert a.dtype == b.dtype and a.stride() == b.stride(), f
                assert a.numpy().tobytes() == b.cpu().numpy().tobytes(), f
    for (cp, cl), (gp, gl) in zip(cpu._host_idx, card._host_idx):
        assert np.array_equal(cp, gp) and np.array_equal(cl, gl)
    assert card.pack_stats["copies"] == 1 and cpu.pack_stats["copies"] == 0


@pytest.mark.gpu
def test_two_gloo_ranks_on_the_card_replicate_the_poses(tmp_path):
    """The distributed path (``parallel/distributed.py``) with two gloo ranks
    sharing the card, at sample size: every rank ends with rank 0's poses bit
    for bit (the pose solve is replicated), and the trace is the one-card
    run's within 1e-7."""
    import torch_dist_cases as tdc

    _cuda()
    tdc.join(tdc.run_ranks(2, ("mono", "mixed"), str(tmp_path), device="cuda"), 300)
    ranks = tdc.read_ranks(2, str(tmp_path))
    for case in ("mono", "mixed"):
        got = ranks[0][case]
        for key in ("trace", "q", "t"):
            assert np.array_equal(np.asarray(got[key]), np.asarray(ranks[1][case][key])), key
        for r in ranks:  # the fused loop's steps eager under gloo, the host loop's bit for bit
            st = r[case]["stats"]
            assert st["fused"] and not st["capture"] and st["captures"] == 0
            assert r[case]["trace"] == r[case]["host"]["trace"]
            assert all(np.array_equal(r[case][k], r[case]["host"][k]) for k in ("q", "t", "Xw"))
        opt = optimizer_from_problem(tdc.problem(case, synthetic))
        opt.optimize(tdc.NITER)
        want = [s.chi2 for s in opt.batch_statistics().get()]
        assert len(got["trace"]) == len(want)
        np.testing.assert_allclose(got["trace"], want, rtol=1e-7)


# -- the distributed loop on one NCCL rank ----------------------------------------


@pytest.fixture(scope="module")
def nccl_rank(tmp_path_factory):
    """One NCCL rank in this process (the default group), for the module."""
    import os

    import torch.distributed as dist

    _cuda()
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    store = tmp_path_factory.mktemp("nccl") / "store"
    dist.init_process_group("nccl", init_method=f"file://{store}", rank=0, world_size=1)
    yield dist
    dist.destroy_process_group()


def _nccl_rank_solver(pose_solver="auto"):
    from cuda_bundle_adjustment_tpu_torch.parallel import RankSolver, shard_problem

    problem = make_ba_problem(num_poses=16, num_landmarks=120, seed=13)
    return RankSolver(None, shard_problem(problem, 1, pose_solver=pose_solver))


@pytest.mark.gpu
@pytest.mark.parametrize("pose_solver", ["auto", "pcg"], ids=["band", "pcg"])
def test_nccl_rank_captures_the_loop_and_equals_the_host_loop(nccl_rank, pose_solver):
    """One NCCL rank: the fused loop captures its steps (their all-reduces
    with them; on the PCG route in three graphs) and replays them; trace,
    final state, CG iterations, launch counts and all-reduces (calls and
    bytes, counted per replay) bit for bit the host loop's on the same
    ``RankSolver``; one flag read a trial."""
    from cuda_bundle_adjustment_tpu_torch import kernels

    rs = _nccl_rank_solver(pose_solver)
    assert rs.capturable and rs.plan.route == ("band" if pose_solver == "auto" else "pcg")
    out = {}
    for fused in (True, False):
        rs.use_fused_loop = fused
        kernels.reset_launch_counts()
        trace, graph = rs.optimize(6)
        out[fused] = (trace, [a.clone() for a in graph], dict(rs.stats), kernels.launch_counts())
    (tf, gf, sf, cf), (th, gh, sh, ch) = out[True], out[False]
    assert tf == th and len(tf) == 6
    assert all(torch.equal(a, b) for a, b in zip(gf, gh))
    assert sf["capture"] and sf["captures"] >= 1 and sf["replays"] >= 5
    assert sf["reads"] == sf["trials"] + 1 + sf["cg_reads"]
    assert sf["trials"] == sh["trials"] and sf["cg_iterations"] == sh["cg_iterations"]
    assert sf["all_reduce"] == sh["all_reduce"]
    assert sf["all_reduce"]["calls"] == len(tf) + 2 * sf["trials"] + 1
    assert cf == ch


@pytest.mark.gpu
def test_nccl_rank_graphs_hold_the_host_loops_collectives(nccl_rank):
    """What a captured step adds to ``comm`` on every replay: the head's
    all-reduce of ``[chi, Pa x 42]`` and a trial's two (``6 Pa + 36 nnz``
    and 2 values) for ``linearise_and_trial``; a trial's two for
    ``retry``; the MAX of the first damping is in no graph."""
    from cuda_bundle_adjustment_tpu_torch.solver.fused import FusedLoop

    rs = _nccl_rank_solver()
    rs.comm = dict(calls=0, bytes=0)
    loop = FusedLoop(rs, 6)
    trace = loop.run()
    assert loop.stats["captures"] >= 1
    Pa, nnz = rs.Pa, rs.sp.nnz_blocks
    trial = 8 * (6 * Pa + 36 * nnz) + 16
    want = {"linearise_and_trial": dict(calls=3, bytes=8 * (1 + 42 * Pa) + trial),
            "retry": dict(calls=2, bytes=trial)}
    for name, parts in loop._parts.items():
        got = {k: sum(d.get("comm." + k, 0) for _, d, _ in parts) for k in ("calls", "bytes")}
        assert got == want[name], name
    assert rs.comm["calls"] == len(trace) + 2 * loop.stats["trials"] + 1


@pytest.mark.gpu
def test_a_rank_loop_captures_on_every_optimize(nccl_rank):
    """A rank's fused loop is not kept: each ``optimize()`` of one
    ``RankSolver`` runs iteration 0 eagerly and captures anew, and repeats
    the trace and final state bit for bit."""
    rs = _nccl_rank_solver()
    runs = []
    for _ in range(3):
        trace, graph = rs.optimize(6)
        runs.append((trace, [a.clone() for a in graph], dict(rs.stats)))
    for trace, graph, st in runs:
        assert st["capture"] and st["captures"] >= 1 and st["reused"] == 0
        assert 0 < st["replays"] < st["trials"]  # iteration 0 runs eagerly
        assert trace == runs[0][0] and all(torch.equal(a, b) for a, b in zip(graph, runs[0][1]))


@pytest.mark.gpu
def test_a_host_read_in_a_rank_trial_under_capture_raises(nccl_rank, monkeypatch):
    """A rank's trial that reads a device value on the host (``.item()``)
    cannot be captured: ``optimize()`` raises after the eager iteration 0,
    and it does not finish on the host loop or eagerly.  The card works
    afterwards."""
    from cuda_bundle_adjustment_tpu_torch.parallel import distributed as pd

    rs = _nccl_rank_solver()
    real = pd.RankSolver.trial

    def reads_back(self, sys_, lam):
        out = real(self, sys_, lam)
        out[1].item()
        return out

    class NoHostLoop:
        def __init__(self, *a, **k):
            raise AssertionError("the host loop ran")

    with monkeypatch.context() as mp:
        mp.setattr(pd.RankSolver, "trial", reads_back)
        mp.setattr(pd, "HostLoop", NoHostLoop)
        with pytest.raises(RuntimeError, match="capturing|capture"):
            rs.optimize(4)
        assert rs.stats == {}
    torch.cuda.synchronize()
    opt = optimizer_from_problem(make_ba_problem(num_poses=16, num_landmarks=120, seed=13))
    opt.optimize(4)
    assert opt.loop_stats["replays"] >= 3 and len(opt.batch_statistics().get()) == 4
