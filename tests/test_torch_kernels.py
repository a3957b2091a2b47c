"""The PyTorch port's kernel twins (kernels B2, B6, B7, B8, and B7 at the
band heights of B11) against the JAX package's Pallas kernels, run in interpret mode on the CPU, and against the
XLA triple path.  Same inputs, made from a seed with numpy, go to both sides.
The CUDA kernels themselves are held against their twins on the card by
tests/test_torch_gpu.py and chip_smoke.py.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from chip_smoke import pair_products_in_plan_order, random_banded_spd
from torch_fragile import FRAGILE_PAIR_PROBLEMS, fragile_pair_problem
from cuda_bundle_adjustment_tpu.io.arrays import optimizer_from_problem as jax_optimizer
from cuda_bundle_adjustment_tpu.io.synthetic import make_ba_problem
from cuda_bundle_adjustment_tpu.ops.components import flat_sym3x3_inv as jax_sym3x3_inv
from cuda_bundle_adjustment_tpu.solver import block_solver as jbs
from cuda_bundle_adjustment_tpu_torch.io.arrays import optimizer_from_problem
from cuda_bundle_adjustment_tpu_torch.kernels import bandchol, gather, pairprod
from cuda_bundle_adjustment_tpu_torch.solver import block_solver as tbs
from cuda_bundle_adjustment_tpu_torch.types import SystemBlocks

torch.set_num_threads(1)


def _t(a):
    return torch.as_tensor(np.array(a))


def _jax_system_in_port_order(js, jsys):
    """The JAX solver's system (group-layout edge and landmark order) in the
    problem's own order, as the port packs it."""
    lay = js.group_layout
    perm = lay.edge_perm
    rows = perm >= 0
    E = int(perm[rows].max()) + 1
    Hpl = np.zeros((E, 18))
    Hpl[perm[rows]] = np.asarray(jsys.Hpl)[rows]
    ren = lay.lm_renumber[: js.La_real]
    return SystemBlocks(
        Hpp=_t(jsys.Hpp), bp=_t(jsys.bp), Hll=_t(np.asarray(jsys.Hll)[ren]),
        bl=_t(np.asarray(jsys.bl)[ren]), Hpl=_t(Hpl),
    )


def _systems(problem):
    """(JAX solver, its system, port solver, JAX system in port order)."""
    js = jax_optimizer(problem).solver
    js.build_structure()
    _, jsys = js.head()
    ts = optimizer_from_problem(problem, device="cpu").solver
    ts.build_structure()
    return js, jsys, ts, _jax_system_in_port_order(js, jsys)


# -- B2 ---------------------------------------------------------------------


def _expand_case(M, K, E, dtype=np.float64):
    """The twin bit for bit ``onehot.expand`` (interpret) on a seeded table
    of ``dtype``, the sentinel index ``M`` (a zero row) included."""
    from cuda_bundle_adjustment_tpu.pallas.onehot import build_expand_plan, expand

    rng = np.random.default_rng(M)
    table = rng.standard_normal((M, K)).astype(dtype)
    idx = rng.integers(0, M + 1, E)  # == M: the zero-row sentinel
    idx[0] = M
    plan = build_expand_plan(idx, M, chunk=1024)
    want = np.asarray(expand(jnp.asarray(table), plan, interpret=True))  # [K, E]
    got = gather.gather_rows(_t(table), _t(idx)).numpy()  # [E, K]
    assert got.dtype == want.dtype == dtype
    np.testing.assert_array_equal(got.T, want)


@pytest.mark.parametrize("M,K,E", [(40, 12, 300), (300, 3, 2000)])
def test_gather_twin_matches_pallas_expand(M, K, E):
    """Bit-exact against ``onehot.expand`` (interpret), sentinel rows included."""
    _expand_case(M, K, E)


@pytest.mark.parametrize("M,K,E,dtype", [
    (40, 12, 300, np.float32),  # expand's f32 table: one f32 summand (onehot.py:274-277)
    (300, 3, 2001, np.float64),  # the landmark width, an odd number of rows
    (300, 3, 2001, np.float32),
])
def test_gather_twin_matches_pallas_expand_f32_and_odd_rows(M, K, E, dtype):
    """As above for an f32 table and the landmark table's K = 3 at an odd E
    (an output that ends inside the kernel's 16-byte chunk)."""
    _expand_case(M, K, E, dtype)


# -- B6 ---------------------------------------------------------------------


def test_pairprod_twin_matches_xla_triple_path():
    """Pair products on the JAX system's own Hpl/inv(Hll) against the JAX
    package's XLA triple path (CPU, real f64).  Tolerance 1e-12 x max|block|:
    the two sum the same products in different orders."""
    problem = make_ba_problem(
        num_poses=16, num_landmarks=120, mean_obs_per_landmark=4.0, kind="mono", seed=13
    )
    js, jsys, ts, psys = _systems(problem)
    lam = 1e-3
    ref_blocks, _, _ = jbs.schur_reduce(
        jsys, jnp.asarray(lam), js.plan, js.Pa, js.La, js.schur.nnz_blocks
    )
    Hpp_d = np.asarray(jsys.Hpp) + lam * np.eye(6)
    ref = -np.asarray(ref_blocks)
    ref[np.asarray(js.schur.diag_pos)] += Hpp_d.reshape(-1, 36)  # pair products only

    invHll = _t(jax_sym3x3_inv(jnp.asarray(psys.Hll.numpy()) + lam * np.array(
        [1.0, 0, 0, 0, 1, 0, 0, 0, 1])))
    plan = ts.plan
    got = pairprod.schur_pair_products(
        psys.Hpl, invHll, plan.ba_lm_idx, plan.tri_ei, plan.tri_ej, plan.tri_offsets
    ).numpy()
    np.testing.assert_array_equal(ts.schur.blk_row, js.schur.blk_row)
    np.testing.assert_array_equal(ts.schur.blk_col, js.schur.blk_col)
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12 * scale)


def test_pairprod_twin_matches_pallas_kernel():
    """Port blocks against the JAX kernel path with ``schur_pair_rows_v2`` in
    interpret mode.  Tolerance f32-relative, as tests/test_groups.py: interpret
    mode loses the kernel's double-float compensation."""
    import cuda_bundle_adjustment_tpu.pallas.pairprod as pp

    problem = make_ba_problem(
        num_poses=12, num_landmarks=80, exact_obs_per_landmark=4, kind="mono", seed=3
    )
    js, jsys, ts, psys = _systems(problem)
    lam = 1e-3
    kplan = js.plan._replace(layout=js.plan.layout._replace(use_kernel=True))
    orig = pp.schur_pair_rows_v2
    pp.schur_pair_rows_v2 = lambda H, I, p_, interpret=True: orig(H, I, p_, interpret=True)
    try:
        ref_blocks, ref_bsc, _ = jbs.schur_reduce(
            jsys, jnp.asarray(lam), kplan, js.Pa, js.La, js.schur.nnz_blocks
        )
    finally:
        pp.schur_pair_rows_v2 = orig
    blocks, bsc, _ = tbs.schur_reduce(psys, lam, ts.plan)
    scale = float(np.abs(np.asarray(ref_blocks)).max())
    np.testing.assert_allclose(blocks.numpy(), np.asarray(ref_blocks), atol=2e-5 * scale)
    bscale = float(np.abs(np.asarray(ref_bsc)).max())
    np.testing.assert_allclose(bsc.numpy(), np.asarray(ref_bsc), atol=1e-9 * bscale)


def _walk_pair_plan(prod, plan, nnz):
    """Block sums of per-triple products as kernel B6 forms them: an item's
    triples dealt round 16 slots, each slot summed in order and the slots by
    a tree, a lone item straight into its block's row, the others into
    scratch rows that are then added in item order."""
    items, block_off = plan.items.numpy(), plan.block_off.numpy()
    out = np.full((nnz, 36), np.nan)
    scratch = np.full((items.shape[0], 36), np.nan)
    seen = np.zeros(prod.shape[0], dtype=int)
    for first, last, target, _ in items:
        assert 0 < last - first <= pairprod.ITEM
        seen[first:last] += 1
        slots = np.zeros((16, 36))
        for k, t in enumerate(range(first, last)):
            slots[k % 16] = slots[k % 16] + prod[t]
        for half in (8, 4, 2, 1):
            slots = slots[:half] + slots[half : 2 * half]
        if target < 0:
            scratch[-1 - target] = slots[0]
        else:
            out[target] = slots[0]
    assert np.all(seen == 1)
    for k in range(nnz):
        c0, c1 = block_off[k], block_off[k + 1]
        if c1 - c0 != 1:
            acc = np.zeros(36)
            for c in range(c0, c1):
                acc = acc + scratch[c]
            out[k] = acc
    return out


@pytest.mark.parametrize("case", FRAGILE_PAIR_PROBLEMS)
def test_pairprod_twin_matches_xla_at_fragile_shapes(case):
    """The B6 twin against the JAX package's XLA triple path at 1e-12 x
    max|block| on the shapes of ``torch_fragile.fragile_pair_problem``, and kernel B6's plan
    (``make_pair_plan``), walked in numpy as the kernel walks it, against
    the twin at the same tolerance (the items associate the sum
    differently)."""
    problem = fragile_pair_problem(case, make_ba_problem)
    js, jsys, ts, psys = _systems(problem)
    lam = 1e-5 * float(np.asarray(jsys.Hll)[:, [0, 4, 8]].max())
    ref_blocks, _, _ = jbs.schur_reduce(
        jsys, jnp.asarray(lam), js.plan, js.Pa, js.La, js.schur.nnz_blocks
    )
    ref = -np.asarray(ref_blocks)
    ref[np.asarray(js.schur.diag_pos)] += (np.asarray(jsys.Hpp) + lam * np.eye(6)).reshape(-1, 36)

    invHll = _t(jax_sym3x3_inv(jnp.asarray(psys.Hll.numpy()) + lam * np.array(
        [1.0, 0, 0, 0, 1, 0, 0, 0, 1])))
    plan = ts.plan
    args = (psys.Hpl, invHll, plan.ba_lm_idx, plan.tri_ei, plan.tri_ej, plan.tri_offsets)
    got = pairprod.schur_pair_products(*args).numpy()
    np.testing.assert_array_equal(ts.schur.blk_row, js.schur.blk_row)
    np.testing.assert_array_equal(ts.schur.blk_col, js.schur.blk_col)
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12 * scale)

    counts = np.diff(plan.tri_offsets.numpy())
    if case == "duplicate_observations":
        dup = plan.tri_ei[plan.tri_ei != plan.tri_ej]
        pose_of = plan.ba_pose_idx
        assert bool((pose_of[plan.tri_ei] == pose_of[plan.tri_ej]).any()) and dup.numel() > 0
    else:
        assert counts.min() == 1 and counts.max() >= 2600

    assert plan.pair_plan is None and plan.lin_plan is None  # made for the card only
    pp = pairprod.make_pair_plan(plan.ba_lm_idx, plan.tri_ei, plan.tri_ej, plan.tri_offsets)
    assert all(t.dtype == torch.int32 for t in pp[:5])
    assert (pp.E, pp.T, pp.nnz) == (plan.ba_lm_idx.shape[0], plan.tri_ei.shape[0], got.shape[0])
    np.testing.assert_array_equal(pp.tri_lm.numpy(), plan.ba_lm_idx[plan.tri_ei].numpy())
    W = psys.Hpl.numpy().reshape(-1, 6, 3) @ invHll.numpy()[plan.ba_lm_idx.numpy()].reshape(-1, 3, 3)
    prod = np.einsum("tik,tjk->tij", W[pp.tri_ei.numpy()],
                     psys.Hpl.numpy().reshape(-1, 6, 3)[pp.tri_ej.numpy()]).reshape(-1, 36)
    walked = _walk_pair_plan(prod, pp, got.shape[0])
    np.testing.assert_allclose(walked, got, rtol=0, atol=1e-12 * scale)
    # chip_smoke.py's tensor form of the same walk (its products come from
    # another einsum, so not bit for bit)
    ordered = pair_products_in_plan_order(*args, pp).numpy()
    np.testing.assert_allclose(ordered, walked, rtol=0, atol=1e-14 * scale)
    lone = np.diff(pp.block_off.numpy()) == 1
    assert lone.any() and (case == "duplicate_observations" or not lone.all())


# -- B7 / B8 ----------------------------------------------------------------


@pytest.mark.parametrize("Pa,bw,SB", [(23, 4, 8), (19, 11, 16)])
def test_band_twins_match_pallas(Pa, bw, SB):
    """Factor against ``band_factor2`` and solve against ``band_solve``
    (interpret), at f32 tolerance: 1e-5 x max|L| for the factor (as
    tests/test_bandchol.py), 1e-5 relative for the solve, 5e-5 against the
    f64 dense solve."""
    from cuda_bundle_adjustment_tpu.pallas.bandchol import band_factor2, band_solve

    rng = np.random.default_rng(Pa)
    A, band = random_banded_spd(Pa, bw, SB, rng)
    b = rng.normal(size=(Pa, 6)).astype(np.float32)

    L_ref = np.asarray(band_factor2(jnp.asarray(band), Pa, SB, interpret=True))
    L_got = bandchol.band_factor(_t(band), Pa, SB)
    live = Pa * SB
    np.testing.assert_allclose(
        L_got.numpy()[:live], L_ref[:live], atol=1e-5 * max(np.abs(L_ref).max(), 1.0)
    )

    x_ref = np.asarray(band_solve(jnp.asarray(L_ref), jnp.asarray(b), Pa, SB, bw, interpret=True))
    x_got = bandchol.band_solve(_t(L_ref), _t(b), Pa, SB, bw).numpy()
    assert np.linalg.norm(x_got - x_ref) / np.linalg.norm(x_ref) < 1e-5
    x_dense = np.linalg.solve(A, b.reshape(-1)).reshape(Pa, 6)
    rel = np.linalg.norm(bandchol.band_solve(L_got, _t(b), Pa, SB, bw).numpy() - x_dense)
    assert rel / np.linalg.norm(x_dense) < 5e-5


@pytest.mark.parametrize("Pa,bw,SB", [(30, 20, 24), (36, 31, 32), (52, 47, 48)])
def test_wide_band_twins_match_pallas_v1(Pa, bw, SB):
    """The band heights of the wide-band path (16 < SB <= 48), where the JAX
    package runs ``band_factor`` (v1): the factor twin against it and the
    solve twin against ``band_solve`` (interpret), at the f32 tolerances of
    :func:`test_band_twins_match_pallas`."""
    from cuda_bundle_adjustment_tpu.pallas.bandchol import band_factor, band_solve

    rng = np.random.default_rng(SB)
    A, band = random_banded_spd(Pa, bw, SB, rng)
    b = rng.normal(size=(Pa, 6)).astype(np.float32)

    L_ref = np.asarray(band_factor(jnp.asarray(band), Pa, SB, bw, interpret=True))
    L_got = bandchol.band_factor(_t(band), Pa, SB)
    live = Pa * SB
    np.testing.assert_allclose(
        L_got.numpy()[:live], L_ref[:live], atol=1e-5 * max(np.abs(L_ref).max(), 1.0)
    )
    x_ref = np.asarray(band_solve(jnp.asarray(L_ref), jnp.asarray(b), Pa, SB, bw, interpret=True))
    x_got = bandchol.band_solve(_t(L_ref), _t(b), Pa, SB, bw).numpy()
    assert np.linalg.norm(x_got - x_ref) / np.linalg.norm(x_ref) < 1e-5
    x_dense = np.linalg.solve(A, b.reshape(-1)).reshape(Pa, 6)
    rel = np.linalg.norm(bandchol.band_solve(L_got, _t(b), Pa, SB, bw).numpy() - x_dense)
    assert rel / np.linalg.norm(x_dense) < 5e-5


def test_band_twin_nonspd_goes_nonfinite():
    """A non-SPD band surfaces as non-finite output (the LM rejection
    signal), not as silently wrong numbers."""
    rng = np.random.default_rng(1)
    Pa, bw, SB = 9, 2, 8
    _, band = random_banded_spd(Pa, bw, SB, rng)
    band[0] = -np.eye(6).reshape(-1)
    b = rng.normal(size=(Pa, 6)).astype(np.float32)
    L = bandchol.band_factor(_t(band), Pa, SB)
    x = bandchol.band_solve(L, _t(b), Pa, SB, bw)
    assert not bool(torch.isfinite(x).all())
