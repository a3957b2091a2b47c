"""The port's CUDA kernels against their plain twins on the card.

Every test here is marked ``gpu`` and skips without a CUDA device.  The file
imports no JAX, so it also runs on a GPU host without it:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q

(``--noconftest``: the suite's conftest configures JAX.)
"""

import numpy as np
import pytest
import torch

from cuda_bundle_adjustment_tpu_torch.io.arrays import optimizer_from_problem
from cuda_bundle_adjustment_tpu_torch.io.synthetic import make_ba_problem
from cuda_bundle_adjustment_tpu_torch.kernels import bandchol, gather, pairprod
from cuda_bundle_adjustment_tpu_torch.ops.components import flat_sym3x3_inv

torch.set_num_threads(1)


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _random_banded_spd(Pa, bw, SB, rng):
    n = Pa * 6
    A = np.zeros((n, n))
    for c in range(Pa):
        for d in range(min(bw + 1, Pa - c)):
            if d > 0 and rng.random() < 0.3:
                continue  # band holes
            A[c * 6 : (c + 1) * 6, (c + d) * 6 : (c + d + 1) * 6] = rng.normal(size=(6, 6))
    A = A + A.T
    A += np.eye(n) * (np.abs(A).sum(axis=1).max() + 1.0)
    band = np.zeros(((Pa + SB) * SB, 36), np.float32)
    for c in range(Pa):
        for d in range(min(bw + 1, Pa - c)):
            band[c * SB + d] = A[c * 6 : (c + 1) * 6, (c + d) * 6 : (c + d + 1) * 6].reshape(-1)
    return A, band


@pytest.mark.gpu
def test_gather_kernel_matches_twin():
    """Bit-exact, out-of-range indices (-1 and M) included."""
    dev = _cuda()
    rng = np.random.default_rng(0)
    table = torch.as_tensor(rng.standard_normal((1322, 12)), device=dev)
    idx = torch.as_tensor(rng.integers(-1, 1323, 50_000), device=dev)
    assert torch.equal(gather.gather_rows(table, idx), gather.gather_rows_plain(table, idx))


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


@pytest.mark.gpu
@pytest.mark.parametrize("bw,SB", [(5, 8), (11, 16), (20, 24), (47, 48)])
def test_band_kernels_match_twins(bw, SB):
    """f32 factor within 1e-5 x max|L| and solve within 1e-5 relative of the
    twins, 5e-5 of the f64 dense solve.  SB = 24..48 is the range of the TPU's
    v1 factor (B11), which this one kernel also covers."""
    dev = _cuda()
    rng = np.random.default_rng(SB)
    Pa = 60
    A, band = _random_banded_spd(Pa, bw, SB, rng)
    b = torch.as_tensor(rng.normal(size=(Pa, 6)).astype(np.float32), device=dev)
    band = torch.as_tensor(band, device=dev)
    L = bandchol.band_factor(band, Pa, SB)
    L_p = bandchol.band_factor_plain(band, Pa, SB)
    assert (L - L_p).abs().max() <= 1e-5 * L_p.abs().max()
    x = bandchol.band_solve(L, b, Pa, SB, bw)
    x_p = bandchol.band_solve_plain(L, b, Pa, SB, bw)
    assert (x - x_p).norm() <= 1e-5 * x_p.norm()
    x_dense = np.linalg.solve(A, b.cpu().numpy().reshape(-1)).reshape(Pa, 6)
    assert np.linalg.norm(x.cpu().numpy() - x_dense) <= 5e-5 * np.linalg.norm(x_dense)


@pytest.mark.gpu
def test_band_kernel_nonspd_goes_nonfinite():
    dev = _cuda()
    rng = np.random.default_rng(1)
    Pa, bw, SB = 9, 2, 8
    _, band = _random_banded_spd(Pa, bw, SB, rng)
    band[0] = -np.eye(6).reshape(-1)
    band = torch.as_tensor(band, device=dev)
    b = torch.as_tensor(rng.normal(size=(Pa, 6)).astype(np.float32), device=dev)
    x = bandchol.band_solve(bandchol.band_factor(band, Pa, SB), b, Pa, SB, bw)
    assert not bool(torch.isfinite(x).all())


@pytest.mark.gpu
def test_slice_on_gpu_matches_cpu_and_repeats():
    """The slice on the card against the CPU twins at rtol 1e-9, and a second
    run on the card bit for bit."""
    dev = _cuda()
    problem = make_ba_problem(num_poses=16, num_landmarks=120, seed=13)
    traces = []
    for d in (dev, dev, "cpu"):
        opt = optimizer_from_problem(problem, device=d)
        opt.optimize(10)
        traces.append([s.chi2 for s in opt.batch_statistics().get()])
    assert traces[0] == traces[1]
    np.testing.assert_allclose(traces[0], traces[2], rtol=1e-9)
