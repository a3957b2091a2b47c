"""Kernels B4 and B10: the port's plain twins (``kernels/lminv.py``) against
the JAX package on the CPU, on the same seeded numpy inputs.

* Against the XLA adjugate oracle (``ops/components.py flat_sym3x3_inv`` /
  ``flat_mv_3x3``) at rtol 1e-12: the same expressions in real f64.
* Against ``lminv_call`` / ``sym3x3_mv_call`` in interpret mode at the
  tolerances of tests/test_lminv.py (the Pallas kernels carry ~49-bit
  double-float pairs, so barely damped ill-conditioned blocks differ by
  conditioning noise).
* A zero Hll block with ``lam > 0`` inverts to ``I / lam`` with a finite y:
  the port has no determinant guard and needs none.
* ``lam`` reaches B4 as a 0-d f64 tensor (the kernel reads it on the
  device): the twin gives the same bits with the tensor as with the float,
  and the wrapper refuses a Python float.
* B4's operand preparation hands the solver's column blocks of ``[La, 12]``
  rows to the kernel uncopied, at their stride 12, and the kernel's tile
  walk (staging map in, shared rows, staging map out), replayed in numpy,
  gives the twin's result bit for bit at ragged sizes and odd offsets.

The CUDA kernels themselves are held against these twins, bit for bit, on
the card by tests/test_torch_gpu.py and chip_smoke.py.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from cuda_bundle_adjustment_tpu.ops.components import flat_mv_3x3, flat_sym3x3_inv
from cuda_bundle_adjustment_tpu.pallas.lminv import lminv_call, sym3x3_mv_call
from cuda_bundle_adjustment_tpu.pallas.terms import split_ff
from cuda_bundle_adjustment_tpu_torch.kernels import lminv

torch.set_num_threads(1)

DIAG9 = np.zeros(9)
DIAG9[[0, 4, 8]] = 1.0


def _lam(lam: float) -> torch.Tensor:
    """``lam`` as B4 takes it: a 0-d f64 tensor."""
    return torch.tensor(lam, dtype=torch.float64)


@pytest.mark.parametrize("lam", [1e-6, 0.37, 1e4, 1e12])
def test_damped_inverse_twin_takes_lam_as_a_tensor(lam):
    """The twin with ``lam`` as a 0-d f64 tensor gives the bits it gives
    with the Python float; the wrapper takes the tensor and refuses the
    float, a 0-d tensor of another dtype or shape, and one on another
    device."""
    H9, bl = _blocks(11, 300)
    H, b = torch.as_tensor(H9), torch.as_tensor(bl)
    by_tensor = lminv.damped_inverse_plain(H, b, _lam(lam))
    by_float = lminv.damped_inverse_plain(H, b, lam)
    assert all(torch.equal(x, y) for x, y in zip(by_tensor, by_float))
    assert all(torch.equal(x, y) for x, y in zip(lminv.damped_inverse(H, b, _lam(lam)), by_float))
    for bad in (lam, torch.tensor(lam, dtype=torch.float32), torch.tensor([lam], dtype=torch.float64)):
        with pytest.raises(TypeError, match="0-d f64 tensor"):
            lminv.damped_inverse(H, b, bad)
    with pytest.raises(ValueError, match="device"):
        lminv.damped_inverse(H, b, torch.tensor(lam, dtype=torch.float64, device="meta"))


def _blocks(seed, La):
    """SPD 3x3 blocks and right-hand sides; every 17th row a zero block."""
    rng = np.random.default_rng(seed)
    G = rng.normal(size=(La, 3, 3))
    H9 = (np.einsum("nij,nkj->nik", G, G) + np.eye(3) * 1e-3).reshape(La, 9)
    bl = rng.normal(size=(La, 3))
    H9[::17] = 0.0
    bl[::17] = 0.0
    return H9, bl


def _solver_views(H9, bl, offset):
    """``H9`` and ``bl`` as the solver hands them to B4: column blocks of one
    ``[La, 12]`` buffer, here ``offset`` doubles into its storage."""
    La = H9.shape[0]
    buf = torch.zeros(offset + La * 12, dtype=torch.float64)
    lm_acc = buf[offset:].view(La, 12)
    lm_acc[:, :9] = torch.as_tensor(H9)
    lm_acc[:, 9:] = torch.as_tensor(bl)
    return lm_acc[:, :9], lm_acc[:, 9:]


@pytest.mark.parametrize("lam,views", [
    pytest.param(1e-6, False, id="1e-06"),
    pytest.param(0.37, False, id="0.37"),
    pytest.param(1e4, False, id="10000.0"),
    pytest.param(1e-6, True, id="1e-06-solver-views"),
    pytest.param(0.37, True, id="0.37-solver-views"),
    pytest.param(1e4, True, id="10000.0-solver-views"),
])
def test_damped_inverse_twin_matches_jax(lam, views):
    H9, bl = _blocks(3, 512)
    if views:
        Hll_t, bl_t = _solver_views(H9, bl, offset=5)
        assert Hll_t.stride() == (12, 1) and bl_t.stride() == (12, 1)
    else:
        Hll_t, bl_t = torch.as_tensor(H9), torch.as_tensor(bl)
    inv, y = lminv.damped_inverse(Hll_t, bl_t, _lam(lam))
    inv, y = inv.numpy(), y.numpy()
    assert inv.shape == (512, 9) and y.shape == (512, 3)

    ref_inv = np.asarray(flat_sym3x3_inv(jnp.asarray(H9 + lam * DIAG9)))
    ref_y = np.asarray(flat_mv_3x3(jnp.asarray(ref_inv), jnp.asarray(bl)))
    np.testing.assert_allclose(inv, ref_inv, rtol=1e-12)
    np.testing.assert_allclose(y, ref_y, rtol=1e-12, atol=1e-12 * np.abs(ref_y).max())

    lm_cm = jnp.asarray(np.concatenate([H9, bl], axis=1).T)
    inv_h, inv_l, y_h, y_l = lminv_call(lm_cm, jnp.asarray(lam, jnp.float64), interpret=True)
    k_inv = (np.asarray(inv_h, np.float64) + np.asarray(inv_l, np.float64)).T
    k_y = (np.asarray(y_h, np.float64) + np.asarray(y_l, np.float64)).T
    scale = np.abs(k_inv).max()
    np.testing.assert_allclose(inv, k_inv, atol=1e-12 * scale, rtol=1e-9)
    np.testing.assert_allclose(y, k_y, atol=1e-12 * (np.abs(k_y).max() or 1.0), rtol=1e-9)


def test_sym3x3_mv_twin_matches_jax():
    rng = np.random.default_rng(5)
    La = 256
    G = rng.normal(size=(La, 3, 3))
    H9 = (np.einsum("nij,nkj->nik", G, G) + np.eye(3)).reshape(La, 9)
    inv = np.array(flat_sym3x3_inv(jnp.asarray(H9)))
    c = rng.normal(size=(La, 3))
    got = lminv.sym3x3_mv(torch.as_tensor(inv), torch.as_tensor(c)).numpy()

    ref = np.asarray(flat_mv_3x3(jnp.asarray(inv), jnp.asarray(c)))
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-12 * np.abs(ref).max())

    x_h, x_l = sym3x3_mv_call(
        *split_ff(jnp.asarray(inv.T)), *split_ff(jnp.asarray(c.T)), interpret=True
    )
    kx = (np.asarray(x_h, np.float64) + np.asarray(x_l, np.float64)).T
    np.testing.assert_allclose(got, kx, atol=1e-12 * (np.abs(kx).max() or 1.0), rtol=1e-11)


@pytest.mark.parametrize("lam", [1e-6, 0.37, 1e4])
def test_zero_block_inverts_to_identity_over_lambda(lam):
    """An all-outlier landmark under Tukey has Hll = 0: the damping alone
    keeps it invertible."""
    H9, bl = np.zeros((4, 9)), np.arange(12.0).reshape(4, 3)
    inv, y = lminv.damped_inverse(torch.as_tensor(H9), torch.as_tensor(bl), _lam(lam))
    np.testing.assert_allclose(inv.numpy(), np.tile(DIAG9 / lam, (4, 1)), rtol=1e-15)
    np.testing.assert_allclose(y.numpy(), bl / lam, rtol=1e-15)
    assert bool(torch.isfinite(y).all())


def test_cuda_operands_never_reach_the_twin():
    """On anything but a CPU tensor the wrappers launch the kernel or raise."""
    meta = torch.empty((3, 9), dtype=torch.float64, device="meta")
    vec = torch.empty((3, 3), dtype=torch.float64, device="meta")
    with pytest.raises(NotImplementedError, match="no kernel for device"):
        lminv.damped_inverse(meta, vec, torch.ones((), dtype=torch.float64, device="meta"))
    with pytest.raises(NotImplementedError, match="no kernel for device"):
        lminv.sym3x3_mv(meta, vec)
    assert lminv.damped_inverse.launches == 0 and lminv.sym3x3_mv.launches == 0


def test_damped_inverse_takes_the_solvers_views_without_a_copy():
    """The solver's ``lm_acc[:, :9]`` and ``lm_acc[:, 9:]`` reach the launch
    with their own storage and row stride 12; contiguous operands with
    strides 9 and 3; an operand whose entries are not adjacent in a row
    (inner stride other than 1) is copied to contiguous rows; the wrong type
    or shape is refused."""
    La = 389
    lm_acc = torch.as_tensor(np.random.default_rng(1).normal(size=(La, 12)))
    Hll, bl = lm_acc[:, :9], lm_acc[:, 9:]
    h, ldh, b, ldb = lminv.damped_inverse_operands(Hll, bl)
    assert (h.data_ptr(), b.data_ptr()) == (Hll.data_ptr(), bl.data_ptr())
    assert b.data_ptr() == lm_acc.data_ptr() + 9 * 8
    assert (ldh, ldb) == (12, 12) and h.stride(1) == b.stride(1) == 1

    Hc, bc = Hll.contiguous(), bl.contiguous()
    h, ldh, b, ldb = lminv.damped_inverse_operands(Hc, bc)
    assert (h.data_ptr(), b.data_ptr()) == (Hc.data_ptr(), bc.data_ptr())
    assert (ldh, ldb) == (9, 3)

    cm = lm_acc.t().contiguous().t()  # component-major storage: inner stride La
    assert cm[:, :9].stride() == (1, La)
    h, ldh, b, ldb = lminv.damped_inverse_operands(cm[:, :9], cm[:, 9:])
    assert h.is_contiguous() and b.is_contiguous() and (ldh, ldb) == (9, 3)
    assert h.data_ptr() != cm.data_ptr()
    assert torch.equal(h, Hll) and torch.equal(b, bl)

    with pytest.raises(TypeError):
        lminv.damped_inverse_operands(Hll.float(), bl)
    with pytest.raises(ValueError):
        lminv.damped_inverse_operands(Hll, bl[1:])
    with pytest.raises(ValueError):
        lminv.damped_inverse_operands(lm_acc[:, :8], bl)


def _tile_walk(Hll, bl, lam, T=128, ROW=13):
    """B4's kernel replayed in numpy: per block of ``T`` landmarks, entry
    ``k = t + j T`` of the tile staged from ``base + (k // w) ld + k % w`` of
    the operand's storage into shared row ``k // w`` (``ROW`` doubles, bl at
    columns 9-11), each landmark computed from its shared row (the twin's
    arithmetic), the rows written back to contiguous ``inv`` and ``y`` at
    ``base w + k``."""
    Hll, ldh, bl, ldb = lminv.damped_inverse_operands(Hll, bl)
    mem_h = torch.empty(0, dtype=torch.float64).set_(Hll.untyped_storage()).numpy()
    mem_b = torch.empty(0, dtype=torch.float64).set_(bl.untyped_storage()).numpy()
    off_h, off_b = Hll.storage_offset(), bl.storage_offset()
    La = Hll.shape[0]
    inv, y = np.full(La * 9, np.nan), np.full(La * 3, np.nan)
    for base in range(0, La, T):
        n = min(T, La - base)
        s = np.full((T, ROW), np.nan)
        for j in range(9):
            k = np.arange(T) + j * T
            k = k[k < 9 * n]
            s[k // 9, k % 9] = mem_h[off_h + (base + k // 9) * ldh + k % 9]
        for j in range(3):
            k = np.arange(T) + j * T
            k = k[k < 3 * n]
            s[k // 3, 9 + k % 3] = mem_b[off_b + (base + k // 3) * ldb + k % 3]
        i, v = lminv.damped_inverse_plain(torch.as_tensor(s[:n, :9]),
                                          torch.as_tensor(s[:n, 9:12]), lam)
        s[:n, :9], s[:n, 9:12] = i.numpy(), v.numpy()
        for j in range(9):
            k = np.arange(T) + j * T
            k = k[k < 9 * n]
            inv[base * 9 + k] = s[k // 9, k % 9]
        for j in range(3):
            k = np.arange(T) + j * T
            k = k[k < 3 * n]
            y[base * 3 + k] = s[k // 3, 9 + k % 3]
    return inv.reshape(La, 9), y.reshape(La, 3)


@pytest.mark.parametrize("layout", ["contiguous", "solver-views"])
@pytest.mark.parametrize("La", [1, 127, 128, 129, 389])
def test_lminv_tile_walk_matches_twin(La, layout):
    """Every entry staged in and written out exactly once, ragged last
    tile included, at the solver's stride and an odd offset: the walk gives
    ``damped_inverse_plain``'s result bit for bit."""
    H9, bl = _blocks(7, La)
    lam = 0.37
    if layout == "contiguous":
        Hll_t, bl_t = torch.as_tensor(H9), torch.as_tensor(bl)
    else:
        Hll_t, bl_t = _solver_views(H9, bl, offset=3)
    inv, y = _tile_walk(Hll_t, bl_t, lam)
    want_inv, want_y = lminv.damped_inverse_plain(torch.as_tensor(H9), torch.as_tensor(bl), lam)
    assert np.array_equal(inv, want_inv.numpy()) and np.array_equal(y, want_y.numpy())
