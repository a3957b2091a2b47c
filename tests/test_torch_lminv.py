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


def _blocks(seed, La):
    """SPD 3x3 blocks and right-hand sides; every 17th row a zero block."""
    rng = np.random.default_rng(seed)
    G = rng.normal(size=(La, 3, 3))
    H9 = (np.einsum("nij,nkj->nik", G, G) + np.eye(3) * 1e-3).reshape(La, 9)
    bl = rng.normal(size=(La, 3))
    H9[::17] = 0.0
    bl[::17] = 0.0
    return H9, bl


@pytest.mark.parametrize("lam", [1e-6, 0.37, 1e4])
def test_damped_inverse_twin_matches_jax(lam):
    H9, bl = _blocks(3, 512)
    inv, y = lminv.damped_inverse(torch.as_tensor(H9), torch.as_tensor(bl), lam)
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
    inv, y = lminv.damped_inverse(torch.as_tensor(H9), torch.as_tensor(bl), lam)
    np.testing.assert_allclose(inv.numpy(), np.tile(DIAG9 / lam, (4, 1)), rtol=1e-15)
    np.testing.assert_allclose(y.numpy(), bl / lam, rtol=1e-15)
    assert bool(torch.isfinite(y).all())


def test_cuda_operands_never_reach_the_twin():
    """On anything but a CPU tensor the wrappers launch the kernel or raise."""
    meta = torch.empty((3, 9), dtype=torch.float64, device="meta")
    vec = torch.empty((3, 3), dtype=torch.float64, device="meta")
    with pytest.raises(NotImplementedError, match="no kernel for device"):
        lminv.damped_inverse(meta, vec, 1.0)
    with pytest.raises(NotImplementedError, match="no kernel for device"):
        lminv.sym3x3_mv(meta, vec)
    assert lminv.damped_inverse.launches == 0 and lminv.sym3x3_mv.launches == 0
