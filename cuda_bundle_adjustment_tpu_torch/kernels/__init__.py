"""Hand-written Hopper kernels of the slice, each beside its plain twin.

=============================  =====================  ==================================
wrapper                        source                 replaces (JAX package)
=============================  =====================  ==================================
``chi_edges``          (B1)    ``csrc/terms.cu``      ``pallas/terms.py`` ``chi_class_call``
``gather_rows``        (B2)    ``csrc/gather.cu``     ``pallas/onehot.py`` ``expand``
``linearise``          (B3)    ``csrc/terms.cu``      ``pallas/terms.py`` ``terms_class_call``
``damped_inverse``     (B4)    ``csrc/lminv.cu``      ``pallas/lminv.py`` ``lminv_call``
``hpl_mv_segment_sum`` (B5)    ``csrc/schurvec.cu``   ``pallas/schurvec.py``
                                                      ``hpl_mv_class_call``
``schur_pair_products`` (B6)   ``csrc/pairprod.cu``   ``pallas/pairprod.py``
                                                      ``_pairprod_call_v2``
``band_factor``        (B7,    ``csrc/bandchol.cu``   ``pallas/bandchol.py`` ``band_factor2``
                       B11)                           (SB <= 16) and ``band_factor`` (wider)
``band_solve``         (B8)    ``csrc/bandchol.cu``   ``pallas/bandchol.py`` ``band_solve``
``hpl_mtv_segment_sum`` (B9)   ``csrc/schurvec.cu``   ``pallas/schurvec.py``
                                                      ``hpl_mtv_class_call``
``sym3x3_mv``          (B10)   ``csrc/lminv.cu``      ``pallas/lminv.py`` ``sym3x3_mv_call``
=============================  =====================  ==================================

Every wrapper counts its kernel launches in a plain integer attribute,
``wrapper.launches``, incremented only where the kernel is launched.
"""

from .bandchol import band_factor, band_solve
from .gather import gather_rows
from .lminv import damped_inverse, sym3x3_mv
from .pairprod import PairPlan, make_pair_plan, schur_pair_products
from .schurvec import hpl_mtv_segment_sum, hpl_mv_segment_sum
from .terms import LinearisePlan, chi_edges, linearise, make_linearise_plan

KERNELS = (
    chi_edges, gather_rows, linearise, damped_inverse, hpl_mv_segment_sum,
    schur_pair_products, band_factor, band_solve, hpl_mtv_segment_sum, sym3x3_mv,
)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def launch_counts() -> dict[str, int]:
    return {k.__name__: k.launches for k in KERNELS}


def add_launch_counts(delta: dict[str, int]) -> None:
    """Add ``delta`` (by wrapper name) to the counts: a CUDA graph's replay
    launches what its capture counted (``solver/fused.py``)."""
    for k in KERNELS:
        k.launches += delta.get(k.__name__, 0)
