"""Hand-written Hopper kernels of the slice, each beside its plain twin.

=========================  =====================  ==================================
wrapper                    source                 replaces (JAX package)
=========================  =====================  ==================================
``gather_rows``   (B2)     ``csrc/gather.cu``     ``pallas/onehot.py`` ``expand``
``schur_pair_products``    ``csrc/pairprod.cu``   ``pallas/pairprod.py``
(B6)                                              ``_pairprod_call_v2``
``band_factor``   (B7)     ``csrc/bandchol.cu``   ``pallas/bandchol.py`` ``band_factor2``
``band_solve``    (B8)     ``csrc/bandchol.cu``   ``pallas/bandchol.py`` ``band_solve``
=========================  =====================  ==================================

Every wrapper counts its kernel launches in a plain integer attribute,
``wrapper.launches``, incremented only where the kernel is launched.
"""

from .bandchol import band_factor, band_solve
from .gather import gather_rows
from .pairprod import schur_pair_products

KERNELS = (gather_rows, schur_pair_products, band_factor, band_solve)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def launch_counts() -> dict[str, int]:
    return {k.__name__: k.launches for k in KERNELS}
