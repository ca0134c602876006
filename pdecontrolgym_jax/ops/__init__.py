from pdecontrolgym_jax.ops.pallas1d import KernelSpec, make_interval_fn
from pdecontrolgym_jax.ops.poisson2d import (
    dct2_basis,
    direct_pressure,
    direct_pressure_setup,
    jacobi_pressure,
    jacobi_pressure_flat,
)
from pdecontrolgym_jax.ops.tridiag import pcr, thomas

__all__ = [
    "KernelSpec",
    "dct2_basis",
    "direct_pressure",
    "direct_pressure_setup",
    "jacobi_pressure",
    "jacobi_pressure_flat",
    "make_interval_fn",
    "pcr",
    "thomas",
]
