"""Oracles for the port's physics checks: copies of the JAX package's
finite-volume, finite-element and cylinder-series oracles (numpy and scipy
only), and its pinned reference numbers."""

from .fdm import fdm_solve, FDMSolution
from .fem import fem_solve
from .pins import cylinder_oracle_pins, notebook_oracle_pins

__all__ = ["fdm_solve", "fem_solve", "FDMSolution", "notebook_oracle_pins",
           "cylinder_oracle_pins"]
