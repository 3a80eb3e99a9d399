"""Oracles for the port's physics checks: a copy of the JAX package's
finite-volume solver (numpy and scipy only)."""

from .fdm import FDMSolution, fdm_solve

__all__ = ["fdm_solve", "FDMSolution"]
