from .problem import Problem
from .majorant import LocalMajorant, derive_local_majorant
from . import fields
from .fields import smooth_circle, constant, gaussian_bump, gaussian_dipole

__all__ = ["Problem", "fields", "LocalMajorant", "derive_local_majorant",
           "smooth_circle", "constant", "gaussian_bump", "gaussian_dipole"]
