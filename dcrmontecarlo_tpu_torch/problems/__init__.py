from .problem import Problem
from .majorant import LocalMajorant, derive_local_majorant
from . import fields

__all__ = ["Problem", "fields", "LocalMajorant", "derive_local_majorant"]
