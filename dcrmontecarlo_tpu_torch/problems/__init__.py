from .problem import Problem
from . import fields

__all__ = ["Problem", "fields"]
