from .polyline import Polyline, square_loop, circle_loop, func_to_polyline
from . import queries

__all__ = ["Polyline", "square_loop", "circle_loop", "func_to_polyline",
           "queries"]
