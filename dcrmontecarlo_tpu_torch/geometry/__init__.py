from .polyline import Polyline, square_loop, circle_loop
from . import queries

__all__ = ["Polyline", "square_loop", "circle_loop", "queries"]
