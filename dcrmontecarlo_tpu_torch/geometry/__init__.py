from .polyline import Polyline, square_loop, circle_loop, func_to_polyline
from . import queries
from .queries import (
    cross2,
    distance,
    closest_point,
    closest_point_chord,
    is_silhouette,
    silhouette_distance,
    ray_intersection,
    first_hit,
)

__all__ = ["Polyline", "square_loop", "circle_loop", "func_to_polyline",
           "queries", "cross2", "distance", "closest_point",
           "closest_point_chord", "is_silhouette", "silhouette_distance",
           "ray_intersection", "first_hit"]
