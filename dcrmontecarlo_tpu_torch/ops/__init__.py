from .bessel import i0, i0e, k0, k0e, i1, i1e, k1, k1e, ii0e, ik0
from .greens import (
    greens_2d,
    greens_norm_2d,
    screened_greens_2d,
    screened_greens_norm_2d,
    screened_interior_prob,
    screened_greens_wall_ratio,
    screened_chord_integral,
)

__all__ = [
    "i0", "i0e", "k0", "k0e", "i1", "i1e", "k1", "k1e", "ii0e", "ik0",
    "greens_2d", "greens_norm_2d", "screened_greens_2d",
    "screened_greens_norm_2d", "screened_interior_prob",
    "screened_greens_wall_ratio", "screened_chord_integral",
]
