from .rng import mix32, counter_uniform, counter_uniform_lanes, stream_seed
from .radial import sample_greens_radius, screened_radial_pdf

__all__ = ["mix32", "counter_uniform", "counter_uniform_lanes",
           "stream_seed", "sample_greens_radius", "screened_radial_pdf"]
