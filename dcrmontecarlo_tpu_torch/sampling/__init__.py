from .rng import mix32, counter_uniform, counter_uniform_lanes, stream_seed
from .radial import greens_radial_pdf, sample_greens_radius, \
    sample_screened_radius_exact, sample_screened_radius_fast, \
    sample_screened_radius_transport, screened_radial_pdf
from .mis import RadialDistribution, mis_sample, uniform_radial

__all__ = ["mix32", "counter_uniform", "counter_uniform_lanes",
           "stream_seed", "sample_greens_radius", "greens_radial_pdf",
           "sample_screened_radius_exact", "sample_screened_radius_fast",
           "sample_screened_radius_transport", "screened_radial_pdf",
           "RadialDistribution", "uniform_radial", "mis_sample"]
