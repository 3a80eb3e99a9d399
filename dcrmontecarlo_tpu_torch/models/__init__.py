from .dcr_scenarios import geophysical_scenario, notebook_survey
from .manufactured import (
    autodiff_manufactured,
    interior_grid,
    polynomial_manufactured,
    trig_manufactured,
)
from .poisson import poisson_solve_points, poisson_square
from .topography import (
    drape_electrodes,
    rolling_hills,
    topographic_survey_problem,
)
from .varcoeff import varcoeff_solve_points, variable_coefficient_problem

__all__ = ["geophysical_scenario", "notebook_survey",
           "topographic_survey_problem", "drape_electrodes", "rolling_hills",
           "polynomial_manufactured", "trig_manufactured",
           "autodiff_manufactured", "interior_grid", "poisson_square",
           "poisson_solve_points", "variable_coefficient_problem",
           "varcoeff_solve_points"]
