from .dcr_scenarios import geophysical_scenario, notebook_survey
from .topography import (
    drape_electrodes,
    rolling_hills,
    topographic_survey_problem,
)

__all__ = ["geophysical_scenario", "notebook_survey",
           "topographic_survey_problem", "drape_electrodes", "rolling_hills"]
