from .dcr import (
    surface_electrode_line,
    dipole_voltages,
    apparent_resistivity_2d,
    apparent_resistivity_halfspace,
    DCRSurvey,
    SurveyResult,
    halfspace_domain,
    survey_default_options,
)

__all__ = [
    "surface_electrode_line",
    "dipole_voltages",
    "apparent_resistivity_2d",
    "apparent_resistivity_halfspace",
    "DCRSurvey",
    "SurveyResult",
    "halfspace_domain",
    "survey_default_options",
]
