from .efield import EFieldResult, estimate_field
from .sensitivity import (
    JacobianResult,
    SensitivityResult,
    linearized_update,
    sensitivity_map,
    survey_jacobian,
)
from .dcr import (
    surface_electrode_line,
    dipole_voltages,
    apparent_resistivity_2d,
    apparent_resistivity_halfspace,
    DCRSurvey,
    SurveyResult,
    Pseudosection,
    halfspace_domain,
    dipole_dipole_pairs,
    run_pseudosection,
    survey_default_options,
)

__all__ = [
    "EFieldResult",
    "estimate_field",
    "SensitivityResult",
    "sensitivity_map",
    "JacobianResult",
    "survey_jacobian",
    "linearized_update",
    "surface_electrode_line",
    "dipole_voltages",
    "apparent_resistivity_2d",
    "apparent_resistivity_halfspace",
    "DCRSurvey",
    "SurveyResult",
    "Pseudosection",
    "halfspace_domain",
    "dipole_dipole_pairs",
    "run_pseudosection",
    "survey_default_options",
]
