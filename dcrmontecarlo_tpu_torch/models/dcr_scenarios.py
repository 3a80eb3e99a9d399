"""DCR survey scenarios (port of ``models/dcr_scenarios.py``).

* :func:`geophysical_scenario` — the 200 m survey: background 100 S/m,
  conductor 10 S/m at (-20, -30) r=10, conductor 1000 S/m at (25, -40)
  r=10, 1 A Gaussian dipole at +/-10 m, 9 surface electrodes.
* :func:`notebook_survey` — the 1000 m dipole-dipole survey: 21 electrodes
  at 40 m spacing, dipole at (+/-200, -9), background 1e-2 S/m.

The conductivities are bump-sum field specs, so the CUDA walk evaluates
them and their hand-derived ``sigma'``.
"""

from typing import Tuple

import numpy as np

from ..problems.fields import bump_sum, smooth_circle
from ..survey.dcr import DCRSurvey, surface_electrode_line

__all__ = ["geophysical_scenario", "notebook_survey"]


def _anomalous_conductivity(background, anomalies, sharpness):
    return bump_sum(background, [
        (value - background, smooth_circle(center, radius, sharpness))
        for center, radius, value in anomalies
    ])


def geophysical_scenario(sharpness: float = 0.5) -> Tuple[DCRSurvey, np.ndarray]:
    """200 m DCR survey; returns ``(survey, electrodes)``."""
    conductivity = _anomalous_conductivity(
        background=1e2,
        anomalies=[
            ((-20.0, -30.0), 10.0, 1e1),
            ((25.0, -40.0), 10.0, 1e3),
        ],
        sharpness=sharpness,
    )
    survey = DCRSurvey(
        half_width=100.0,
        depth=200.0,
        current_a=(-10.0, 0.0),
        current_b=(10.0, 0.0),
        conductivity=conductivity,
        current=1.0,
        source_width=0.5,
    )
    electrodes = surface_electrode_line((-40.0, 40.0), 10.0, y=0.0)
    return survey, electrodes


def notebook_survey(sharpness: float = 0.1) -> Tuple[DCRSurvey, np.ndarray]:
    """1000 m dipole-dipole survey, electrodes at y = -0.1. Its Robin
    ``auto`` mode resolves to the chord chain; set
    ``survey.local_majorant = "auto"`` for the accuracy configuration of
    ``bench.py --preset accuracy`` (two boxes around the anomalies)."""
    conductivity = _anomalous_conductivity(
        background=1e-2,
        anomalies=[
            ((-120.0, -80.0), 60.0, 1e-1),
            ((120.0, -80.0), 60.0, 1e-3),
        ],
        sharpness=sharpness,
    )
    survey = DCRSurvey(
        half_width=500.0,
        depth=1001.0,
        current_a=(-200.0, -9.0),
        current_b=(200.0, -9.0),
        conductivity=conductivity,
        current=1.0,
        source_width=5.0,
        surface_y=1.0,
    )
    electrodes = surface_electrode_line((-400.0, 400.0), 40.0, y=-0.1)
    return survey, electrodes
