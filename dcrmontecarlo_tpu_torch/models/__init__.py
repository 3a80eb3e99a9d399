from .dcr_scenarios import geophysical_scenario, notebook_survey

__all__ = ["geophysical_scenario", "notebook_survey"]
