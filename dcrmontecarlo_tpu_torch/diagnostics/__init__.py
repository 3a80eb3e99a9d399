"""Diagnostics of the walk (port of ``diagnostics/``): walk histories, the
occupancy profile and the per-step martingale audit, all on one-step
launches of the solver's own walk."""

from .history import WalkHistory, trace_walks
from .counters import OccupancyProfile, profile_occupancy
from .martingale import MartingaleReport, martingale_audit, grid_continuation

__all__ = [
    "WalkHistory",
    "trace_walks",
    "OccupancyProfile",
    "profile_occupancy",
    "MartingaleReport",
    "martingale_audit",
    "grid_continuation",
]
