"""Topographic DCR survey (port of ``models/topography.py``).

DC resistivity over terrain: a Neumann ground surface that follows
``height(x)`` (many segments and interior vertices, so the walk runs its
table form with silhouette vertices), Dirichlet far-field sides and
bottom, and electrodes draped on the terrain, nudged inward along the
local downhill normal. The conductivity and the source are field specs,
so the CUDA walk evaluates them.
"""

from typing import Callable, Tuple

import numpy as np

from ..geometry.polyline import Polyline, func_to_polyline
from ..problems import fields
from ..problems.problem import Problem
from .dcr_scenarios import _anomalous_conductivity

__all__ = ["topographic_survey_problem", "drape_electrodes", "rolling_hills"]


def rolling_hills(amplitude: float = 8.0, wavelength: float = 80.0):
    """Gentle sinusoidal terrain ``h(x) = A sin(2 pi x / L)`` (numpy)."""

    def h(x):
        return amplitude * np.sin(2.0 * np.pi * x / wavelength)

    return h


def drape_electrodes(height_fn: Callable, xs, nudge: float = 0.25) -> np.ndarray:
    """Electrode positions on the terrain, nudged inward along the local
    (downhill) surface normal so walks start strictly inside the domain."""
    xs = np.asarray(xs, np.float64)
    h = np.asarray(height_fn(xs), np.float64)
    dx = 1e-3
    slope = (np.asarray(height_fn(xs + dx))
             - np.asarray(height_fn(xs - dx))) / (2 * dx)
    # inward normal of y = h(x): (slope, -1) / sqrt(1 + slope^2)
    norm = np.sqrt(1.0 + slope * slope)
    ex = xs + nudge * slope / norm
    ey = h - nudge / norm
    return np.stack([ex, ey], axis=1).astype(np.float32)


def topographic_survey_problem(
    height_fn: Callable = None,
    half_width: float = 200.0,
    depth: float = 300.0,
    resolution: float = 2.0,
    background: float = 1e2,
    anomalies=(((-40.0, -50.0), 15.0, 1e1), ((50.0, -60.0), 15.0, 1e3)),
    sharpness: float = 0.5,
    current_a=(-20.0, None),
    current_b=(20.0, None),
    current: float = 1.0,
    source_width: float = 0.5,
    source_depth: float = 1.5,
) -> Tuple[Problem, Callable]:
    """DCR forward problem under topography; returns ``(Problem,
    height_fn)``.

    The current electrodes sit at the x-positions of ``current_a/b``,
    ``source_depth`` below the terrain. At the defaults the surface has
    200 segments and 199 interior vertices.
    """
    if height_fn is None:
        height_fn = rolling_hills()
    neumann = func_to_polyline(height_fn, -half_width, half_width, resolution)
    pts = neumann.points.numpy()
    dirichlet = Polyline.from_points([
        [pts[0, 0], float(pts[0, 1])],
        [-half_width, -depth],
        [half_width, -depth],
        [pts[-1, 0], float(pts[-1, 1])],
    ])
    conductivity = _anomalous_conductivity(
        background=background, anomalies=anomalies, sharpness=sharpness)
    ax, bx = float(current_a[0]), float(current_b[0])
    a_pos = (ax, float(height_fn(np.asarray(ax))) - source_depth)
    b_pos = (bx, float(height_fn(np.asarray(bx))) - source_depth)
    problem = Problem(
        dirichlet=dirichlet,
        neumann=neumann,
        bc_dirichlet=fields.constant(0.0),
        source=fields.gaussian_dipole(a_pos, b_pos, current, source_width),
        alpha=conductivity,
    )
    return problem, height_fn
