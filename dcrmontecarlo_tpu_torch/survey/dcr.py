"""DC-resistivity survey layer (port of ``survey/dcr.py``).

Electrode lines, the half-space domain, the Gaussian current dipole, and
the conversion of solved potentials into dipole voltages and apparent
resistivities (2D line-source and 3D point-source factors).
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np

from ..geometry.polyline import Polyline
from ..problems.fields import GaussianMixture, constant, gaussian_dipole
from ..problems.problem import Problem
from ..solver.wost import SolveResult, SolverOptions, WoStSolver

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


def survey_default_options(**overrides) -> SolverOptions:
    """The survey pipelines' default options: common random numbers,
    roulette 0.05, two rejection rounds, no compaction (the JAX package's
    measured optima)."""
    base = dict(
        common_random_numbers=True,
        compaction=False,
        roulette_threshold=0.05,
        rejection_rounds=2,
    )
    base.update(overrides)
    return SolverOptions(**base)


def surface_electrode_line(x_range, spacing: float, y: float = 0.0) -> np.ndarray:
    """Measurement electrodes along the surface, never past ``x_range[1]``."""
    n = int(np.floor((x_range[1] - x_range[0]) / spacing + 1e-6)) + 1
    x = np.linspace(x_range[0], x_range[0] + (n - 1) * spacing, n,
                    dtype=np.float32)
    return np.stack([x, np.full_like(x, y)], axis=1)


def halfspace_domain(half_width: float, depth: float, surface_y: float = 0.0):
    """Dirichlet sides/bottom (open chain) + Neumann (insulating) top."""
    dirichlet = Polyline.from_points(
        [
            [-half_width, surface_y],
            [-half_width, surface_y - depth],
            [half_width, surface_y - depth],
            [half_width, surface_y],
        ]
    )
    neumann = Polyline.from_points(
        [[-half_width, surface_y], [half_width, surface_y]]
    )
    return dirichlet, neumann


def dipole_voltages(potentials: np.ndarray) -> np.ndarray:
    """Adjacent-electrode dipole receiver voltages ``V_M - V_N``."""
    potentials = np.asarray(potentials)
    return potentials[:-1] - potentials[1:]


def _pair_distances(a, b, m, n):
    a, b, m, n = (np.asarray(v, np.float64) for v in (a, b, m, n))
    r = lambda p, q: np.sqrt(((p - q) ** 2).sum(axis=-1))
    return r(a, m), r(b, m), r(a, n), r(b, n)


def apparent_resistivity_2d(dv, current, a, b, m, n):
    """``rho_a = pi dV / (I ln[(r_BM r_AN)/(r_AM r_BN)])`` (2D line sources)."""
    am, bm, an, bn = _pair_distances(a, b, np.asarray(m), np.asarray(n))
    with np.errstate(divide="ignore", invalid="ignore"):
        g = np.log((bm * an) / (am * bn))
        rho = np.pi * np.asarray(dv, np.float64) / (current * g)
    return np.where(np.isfinite(g) & (np.abs(g) > 0), rho, np.nan)


def apparent_resistivity_halfspace(dv, current, a, b, m, n):
    """Apparent resistivity with the conventional 3D point-source factor."""
    am, bm, an, bn = _pair_distances(a, b, np.asarray(m), np.asarray(n))
    with np.errstate(divide="ignore", invalid="ignore"):
        g = 1.0 / am - 1.0 / bm - 1.0 / an + 1.0 / bn
        rho = 2.0 * np.pi * np.asarray(dv, np.float64) / (current * g)
    return np.where(np.isfinite(g) & (np.abs(g) > 0), rho, np.nan)


class SurveyResult(NamedTuple):
    electrodes: np.ndarray
    potentials: np.ndarray
    potentials_stderr: np.ndarray
    voltages: np.ndarray
    voltages_stderr: np.ndarray
    apparent_resistivity: np.ndarray
    solve: SolveResult


@dataclass
class DCRSurvey:
    """A DC-resistivity forward-modelling survey: half-space domain,
    current dipole and conductivity field (a field spec for the CUDA
    walk, e.g. :func:`~dcrmontecarlo_tpu_torch.problems.fields.bump_sum`).
    """

    half_width: float
    depth: float
    current_a: tuple
    current_b: tuple
    conductivity: callable
    current: float = 1.0
    source_width: float = 0.5
    surface_y: float = 0.0
    sigma_bar_override: Optional[float] = None
    electrode_nudge: float = 0.1
    source_mis: bool = False
    local_majorant: object = None

    def _bury_source(self, pos) -> tuple:
        """Sink a current electrode whose Gaussian overlaps the Neumann
        surface to ~2 widths below it (warning when it had been placed
        below the surface on purpose)."""
        x, y = float(pos[0]), float(pos[1])
        depth = max(self.electrode_nudge, 2.0 * self.source_width)
        if abs(y - self.surface_y) < depth:
            if abs(y - self.surface_y) > self.electrode_nudge:
                warnings.warn(
                    f"current electrode at y={y:g} is within 2 source "
                    f"widths of the surface y={self.surface_y:g}; burying "
                    f"it to y={self.surface_y - depth:g} so the full "
                    "current enters the half-space. Reduce source_width "
                    "to keep a deliberately shallow source in place.")
            y = self.surface_y - depth
        return (x, y)

    def make_solver(self, options: SolverOptions = None,
                    device="cuda") -> WoStSolver:
        """A reusable solver (``options`` default to
        :func:`survey_default_options`) on ``device``: the card unless
        the caller asks for ``"cpu"``."""
        if options is None:
            options = survey_default_options()
        return WoStSolver(self.build_problem(), options, device=device)

    def build_problem(self) -> Problem:
        dirichlet, neumann = halfspace_domain(
            self.half_width, self.depth, self.surface_y)
        a = self._bury_source(self.current_a)
        b = self._bury_source(self.current_b)
        importance = None
        if self.source_mis:
            importance = GaussianMixture.from_components([
                (a, self.source_width, 0.5),
                (b, self.source_width, 0.5),
            ])
        return Problem(
            dirichlet=dirichlet,
            neumann=neumann,
            bc_dirichlet=constant(0.0),  # far-field ground
            source=gaussian_dipole(a, b, self.current, self.source_width),
            alpha=self.conductivity,
            sigma_bar_override=self.sigma_bar_override,
            source_importance=importance,
            local_majorant=self.local_majorant,
        )

    def run(
        self,
        electrodes: np.ndarray,
        n_walks: int = 1000,
        max_steps: int = 500,
        eps: float = 0.9,
        seed: int = 0,
        options: SolverOptions = None,
        solver: WoStSolver = None,
        device="cuda",
    ) -> SurveyResult:
        """Solve the survey at ``electrodes`` (surface electrodes are
        nudged ``electrode_nudge`` inside the half-space). Without a
        ``solver`` one is made on ``device``: the card unless the caller
        asks for ``"cpu"``."""
        if solver is None:
            solver = self.make_solver(options, device=device)
        pts = np.asarray(electrodes, np.float32).copy()
        on_surface = np.abs(pts[:, 1] - self.surface_y) < self.electrode_nudge
        pts[on_surface, 1] = self.surface_y - self.electrode_nudge
        res = solver.solve(pts, n_walks=n_walks, max_steps=max_steps,
                           eps=eps, seed=seed)
        dv = dipole_voltages(res.mean)
        dv_err = np.sqrt(res.stderr[:-1] ** 2 + res.stderr[1:] ** 2)
        rho_a = apparent_resistivity_2d(
            dv, self.current,
            np.asarray(self.current_a, np.float64),
            np.asarray(self.current_b, np.float64),
            electrodes[:-1], electrodes[1:])
        return SurveyResult(
            electrodes=np.asarray(electrodes),
            potentials=res.mean,
            potentials_stderr=res.stderr,
            voltages=dv,
            voltages_stderr=dv_err,
            apparent_resistivity=rho_a,
            solve=res,
        )
