"""DC-resistivity survey layer (port of ``survey/dcr.py``).

Electrode lines, the half-space domain, the Gaussian current dipole, the
conversion of solved potentials into dipole voltages and apparent
resistivities (2D line-source and 3D point-source factors), and the
dipole-dipole pseudosection of a whole line from one walker ensemble.
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
    "Pseudosection",
    "dipole_dipole_pairs",
    "run_pseudosection",
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


def dipole_dipole_pairs(n_electrodes: int, num_rx_per_src: int = 10):
    """Dipole-dipole (source, receiver) index pairs, SimPEG's convention:
    source dipole ``(i, i+1)``, receiver dipoles ``(j, j+1)`` for ``j``
    from ``i+2`` up to ``i+1+num_rx_per_src``.

    Returns ``(sources, receivers)``: the source list of ``(a, b)`` index
    tuples and per-source lists of ``(m, n)`` receiver index tuples.
    """
    sources, receivers = [], []
    for i in range(n_electrodes - 3):
        rx = [
            (j, j + 1)
            for j in range(i + 2, min(i + 2 + num_rx_per_src, n_electrodes - 1))
        ]
        if rx:
            sources.append((i, i + 1))
            receivers.append(rx)
    return sources, receivers


class Pseudosection(NamedTuple):
    """Dipole-dipole pseudosection data: flat arrays over all (source,
    receiver) measurements; ``pseudo_x`` / ``pseudo_z`` are the midpoint
    of the source and receiver centers and minus half their separation."""

    potentials: np.ndarray       # (n_src, n_electrodes)
    potentials_stderr: np.ndarray
    src_index: np.ndarray        # (M,) source id per measurement
    a_index: np.ndarray          # (M,) current electrode indices
    b_index: np.ndarray
    m_index: np.ndarray          # (M,) potential electrode indices
    n_index: np.ndarray
    voltage: np.ndarray          # (M,) V_M - V_N
    voltage_stderr: np.ndarray   # (M,) correlated-walk upper bound
    apparent_resistivity: np.ndarray  # (M,) 2D line-source convention
    pseudo_x: np.ndarray         # (M,)
    pseudo_z: np.ndarray         # (M,)


def _line_problem(survey: DCRSurvey, electrodes, num_rx_per_src: int):
    """What :func:`run_pseudosection` solves: the survey's problem with
    one Gaussian dipole per source pair of the line (and, with
    ``source_mis``, one mixture over the electrodes they use), and the
    electrodes nudged into the half-space. Returns ``(problem, points,
    sources, receivers)``."""
    electrodes = np.asarray(electrodes, np.float32)
    sources, receivers = dipole_dipole_pairs(len(electrodes), num_rx_per_src)
    # bury surface-overlapping current electrodes (see _bury_source)
    src_pos = np.asarray(
        [survey._bury_source(p) for p in electrodes], np.float32
    )
    problem = survey.build_problem()
    # the version-bumping setters, as solvers key their caches on it
    problem.set_source_term([
        gaussian_dipole(src_pos[a], src_pos[b], survey.current,
                        survey.source_width)
        for a, b in sources
    ])
    if survey.source_mis:
        # one mixture covering every electrode of the line
        used = sorted({i for ab in sources for i in ab})
        problem.set_source_importance(GaussianMixture.from_components([
            (tuple(src_pos[i]), survey.source_width, 1.0) for i in used
        ]))
    pts = electrodes.copy()
    on_surface = np.abs(pts[:, 1] - survey.surface_y) < survey.electrode_nudge
    pts[on_surface, 1] = survey.surface_y - survey.electrode_nudge
    return problem, pts, sources, receivers


def run_pseudosection(
    survey: DCRSurvey,
    electrodes: np.ndarray,
    num_rx_per_src: int = 10,
    n_walks: int = 1000,
    max_steps: int = 500,
    eps: float = 0.9,
    seed: int = 0,
    options: SolverOptions = None,
    device="cuda",
) -> Pseudosection:
    """The whole dipole-dipole sweep of the line from ONE walker ensemble.

    Walk paths do not depend on the source term, so the solve carries one
    accumulator per source dipole of the line (the kernel's wide form
    beyond four) instead of walking once per source. The survey's own
    ``current_a/current_b`` are ignored; the sources come from the
    electrode line. The solve runs on ``device``: the card unless the
    caller asks for ``"cpu"``.
    """
    electrodes = np.asarray(electrodes, np.float32)
    problem, pts, sources, receivers = _line_problem(survey, electrodes,
                                                     num_rx_per_src)
    if options is None:
        options = survey_default_options()
    solver = WoStSolver(problem, options, device=device)
    res = solver.solve(pts, n_walks=n_walks, max_steps=max_steps, eps=eps,
                       seed=seed)
    # solve() squeezes to (n_elec,) when there is a single source field
    # (a 4-electrode line yields exactly one source dipole): normalize to
    # the (n_src, n_elec) layout the measurement loop indexes
    u = np.atleast_2d(np.asarray(res.mean))
    u_err = np.atleast_2d(np.asarray(res.stderr))

    rows = {k: [] for k in ("src", "a", "b", "m", "n", "dv", "dverr",
                            "rho", "px", "pz")}
    for s, ((a, b), rx_list) in enumerate(zip(sources, receivers)):
        for (m, n) in rx_list:
            dv = u[s, m] - u[s, n]
            dverr = float(np.sqrt(u_err[s, m] ** 2 + u_err[s, n] ** 2))
            rho = apparent_resistivity_2d(
                np.asarray([dv]), survey.current,
                electrodes[a], electrodes[b],
                electrodes[m][None], electrodes[n][None],
            )[0]
            src_mid = 0.5 * (electrodes[a, 0] + electrodes[b, 0])
            rx_mid = 0.5 * (electrodes[m, 0] + electrodes[n, 0])
            rows["src"].append(s)
            rows["a"].append(a)
            rows["b"].append(b)
            rows["m"].append(m)
            rows["n"].append(n)
            rows["dv"].append(float(dv))
            rows["dverr"].append(dverr)
            rows["rho"].append(float(rho))
            rows["px"].append(0.5 * (src_mid + rx_mid))
            rows["pz"].append(-0.5 * abs(rx_mid - src_mid))
    return Pseudosection(
        potentials=u,
        potentials_stderr=u_err,
        src_index=np.asarray(rows["src"]),
        a_index=np.asarray(rows["a"]),
        b_index=np.asarray(rows["b"]),
        m_index=np.asarray(rows["m"]),
        n_index=np.asarray(rows["n"]),
        voltage=np.asarray(rows["dv"]),
        voltage_stderr=np.asarray(rows["dverr"]),
        apparent_resistivity=np.asarray(rows["rho"]),
        pseudo_x=np.asarray(rows["px"]),
        pseudo_z=np.asarray(rows["pz"]),
    )
