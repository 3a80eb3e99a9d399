"""Measurement sensitivity (Fréchet derivative) maps by reciprocity (port
of ``survey/sensitivity.py``).

For the measurement ``V = u_s(M) - u_s(N)`` of the potential ``u_s``
driven by the current dipole ``A/B`` through ``-div(alpha grad u_s) =
q_AB``, the first-order response to a conductivity perturbation
``d_alpha(x)`` is the adjoint (reciprocity) identity

    ``dV = - int d_alpha(x) grad u_s(x) . grad u_a(x) dx``

where ``u_a`` solves the same operator with a unit current dipole at the
receiver pair ``M/N``. In field form (``E = -grad u``):

    ``S(x) = dV / d_alpha(x) = - E_s(x) . E_a(x)``   (per unit area)

Both fields come from ONE walker ensemble: walk paths do not depend on the
source term, so the problem carries the ``A/B`` and ``M/N`` dipoles as two
sources, and the central-difference estimator with common random numbers
(``survey/efield.py``) differentiates both at once. The ``M/N``
"electrodes" are the same Gaussian blobs the survey injects with, so ``V``
is the Gaussian-smoothed potential difference whose derivative the map
is. :func:`survey_jacobian` builds every dipole-dipole row from the unit
dipoles of consecutive electrodes, and :func:`linearized_update` takes one
Tikhonov-regularized Born step from it.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..problems.fields import GaussianMixture, gaussian_dipole
from ..solver.wost import SolverOptions
from .efield import estimate_field

__all__ = ["SensitivityResult", "sensitivity_map",
           "JacobianResult", "survey_jacobian", "linearized_update"]


class SensitivityResult(NamedTuple):
    grid: np.ndarray              # (N, 2) evaluation points
    sensitivity: np.ndarray       # (N,) dV/d alpha(x), per unit area
    sensitivity_log: np.ndarray   # (N,) dV/d ln alpha(x) = alpha * S
    stderr: np.ndarray            # (N,) error scale: with n_batches > 1
                                  # (the default) the empirical stderr of
                                  # independent batch replicas of the
                                  # product; with n_batches = 1 the
                                  # first-order propagation of the two
                                  # E-field bounds (a weighting scale only:
                                  # it drops the E_s/E_a covariance)
    e_source: tuple               # (ex, ey) of the A/B current field
    e_adjoint: tuple              # (ex, ey) of the unit M/N field


def _alpha_on(problem, pts) -> np.ndarray:
    """The problem's conductivity at ``pts`` in float32."""
    return problem.alpha(torch.as_tensor(pts[:, 0], dtype=torch.float32),
                         torch.as_tensor(pts[:, 1], dtype=torch.float32)
                         ).numpy()


def sensitivity_map(
    survey,
    rx_m,
    rx_n,
    grid_points,
    h: float = None,
    n_walks: int = 4000,
    max_steps: int = 500,
    eps: float = 0.9,
    seed: int = 0,
    options: SolverOptions = None,
    n_batches: int = 4,
    device="cuda",
) -> SensitivityResult:
    """Sensitivity of the ``(rx_m, rx_n)`` voltage to ``alpha(x)``.

    ``survey`` is a :class:`~dcrmontecarlo_tpu_torch.survey.DCRSurvey`
    (its ``current_a/current_b`` drive the source field, its conductivity
    and geometry define the operator); ``rx_m``, ``rx_n`` are the receiver
    electrodes, buried below the insulating surface as current electrodes
    are; ``grid_points`` ``(N, 2)``; ``h`` the central-difference step,
    half the source width by default. Integrate ``sensitivity * d_alpha``
    over the model region to predict a voltage change. The solves run on
    ``device``: the card unless the caller asks for ``"cpu"``.
    """
    if h is None:
        h = 0.5 * survey.source_width
    problem = survey.build_problem()
    m = survey._bury_source(rx_m)
    n = survey._bury_source(rx_n)
    adj = gaussian_dipole(m, n, 1.0, survey.source_width)
    problem.set_source_term(problem.source_fields + [adj])
    if survey.source_mis:
        # importance must cover every source: walks that feed the adjoint
        # accumulator need NEE mass at the receiver blobs too
        a = survey._bury_source(survey.current_a)
        b = survey._bury_source(survey.current_b)
        w = survey.source_width
        problem.set_source_importance(GaussianMixture.from_components(
            [(a, w, 0.25), (b, w, 0.25), (m, w, 0.25), (n, w, 0.25)]
        ))

    f = estimate_field(
        problem, grid_points, h=h, n_walks=n_walks, max_steps=max_steps,
        eps=eps, seed=seed, options=options, n_batches=n_batches,
        device=device,
    )
    ex_s, ey_s = f.ex[0], f.ey[0]
    ex_a, ey_a = f.ex[1], f.ey[1]
    sens = -(ex_s * ex_a + ey_s * ey_a)
    if f.ex_batches is not None:
        # the spread of per-batch products over independent replicas
        # holds the CRN-correlated factor errors that first-order
        # propagation drops; the point estimate stays the product of the
        # full-ensemble means
        s_b = -(f.ex_batches[:, 0] * f.ex_batches[:, 1]
                + f.ey_batches[:, 0] * f.ey_batches[:, 1])
        stderr = s_b.std(axis=0, ddof=1) / np.sqrt(len(s_b))
    else:
        stderr = np.sqrt(
            (ex_a * f.ex_stderr[0]) ** 2 + (ex_s * f.ex_stderr[1]) ** 2
            + (ey_a * f.ey_stderr[0]) ** 2 + (ey_s * f.ey_stderr[1]) ** 2
        )
    pts = np.asarray(grid_points, np.float64).reshape(-1, 2)
    alpha_g = _alpha_on(problem, pts)
    return SensitivityResult(
        grid=pts,
        sensitivity=sens,
        sensitivity_log=alpha_g * sens,
        stderr=stderr,
        e_source=(ex_s, ey_s),
        e_adjoint=(ex_a, ey_a),
    )


class JacobianResult(NamedTuple):
    grid: np.ndarray          # (N, 2) evaluation points
    rows: np.ndarray          # (M, N) dV_m/d alpha(x) per unit area
    rows_log: np.ndarray      # (M, N) dV_m/d ln alpha(x) = alpha * rows
    stderr: np.ndarray        # (M, N) error scales (as
                              # SensitivityResult.stderr)
    src_pairs: list           # (M,) (a, b) electrode-index tuples
    rx_pairs: list            # (M,) (m, n) electrode-index tuples
    fields: tuple             # (ex, ey), each (n_dipoles, N): the shared
                              # unit-dipole fields the rows are built of


def _jacobian_problem(survey, electrodes):
    """What :func:`survey_jacobian` solves: the survey's own problem (one
    sigma' scan) with the unit dipoles of consecutive electrodes as its
    sources and, with ``source_mis``, one mixture over the electrodes."""
    elec = np.asarray(electrodes, np.float64).reshape(-1, 2)
    w = survey.source_width
    buried = [survey._bury_source(p) for p in elec]
    problem = survey.build_problem()
    problem.set_source_term([
        gaussian_dipole(buried[k], buried[k + 1], 1.0, w)
        for k in range(len(elec) - 1)
    ])
    if survey.source_mis:
        problem.set_source_importance(GaussianMixture.from_components(
            [(p, w, 1.0 / len(elec)) for p in buried]
        ))
    return problem


def survey_jacobian(
    survey,
    electrodes,
    grid_points,
    num_rx_per_src: int = 10,
    h: float = None,
    n_walks: int = 4000,
    max_steps: int = 500,
    eps: float = 0.9,
    seed: int = 0,
    options: SolverOptions = None,
    n_batches: int = 4,
    device="cuda",
) -> JacobianResult:
    """Fréchet Jacobian of every dipole-dipole voltage in one solve.

    Every measurement row is the product ``-I * E_s(x) . E_r(x)`` of the
    fields of two unit dipoles of consecutive electrodes (source ``(i,
    i+1)`` and receiver ``(j, j+1)`` are the same kind of object by
    reciprocity). The ``n_electrodes - 1`` unit dipoles ride one walker
    ensemble as sources, one stencil solve estimates all their E-fields at
    the grid, and the rows are their products. The measurements follow
    :func:`~dcrmontecarlo_tpu_torch.survey.dipole_dipole_pairs`, source
    major. The solves run on ``device``: the card unless the caller asks
    for ``"cpu"``.
    """
    from .dcr import dipole_dipole_pairs

    n_elec = len(np.asarray(electrodes).reshape(-1, 2))
    if h is None:
        h = 0.5 * survey.source_width
    problem = _jacobian_problem(survey, electrodes)
    f = estimate_field(
        problem, grid_points, h=h, n_walks=n_walks, max_steps=max_steps,
        eps=eps, seed=seed, options=options, n_batches=n_batches,
        device=device,
    )
    ex, ey = f.ex, f.ey                      # (n_dip, N)
    exe, eye = f.ex_stderr, f.ey_stderr
    src_list, rx_lists = dipole_dipole_pairs(n_elec, num_rx_per_src)
    cur = survey.current
    rows, errs, src_pairs, rx_pairs = [], [], [], []
    for (a, b), rxs in zip(src_list, rx_lists):
        s = a  # the consecutive dipole (a, a+1) is unit dipole a
        for (m, n) in rxs:
            r = m
            rows.append(-cur * (ex[s] * ex[r] + ey[s] * ey[r]))
            if f.ex_batches is not None:
                r_b = -cur * (f.ex_batches[:, s] * f.ex_batches[:, r]
                              + f.ey_batches[:, s] * f.ey_batches[:, r])
                errs.append(r_b.std(axis=0, ddof=1) / np.sqrt(len(r_b)))
            else:
                errs.append(cur * np.sqrt(
                    (ex[r] * exe[s]) ** 2 + (ex[s] * exe[r]) ** 2
                    + (ey[r] * eye[s]) ** 2 + (ey[s] * eye[r]) ** 2
                ))
            src_pairs.append((a, b))
            rx_pairs.append((m, n))
    rows = np.stack(rows)
    errs = np.stack(errs)
    pts = np.asarray(grid_points, np.float64).reshape(-1, 2)
    alpha_g = _alpha_on(problem, pts)
    return JacobianResult(
        grid=pts,
        rows=rows,
        rows_log=rows * alpha_g[None, :],
        stderr=errs,
        src_pairs=src_pairs,
        rx_pairs=rx_pairs,
        fields=(ex, ey),
    )


def linearized_update(jac: JacobianResult, d_resid, cell_area,
                      lam_rel: float = 0.05, log_space: bool = False):
    """One Tikhonov-regularized linearized (Born / Gauss-Newton) update.

    Solves ``min ||A m - d||^2 + lam ||m||^2`` with ``A = rows *
    cell_area`` (``m`` the per-cell ``d_alpha``, or ``d ln alpha`` with
    ``log_space=True``) by the dual normal equations, ``A^T (A A^T + lam
    I)^{-1} d`` (far fewer measurements than cells). ``lam`` is
    ``lam_rel`` times the data-space scale ``trace(A A^T) / M``.
    """
    d = np.asarray(d_resid, np.float64)
    A = np.asarray(jac.rows_log if log_space else jac.rows,
                   np.float64) * cell_area
    gram = A @ A.T
    lam = lam_rel * np.trace(gram) / max(len(d), 1)
    return A.T @ np.linalg.solve(gram + lam * np.eye(len(d)), d)
