"""Electric-field (gradient) estimation (port of ``survey/efield.py``).

DCR instruments measure potential differences; the physical quantity is
the electric field ``E = -grad u``. It is estimated by central
differences over one solve with common random numbers: the walks from
``x +/- h`` draw the same streams and follow nearly the same paths, so the
difference quotient cancels the shared Monte Carlo noise that would
otherwise need ``O(1/h^2)`` more walks.

The bias is the usual ``O(h^2)`` central-difference term plus the walk
decorrelation growing with ``h``; ``h`` around ``1e-2`` of the local
feature scale works well.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from ..sampling.rng import mix32
from ..solver.wost import SolverOptions, WoStSolver

__all__ = ["EFieldResult", "estimate_field"]


class EFieldResult(NamedTuple):
    ex: np.ndarray        # (N,) E_x = -du/dx; (n_src, N) for multi-source
    ey: np.ndarray        # (N,) E_y = -du/dy; (n_src, N) for multi-source
    ex_stderr: np.ndarray  # n_batches <= 1: conservative quadrature
    ey_stderr: np.ndarray  # bounds; n_batches > 1: the empirical stderr
                           # of the batch mean (a B-sample estimate, no
                           # longer an upper bound)
    potential: np.ndarray  # (N,) u at the stencil centers
    ex_batches: np.ndarray = None  # (B, ...) per-batch fields when
    ey_batches: np.ndarray = None  # n_batches > 1: independent replicas
                                   # for empirical error bars of derived
                                   # quantities (the E_s . E_a products of
                                   # the sensitivity maps)


def estimate_field(
    problem,
    points,
    h: float,
    n_walks: int = 4000,
    max_steps: int = 1000,
    eps: float = 1e-4,
    seed: int = 0,
    options: SolverOptions = None,
    n_batches: int = 1,
    device="cuda",
) -> EFieldResult:
    """Estimate ``E = -grad u`` at ``points`` with step ``h``.

    The 5-point stencil ``{x, x+-h e_x, x+-h e_y}`` of every point is
    solved in ONE solve with common random numbers: slot ``k`` of every
    stencil point draws stream ``k`` (the ``"tile"`` layout of
    ``ops/walk_kernel.py::stream_ids``), so its walks correlate.

    ``n_batches > 1`` splits the walk budget exactly (remainders go to the
    first batches) into independent replicas with hashed seeds, switching
    ``ex_stderr``/``ey_stderr`` to the empirical stderr of the batch mean
    and filling ``ex_batches``/``ey_batches``. The solves run on
    ``device``: the card unless the caller asks for ``"cpu"``.
    """
    pts = np.asarray(points, np.float32).reshape(-1, 2)
    n = len(pts)
    stencil = np.concatenate([
        pts,
        pts + [h, 0.0],
        pts - [h, 0.0],
        pts + [0.0, h],
        pts - [0.0, h],
    ]).astype(np.float32)
    if options is None:
        # the survey pipelines' defaults (roulette is inert on problems
        # without delta tracking)
        from .dcr import survey_default_options

        base = survey_default_options()
    else:
        base = options
    opts = SolverOptions(**{
        **base.__dict__,
        "common_random_numbers": True,
        "rng": "fast",
    })
    solver = WoStSolver(problem, opts, device=device)

    def one(seed_b, walks_b):
        res = solver.solve(stencil, n_walks=walks_b, max_steps=max_steps,
                           eps=eps, seed=seed_b)
        # single-source solves return (5n,), multi-source (n_src, 5n): the
        # stencil axis is always the trailing one
        multi = res.mean.ndim == 2
        u = res.mean.reshape(-1, 5, n)
        se = res.stderr.reshape(-1, 5, n)
        ex = -(u[:, 1] - u[:, 2]) / (2 * h)
        ey = -(u[:, 3] - u[:, 4]) / (2 * h)
        return multi, ex, ey, se, u[:, 0]

    if n_batches <= 1:
        multi, ex, ey, se, pot = one(seed, n_walks)
        ex_err = np.sqrt(se[:, 1] ** 2 + se[:, 2] ** 2) / (2 * h)
        ey_err = np.sqrt(se[:, 3] ** 2 + se[:, 4] ** 2) / (2 * h)
        exb = eyb = None
    else:
        # independent batches; their spread gives error bars for any
        # derived quantity, CRN correlations included. The batch seeds
        # are hashed, so distinct user seeds never alias onto each
        # other's batch streams
        n_batches = min(n_batches, max(1, n_walks))
        base_walks, rem = divmod(n_walks, n_batches)
        runs = []
        for b in range(n_batches):
            seed_b = int(mix32(np.uint32(seed) ^ np.uint32(
                (0xB5297A4D * (b + 1)) & 0xFFFFFFFF)))
            runs.append(one(seed_b, base_walks + (1 if b < rem else 0)))
        multi = runs[0][0]
        exb = np.stack([r[1] for r in runs])   # (B, n_src, N)
        eyb = np.stack([r[2] for r in runs])
        ex = exb.mean(axis=0)
        ey = eyb.mean(axis=0)
        ex_err = exb.std(axis=0, ddof=1) / np.sqrt(n_batches)
        ey_err = eyb.std(axis=0, ddof=1) / np.sqrt(n_batches)
        pot = np.mean([r[4] for r in runs], axis=0)
    if not multi:
        ex, ey, ex_err, ey_err, pot = (
            a[0] for a in (ex, ey, ex_err, ey_err, pot)
        )
        if exb is not None:
            exb, eyb = exb[:, 0], eyb[:, 0]
    return EFieldResult(ex=ex, ey=ey, ex_stderr=ex_err, ey_stderr=ey_err,
                        potential=pot, ex_batches=exb, ey_batches=eyb)
