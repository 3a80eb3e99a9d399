"""Two more boundaries of more than 8,192 rows, against the JAX package.

A Dirichlet-only circle of 8,200 segments with the data ``x + 2y`` (no
alpha or sigma: the table form without delta tracking,
``walk_kernel<0,false,false,false,true,false,false>``), 1,024 walks at
three points: each mean within 4 sigma + 5e-3 of ``x + 2y`` and within 4
combined standard errors of the JAX package's solve (its XLA step). And
the survey's box with a heightmap wall of 4,200 segments and 4,199
vertices (8,402 rows, the culled table build), which the port refused
before it walked such a boundary: 3 points x 64 walks, within 4 combined
standard errors of the JAX solve. The JAX package's XLA step rounds its
scans otherwise, so the comparisons are statistical.
"""

import numpy as np
import torch

from dcrmontecarlo_tpu.geometry import Polyline as JPolyline
from dcrmontecarlo_tpu.models import geophysical_scenario as j_geo
from dcrmontecarlo_tpu.problems import Problem as JProblem
from dcrmontecarlo_tpu.solver import SolverOptions as JOptions
from dcrmontecarlo_tpu.solver import WoStSolver as JSolver
from dcrmontecarlo_tpu_torch.geometry import Polyline
from dcrmontecarlo_tpu_torch.models import geophysical_scenario
from dcrmontecarlo_tpu_torch.ops import walk_kernel as wk
from dcrmontecarlo_tpu_torch.problems import Problem
from dcrmontecarlo_tpu_torch.solver import SolverOptions, WoStSolver
from test_torch_large_table import _circle

torch.set_num_threads(1)

CIRCLE_PTS = np.array([[0.0, 0.0], [0.5, 0.3], [-0.4, 0.6]])
WALL_PTS = np.array([[-20.0, -1.0], [0.0, -1.0], [20.0, -1.0]])


def _wall():
    """The survey's box and source with a heightmap wall of 4,200
    segments and 4,199 vertices: 8,402 rows (the JAX package walks it on
    its XLA step)."""
    x = np.linspace(-100.0, 100.0, 4201)
    pts = np.stack([x, 0.1 * np.sin(x)], 1)
    tprob = geophysical_scenario()[0].build_problem()
    jprob = j_geo()[0].build_problem()
    return (Problem(dirichlet=tprob.dirichlet,
                    neumann=Polyline.from_points(pts), alpha=tprob.alpha,
                    source=tprob.source, sigma_bar_override=0.1),
            JProblem(dirichlet=jprob.dirichlet,
                     neumann=JPolyline.from_points(pts), alpha=jprob.alpha,
                     source=jprob.source, sigma_bar_override=0.1))


def _both(prob, jprob, pts, **kw):
    solver = WoStSolver(prob, SolverOptions(target_slots=1024), device="cpu")
    got = solver.solve(pts, **kw)
    want = JSolver(jprob, JOptions(target_slots=1024)).solve(pts, **kw)
    return solver, got, want


def _within(got, want):
    se = np.hypot(got.stderr, want.stderr)
    assert np.isfinite(got.mean).all() and (got.stderr > 0).all()
    assert (np.abs(got.mean - want.mean) < 4.0 * se).all(), (
        got.mean, want.mean, se)


def test_dirichlet_circle_of_8200_segments():
    prob, jprob = _circle(8200)
    solver, got, want = _both(prob, jprob, CIRCLE_PTS, n_walks=1024,
                              max_steps=200, eps=1e-3, seed=0)
    _, params, _, _ = solver._setup(CIRCLE_PTS, 1024, 200, 1e-3, 0)
    assert params.table and not params.delta
    assert params.kernel_name == \
        "walk_kernel<0,false,false,false,true,false,false>"
    exact = CIRCLE_PTS[:, 0] + 2.0 * CIRCLE_PTS[:, 1]
    assert (np.abs(got.mean - exact) < 4.0 * got.stderr + 5e-3).all(), (
        got.mean, exact, got.stderr)
    _within(got, want)


def test_survey_wall_of_8402_rows():
    prob, jprob = _wall()
    assert wk.geometry_size(prob) == 8402
    solver, got, want = _both(prob, jprob, WALL_PTS, n_walks=64,
                              max_steps=100, eps=0.9, seed=0)
    _, params, _, _ = solver._setup(WALL_PTS, 64, 100, 0.9, 0)
    assert params.table and wk.culled_scans(params.variant)
    assert len(params.neu_table) == 4200 and len(params.vert_table) == 4199
    _within(got, want)


def test_survey_wall_solve_at_any_scan_block(monkeypatch):
    # the plain walk's scans in blocks of rows: a solve is the same bit
    # for bit whatever the block (the first row of a tie wins, as in the
    # kernel's row loop)
    prob, _ = _wall()
    kw = dict(n_walks=16, max_steps=40, eps=0.9, seed=3)

    def solve():
        return WoStSolver(prob, SolverOptions(target_slots=256),
                          device="cpu").solve(WALL_PTS, **kw)

    one_pass = solve()  # 12 lanes with quota: one block of every row
    # 500 rows a block at 12 lanes, more as lanes drain
    monkeypatch.setattr(wk, "SCAN_ELEMS", 12 * 500)
    blocks = solve()
    np.testing.assert_array_equal(one_pass.mean, blocks.mean)
    np.testing.assert_array_equal(one_pass.stderr, blocks.stderr)
    assert one_pass.total_steps == blocks.total_steps > 0
