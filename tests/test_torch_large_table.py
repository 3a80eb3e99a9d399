"""Boundaries of more than 8,192 rows on the port, against the JAX package.

The JAX package's Pallas kernel holds up to ``MAX_SMEM_SEGMENTS`` = 8,192
boundary rows (both boundaries' segments and the Neumann boundary's
interior vertices) in SMEM, and its solver walks a larger boundary on its
XLA step (``solver/wost.py:1492-1525``). The port's table form reads its
rows from global memory and walks any count: here the topographic survey
at ``half_width=100, depth=150, resolution=100/2048`` (4,096 Neumann
segments, 4,095 vertices: 8,194 rows), 3 electrodes draped at x = -20, 0,
20, goes through both packages' ``WoStSolver.solve`` (the JAX package on
its XLA step, ``backend="auto"`` on the CPU); the two solves walk with
other roundings of the table loops, so each potential must lie within 4
combined standard errors of the other's. ``backend="pallas"`` names the
fused kernel's budget in both packages and raises ``ValueError`` past it;
the form is the table form from 97 rows on, at 8,192 and at 8,193 rows
alike. The circle of 8,200 segments and the 8,402-row survey wall are in
``test_torch_large_table_b.py``, the sharded solver in
``test_torch_large_table_sharded.py``.
"""

import numpy as np
import pytest
import torch

from dcrmontecarlo_tpu.geometry import circle_loop as j_circle
from dcrmontecarlo_tpu.models import drape_electrodes as j_drape
from dcrmontecarlo_tpu.models import topographic_survey_problem as j_topo
from dcrmontecarlo_tpu.ops.pallas_walk import pallas_supported
from dcrmontecarlo_tpu.problems import Problem as JProblem
from dcrmontecarlo_tpu.solver import SolverOptions as JOptions
from dcrmontecarlo_tpu.solver import WoStSolver as JSolver
from dcrmontecarlo_tpu_torch.geometry import circle_loop
from dcrmontecarlo_tpu_torch.models import drape_electrodes, \
    topographic_survey_problem
from dcrmontecarlo_tpu_torch.ops import walk_kernel as wk
from dcrmontecarlo_tpu_torch.problems import Problem, fields
from dcrmontecarlo_tpu_torch.solver import SolverOptions, WoStSolver

torch.set_num_threads(1)

# 8,194 rows: two past the JAX kernel's SMEM budget
LARGE_TERRAIN = dict(half_width=100.0, depth=150.0, resolution=100.0 / 2048)
XS = np.array([-20.0, 0.0, 20.0])
RUN = dict(n_walks=64, max_steps=300, eps=0.5, seed=0)


def _circle(n):
    """A Dirichlet-only circle of ``n`` segments (``n`` rows) with the data
    ``x + 2y``, in the port and in the JAX package."""
    return (Problem(dirichlet=circle_loop(1.0, n=n),
                    bc_dirichlet=fields.polynomial({(1, 0): 1.0,
                                                    (0, 1): 2.0})),
            JProblem(dirichlet=j_circle(1.0, n=n),
                     bc_dirichlet=lambda x, y: x + 2.0 * y))


@pytest.fixture(scope="module")
def terrain_solves():
    prob, h = topographic_survey_problem(**LARGE_TERRAIN)
    jprob, jh = j_topo(**LARGE_TERRAIN)
    el = drape_electrodes(h, XS, nudge=0.5)
    np.testing.assert_array_equal(el, j_drape(jh, XS, 0.5))
    solver = WoStSolver(prob, SolverOptions(target_slots=1024), device="cpu")
    got = solver.solve(el, **RUN)
    want = JSolver(jprob, JOptions(target_slots=1024)).solve(el, **RUN)
    return prob, solver, el, got, want


def test_large_terrain_walks_the_table_form(terrain_solves):
    prob, solver, el, _, _ = terrain_solves
    assert wk.geometry_size(prob) == 8194
    _, params, _, _ = solver._setup(el, RUN["n_walks"], RUN["max_steps"],
                                    RUN["eps"], 0)
    assert params.table and params.kernel_name == \
        "walk_kernel<0,false,false,false,true,true,false>"
    assert wk.culled_scans(params.variant)
    assert len(params.neu_table) == 4096 and len(params.vert_table) == 4095
    fp, ip = params.pack()
    assert ip[8] == 3 and ip[9] == 4096 and ip[17] == 4095 and ip[18] == 1
    assert len(wk.chunk_records(params.neu_table)) == 4096 // wk.CHUNK_ROWS


def test_large_terrain_matches_jax_xla(terrain_solves):
    # the JAX package's XLA step and the port's table loops round the
    # scans apart: statistically, 4 combined standard errors
    _, _, _, got, want = terrain_solves
    se = np.hypot(got.stderr, want.stderr)
    assert np.isfinite(got.mean).all() and (got.stderr > 0).all()
    assert (np.abs(got.mean - want.mean) < 4.0 * se).all(), (
        got.mean, want.mean, se)
    assert got.total_steps > 0


def test_pallas_backend_past_the_budget_raises_as_in_jax():
    prob, jprob = _circle(wk.MAX_SMEM_SEGMENTS + 1)
    pts = np.array([[0.0, 0.0]])
    with pytest.raises(ValueError, match="backend='pallas'"):
        JSolver(jprob, JOptions(backend="pallas")).solve(
            pts, n_walks=8, max_steps=5, eps=1e-3)
    with pytest.raises(ValueError, match="backend='pallas'"):
        WoStSolver(prob, SolverOptions(backend="pallas"),
                   device="cpu").solve(pts, n_walks=8, max_steps=5, eps=1e-3)
    # at the budget both run it ("auto" at any size)
    prob, _ = _circle(wk.MAX_SMEM_SEGMENTS)
    r = WoStSolver(prob, SolverOptions(backend="pallas", target_slots=256),
                   device="cpu").solve(pts, n_walks=8, max_steps=5, eps=1e-3)
    assert np.isfinite(r.mean).all()


@pytest.mark.parametrize("rows", [wk.MAX_UNROLL_SEGMENTS,
                                  wk.MAX_UNROLL_SEGMENTS + 1,
                                  wk.MAX_SMEM_SEGMENTS,
                                  wk.MAX_SMEM_SEGMENTS + 1])
def test_form_by_rows(rows):
    prob, jprob = _circle(rows)
    assert wk.geometry_size(prob) == rows
    # the JAX kernel's budget: its fused kernel up to 8,192 rows
    assert pallas_supported(jprob) == (rows <= wk.MAX_SMEM_SEGMENTS)
    solver = WoStSolver(prob, SolverOptions(target_slots=256), device="cpu")
    _, params, _, _ = solver._setup(np.zeros((1, 2)), 8, 5, 1e-3, 0)
    table = rows > wk.MAX_UNROLL_SEGMENTS
    assert params.table == table and len(params.dir_table) == rows
    assert params.variant == (wk.ROBIN_OFF, False, False, False, table,
                              False, False, False, False)
    fp, ip = params.pack()
    assert ip[8] == rows and ip[18] == int(table)
    if table:  # the rows go by device_tables, not in the parameters
        dirt, _, _ = params.device_tables("cpu")
        assert dirt.shape == (rows, 4)
