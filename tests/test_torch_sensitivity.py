"""Sensitivity maps, the survey Jacobian and the Born update, port against
the JAX package.

``sensitivity_map`` and ``survey_jacobian`` differentiate the fields of
several dipoles from one solve with common random numbers. On the
configurations of ``tests/test_sensitivity.py`` (a uniform half-space,
MIS toward the electrodes) cut to 3 grid points and a few hundred walks,
the port's plain walk and the JAX package's XLA backend draw the same
streams from the same seed. Each map row is a product of two fields, each
field a difference of two potentials over ``2h``, so the rows are held to
``1e-4`` of their largest magnitude and the fields to ``1e-4`` of theirs
(measured: 3.5e-5 of the scale at most; the moments of the walks are summed in
another order and XLA's CPU backend contracts FMAs). The Jacobian with 5
unit dipoles (6 electrodes, 6 mixture components) is the kernel's wide
form on the card. The conductivity on the grid is the problem's field in
float32, as the JAX package evaluates it with ``jnp``.
``linearized_update`` is numpy in both packages: equal to 1e-12 on shared
inputs.
"""

import numpy as np
import pytest
import torch

from dcrmontecarlo_tpu.solver import SolverOptions as JOptions
from dcrmontecarlo_tpu.survey import DCRSurvey as JSurvey
from dcrmontecarlo_tpu.survey import sensitivity as jsens
from dcrmontecarlo_tpu_torch.problems import fields
from dcrmontecarlo_tpu_torch.solver import SolverOptions
from dcrmontecarlo_tpu_torch.survey import DCRSurvey, surface_electrode_line
from dcrmontecarlo_tpu_torch.survey import sensitivity as tsens

torch.set_num_threads(1)

REL = 1e-4  # of each array's largest magnitude
GRID = np.array([[0.0, -8.0], [5.0, -15.0], [-8.0, -10.0]], np.float32)
RUN = dict(h=3.0, n_walks=200, max_steps=300, eps=0.5, seed=3, n_batches=2)


def _surveys(elec, alpha=1.0):
    kw = dict(half_width=80.0, depth=80.0, current_a=tuple(elec[0]),
              current_b=tuple(elec[1]), source_width=2.0, source_mis=True)
    return (DCRSurvey(conductivity=fields.constant(alpha), **kw),
            JSurvey(conductivity=lambda x, y: alpha + 0.0 * x, **kw))


def _close(got, want):
    g, w = np.asarray(got), np.asarray(want)
    assert g.shape == w.shape and np.isfinite(g).all()
    np.testing.assert_allclose(g, w, rtol=0, atol=REL * np.abs(w).max())


@pytest.fixture(scope="module")
def elec():
    return surface_electrode_line((-25.0, 25.0), 10.0)  # 6 electrodes


def test_sensitivity_map_matches_jax_xla(elec):
    ts, js = _surveys(elec, alpha=2.0)
    want = jsens.sensitivity_map(
        js, tuple(elec[2]), tuple(elec[3]), GRID,
        options=JOptions(backend="xla", target_slots=1 << 12), **RUN)
    got = tsens.sensitivity_map(
        ts, tuple(elec[2]), tuple(elec[3]), GRID,
        options=SolverOptions(target_slots=1 << 12), device="cpu", **RUN)
    for k in ("sensitivity", "sensitivity_log", "stderr"):
        _close(getattr(got, k), getattr(want, k))
    for part in ("e_source", "e_adjoint"):
        for g, w in zip(getattr(got, part), getattr(want, part)):
            _close(g, w)
    np.testing.assert_array_equal(got.grid, want.grid)
    # alpha = 2 on the grid, in float32
    np.testing.assert_array_equal(got.sensitivity_log,
                                  np.float32(2.0) * got.sensitivity)


def test_survey_jacobian_matches_jax_xla(elec):
    ts, js = _surveys(elec)
    want = jsens.survey_jacobian(
        js, elec, GRID, num_rx_per_src=2,
        options=JOptions(backend="xla", target_slots=1 << 12), **RUN)
    got = tsens.survey_jacobian(
        ts, elec, GRID, num_rx_per_src=2,
        options=SolverOptions(target_slots=1 << 12), device="cpu", **RUN)
    assert got.src_pairs == want.src_pairs and got.rx_pairs == want.rx_pairs
    assert got.rows.shape == (len(got.src_pairs), len(GRID))
    assert got.fields[0].shape == (5, len(GRID))
    for k in ("rows", "rows_log", "stderr"):
        _close(getattr(got, k), getattr(want, k))
    for g, w in zip(got.fields, want.fields):
        _close(g, w)


def test_linearized_update_matches_jax():
    rng = np.random.default_rng(5)
    rows = rng.normal(size=(7, 30)).astype(np.float32)
    alpha = rng.uniform(0.5, 2.0, size=30).astype(np.float32)
    d = rng.normal(size=7)
    common = dict(grid=np.zeros((30, 2)), rows=rows,
                  rows_log=rows * alpha[None, :], stderr=np.abs(rows),
                  src_pairs=[(0, 1)] * 7, rx_pairs=[(2, 3)] * 7,
                  fields=(rows, rows))
    for log_space in (False, True):
        for lam in (0.05, 0.3):
            got = tsens.linearized_update(tsens.JacobianResult(**common), d,
                                          2.5, lam_rel=lam,
                                          log_space=log_space)
            want = jsens.linearized_update(jsens.JacobianResult(**common),
                                           d, 2.5, lam_rel=lam,
                                           log_space=log_space)
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=1e-12 * np.abs(want).max())
