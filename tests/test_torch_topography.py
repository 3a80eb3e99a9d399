"""The topographic DCR survey on the port against the JAX package.

``models/topography.py`` of both packages builds DC resistivity over
rolling hills: a 200-segment heightmap Neumann surface with 199 interior
vertices at its defaults (the walk's table form, with silhouettes), the
test size (``half_width=100, depth=150, resolution=4``: 102 rows, also
the table form) and electrodes draped on the terrain. Both packages must
give bit-equal boundaries and electrodes; a whole solve at the test size
must agree with the JAX XLA backend within 4 sigma of the combined
standard error (walks on sloped walls desynchronize on one-ulp
differences, see ``test_torch_silhouette.py``, so the comparison is
statistical); and ``tests/test_topography.py`` runs here on the port.
"""

import numpy as np
import pytest
import torch

from dcrmontecarlo_tpu.geometry.polyline import \
    func_to_polyline as j_func_to_polyline
from dcrmontecarlo_tpu.models import drape_electrodes as j_drape
from dcrmontecarlo_tpu.models import rolling_hills as j_hills
from dcrmontecarlo_tpu.models import topographic_survey_problem as j_topo
from dcrmontecarlo_tpu.solver import SolverOptions as JOptions
from dcrmontecarlo_tpu.solver import WoStSolver as JSolver
from dcrmontecarlo_tpu_torch.geometry import func_to_polyline
from dcrmontecarlo_tpu_torch.models import (
    drape_electrodes,
    rolling_hills,
    topographic_survey_problem,
)
from dcrmontecarlo_tpu_torch.ops import walk_kernel as wk
from dcrmontecarlo_tpu_torch.solver import SolverOptions, WoStSolver

torch.set_num_threads(1)

TEST_SIZE = dict(half_width=100.0, depth=150.0, resolution=4.0)
XS = np.arange(-40.0, 41.0, 10.0)
_FIELDS = ("seg_a", "seg_b", "seg_valid", "vert_abc", "vert_valid", "points")


def _assert_polylines_equal(tpoly, jpoly):
    for f in _FIELDS:
        np.testing.assert_array_equal(getattr(tpoly, f).numpy(),
                                      np.asarray(getattr(jpoly, f)),
                                      err_msg=f)


@pytest.fixture(scope="module")
def test_size():
    tprob, th = topographic_survey_problem(**TEST_SIZE)
    jprob, jh = j_topo(**TEST_SIZE)
    return tprob, jprob, th


def test_func_to_polyline_matches_jax():
    h = rolling_hills(5.0, 60.0)
    for args in ((-100.0, 100.0, 4.0), (-37.5, 81.0, 2.6), (0.0, 1.0, 5.0)):
        _assert_polylines_equal(func_to_polyline(h, *args),
                                j_func_to_polyline(h, *args))
    # x_max is a vertex: no gap at a side wall
    assert float(func_to_polyline(h, -100.0, 100.0, 3.0).points[-1, 0]) \
        == 100.0


def test_drape_electrodes_match_jax():
    for amp, wl, nudge in ((8.0, 80.0, 0.5), (5.0, 60.0, 0.25)):
        np.testing.assert_array_equal(
            drape_electrodes(rolling_hills(amp, wl), XS, nudge),
            j_drape(j_hills(amp, wl), XS, nudge))


@pytest.mark.parametrize("kw,size", [(TEST_SIZE, 102), ({}, 402)])
def test_problem_matches_jax(test_size, kw, size):
    if kw is TEST_SIZE:
        tprob, jprob, _ = test_size
    else:
        tprob, _ = topographic_survey_problem(**kw)
        jprob, _ = j_topo(**kw)
    _assert_polylines_equal(tprob.neumann, jprob.neumann)
    _assert_polylines_equal(tprob.dirichlet, jprob.dirichlet)
    assert wk.geometry_size(tprob) == size
    assert tprob.sigma_bar == pytest.approx(jprob.sigma_bar, rel=1e-4)
    # the dipole sits source_depth under the terrain at x = -20, +20
    np.testing.assert_allclose(tprob.source.params[:4],
                               [-20.0, -9.5, 20.0, 6.5], atol=1e-5)
    # Robin "auto" resolves off on both (gamma ~ 1e-7 along the terrain)
    assert JSolver(jprob)._robin_enabled() is False
    assert WoStSolver(tprob, device="cpu")._robin_enabled() is False


def test_defaults_solve_on_cpu():
    # the full-size problem (table form, 402 rows) runs through the
    # entry point on the CPU, a few walks
    prob, h = topographic_survey_problem()
    solver = WoStSolver(prob, SolverOptions(target_slots=64), device="cpu")
    e = drape_electrodes(h, [-20.0, 20.0], nudge=0.5)
    state, params, _, _ = solver._setup(e, 8, 40, 0.5, 0)
    assert params.table and params.kernel_name == \
        "walk_kernel<0,false,false,false,true>"
    res = solver.solve(e, n_walks=8, max_steps=40, eps=0.5, seed=0)
    assert np.isfinite(res.mean).all() and res.total_steps > 0


def test_whole_solve_matches_jax_xla(test_size):
    tprob, jprob, h = test_size
    e = drape_electrodes(h, XS, nudge=0.5)
    rj = JSolver(jprob, JOptions(backend="xla")).solve(
        e, n_walks=64, max_steps=600, eps=0.5, seed=0)
    rt = WoStSolver(tprob, SolverOptions(), device="cpu").solve(
        e, n_walks=64, max_steps=600, eps=0.5, seed=0)
    se = np.sqrt(rj.stderr ** 2 + rt.stderr ** 2)
    assert np.isfinite(rt.mean).all()
    assert (np.abs(rt.mean - rj.mean) < 4.0 * se).all(), (rt.mean, rj.mean)
    # the same walks until a wall visit desynchronizes them: the step
    # counts agree to a few percent (148,843 port, 152,271 JAX)
    print(f"total steps: port {rt.total_steps:.0f}, JAX XLA "
          f"{rj.total_steps:.0f}")
    assert abs(rt.total_steps - rj.total_steps) < 0.1 * rj.total_steps


# tests/test_topography.py, on the port


def test_drape_electrodes_on_terrain():
    h = rolling_hills(amplitude=5.0, wavelength=60.0)
    xs = np.linspace(-50, 50, 11)
    e = drape_electrodes(h, xs, nudge=0.5)
    gap = h(e[:, 0]) - e[:, 1]
    assert (gap > 0.2).all() and (gap < 1.0).all()


def test_topographic_problem_builds(test_size):
    prob, _, _ = test_size
    assert prob.neumann is not None
    assert prob.neumann.num_segments > 40
    assert prob.use_delta_tracking
    assert 0 < prob.sigma_bar < 10


def test_topographic_survey_solves(test_size):
    prob, _, h = test_size
    electrodes = drape_electrodes(h, XS, nudge=0.5)
    solver = WoStSolver(prob, SolverOptions(target_slots=8192), device="cpu")
    res = solver.solve(electrodes, n_walks=600, max_steps=600, eps=0.5,
                       seed=0)
    assert np.isfinite(res.mean).all()
    i_pos = int(np.argmin(np.abs(XS + 20)))
    i_neg = int(np.argmin(np.abs(XS - 20)))
    assert res.mean[i_pos] > 0, res.mean
    assert res.mean[i_neg] < 0, res.mean
    assert np.abs(res.mean).max() < 1.0
