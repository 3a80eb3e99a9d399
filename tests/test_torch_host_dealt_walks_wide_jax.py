"""Whole solves through the wide survey's dealt loop and the short walk's
single launch against the JAX package.

The host compiler builds ``csrc/walk_kernel.cu``'s wide survey without
MIS ``<0,false,false,false,false,true,false,true>`` and its static form
without delta tracking ``<0,false,false,false,false,false,false>``
(``tests/host_cuda/``), and the solver's adaptive single launch runs
through them as the card's wrapper launches it
(``walk_kernel.launch_loop``: every quota drained from fresh walks, so
the wide survey's walks are dealt to the threads; the short walk's build
keeps one thread a lane, which ran faster on the card). The scenario
line's pseudosection (9
electrodes, 6 source dipoles, 128 walks, the survey defaults) through the
port's ``run_pseudosection`` agrees with the JAX package's
``run_pseudosection`` on its XLA backend at the same seed: every potential
of every source row within 4 sigma (the two errors in quadrature; the two
draw the same counter-hash streams, so they agree far closer, but XLA
contracts FMAs and a heavy walk may part by an ulp), the same
measurements. The short walk's harmonic square (``x +
2y`` on the unit square, ``bench.py --preset short``'s three points at 32
walks a slot, 1,024 walks each) walks the JAX package's Pallas kernel's
walks in interpret mode (axis-aligned walls keep them in step across math
libraries): equal total steps, sums to rel 1e-5; and every mean within 4
sigma + 5e-3 of ``x + 2y``, phase 25's bound.
"""

import numpy as np
import pytest
import torch

import chip_smoke as cs
from dcrmontecarlo_tpu_torch.solver import SolverOptions, WoStSolver
from test_torch_host_dealt_walks import SHORT, WIDE, host_builds
from test_torch_host_dealt_walks_jax import _dealt_walk

torch.set_num_threads(1)

HERE = (WIDE, SHORT)


@pytest.fixture(scope="module")
def host_walks(tmp_path_factory):
    return host_builds(tmp_path_factory, HERE)


def test_scenario_pseudosection_through_the_dealt_loop_matches_jax_xla(
        host_walks, monkeypatch):
    from dcrmontecarlo_tpu.models import geophysical_scenario as j_geo
    from dcrmontecarlo_tpu.survey import dcr as jdcr
    from dcrmontecarlo_tpu_torch.models import geophysical_scenario
    from dcrmontecarlo_tpu_torch.survey import dcr as tdcr

    walk = _dealt_walk(host_walks[WIDE])

    class Dealt(tdcr.WoStSolver):
        def _solve_raw(self, *args, **kwargs):
            kwargs["walk"] = walk
            return super()._solve_raw(*args, **kwargs)

    monkeypatch.setattr(tdcr, "WoStSolver", Dealt)
    kw = dict(num_rx_per_src=3, n_walks=128, max_steps=500, eps=0.9, seed=3)
    jsurvey, electrodes = j_geo()
    want = jdcr.run_pseudosection(
        jsurvey, electrodes,
        options=jdcr.survey_default_options(backend="xla"), **kw)
    tsurvey, t_electrodes = geophysical_scenario()
    got = tdcr.run_pseudosection(tsurvey, t_electrodes,
                                 options=tdcr.survey_default_options(),
                                 device="cpu", **kw)
    assert walk.loops == ["dealt"]
    assert got.potentials.shape == (6, 9)
    w, w_se = np.asarray(want.potentials), np.asarray(want.potentials_stderr)
    lim = 4.0 * np.hypot(got.potentials_stderr, w_se)
    assert (np.abs(got.potentials - w) <= lim).all(), (got.potentials, w,
                                                       lim)
    assert (got.potentials_stderr > 0).all()
    np.testing.assert_array_equal(got.src_index, np.asarray(want.src_index))


def test_short_walk_single_launch_matches_jax_pallas(host_walks):
    from jax.experimental.pallas import tpu as pltpu

    from dcrmontecarlo_tpu import Problem as JProblem
    from dcrmontecarlo_tpu import square_loop as j_square_loop
    from dcrmontecarlo_tpu.solver import SolverOptions as JOptions
    from dcrmontecarlo_tpu.solver import WoStSolver as JSolver

    jprob = JProblem(dirichlet=j_square_loop(1.0),
                     bc_dirichlet=lambda x, y: x + 2.0 * y)
    tprob, _ = cs.short_config()
    pts = cs.SHORT_POINTS
    n_walks, max_steps, eps = 1024, cs.SHORT_RUN[1], cs.SHORT_RUN[2]
    kw = dict(target_slots=96, pallas_block_rows=1, min_quota=32)
    with pltpu.force_tpu_interpret_mode():
        want = JSolver(jprob, JOptions(backend="pallas", **kw)).solve(
            pts, n_walks=n_walks, max_steps=max_steps, eps=eps, seed=9)
    solver = WoStSolver(tprob, SolverOptions(**kw), device="cpu")
    walk = _dealt_walk(host_walks[SHORT])
    got = solver._solve_raw(pts, n_walks, max_steps, eps, 9, walk=walk)
    assert walk.loops == ["lanes"]
    assert got.total_steps == want.total_steps
    np.testing.assert_allclose(got.walk_sum[0], np.asarray(want.walk_sum),
                               rtol=1e-5)
    np.testing.assert_allclose(got.walk_sumsq[0],
                               np.asarray(want.walk_sumsq), rtol=1e-5)
    exact = pts[:, 0] + 2.0 * pts[:, 1]
    assert (np.abs(got.mean[0] - exact) < 4.0 * got.stderr[0] + 5e-3).all()
