"""The wide form's sources of any kind against the JAX package.

The host compiler builds ``csrc/walk_kernel.cu``'s wide survey in its
general rows build
``<0,false,false,false,false,true,false,true,false,false,true>``
(``tests/host_cuda/``), and the solver's adaptive single launch runs
through it as the card's wrapper launches it (``walk_kernel.launch_loop``:
every quota drained from fresh walks, so the walks are dealt to the
threads). On a square with a bump conductivity (axis-aligned walls keep
the walks in step across math libraries), six sources, each built from
the same numbers on both sides (a Gaussian dipole, a constant, a Gaussian
bump, a smoothed disk, a polynomial and a second bump: in that order,
whose last two are wide ``TERMS`` rows; turned by two, whose wide rows
are the dipole and the constant; and with the disk and the polynomial
swapped, whose wide rows are the disk's bump sum and the second bump),
follow the JAX package's
Pallas kernel in interpret mode walk for walk: equal total steps, sums to
rel 1e-5. The pole-pole line of
``chip_smoke.py`` phase 46 (nine unit poles at the scenario's buried
electrodes, 128 walks each, ``survey_config()``'s options) agrees with
the JAX package's ``WoStSolver`` on its XLA backend at the same seed:
every potential within 4 sigma, the two errors in quadrature.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

import chip_smoke as cs
from dcrmontecarlo_tpu_torch.problems import fields
from dcrmontecarlo_tpu_torch.solver import SolverOptions, WoStSolver
from test_torch_host_dealt_walks import WIDE, host_builds
from test_torch_host_dealt_walks_jax import _dealt_walk

torch.set_num_threads(1)

ROWS = WIDE + (False, True)


@pytest.fixture(scope="module")
def host_walks(tmp_path_factory):
    return host_builds(tmp_path_factory, (ROWS,))


# (dipole ends and width), constant, (bump center, amplitude, width),
# (disk center, radius, sharpness), (polynomial x and y slopes), bump
SIX = (((-0.5, -0.3), (0.4, 0.5), 0.2), 0.3, ((0.2, -0.4), 1.5, 0.3),
       ((-0.3, 0.4), 0.25, 20.0), (0.5, -0.25), ((-0.6, -0.6), 0.8, 0.25))


def six_sources():
    """``SIX`` as the port's field specs and as the JAX package's
    fields."""
    from dcrmontecarlo_tpu.problems import fields as jf

    (a, b, w), c, bump, disk, (sx, sy), bump2 = SIX
    port = [fields.gaussian_dipole(a, b, 1.0, w), fields.constant(c),
            fields.gaussian_bump(*bump), fields.smooth_circle(*disk),
            fields.polynomial({(1, 0): sx, (0, 1): sy}),
            fields.gaussian_bump(*bump2)]
    ref = [jf.gaussian_dipole(a, b, 1.0, w), jf.constant(c),
           jf.gaussian_bump(*bump), jf.smooth_circle(*disk),
           lambda x, y: sx * x + sy * y, jf.gaussian_bump(*bump2)]
    return port, ref


ORDERS = {"given": (0, 1, 2, 3, 4, 5), "turned": (2, 3, 4, 5, 0, 1),
          "disk_wide": (0, 1, 2, 4, 3, 5)}
KINDS = (fields.DIPOLE, fields.CONST, fields.TERMS, fields.BUMPS,
         fields.TERMS, fields.TERMS)


@pytest.mark.parametrize("order", sorted(ORDERS))
def test_six_kinds_follow_the_jax_pallas_kernel_walk_for_walk(host_walks,
                                                              order):
    from jax.experimental.pallas import tpu as pltpu

    from dcrmontecarlo_tpu.solver import SolverOptions as JOptions
    from dcrmontecarlo_tpu.solver import WoStSolver as JSolver
    from test_torch_split import _bump_problems

    tprob, _ = _bump_problems(fields.constant(0.0))
    _, jprob = _bump_problems(lambda x, y: 0.0 * x)
    port, ref = six_sources()
    turn = ORDERS[order]
    tprob.set_source_term([port[i] for i in turn])
    jprob = dataclasses.replace(jprob, source=[ref[i] for i in turn])
    pts = np.array([[0.0, 0.0], [0.4, 0.2], [-0.9, 0.7]], np.float32)
    kw = dict(target_slots=512, pallas_block_rows=2)
    with pltpu.force_tpu_interpret_mode():
        want = JSolver(jprob, JOptions(backend="pallas", **kw)).solve(
            pts, n_walks=128, max_steps=150, eps=2e-2, seed=9)
    solver = WoStSolver(tprob, SolverOptions(**kw), device="cpu")
    params = solver._setup(pts, 128, 150, 2e-2, 9)[1]
    assert params.variant == ROWS
    assert [f.kind for f in params.specs[3:]] == [KINDS[i] for i in turn]
    walk = _dealt_walk(host_walks[ROWS])
    got = solver._solve_raw(pts, 128, 150, 2e-2, 9, walk=walk)
    assert walk.loops == ["dealt"]
    assert got.total_steps == want.total_steps
    w_sum, w_sq = np.asarray(want.walk_sum), np.asarray(want.walk_sumsq)
    assert got.walk_sum.shape == w_sum.shape == (6, 3)
    np.testing.assert_allclose(got.walk_sum, w_sum, rtol=1e-5)
    np.testing.assert_allclose(got.walk_sumsq, w_sq, rtol=1e-5)
    assert (np.abs(got.walk_sum) > 0).all()


def test_pole_line_matches_jax_xla(host_walks):
    from dcrmontecarlo_tpu.models import geophysical_scenario as j_geo
    from dcrmontecarlo_tpu.problems import fields as jf
    from dcrmontecarlo_tpu.solver import SolverOptions as JOptions
    from dcrmontecarlo_tpu.solver import WoStSolver as JSolver

    survey, electrodes, tprob, options = cs.pole_config()
    pts = cs.survey_points(electrodes, -0.5)
    kw = dict(target_slots=4096, min_quota=options.min_quota,
              rejection_rounds=options.rejection_rounds)
    jsurvey, j_electrodes = j_geo(sharpness=0.5)
    w = jsurvey.source_width
    jprob = jsurvey.build_problem()
    jprob.set_source_term([
        jf.gaussian_bump(jsurvey._bury_source(e),
                         1.0 / (2.0 * math.pi * w * w), w)
        for e in j_electrodes])
    want = JSolver(jprob, JOptions(backend="xla", **kw)).solve(
        pts, n_walks=128, max_steps=500, eps=0.9, seed=4)
    solver = WoStSolver(tprob, dataclasses.replace(options, **kw),
                        device="cpu")
    assert solver._setup(pts, 128, 500, 0.9, 4)[1].variant == ROWS
    walk = _dealt_walk(host_walks[ROWS])
    got = solver._solve_raw(pts, 128, 500, 0.9, 4, walk=walk)
    assert walk.loops == ["dealt"]
    w_mean, w_se = np.asarray(want.mean), np.asarray(want.stderr)
    assert got.mean.shape == w_mean.shape == (9, 9)
    lim = 4.0 * np.hypot(got.stderr, w_se)
    assert (np.abs(got.mean - w_mean) <= lim).all(), (got.mean, w_mean,
                                                      lim)
    assert (got.stderr > 0).sum() > 70
