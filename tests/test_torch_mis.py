"""MIS next-event estimation in the port against the JAX package.

The importance mixture (``fields.GaussianMixture``): ``sample`` and ``pdf``
on the same numpy uniforms and points equal the JAX package's to float32
rounding (rel 1e-6; the cosines and logs of two math libraries). The
walk: 1024 numpy-built lanes go through the interpreted Pallas kernel and
the port's plain walk for 32 steps (as ``test_torch_walk_kernel.py``
sets them up), in two cases with ``source_mis``: the flagship notebook
gate's kernel variant (the Robin chord chain and ``local_majorant="auto"``,
the majorant and the mixture carried over by ``interop``; CRN, roulette
0.05, two rejection rounds, boundary snap) and the geophysical survey
(Robin off, no majorant). Every plane agrees on >= 99% of lanes
(``walk_kernel.compare_planes``), and the mechanism ran: the same 32 steps
without the mixture change ``acc0`` on >= 1% of lanes (MIS moves no walker:
it changes what the walk banks, not where it goes).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcrmontecarlo_tpu.models import geophysical_scenario as j_geo
from dcrmontecarlo_tpu.models import notebook_survey as j_nb
from dcrmontecarlo_tpu.ops.pallas_walk import make_pallas_walk
from dcrmontecarlo_tpu.problems import fields as jf
from dcrmontecarlo_tpu.solver import SolverOptions as JOptions
from dcrmontecarlo_tpu.solver import WoStSolver as JSolver
from dcrmontecarlo_tpu_torch import interop
from dcrmontecarlo_tpu_torch.models import geophysical_scenario, \
    notebook_survey
from dcrmontecarlo_tpu_torch.ops import walk_kernel as wk
from dcrmontecarlo_tpu_torch.problems import fields
from dcrmontecarlo_tpu_torch.sampling.rng import stream_seed
from dcrmontecarlo_tpu_torch.solver.state import state_planes
from test_torch_walk_kernel import OPTS, POINTS, SEED, STEPS, _compare, \
    numpy_planes

torch.set_num_threads(1)

COMPONENTS = [((-200.0, -9.0), 5.0, 0.5), ((200.0, -9.0), 5.0, 0.5),
              ((13.25, -41.5), 0.75, -2.0)]


def test_mixture_from_components_matches_jax():
    t = fields.GaussianMixture.from_components(COMPONENTS)
    j = jf.GaussianMixture.from_components(COMPONENTS)
    for a, b in zip(t, j):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    t2 = fields.dipole_importance((-10.0, -1.0), (10.0, -1.0), 0.5)
    j2 = jf.dipole_importance((-10.0, -1.0), (10.0, -1.0), 0.5)
    for a, b in zip(t2, j2):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(interop.gaussian_mixture_from(j), t):
        assert torch.equal(a, b)
    assert interop.gaussian_mixture_from(None) is None


def test_mixture_sample_and_pdf_match_jax():
    rng = np.random.default_rng(5)
    u = rng.random((3, 4096), dtype=np.float32)
    u[1, :4] = [0.0, 1e-13, 1.0 - 2**-24, 0.5]   # the log's clamp
    t = fields.GaussianMixture.from_components(COMPONENTS)
    j = jf.GaussianMixture.from_components(COMPONENTS)
    tx, ty = t.sample(*(torch.from_numpy(v) for v in u))
    jx, jy = j.sample(*(jnp.asarray(v) for v in u))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-6,
                               atol=1e-4)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-6,
                               atol=1e-4)
    # the component pick is exact: the same centre for every draw
    pick = lambda x, y: np.argmin(np.hypot(
        x[:, None] - np.array([-200.0, 200.0, 13.25]),
        y[:, None] - np.array([-9.0, -9.0, -41.5])), 1)
    np.testing.assert_array_equal(pick(tx.numpy(), ty.numpy()),
                                  pick(np.asarray(jx), np.asarray(jy)))
    px = np.concatenate([tx.numpy(), rng.uniform(-250, 250, 512)]
                        ).astype(np.float32)
    py = np.concatenate([ty.numpy(), rng.uniform(-60, 0, 512)]
                        ).astype(np.float32)
    tp = t.pdf(torch.from_numpy(px), torch.from_numpy(py)).numpy()
    jp = np.asarray(j.pdf(jnp.asarray(px), jnp.asarray(py)))
    np.testing.assert_allclose(tp, jp, rtol=1e-5, atol=1e-30)
    assert (tp > 0).mean() > 0.5


def test_mis_table_is_the_pallas_kernels_constants():
    # the float32 cumsum and the float64 products of the float32 widths,
    # each rounded once (ops/pallas_walk.py:569-576, :975-979)
    j = jf.GaussianMixture.from_components(COMPONENTS)
    tab = wk._mis_table(interop.gaussian_mixture_from(j))
    w = np.asarray(j.width)
    assert tab.dtype == np.float32 and tab.shape == (3, 7)
    np.testing.assert_array_equal(tab[:, 4], np.cumsum(np.asarray(
        j.weight, np.float32)))
    for i, wi in enumerate(w):
        w2 = float(wi) * float(wi)
        assert tab[i, 5] == np.float32(2.0 * w2)
        assert tab[i, 6] == np.float32(float(2.0 * np.pi) * w2)


@pytest.fixture(scope="module")
def mis_problems():
    """(port problem, JAX problem, points) per case; the port walks the
    JAX package's majorant and mixture (``interop``)."""
    js, je = j_nb()
    js.local_majorant = "auto"
    js.source_mis = True
    jprob = js.build_problem()
    ts, _ = notebook_survey()
    ts.source_mis = True
    ts.local_majorant = interop.local_majorant_from(jprob.local_majorant)
    tprob = ts.build_problem()
    tprob.set_source_importance(
        interop.gaussian_mixture_from(jprob.source_importance))
    out = {"flagship": (tprob, jprob, np.asarray(je, np.float32), 1024, 1.0,
                        6000, "chain")}
    jg, _ = j_geo()
    jg.source_mis = True
    jgprob = jg.build_problem()
    tg, _ = geophysical_scenario()
    tg.source_mis = True
    out["geophysical"] = (tg.build_problem(), jgprob, POINTS, 256, 0.9, 12,
                          False)
    return out


@pytest.mark.parametrize("case", ["flagship", "geophysical"])
def test_mis_walk_matches_pallas_kernel(mis_problems, case):
    from jax.experimental.pallas import tpu as pltpu

    tprob, jprob, pts, n_walks, eps, max_steps, mode = mis_problems[case]
    jsolver = JSolver(jprob, JOptions(robin_correction=mode, **OPTS))
    assert jsolver._robin_enabled() == mode
    assert (jprob.local_majorant is not None) == (case == "flagship")
    planes = numpy_planes(jsolver, pts, n_walks, eps)
    assert planes["px"].size == 1024
    common = dict(eps=eps, max_steps=max_steps, t_min=1e-5 * jprob.diameter,
                  rmin=0.5 * eps, project=True, rejection_rounds=2,
                  roulette_threshold=0.05)
    plan = make_pallas_walk(jprob, n_inner=STEPS, block_rows=8,
                            snap_starts=True, robin_correction=mode,
                            robin_arrival_clamp=0.02, **common)
    with pltpu.force_tpu_interpret_mode():
        out = plan.run({k: jnp.asarray(v) for k, v in planes.items()},
                       stream_seed(SEED), inner_steps=STEPS)
    want = {k: np.asarray(v) for k, v in out.items()}

    params = wk.make_walk_params(tprob, snap=True, seed=stream_seed(SEED),
                                 robin_correction=mode, **common)
    assert params.mis_table is not None and params.mis_table.shape == (2, 7)
    assert params.variant[2] and not params.variant[3]
    got = interop.state_to_numpy(wk.run_walk(interop.state_from_numpy(planes),
                                             params, STEPS))
    _compare(got, want, state_planes(1))
    assert (want["ndone"] > 0).any() and (want["asum0"] != 0).any()
    # the mechanism ran: the same walk without the mixture banks otherwise
    other = interop.state_to_numpy(wk.walk_plain(
        interop.state_from_numpy(planes),
        dataclasses.replace(params, mis_table=None), STEPS))
    np.testing.assert_array_equal(other["px"], got["px"])
    differ = other["acc0"] != got["acc0"]
    assert differ.mean() >= 0.01, differ.mean()
