"""Phase 48's configuration through whole solves, against the JAX package.

``chip_smoke.py`` phase 48 is the topographic survey over shallow bodies:
``topographic_survey_problem(anomalies=SHALLOW_ANOMALIES)``, the defaults'
two bodies raised to 25 and 30 m depth, where Robin ``"auto"`` resolves to
the chord chain (``solver/wost.py``'s scale above 0.05). At the test size
of ``tests/test_topography.py`` (``half_width=100, depth=150,
resolution=4``: 102 rows, the table form) both sides resolve ``"auto"`` to
``"chain"``, and the port's solve through the host build of the table
chain ``<1,false,false,false,true,true,false>`` (``tests/host_cuda/``, its
chord frame culled: ``walk_kernel.culled_chord``), launched as the card's wrapper launches it, agrees with
the JAX package's solve at the same seed on its default backend: every
electrode within 4 sigma of the two errors in quadrature (the two draw the
same counter-hash streams, but on the sloped terrain a one-ulp difference
of the two math libraries parts a walk), and both pass
``tests/test_topography.py``'s physics (the +20 m side positive, the -20 m
side negative, every |potential| < 1).
"""

import numpy as np
import pytest
import torch

import chip_smoke as cs
from dcrmontecarlo_tpu_torch.solver import SolverOptions, WoStSolver
from test_torch_host_dealt_walks import host_builds
from test_torch_host_dealt_walks_jax import _dealt_walk

torch.set_num_threads(1)

_F, _T = False, True
CHAIN = (1, _F, _F, _F, _T, _T, _F, _F, _F)
SIZE = dict(half_width=100.0, depth=150.0, resolution=4.0)
WALKS, MAX_STEPS, EPS = 256, 600, 0.5


@pytest.fixture(scope="module")
def host_walks(tmp_path_factory):
    return host_builds(tmp_path_factory, (CHAIN,))


def _physics(mean):
    xs = cs.TOPO_XS
    m = np.asarray(mean).reshape(-1)
    return (np.isfinite(m).all() and m[int(np.argmin(np.abs(xs + 20)))] > 0
            and m[int(np.argmin(np.abs(xs - 20)))] < 0
            and np.abs(m).max() < 1.0)


def test_shallow_terrain_resolves_the_chain_and_matches_jax(host_walks):
    from dcrmontecarlo_tpu.models import drape_electrodes as j_drape
    from dcrmontecarlo_tpu.models import \
        topographic_survey_problem as j_topo
    from dcrmontecarlo_tpu.solver import SolverOptions as JOptions
    from dcrmontecarlo_tpu.solver import WoStSolver as JSolver

    jprob, jh = j_topo(anomalies=cs.SHALLOW_ANOMALIES, **SIZE)
    pts = np.asarray(j_drape(jh, cs.TOPO_XS, nudge=0.5), np.float32)
    jsolver = JSolver(jprob, JOptions(target_slots=8192))
    prob, t_pts, _ = cs.shallow_terrain_config(**SIZE)
    solver = WoStSolver(prob, SolverOptions(target_slots=8192),
                        device="cpu")
    assert jsolver._robin_enabled() == solver._robin_enabled() == "chain"
    np.testing.assert_allclose(t_pts, pts, rtol=0, atol=1e-6)
    want = jsolver.solve(pts, n_walks=WALKS, max_steps=MAX_STEPS, eps=EPS,
                         seed=0)
    walk = _dealt_walk(host_walks[CHAIN])
    got = solver._solve_raw(pts, WALKS, MAX_STEPS, EPS, 0, walk=walk)
    assert set(walk.loops) == {"lanes"}
    w, w_se = np.asarray(want.mean), np.asarray(want.stderr)
    g, g_se = got.mean[0], got.stderr[0]
    assert np.isfinite(g).all() and np.isfinite(g_se).all()
    assert (np.abs(g - w) <= 4.0 * np.hypot(g_se, w_se)).all(), (
        g, w, g_se, w_se)
    assert _physics(g) and _physics(w), (g, w)
