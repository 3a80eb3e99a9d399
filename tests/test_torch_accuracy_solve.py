"""The notebook survey's accuracy path, whole solves, port against JAX.

``DCRSurvey.run`` on ``notebook_survey()`` with ``local_majorant="auto"``
and the survey defaults (``target_slots=1<<17``: CRN, roulette 0.05, two
rejection rounds, boundary snap; Robin ``auto``), 21 electrodes x 64
walks, ``max_steps=6000``, ``eps=1.0``, against the JAX package's XLA
backend at the same seed. Both draw the same counter-hash streams, so
per electrode ``|dmean| <= 4 sqrt(se_port^2 + se_jax^2)`` is a loose
bound; measured on the CPU, the means agree to ~1e-6 relative and the
total steps are EQUAL (66,183), which the test also asserts, with the
dipole voltages to rel 1e-3 + 1e-3 absolute.
"""

import numpy as np
import pytest
import torch

from dcrmontecarlo_tpu.models import notebook_survey as j_nb
from dcrmontecarlo_tpu.survey import dcr as jdcr
from dcrmontecarlo_tpu_torch import interop
from dcrmontecarlo_tpu_torch.models import notebook_survey
from dcrmontecarlo_tpu_torch.survey import survey_default_options

torch.set_num_threads(1)

N_WALKS, MAX_STEPS, EPS, SEED = 64, 6000, 1.0, 0


@pytest.fixture(scope="module")
def paired_runs():
    js, je = j_nb()
    js.local_majorant = "auto"
    j_opts = jdcr.survey_default_options(backend="xla", target_slots=1 << 17)
    want = js.run(je, n_walks=N_WALKS, max_steps=MAX_STEPS, eps=EPS,
                  seed=SEED, options=j_opts)
    ts, te = notebook_survey()
    ts.local_majorant = "auto"
    # the same Robin settings, carried over from the JAX options
    robin = interop.robin_options_from(j_opts)
    assert robin == {"robin_correction": "auto", "robin_interior": "arrival",
                     "robin_arrival_clamp": 0.02}
    solver = ts.make_solver(survey_default_options(target_slots=1 << 17,
                                                   **robin), device="cpu")
    got = ts.run(te, n_walks=N_WALKS, max_steps=MAX_STEPS, eps=EPS,
                 seed=SEED, solver=solver)
    return got, want, solver


def test_accuracy_solve_matches_jax_xla(paired_runs):
    got, want, _ = paired_runs
    g, w = got.solve, want.solve
    gm, wm = np.asarray(g.mean), np.asarray(w.mean)
    lim = 4.0 * np.sqrt(np.asarray(g.stderr) ** 2
                        + np.asarray(w.stderr) ** 2)
    assert gm.shape == (21,) and np.isfinite(gm).all()
    assert (np.abs(gm - wm) <= lim).all(), (gm, wm, lim)
    assert g.total_steps == w.total_steps
    np.testing.assert_allclose(got.voltages, np.asarray(want.voltages),
                               rtol=1e-3, atol=1e-3)


def test_accuracy_path_resolves_chain_and_two_boxes(paired_runs):
    got, _, solver = paired_runs
    assert solver._robin_enabled() == "chain"
    mj = solver.problem.local_majorant
    assert len(mj.boxes) == 2 and mj.bands == ()
    # ~50 walker-steps per walk, as the JAX package's accuracy preset takes
    assert 40.0 < got.solve.total_steps / (21 * N_WALKS) < 60.0
