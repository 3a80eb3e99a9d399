"""The flagship notebook gate's path, whole solve, port against JAX.

``DCRSurvey.run`` on ``notebook_survey()`` with ``source_mis=True``,
``local_majorant="auto"`` and ``survey_default_options(target_slots=1<<17,
split_threshold=4.0)``, 21 electrodes x 64 walks, ``eps=1.0``, on the CPU
(the plain walk through the host launch loop: the freeze and the split
at launch boundaries), against the JAX package's XLA backend at the same
seed (which splits in-graph every 16 steps): the two agree only
statistically, per electrode ``|dmean| <= 4 sqrt(se_port^2 + se_jax^2)``.

The same configuration at 21 x 16 walks also runs through the JAX
package's own Pallas host loop (in interpret mode, the kernel built with
MIS, the chain, the majorant and the freeze): equal total steps and
clone counts, means to ``1e-3 (|mean| + stderr)``
(``test_torch_flagship_host_loop.py``).

Two settings differ from the gate's, to keep the solves inside a minute
on one CPU thread. ``pallas_block_rows=1``: with the default 64-row blocks,
7,856 of the 8,192 lanes are padding, and padding lanes host clones; on
this survey nearly every active lane is heavy at every launch boundary,
so the clones fill all 8,192 lanes and the loop runs to its launch cap
(measured: 611 s, 142,554 clones at ``max_steps=6000``). One row per block
leaves 48 padding lanes beside the 84 reserved ones, about the gate's own
proportion of idle to working lanes. ``max_steps=300``: the launch cap is
``quota * (max_steps + 1) / 256``, so the cap shrinks with it (both sides
truncate at the same step count). The gate's own settings run on the card
(``chip_smoke.py`` phase 14, ``test_torch_cuda.py``).
"""

import numpy as np
import pytest
import torch

from dcrmontecarlo_tpu.models import notebook_survey as j_nb
from dcrmontecarlo_tpu.survey import dcr as jdcr
from dcrmontecarlo_tpu_torch.models import notebook_survey
from dcrmontecarlo_tpu_torch.survey import survey_default_options

torch.set_num_threads(1)

N_WALKS, MAX_STEPS, EPS, SEED = 64, 300, 1.0, 0


@pytest.fixture(scope="module")
def paired_runs():
    js, je = j_nb()
    js.local_majorant = "auto"
    js.source_mis = True
    want = js.run(je, n_walks=N_WALKS, max_steps=MAX_STEPS, eps=EPS,
                  seed=SEED, options=jdcr.survey_default_options(
                      backend="xla", target_slots=1 << 17,
                      split_threshold=4.0))
    ts, te = notebook_survey()
    ts.local_majorant = "auto"
    ts.source_mis = True
    solver = ts.make_solver(survey_default_options(
        target_slots=1 << 17, split_threshold=4.0, pallas_block_rows=1),
        device="cpu")
    got = ts.run(te, n_walks=N_WALKS, max_steps=MAX_STEPS, eps=EPS,
                 seed=SEED, solver=solver)
    return got, want, solver


def test_flagship_solve_matches_jax_xla(paired_runs):
    got, want, _ = paired_runs
    g, w = got.solve, want.solve
    gm, wm = np.asarray(g.mean), np.asarray(w.mean)
    lim = 4.0 * np.sqrt(np.asarray(g.stderr) ** 2
                        + np.asarray(w.stderr) ** 2)
    assert gm.shape == (21,) and np.isfinite(gm).all()
    assert np.isfinite(got.potentials_stderr).all()
    assert (np.abs(gm - wm) <= lim).all(), (gm, wm, lim)
    # the split ran on both sides: clones walk on top of the 21 x 64 walks
    assert g.total_steps > 0 and w.total_steps > 0


def test_flagship_path_runs_chain_mis_and_the_split(paired_runs):
    got, _, solver = paired_runs
    assert solver._robin_enabled() == "chain"
    pb = solver.problem
    assert pb.local_majorant is not None and len(pb.local_majorant.boxes) == 2
    assert pb.source_importance is not None
    stats = solver.last_solve_stats
    assert stats["clones"] > 0 and stats["launches"] > 1
