"""The flagship notebook gate's path through both packages' Pallas host loops.

``notebook_survey()`` with ``source_mis=True`` and ``local_majorant="auto"``
(the port takes the JAX problem's majorant and mixture, ``interop``), the
split at 4 and 64-step launches, 21 electrodes x 16 walks, ``max_steps``
300, ``pallas_block_rows=1`` (``test_torch_flagship.py`` says why): the
port's plain walk through its host launch loop against the JAX package's
Pallas host loop in interpret mode (the kernel built with MIS, the chain,
the majorant and the freeze, ``test_torch_split.py::_host_loop_pair``):
equal total steps, clone counts and progress calls, means to ``1e-3
(|mean| + stderr)``.
"""

import numpy as np
import torch

from dcrmontecarlo_tpu.models import notebook_survey as j_nb
from dcrmontecarlo_tpu_torch import interop
from dcrmontecarlo_tpu_torch.models import notebook_survey
from test_torch_flagship import EPS, MAX_STEPS
from test_torch_split import _host_loop_pair

torch.set_num_threads(1)


def test_flagship_host_loop_matches_pallas_host_loop():
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
    r = _host_loop_pair(tprob, jprob, np.asarray(je, np.float32), 16,
                        MAX_STEPS, 3, 4.0, n_inner=64, eps=EPS,
                        target_slots=1 << 17, block_rows=1,
                        common_random_numbers=True, roulette_threshold=0.05,
                        rejection_rounds=2, robin_correction="chain")
    got, want = r["got"], r["want"]
    assert got.total_steps == want.total_steps
    assert r["stats"]["clones"] == r["j_clones"] > 0
    wm = np.asarray(want.mean)
    se = np.sqrt(got.stderr ** 2 + np.asarray(want.stderr) ** 2)
    assert (np.abs(got.mean - wm) <= 1e-3 * (np.abs(wm) + se)).all()
    assert r["t_calls"] == r["j_calls"]
