"""``tests/test_topography.py``'s whole survey solve, on the port.

The test-size topographic survey (``half_width=100, depth=150,
resolution=4``: 102 rows, the walk's table form with silhouettes), 9
electrodes draped at x = -40..40, 600 walks on the CPU: finite, the +20 m
side positive, the -20 m side negative, every |potential| < 1. The
boundaries against the JAX package are in ``test_torch_topography.py``.
"""

import numpy as np
import torch

from dcrmontecarlo_tpu_torch.models import drape_electrodes, \
    topographic_survey_problem
from dcrmontecarlo_tpu_torch.solver import SolverOptions, WoStSolver
from test_torch_topography import TEST_SIZE, XS

torch.set_num_threads(1)


def test_topographic_survey_solves():
    prob, h = topographic_survey_problem(**TEST_SIZE)
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
