"""Whole solves through the dealt loop of the survey's transport and MIS
builds against the JAX package.

The host compiler builds ``csrc/walk_kernel.cu``'s survey build with the
transport sampler ``<0,false,false,false,false,true,true>`` and with MIS
``<0,false,true,false,false,true,false>`` (``tests/host_cuda/``), and
``WoStSolver._solve_raw`` runs its adaptive single launch through them as
the card's wrapper launches it: the cases of
``test_torch_host_dealt_walks_jax.py``. The geophysical survey with the
transport sampler and with its MIS mixture (9 electrodes x 256 walks)
agrees with the JAX package's XLA backend at the same seed within 4 sigma
per electrode, total steps within 3%; the bump square with a dipole and
its two-component mixture walks the JAX package's Pallas kernel's walks
in interpret mode with MIS: equal total steps, sums to rel 1e-5.
"""

import numpy as np
import pytest
import torch

from test_torch_host_dealt_walks import NAMES, SURVEY_MIS, TRANSPORT, \
    host_builds
from test_torch_host_dealt_walks_jax import square_solve_case, \
    survey_solve_case

torch.set_num_threads(1)

HERE = (TRANSPORT, SURVEY_MIS)


@pytest.fixture(scope="module")
def host_walks(tmp_path_factory):
    return host_builds(tmp_path_factory, HERE)


@pytest.mark.parametrize("variant", HERE, ids=[NAMES[v] for v in HERE])
def test_survey_solve_through_the_dealt_loop_matches_jax_xla(host_walks,
                                                            variant):
    survey_solve_case(host_walks[variant],
                      "transport" if variant == TRANSPORT else "mis")


@pytest.mark.parametrize("variant", [SURVEY_MIS], ids=["survey_mis"])
def test_square_solve_through_the_dealt_loop_matches_jax_pallas(host_walks,
                                                               variant):
    got = square_solve_case(host_walks[variant], mis=True)
    assert np.abs(got.walk_sum[0]).max() > 0
