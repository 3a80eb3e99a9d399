"""The DCR survey of the PyTorch port against the finite-volume oracle.

The gate of ``tests/test_dcr_survey.py`` at the same settings (9
electrodes x 1500 walks, eps 0.5, max_steps 800, 16384 target slots):
at least 8 of 9 electrode potentials within 4 sigma + 2e-4 of the
oracle. The oracle is the JAX package's ``validation.fdm_solve``
(numpy/scipy only), fed the port's own conductivity and source fields.
The port's own copy of it (``dcrmontecarlo_tpu_torch.validation``, which
``chip_smoke.py`` uses) gives the same electrode potentials, to 1e-12
relative: the same code on the same inputs.
"""

import numpy as np
import torch

from dcrmontecarlo_tpu.validation import fdm_solve
from dcrmontecarlo_tpu_torch.models import geophysical_scenario
from dcrmontecarlo_tpu_torch.solver import SolverOptions
from dcrmontecarlo_tpu_torch.validation import fdm_solve as port_fdm_solve

torch.set_num_threads(1)


def _np_field(f):
    return lambda X, Y: f(torch.as_tensor(X, dtype=torch.float32),
                          torch.as_tensor(Y, dtype=torch.float32)).numpy()


def test_port_oracle_copy_matches_jax_package():
    survey, electrodes = geophysical_scenario(sharpness=0.5)
    prob = survey.build_problem()
    kw = dict(bounds=((-100.0, 100.0), (-200.0, 0.0)),
              alpha=_np_field(prob.alpha), source=_np_field(prob.source),
              neumann_top=True, nx=121, ny=121)
    pts = np.asarray(electrodes, np.float64) - [0.0, 0.1]
    want = fdm_solve(**kw)(pts)
    got = port_fdm_solve(**kw)(pts)
    assert np.isfinite(want).all() and np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)


def test_dcr_potentials_match_fdm():
    survey, electrodes = geophysical_scenario(sharpness=0.5)
    result = survey.run(electrodes, n_walks=1500, max_steps=800, eps=0.5,
                        seed=0, options=SolverOptions(target_slots=16384),
                        device="cpu")
    prob = survey.build_problem()
    fdm = fdm_solve(bounds=((-100.0, 100.0), (-200.0, 0.0)),
                    alpha=_np_field(prob.alpha),
                    source=_np_field(prob.source),
                    neumann_top=True, nx=321, ny=321)
    ref = fdm(result.electrodes)
    err = np.abs(result.potentials - ref)
    tol = 4.0 * result.potentials_stderr + 2e-4  # MC error + shell/grid bias
    assert (err < tol).mean() >= 8 / 9, (result.potentials, ref,
                                         result.potentials_stderr)
