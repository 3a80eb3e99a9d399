"""The per-step martingale audit on the port (``tests/test_martingale_audit
.py`` of the JAX package), and held against the JAX audit seed for seed.

The port's audit launches the solver's own walk one step at a time (the
CUDA kernel on the card, its plain version here) from a controlled start
state, and evaluates the continuation on the state's device between
launches. The two controls and the band partition run on the plain path
(``autodiff_manufactured`` builds its source by ``torch.func``, so it runs
on the CPU only), the controls at 2^13 walkers where the JAX test takes
2^15: the bounds scale with the standard errors. For the same seeds the
port's report equals the JAX XLA audit's visit counts and lies within one
standard error of its means (measured: to ~1e-5 relative). The notebook
audit's configuration runs at its full size on the card
(``chip_smoke.py`` phase 35) and at 2^12 walkers here, with its bounds.
"""
import math

import numpy as np
import pytest
import torch

from dcrmontecarlo_tpu_torch.diagnostics import MartingaleReport, \
    grid_continuation, martingale_audit
from dcrmontecarlo_tpu_torch.geometry import Polyline
from dcrmontecarlo_tpu_torch.models import autodiff_manufactured
from dcrmontecarlo_tpu_torch.solver import SolverOptions

torch.set_num_threads(1)

L, C0 = 10.0, 2.0
W_TANH = 0.6 * L
BOX = [[-L / 2, 0.0], [-L / 2, -L], [L / 2, -L], [L / 2, 0.0]]
WALL = [[-L / 2, 0.0], [L / 2, 0.0]]


def _um(x, y):
    return (100.0 * torch.sin(math.pi * (x + L / 2) / L)
            * torch.cos(math.pi * y / (2 * L)))


def _mms():
    def alpham(x, y):
        return torch.exp(-C0 * torch.tanh(-y / W_TANH)) + 0.0 * x

    prob, _ = autodiff_manufactured(
        _um, alpha=alpham, dirichlet=Polyline.from_points(BOX),
        neumann=Polyline.from_points(WALL))
    return prob


def _audit(robin, n_seeds=4, n_walkers=1 << 13, n_steps=24, **kw):
    opts = SolverOptions(target_slots=n_walkers, robin_correction=robin,
                         rejection_rounds=2, boundary_snap=0.01)
    return martingale_audit(
        _mms(), opts, (0.0, 0.0), continuation=_um, eps=0.02,
        on_boundary=True, normal=(0.0, -1.0), n_steps=n_steps,
        n_walkers=n_walkers, n_seeds=n_seeds, device="cpu", **kw)


def test_audit_blesses_unbiased_interior_and_detects_offmode_deficit():
    rep_chain = _audit("chain")
    assert isinstance(rep_chain, MartingaleReport)
    for b in (0, 1):
        assert abs(rep_chain.mean[b]) < 5 * rep_chain.sem[b] + 0.05, (
            rep_chain.bucket_names[b], rep_chain.mean[b], rep_chain.sem[b])
    assert -1.0 < rep_chain.mean[4] < 0.0
    rep_off = _audit(False)
    assert rep_off.mean[3] < -20.0
    assert rep_off.mean[3] < -5 * rep_off.sem[3]
    assert abs(rep_off.mean[0]) < 5 * rep_off.sem[0] + 0.05
    assert "far-interior" in str(rep_off)


def test_banded_audit_partitions_the_unbanded_buckets():
    kw = dict(n_steps=12, n_walkers=1 << 12, n_seeds=2)
    plain = _audit("chain", **kw)
    banded = _audit("chain", atten_bands=[0.9, 1.1], step_bands=[4], **kw)
    assert len(banded.bucket_names) == 5 * 3 * 2
    assert "far-interior@a<0.9@t<4" in banded.bucket_names
    assert "on-boundary@a>=1.1@t>=4" in banded.bucket_names
    n_b = np.asarray(banded.n).reshape(5, 3, 2)
    np.testing.assert_allclose(n_b.sum(axis=(1, 2)), plain.n)
    sums_b = (np.asarray(banded.mean) * np.asarray(banded.n)).reshape(
        5, 3, 2).sum(axis=(1, 2))
    np.testing.assert_allclose(
        sums_b, np.asarray(plain.mean) * np.asarray(plain.n),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("robin", ["chain", False])
def test_audit_matches_jax_seed_for_seed(robin):
    import jax.numpy as jnp

    from dcrmontecarlo_tpu.diagnostics import martingale_audit as j_audit
    from dcrmontecarlo_tpu.geometry import Polyline as JPolyline
    from dcrmontecarlo_tpu.models import autodiff_manufactured as j_mms
    from dcrmontecarlo_tpu.solver import SolverOptions as JOptions

    def um(x, y):
        return (100.0 * jnp.sin(jnp.pi * (x + L / 2) / L)
                * jnp.cos(jnp.pi * y / (2 * L)))

    jprob, _ = j_mms(
        um, alpha=lambda x, y: jnp.exp(-C0 * jnp.tanh(-y / W_TANH)) + 0.0 * x,
        dirichlet=JPolyline.from_points(BOX),
        neumann=JPolyline.from_points(WALL))
    kw = dict(n_steps=12, n_walkers=1 << 12, n_seeds=2, seed0=3)
    want = j_audit(jprob, JOptions(backend="xla", target_slots=1 << 12,
                                   robin_correction=robin,
                                   rejection_rounds=2, boundary_snap=0.01),
                   (0.0, 0.0), continuation=um, eps=0.02, on_boundary=True,
                   normal=(0.0, -1.0), **kw)
    got = _audit(robin, **kw)
    assert list(got.bucket_names) == list(want.bucket_names)
    np.testing.assert_array_equal(got.n, want.n)
    live = want.n > 0
    assert (np.abs(got.mean - want.mean)[live] <= want.sem[live]).all(), (
        got.mean, want.mean, want.sem)
    np.testing.assert_allclose(got.visits_per_walk, want.visits_per_walk)


def test_notebook_step_operator_normalized_residuals():
    # tests/test_martingale_audit.py's notebook tripwire (MIS, the chain,
    # the FDM-oracle continuation) with its bounds, at 2^12 walkers
    from dcrmontecarlo_tpu_torch.models import notebook_survey
    from dcrmontecarlo_tpu_torch.validation import fdm_solve

    survey, _ = notebook_survey()
    survey.source_mis = True
    prob = survey.build_problem()

    def np_field(f):
        return lambda X, Y: f(torch.as_tensor(X, dtype=torch.float32),
                              torch.as_tensor(Y, dtype=torch.float32)
                              ).numpy()

    fdm = fdm_solve(bounds=((-500.0, 500.0), (-1000.0, 1.0)),
                    alpha=np_field(prob.alpha), source=np_field(prob.source),
                    neumann_top=True, nx=201, ny=201)
    cont = grid_continuation(fdm.xs, fdm.ys, fdm.u)
    opts = SolverOptions(target_slots=1 << 12, robin_correction="chain",
                         rejection_rounds=2)
    rep = martingale_audit(
        prob, opts, (0.0, -0.1), continuation=cont, eps=1.0,
        max_steps=6000, n_steps=24, n_walkers=1 << 12, n_seeds=4,
        normalize_by_atten=True, device="cpu")
    assert abs(rep.mean[0]) < 5 * rep.sem[0] + 0.03, (
        rep.mean[0], rep.sem[0])
    for b in (1, 2):
        if rep.n[b] == 0:
            continue
        assert abs(rep.mean[b]) < 5 * rep.sem[b] + 0.1, (
            rep.bucket_names[b], rep.mean[b], rep.sem[b])
    assert rep.n[1] > 0 and rep.n[2] > 0
