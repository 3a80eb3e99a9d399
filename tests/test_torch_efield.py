"""The E-field estimator, port against the JAX package.

``estimate_field`` solves the 5-point stencil of every point in one solve
with common random numbers. The port's plain walk and the JAX package's
XLA backend draw the same streams from the same seed, so on
``tests/test_efield.py``'s linear potential and multi-source problems (the
coefficient-free walk: no weights) at a cut size the potentials at the
stencil centers agree to 1e-5 of their scale ``U``, and the fields and
their error bars to ``1e-5 U / h``: a field is a difference of two
potentials over ``2h``, and the float32 moments are summed in another
order (measured: 3.4e-5 on fields of ~1.1 with ``h = 0.02``, where the
bound is 5.7e-4). With ``n_batches > 1`` the hashed batch seeds (``mix32``
on ``np.uint32``) and the walk counts of the batches are IDENTICAL, and
the batch fields agree to the same bound.
"""

import numpy as np
import pytest
import torch

from dcrmontecarlo_tpu import Problem as JProblem
from dcrmontecarlo_tpu.geometry import square_loop as j_square
from dcrmontecarlo_tpu.sampling.rng import mix32 as j_mix32
from dcrmontecarlo_tpu.solver import SolverOptions as JOptions
from dcrmontecarlo_tpu.survey import efield as jef
from dcrmontecarlo_tpu_torch.geometry import square_loop
from dcrmontecarlo_tpu_torch.problems import Problem, fields
from dcrmontecarlo_tpu_torch.sampling.rng import mix32
from dcrmontecarlo_tpu_torch.solver import SolverOptions
from dcrmontecarlo_tpu_torch.survey import efield as tef

torch.set_num_threads(1)

REL = 1e-5  # of the potentials' largest magnitude
SMALL = dict(target_slots=1024, pallas_inner_steps=16, pallas_block_rows=8)


def _linear():
    return (Problem(dirichlet=square_loop(1.0),
                    bc_dirichlet=fields.polynomial({(1, 0): 1.0,
                                                    (0, 1): 2.0})),
            JProblem(dirichlet=j_square(1.0),
                     bc_dirichlet=lambda x, y: x + 2.0 * y))


def _multi():
    return (Problem(dirichlet=square_loop(2.0),
                    bc_dirichlet=fields.polynomial({(2, 0): 1.0,
                                                    (0, 2): 1.0}),
                    source=[fields.constant(-4.0), fields.constant(0.0)]),
            JProblem(dirichlet=j_square(2.0),
                     bc_dirichlet=lambda x, y: x * x + y * y,
                     source=[lambda x, y: -4.0 + 0.0 * x,
                             lambda x, y: 0.0 * x]))


def _recording(monkeypatch, module, log):
    """Record the seed and walk count of every solve ``module`` makes."""
    base = module.WoStSolver

    class Recording(base):
        def solve(self, points, n_walks=1000, max_steps=1000, eps=1e-4,
                  seed=0, **kw):
            log.append((int(seed), int(n_walks)))
            return super().solve(points, n_walks=n_walks,
                                 max_steps=max_steps, eps=eps, seed=seed,
                                 **kw)

    monkeypatch.setattr(module, "WoStSolver", Recording)


def _close(got, want, atol):
    g, w = np.asarray(got), np.asarray(want)
    assert g.shape == w.shape and np.isfinite(g).all()
    np.testing.assert_allclose(g, w, rtol=0, atol=atol)


def _same_fields(got, want, h, names):
    scale = np.abs(np.asarray(want.potential)).max()
    _close(got.potential, want.potential, REL * scale)
    for k in names:
        _close(getattr(got, k), getattr(want, k), REL * scale / h)


@pytest.mark.parametrize("make,pts", [
    (_linear, [[0.0, 0.0], [0.3, -0.2]]),
    (_multi, [[0.5, 0.0], [0.0, 0.5]]),
])
def test_field_matches_jax_xla(make, pts):
    tprob, jprob = make()
    pts = np.asarray(pts, np.float32)
    kw = dict(h=0.02, n_walks=64, max_steps=100, eps=1e-3, seed=0)
    want = jef.estimate_field(jprob, pts, options=JOptions(
        backend="xla", **SMALL), **kw)
    got = tef.estimate_field(tprob, pts, options=SolverOptions(**SMALL),
                             device="cpu", **kw)
    _same_fields(got, want, kw["h"], ("ex", "ey", "ex_stderr", "ey_stderr"))
    assert got.ex_batches is None and want.ex_batches is None
    if make is _multi:
        assert got.ex.shape == (2, 2) and got.potential.shape == (2, 2)


@pytest.mark.parametrize("seed", [0, 11, 2**31 + 3])
def test_batch_seeds_match_jax(seed):
    for b in range(6):
        word = np.uint32(seed) ^ np.uint32((0xB5297A4D * (b + 1))
                                           & 0xFFFFFFFF)
        assert int(mix32(word)) == int(j_mix32(word))


def test_batches_match_jax_xla(monkeypatch):
    tlog, jlog = [], []
    _recording(monkeypatch, tef, tlog)
    _recording(monkeypatch, jef, jlog)
    tprob, jprob = _linear()
    pts = np.asarray([[0.1, 0.2]], np.float32)
    kw = dict(h=0.02, n_walks=50, max_steps=100, eps=1e-3, seed=7,
              n_batches=3)
    want = jef.estimate_field(jprob, pts, options=JOptions(
        backend="xla", **SMALL), **kw)
    got = tef.estimate_field(tprob, pts, options=SolverOptions(**SMALL),
                             device="cpu", **kw)
    assert tlog == jlog and len(tlog) == 3
    assert [n for _, n in tlog] == [17, 17, 16]  # the exact walk budget
    assert got.ex_batches.shape == (3, 1)
    _same_fields(got, want, kw["h"], ("ex", "ey", "ex_stderr", "ey_stderr",
                                       "ex_batches", "ey_batches"))
