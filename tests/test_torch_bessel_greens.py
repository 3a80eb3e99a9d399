"""Bessel functions and ball Green's functions of the PyTorch port.

Held against the JAX package in float32 over 1e-6..50 (same polynomials,
same branch guards: rel 1e-5) and against scipy in float64, as
``tests/test_bessel_greens.py`` holds the JAX package.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.special as sp
import torch

from dcrmontecarlo_tpu.ops import bessel as jb
from dcrmontecarlo_tpu.ops import greens as jg
from dcrmontecarlo_tpu_torch.ops import bessel as tb
from dcrmontecarlo_tpu_torch.ops import greens as tg

torch.set_num_threads(1)

X32 = np.geomspace(1e-6, 50.0, 2000).astype(np.float32)
REL = 1e-5


def _both(jf, tf, *args):
    want = np.asarray(jf(*[jnp.asarray(a) if isinstance(a, np.ndarray)
                           else a for a in args]))
    got = tf(*[torch.from_numpy(a) if isinstance(a, np.ndarray) else a
               for a in args]).numpy()
    assert got.dtype == np.float32
    return got, want


@pytest.mark.parametrize("name", ["i0", "i0e", "k0", "k0e", "i1", "i1e",
                                  "k1", "k1e", "ii0e", "ik0"])
def test_bessel_matches_jax(name):
    got, want = _both(getattr(jb, name), getattr(tb, name), X32)
    np.testing.assert_allclose(got, want, rtol=REL)


@pytest.mark.parametrize("name", ["_one_minus_inv_i0", "screened_interior_prob",
                                  "greens_norm_2d"])
def test_greens_unary_matches_jax(name):
    if name == "_one_minus_inv_i0":
        got, want = _both(jg._one_minus_inv_i0, tg._one_minus_inv_i0, X32)
    elif name == "screened_interior_prob":
        got, want = _both(jg.screened_interior_prob,
                          tg.screened_interior_prob, X32, 0.0736196)
    else:
        got, want = _both(jg.greens_norm_2d, tg.greens_norm_2d, X32)
    np.testing.assert_allclose(got, want, rtol=REL)


@pytest.mark.parametrize("sb", [1e-6, 0.0026998, 0.0736196, 2.5])
def test_screened_norm_matches_jax(sb):
    got, want = _both(jg.screened_greens_norm_2d, tg.screened_greens_norm_2d,
                      X32, sb)
    np.testing.assert_allclose(got, want, rtol=REL)


@pytest.mark.parametrize("R,sb", [(1.0, 0.0736196), (20.0, 0.0736196),
                                  (3.0, 2.5)])
def test_ball_greens_match_jax(R, sb):
    # radii inside the ball, away from the G -> 0 cancellation at r -> R
    r = (R * np.geomspace(1e-6, 0.9, 500)).astype(np.float32)
    got, want = _both(jg.greens_2d, tg.greens_2d, r, R)
    np.testing.assert_allclose(got, want, rtol=REL)
    got, want = _both(jg.screened_greens_2d, tg.screened_greens_2d, r, R, sb)
    np.testing.assert_allclose(got, want, rtol=REL)


def test_i0_k0_match_scipy_f64():
    x = np.concatenate([np.linspace(1e-3, 3.74, 200),
                        np.linspace(3.76, 60, 200)])
    xt = torch.from_numpy(x)
    np.testing.assert_allclose(tb.i0(xt).numpy(), sp.i0(x), rtol=5e-7)
    np.testing.assert_allclose(tb.i0e(xt).numpy(), sp.i0e(x), rtol=5e-7)
    np.testing.assert_allclose(tb.k0(xt).numpy(), sp.k0(x), rtol=2e-6)
    np.testing.assert_allclose(tb.k0e(xt).numpy(), sp.k0e(x), rtol=2e-6)


def test_float32_accuracy_vs_scipy():
    x = np.linspace(0.05, 80.0, 300).astype(np.float32)
    xt = torch.from_numpy(x)
    np.testing.assert_allclose(tb.i0e(xt).numpy(), sp.i0e(x), rtol=3e-5)
    np.testing.assert_allclose(tb.k0e(xt).numpy(), sp.k0e(x), rtol=3e-5)


def test_screened_norm_is_disk_integral():
    R, sb = 1.3, 2.5
    r = np.linspace(1e-7, R, 400000)
    g = tg.screened_greens_2d(torch.from_numpy(r).float(), R, sb).double()
    integral = np.trapezoid(g.numpy() * 2 * np.pi * r, r)
    np.testing.assert_allclose(
        integral, float(tg.screened_greens_norm_2d(R, sb)), rtol=1e-3)


def test_weak_screening_limit_is_unscreened_norm():
    # cancellation-safe series branch: |G_s| -> R^2/4 as sigma_bar -> 0
    R = torch.tensor([0.5, 2.0, 10.0])
    got = tg.screened_greens_norm_2d(R, 1e-10)
    np.testing.assert_allclose(got.numpy(), (R * R / 4).numpy(), rtol=1e-4)
