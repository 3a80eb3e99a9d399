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


# The Robin correction's kernels over the accuracy path's range: radii
# 1e-3..500 m and majorants from 0 (the chord integral's r/2pi limit) to
# 100, so z = r sqrt(sigma_bar) lies on both sides of the z <= 2 select
# (the notebook's background majorant 6.8e-5 keeps z < 0.05 below 6 m and
# reaches 4.1 at 500 m). Chord integral: rel 1e-6 (measured <= 1.6e-7).
# Wall ratio: rel 5e-5 above an absolute floor of 1e-6 x its largest value
# (measured <= 1.3e-5: num = K0e(zd) - c I0e(zd) cancels as d -> R).
R_WALK = np.geomspace(1e-3, 500.0, 3000).astype(np.float32)
SIGMA_BARS = [0.0, 1e-8, 6.8e-5, 2.7e-3, 1.0, 100.0]


@pytest.mark.parametrize("sb", SIGMA_BARS)
def test_chord_integral_matches_jax(sb):
    got, want = _both(jg.screened_chord_integral, tg.screened_chord_integral,
                      R_WALK, sb)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    z = R_WALK * np.sqrt(sb)
    if sb >= 6.8e-5:
        assert (z <= 2.0).any() and (z > 2.0).any()
    if sb == 0.0:  # the unscreened ball: J = r / 2 pi exactly
        np.testing.assert_allclose(got, R_WALK / np.float32(2 * np.pi),
                                   rtol=1e-6)


@pytest.mark.parametrize("sb", SIGMA_BARS)
@pytest.mark.parametrize("R", [1.0, 60.0, 500.0])
def test_wall_ratio_matches_jax(sb, R):
    d = (R * np.geomspace(1e-4, 1.0, 500)).astype(np.float32)
    got, want = _both(jg.screened_greens_wall_ratio,
                      tg.screened_greens_wall_ratio, d, R, sb)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=5e-5,
                               atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("name", ["_ii0_over_z_series",
                                  "_ik0_reg_over_z_series",
                                  "_k0_reg_over_z2_series"])
def test_integral_series_match_jax(name):
    z2 = np.linspace(0.0, 4.0, 400).astype(np.float32) ** 2
    got, want = _both(getattr(jb, name), getattr(tb, name), z2)
    np.testing.assert_allclose(got, want, rtol=REL)


@pytest.mark.parametrize("r,sb", [(0.5, 1.0), (30.0, 6.8e-5), (300.0, 6.8e-5),
                                  (100.0, 2.7e-3), (500.0, 2.7e-3),
                                  (5.0, 100.0)])
def test_chord_integral_is_green_integral(r, sb):
    # J(r) = int_0^r G_s(t) dt in float64 (quad handles the log singularity)
    from scipy.integrate import quad

    q = np.sqrt(sb)
    c = sp.k0(r * q) / sp.i0(r * q)
    val, _ = quad(lambda t: (sp.k0(t * q) - c * sp.i0(t * q)) / (2 * np.pi),
                  0.0, r, limit=200)
    got = float(tg.screened_chord_integral(torch.tensor([r]), sb))
    assert got == pytest.approx(val, rel=1e-4)
