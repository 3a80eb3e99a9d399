"""Radial samplers of the PyTorch port.

Equal uniforms (the walk's own round-seeded counter hash, fed to both
packages) give equal radii and importance weights as the JAX package's
``_exact_rejection`` at 1, 2 and 64 rounds (rel 1e-5 on >= 99.9% of the
draws, rel 1e-4 on all), across the tiny, small and large
``z = R sqrt(sigma_bar)`` regimes; the port's draws match
the analytic screened radial law (weighted ECDF vs ``screened_radial_pdf``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcrmontecarlo_tpu.sampling import radial as jr
from dcrmontecarlo_tpu.sampling import rng as jrng
from dcrmontecarlo_tpu_torch.sampling import radial as tr
from dcrmontecarlo_tpu_torch.sampling import rng as trng

torch.set_num_threads(1)

SEED = 0x2B7E1516
SB = 0.0736196  # the geophysical survey's majorant


def _radii(n, seed=0):
    # z spans < 1e-3 (unscreened fallback), the small-z envelope and the
    # large-z free-density regime
    r = np.random.default_rng(seed)
    return np.geomspace(1e-3, 150.0, n).astype(np.float32)[r.permutation(n)]


def _draws(n):
    ctr = np.arange(n, dtype=np.uint32) * np.uint32(7) + np.uint32(3)
    lanes = np.arange(n, dtype=np.uint32)

    def jdraw(round_idx):
        sd = (jnp.uint32(SEED) ^ jnp.uint32(0xA5A5A5A5)
              ^ (jnp.asarray(round_idx).astype(jnp.uint32)
                 * jnp.uint32(0x68E31DA4)))
        return jrng.counter_uniform_lanes(sd, jnp.asarray(ctr), 4,
                                          jnp.asarray(lanes))

    def tdraw(round_idx):
        sd = (SEED ^ 0xA5A5A5A5 ^ (round_idx * 0x68E31DA4)) & 0xFFFFFFFF
        return trng.counter_uniform_lanes(
            sd, torch.from_numpy(ctr.astype(np.int64)), 4,
            torch.from_numpy(lanes.astype(np.int64)))

    return jdraw, tdraw


@pytest.mark.parametrize("rounds,with_weight", [
    (1, True), (2, True), (64, True), (2, False), (64, False)])
def test_equal_uniforms_equal_radii(rounds, with_weight):
    n = 20000
    R = _radii(n)
    jdraw, tdraw = _draws(n)
    want = jr._exact_rejection(jdraw, jnp.asarray(R), SB, rounds,
                               with_weight=with_weight)
    got = tr._exact_rejection(tdraw, torch.from_numpy(R), SB, rounds,
                              with_weight=with_weight)
    if not with_weight:
        want, got = (want,), (got,)
    for g, w in zip(got, want):
        g, w = g.numpy(), np.asarray(w)
        assert g.dtype == np.float32 and np.isfinite(w).all()
        # the capped round's weight A/a has A = 1 - ratio: where ratio ~ 1
        # that difference turns one-ulp exp/log differences of the two
        # libraries into ~1e-5; all other values agree to rel 1e-5
        close = np.isclose(g, w, rtol=1e-5, atol=0)
        assert close.mean() >= 0.999
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=0)
    if with_weight and rounds <= 2:
        assert (np.asarray(want[1]) != 1.0).mean() > 0.01  # cap fired


def test_greens_radius_matches_jax():
    r = np.random.default_rng(1)
    u1, u2 = r.uniform(size=(2, 1000)).astype(np.float32)
    R = np.float32(3.5)
    want = np.asarray(jr.sample_greens_radius(R, jnp.asarray(u1),
                                              jnp.asarray(u2)))
    got = tr.sample_greens_radius(R, torch.from_numpy(u1),
                                  torch.from_numpy(u2)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)


def _cdf(R, sb):
    rr = np.concatenate([np.geomspace(1e-6 * R, 1e-2 * R, 512,
                                      endpoint=False),
                         np.linspace(1e-2 * R, R, 4096)])
    pdf = tr.screened_radial_pdf(rr, R, sb)
    np.testing.assert_allclose(pdf, jr.screened_radial_pdf(rr, R, sb))
    cdf = np.concatenate([[0], np.cumsum(0.5 * (pdf[1:] + pdf[:-1])
                                         * np.diff(rr))])
    return rr, cdf / cdf[-1]


@pytest.mark.parametrize("rounds", [1, 2, 64])
@pytest.mark.parametrize("R", [3.0, 27.0, 150.0])
def test_weighted_ecdf_matches_screened_law(rounds, R):
    n = 100_000
    r_in = torch.full((n,), R, dtype=torch.float32)
    ctr = torch.arange(n, dtype=torch.int64)

    def draw(round_idx):
        sd = (SEED ^ 0xA5A5A5A5 ^ (round_idx * 0x68E31DA4)) & 0xFFFFFFFF
        return trng.counter_uniform_lanes(sd, ctr, 4, ctr)

    r, w = tr._exact_rejection(draw, r_in, SB, rounds, with_weight=True)
    r, w = r.numpy().astype(np.float64), w.numpy().astype(np.float64)
    assert (r >= 0).all() and (r <= R * (1 + 1e-6)).all() and (w >= 0).all()
    np.testing.assert_allclose(w.mean(), 1.0, atol=0.02)
    rr, cdf = _cdf(R, SB)
    order = np.argsort(r)
    w_cum = np.concatenate([[0.0], np.cumsum(w[order])]) / w.sum()
    emp = w_cum[np.searchsorted(r[order], rr, side="right")]
    # KS 99.9% bound ~ 1.95/sqrt(n) ~ 0.006; importance weights widen it
    assert np.abs(emp - cdf).max() < 0.012
