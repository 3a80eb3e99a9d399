"""The transport sampler of the screened radius, against the JAX package.

``screened_sampler="transport"`` draws the screened Green's radius from a
fitted Chebyshev map plus its exact importance weight
(``sampling/radial.py:64-177``, table ``_transport_coeffs.py``). Here:

* the port's sampler against the JAX function on the same numpy uniforms.
  XLA's CPU backend contracts ``a * b + c`` into fused multiply-adds, so the
  JAX side runs in a subprocess whose XLA is capped at AVX (no FMA), and
  PyTorch's CPU ``sqrt`` misrounds a fraction of a percent of float32
  inputs (the card's is correctly rounded), so the port runs with a
  correctly rounded ``sqrt`` (float64, rounded once). Then the map's radii
  agree to one ulp; radii of the free branch (``z > Z_SW``) to a few ulps,
  the two math libraries' ``log`` apart; the weights to rel 1e-5 on
  >= 99.9% of draws and rel 2e-4 on all: where ``ratio ~ 1`` the factor
  ``1 - ratio`` turns one-ulp ``exp`` differences into ~1e-4 relative
  (the same cancellation as the rejection weight's, test_torch_radial.py);
* the JAX package's own sampler tests (``tests/test_sampling.py:67-126``,
  ``:206-220``, ``:221-260``) on the port's sampler, the MIS scaffold and
  the coefficient copy.

``test_torch_transport_walk.py`` runs the walk with the sampler against
the interpreted Pallas kernel.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from dcrmontecarlo_tpu.sampling import _transport_coeffs as j_coeffs
from dcrmontecarlo_tpu.sampling import mis_sample as j_mis_sample
from dcrmontecarlo_tpu.sampling import uniform_radial as j_uniform
from dcrmontecarlo_tpu.sampling import greens_radial_pdf as j_greens_pdf
from dcrmontecarlo_tpu.sampling import sample_greens_radius as j_greens
from dcrmontecarlo_tpu.sampling import RadialDistribution as JRadial
from dcrmontecarlo_tpu_torch.sampling import _transport_coeffs as t_coeffs
from dcrmontecarlo_tpu_torch.sampling import RadialDistribution, \
    greens_radial_pdf, mis_sample, sample_greens_radius, \
    sample_screened_radius_transport, screened_radial_pdf, uniform_radial

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIGMA_BARS = (1e-8, 0.04, 0.44, 1.0, 5.0)
N_EQ = 100_000

_JAX_SIDE = r"""
import sys
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import numpy as np
from dcrmontecarlo_tpu.sampling import sample_screened_radius_transport
z = np.load(sys.argv[1])
out = {}
for i, sb in enumerate(z["sb"]):
    r, w = sample_screened_radius_transport(
        lambda k: jnp.asarray(z["u"]), jnp.asarray(z["R"]), float(sb))
    out[f"r{i}"], out[f"w{i}"] = np.asarray(r), np.asarray(w)
np.savez(sys.argv[2], **out)
"""


def _exact_sqrt(x, *args, **kwargs):
    """A correctly rounded float32 square root, as the card's."""
    if isinstance(x, torch.Tensor) and x.dtype == torch.float32:
        return _TORCH_SQRT(x.double(), *args, **kwargs).float()
    return _TORCH_SQRT(x, *args, **kwargs)


_TORCH_SQRT = torch.sqrt


@pytest.fixture(scope="module")
def equal_uniforms(tmp_path_factory):
    """Seeded uniforms and radii (spanning the clamp, the map and the free
    branch), and the JAX sampler's ``(r, w)`` on them per sigma_bar."""
    rng = np.random.default_rng(0)
    u = rng.random((4, N_EQ), dtype=np.float32)
    R = rng.uniform(0.01, 60.0, N_EQ).astype(np.float32)
    d = tmp_path_factory.mktemp("transport")
    np.savez(d / "in.npz", u=u, R=R, sb=np.asarray(SIGMA_BARS))
    env = dict(os.environ, XLA_FLAGS="--xla_cpu_max_isa=AVX",
               JAX_PLATFORMS="cpu", PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", _JAX_SIDE,
                           str(d / "in.npz"), str(d / "out.npz")], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with np.load(d / "out.npz") as z:
        return u, R, {k: z[k] for k in z.files}


def _ulps(a, b):
    ia = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    ib = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(ia - ib)


@pytest.mark.parametrize("i", range(len(SIGMA_BARS)))
def test_transport_matches_jax_on_equal_uniforms(equal_uniforms, i,
                                                 monkeypatch):
    u, R, want = equal_uniforms
    monkeypatch.setattr(torch, "sqrt", _exact_sqrt)
    sb = SIGMA_BARS[i]
    r, w = sample_screened_radius_transport(
        lambda k: torch.from_numpy(u), torch.from_numpy(R), sb)
    r, w = r.numpy(), w.numpy()
    rj, wj = want[f"r{i}"], want[f"w{i}"]
    free = R.astype(np.float64) * np.sqrt(np.float32(sb)) > t_coeffs.Z_SW
    ulp = _ulps(r, rj)
    assert ulp[~free].max() <= 1, ulp[~free].max()
    if free.any():
        assert ulp[free].max() <= 8, ulp[free].max()
    rel = np.abs(w - wj) / np.maximum(np.abs(wj), 1e-30)
    assert np.mean(rel <= 1e-5) >= 0.999, np.quantile(rel, 0.999)
    assert rel.max() <= 2e-4, rel.max()
    np.testing.assert_array_equal(w == 0.0, wj == 0.0)


def test_coefficient_copy_equals_the_jax_table():
    for name in ("COEFFS", "Z_LO", "Z_SW", "A_RAT", "OMEGA_R0", "OMEGA_R1"):
        assert getattr(t_coeffs, name) == getattr(j_coeffs, name), name


# ---- the JAX package's sampler tests, on the port ------------------------

def _draw(seed, n):
    u = np.random.default_rng(seed).uniform(1e-7, 1.0, (4, n))
    return lambda k: torch.from_numpy(u.astype(np.float32))


def _weighted_ecdf_sup_error(r, w, rr, cdf):
    order = np.argsort(r)
    w_cum = np.concatenate([[0.0], np.cumsum(w[order])]) / w.sum()
    emp = w_cum[np.searchsorted(r[order], rr, side="right")]
    return np.abs(emp - cdf).max()


@pytest.mark.parametrize("i,R,sb", [
    (0, 1.0, 1e-4), (1, 0.5, 0.36), (2, 2.0, 1.0), (3, 10.0, 0.49),
    (4, 11.4, 1.0), (5, 11.6, 1.0), (6, 500.0, 0.49)])
def test_transport_sampler_matches_analytic_cdf(i, R, sb):
    # test_sampling.py:67-98: every regime (clamp below the fit range, the
    # map, the map/free seam, deep screening); KS 99.9% ~ 0.0031 at 400k
    n = 400_000
    r, w = sample_screened_radius_transport(
        _draw(100 + i, n), torch.full((n,), R), sb)
    r, w = r.numpy(), w.numpy()
    assert np.isfinite(r).all() and np.isfinite(w).all()
    assert (r >= 0).all() and (r <= R + 1e-4 * R).all() and (w >= 0).all()
    np.testing.assert_allclose(w.mean(), 1.0, atol=2e-3)
    rr = np.concatenate([np.geomspace(1e-6 * R, 1e-2 * R, 512,
                                      endpoint=False),
                         np.linspace(1e-2 * R, R, 4096)])
    pdf = screened_radial_pdf(rr, R, sb)
    cdf = np.concatenate(
        [[0], np.cumsum(0.5 * (pdf[1:] + pdf[:-1]) * np.diff(rr))])
    cdf /= cdf[-1]
    assert _weighted_ecdf_sup_error(r, w, rr, cdf) < 0.005


@pytest.mark.parametrize("R,sb,bound", [(11.5, 1.0, 1e-4), (3.0, 1.0, 2e-5),
                                        (0.5, 1.0, 2e-5)])
def test_transport_sampler_weight_spread_is_tiny(R, sb, bound):
    # test_sampling.py:101-113: E[(w - 1)^2] at the seam and mid-map
    n = 400_000
    _, w = sample_screened_radius_transport(_draw(7, n), torch.full((n,), R),
                                            sb)
    assert float(torch.mean((w - 1.0) ** 2)) < bound


def test_transport_sampler_mixed_lanes():
    # test_sampling.py:116-126: per-lane radii over all three regimes
    n = 100_000
    R = torch.from_numpy(np.random.default_rng(0).uniform(0.05, 80.0, n)
                         .astype(np.float32))
    r, w = sample_screened_radius_transport(_draw(42, n), R, 0.44)
    assert torch.isfinite(r).all() and torch.isfinite(w).all()
    assert (r >= 0).all() and (r <= R * (1 + 1e-5)).all()
    np.testing.assert_allclose(float(w.mean()), 1.0, atol=3e-3)


def test_transport_sampler_tiny_z_matches_unscreened():
    # test_sampling.py:206-218: the map clamps to Z_LO, the weight absorbs
    # the O(z^2) shape difference
    n = 200_000
    r, w = sample_screened_radius_transport(_draw(2, n), torch.ones(n), 1e-8)
    s_grid = np.linspace(1e-4, 1.0, 200)
    cdf = s_grid ** 2 * (1.0 - 2.0 * np.log(s_grid))
    assert _weighted_ecdf_sup_error(r.numpy(), w.numpy(), s_grid,
                                    cdf) < 0.005


def test_transport_coeffs_are_monotone():
    # test_sampling.py:244-260, on the port's copy: S'(v) > 0 for every
    # omega, which makes the proposal density and the weight exact
    from numpy.polynomial import chebyshev as C

    B = np.asarray(t_coeffs.COEFFS)
    tv = 2 * np.linspace(0.0, 1.0, 8001) - 1
    for om in np.linspace(-1.0, 1.0, 101):
        c = B @ C.chebvander(np.array([om]), B.shape[1] - 1)[0]
        assert (C.chebval(tv, C.chebder(c)) * 2.0).min() > 0.01, om


def test_mis_balance_heuristic_unbiased():
    # test_sampling.py:221-241: MIS over uniform and Green's radii
    # estimates int_0^1 r^2 dr without bias
    R = 1.0
    greens = RadialDistribution(sample=sample_greens_radius,
                                pdf=greens_radial_pdf)
    dists = [uniform_radial(), greens]
    us, u1, u2 = torch.from_numpy(np.random.default_rng(3).random(
        (3, 400_000), dtype=np.float32))
    r, idx, w = mis_sample(dists, [0.5, 0.5], R, us, u1, u2)
    pdfs = torch.stack([d.pdf(r, R) for d in dists], dim=-1)
    p_sel = torch.gather(pdfs, -1, idx[:, None])[:, 0]
    est = float(torch.mean(w * r * r / torch.clamp(0.5 * p_sel, min=1e-30)))
    np.testing.assert_allclose(est, 1.0 / 3.0, rtol=0.02)


def test_mis_sample_matches_jax():
    # the same uniforms through both scaffolds: equal choices, radii to
    # float32 rounding (rel 1e-6), weights to rel 2e-5: the Green's pdf's
    # ln(R / r) is near 0 for r near R, where the two math libraries'
    # one-ulp log differences grow relative
    import jax.numpy as jnp

    us, u1, u2 = np.random.default_rng(5).random((3, 4096), dtype=np.float32)
    R = 1.7
    jd = [j_uniform(), JRadial(sample=j_greens, pdf=j_greens_pdf)]
    td = [uniform_radial(), RadialDistribution(sample=sample_greens_radius,
                                               pdf=greens_radial_pdf)]
    jr, ji, jw = (np.asarray(v) for v in j_mis_sample(
        jd, [0.3, 0.7], R, jnp.asarray(us), jnp.asarray(u1),
        jnp.asarray(u2)))
    tr, ti, tw = (v.numpy() for v in mis_sample(
        td, [0.3, 0.7], R, torch.from_numpy(us), torch.from_numpy(u1),
        torch.from_numpy(u2)))
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(tr, jr, rtol=1e-6)
    np.testing.assert_allclose(tw, jw, rtol=2e-5)


def test_greens_radial_pdf_matches_jax_and_is_normalized():
    import jax.numpy as jnp

    # to 1e-6 of the density's peak: near r = R, ln(R / r) -> 0 turns the
    # math libraries' one-ulp log differences into large relative ones
    R = 2.3
    r = np.linspace(-0.1, R + 0.1, 100_001).astype(np.float32)
    got = greens_radial_pdf(torch.from_numpy(r), R).numpy()
    want = np.asarray(j_greens_pdf(jnp.asarray(r), R))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * want.max())
    np.testing.assert_array_equal(got == 0.0, want == 0.0)
    np.testing.assert_allclose(np.trapezoid(got, r), 1.0, rtol=1e-3)
