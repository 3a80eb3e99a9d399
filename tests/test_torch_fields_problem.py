"""Field specs and ``Problem`` of the PyTorch port against the JAX package.

The kernel field specs carry hand-derived gradients and Laplacians; they
are held against ``torch.func`` autodiff of the same spec and against
``jax.grad`` of the JAX package's lambdas, on a 128^2 grid over each
survey domain (atol 1e-5 * max|sigma'|). The majorant sigma_bar of both
surveys matches the JAX package's grid scan plus refinement (rel 1e-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcrmontecarlo_tpu.models import geophysical_scenario as j_geo
from dcrmontecarlo_tpu.models import notebook_survey as j_nb
from dcrmontecarlo_tpu.problems import fields as jf
from dcrmontecarlo_tpu_torch.models import geophysical_scenario, \
    notebook_survey
from dcrmontecarlo_tpu_torch.problems import Problem, fields
from dcrmontecarlo_tpu_torch.geometry import square_loop
from dcrmontecarlo_tpu_torch.utils import gradient, laplacian, \
    value_grad_laplacian

torch.set_num_threads(1)

SURVEYS = {"geophysical": (geophysical_scenario, j_geo),
           "notebook": (notebook_survey, j_nb)}


@pytest.fixture(scope="module")
def problems():
    out = {}
    for name, (tf, jfn) in SURVEYS.items():
        out[name] = (tf()[0].build_problem(), jfn()[0].build_problem())
    return out


def _grid(prob, n=128):
    (x0, x1), (y0, y1) = prob.domain_bounds
    X, Y = np.meshgrid(np.linspace(x0, x1, n), np.linspace(y0, y1, n),
                       indexing="ij")
    return X.ravel().astype(np.float32), Y.ravel().astype(np.float32)


def _tv(f, x, y):
    return f(torch.from_numpy(x), torch.from_numpy(y)).detach().numpy()


def _jv(f, x, y):
    return np.asarray(jax.vmap(f)(jnp.asarray(x), jnp.asarray(y)))


@pytest.mark.parametrize("name", list(SURVEYS))
def test_survey_fields_match_jax(problems, name):
    tp, jp = problems[name]
    x, y = _grid(tp)
    for t_field, j_field in ((tp.alpha, jp.alpha), (tp.source, jp.source),
                             (tp.bc_dirichlet, jp.bc_dirichlet)):
        got, want = _tv(t_field, x, y), _jv(j_field, x, y)
        scale = max(np.abs(want).max(), 1e-30)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * scale)


def test_builders_match_jax():
    x, y = _grid(geophysical_scenario()[0].build_problem(), 64)
    pairs = [
        (fields.smooth_circle((3.0, -20.0), 10.0, 0.5),
         jf.smooth_circle((3.0, -20.0), 10.0, 0.5)),
        (fields.smooth_circle((0.0, -50.0), 4.0, 100.0),
         jf.smooth_circle((0.0, -50.0), 4.0, 100.0)),
        (fields.gaussian_dipole((-10.0, -1.0), (10.0, -1.0), 2.0, 3.0),
         jf.gaussian_dipole((-10.0, -1.0), (10.0, -1.0), 2.0, 3.0)),
        (fields.constant(2.5), jf.constant(2.5)),
    ]
    for tf_, jf_ in pairs:
        np.testing.assert_allclose(_tv(tf_, x, y), _jv(jf_, x, y),
                                   rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("spec", [
    fields.bump_sum(100.0, [(-90.0, fields.smooth_circle((-20, -30), 10, .5)),
                            (900.0, fields.smooth_circle((25, -40), 10, .5))]),
    fields.gaussian_dipole((-10.0, -1.0), (10.0, -1.0), 1.0, 5.0),
    fields.constant(3.0),
], ids=["bumps", "dipole", "constant"])
def test_hand_derivatives_match_autodiff(spec):
    r = np.random.default_rng(0)
    x = r.uniform(-60, 60, 4000).astype(np.float32)
    y = r.uniform(-80, 10, 4000).astype(np.float32)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    v, gx, gy, lap = (t.numpy() for t in spec.value_grad_lap(xt, yt))
    v_ad, (gx_ad, gy_ad), lap_ad = value_grad_laplacian(spec)(xt, yt)
    np.testing.assert_allclose(v, v_ad.numpy(), rtol=1e-6, atol=1e-7)
    for got, want in ((gx, gx_ad), (gy, gy_ad), (lap, lap_ad)):
        want = want.numpy()
        np.testing.assert_allclose(got, want, rtol=1e-4,
                                   atol=1e-5 * max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("name", list(SURVEYS))
def test_sigma_prime_matches_jax_grad(problems, name):
    tp, jp = problems[name]
    x, y = _grid(tp)
    got = _tv(tp.sigma_prime, x, y)
    want = _jv(jp.sigma_prime, x, y)
    atol = 1e-5 * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    # and the port's own autodiff path on the same conductivity
    alpha = tp.alpha
    ad = Problem(dirichlet=tp.dirichlet, neumann=tp.neumann,
                 alpha=lambda a, b: alpha(a, b), sigma_bar_override=1.0)
    np.testing.assert_allclose(_tv(ad.sigma_prime, x, y), want, rtol=0,
                               atol=atol)
    gx, gy = tp.grad_log_alpha(torch.from_numpy(x), torch.from_numpy(y))
    jg = jax.vmap(jp.grad_log_alpha)(jnp.asarray(x), jnp.asarray(y))
    for g, w in ((gx, jg[0]), (gy, jg[1])):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max())


@pytest.mark.parametrize("name,expected", [("geophysical", 0.0736196),
                                           ("notebook", 0.0026998)])
def test_sigma_bar_matches_jax(problems, name, expected):
    tp, jp = problems[name]
    np.testing.assert_allclose(tp.sigma_bar, jp.sigma_bar, rtol=1e-4)
    np.testing.assert_allclose(tp.sigma_bar, expected, rtol=1e-4)


@pytest.mark.parametrize("name", list(SURVEYS))
def test_problem_geometry_and_gamma_match_jax(problems, name):
    tp, jp = problems[name]
    assert tp.domain_bounds == jp.domain_bounds
    assert tp.diameter == pytest.approx(jp.diameter, rel=1e-12)
    np.testing.assert_allclose(tp.max_boundary_gamma(),
                               jp.max_boundary_gamma(), rtol=1e-4,
                               atol=1e-9)
    assert tp.use_delta_tracking and jp.use_delta_tracking


def test_autodiff_operators():
    f = lambda x, y: x * x * y + torch.sin(y)
    x = torch.linspace(-1, 1, 50)
    y = torch.linspace(0, 2, 50)
    gx, gy = gradient(f)(x, y)
    np.testing.assert_allclose(gx.numpy(), (2 * x * y).numpy(), rtol=1e-5)
    np.testing.assert_allclose(gy.numpy(), (x * x + torch.cos(y)).numpy(),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(laplacian(f)(x, y).numpy(),
                               (2 * y - torch.sin(y)).numpy(), atol=1e-5)


def test_problem_options_and_setters():
    with pytest.raises(ValueError, match="local_majorant"):
        Problem(dirichlet=square_loop(1.0), alpha=fields.constant(1.0),
                local_majorant="everywhere")
    # constant coefficients: no sigma' load to localize
    assert Problem(dirichlet=square_loop(1.0), alpha=fields.constant(1.0),
                   local_majorant="auto").local_majorant is None
    p = Problem(dirichlet=square_loop(1.0), alpha=fields.constant(2.0))
    assert p.sigma_bar == 1e-6  # constant coefficients: unscreened limit
    v = p.version
    p.set_source_term(fields.constant(1.0))
    p.set_boundary_conditions(fields.constant(0.5))
    assert p.version == v + 2 and p.source_fields and p.bc_dirichlet.value == 0.5
    plain = Problem(dirichlet=square_loop(1.0))
    assert not plain.use_delta_tracking and plain.source_fields == []
