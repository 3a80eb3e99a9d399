"""The analytic-check models of the port: ``TERMS`` field specs and problems.

The JAX package writes the fields of its Laplace, Poisson, manufactured and
variable-coefficient models as jnp lambdas; the port writes each as a
kernel field spec (``problems/fields.py``, kind ``TERMS``: a background
plus terms ``P(x, y) exp(ax x + ay y - g |p - c|^2) S1(x) S2(y)``), built
from the JAX model functions' constants. Here:

* every field the reference's analytic checks use, as a spec, against its
  JAX lambda: value, gradient (``jax.grad``) and Laplacian to rel 1e-5,
  with an absolute floor of 1e-5 of the quantity's largest magnitude on
  the grid (the spec's one operation order differs from each lambda's by
  a few ulps, and ``sinh``/``cosh`` as two exponentials cancel near 0);
  the hand-derived gradient and Laplacian also against ``torch.func`` of
  the spec's value;
* sigma' and sigma_bar of every model function against the JAX ``Problem``
  to rel 1e-4, and the Robin mode ``"auto"`` resolves to.

The model tests of ``tests/test_models.py:17-73`` run on the port in
``test_torch_analytic.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcrmontecarlo_tpu import Problem as JProblem
from dcrmontecarlo_tpu.geometry import Polyline as JPolyline
from dcrmontecarlo_tpu.geometry import circle_loop as j_circle
from dcrmontecarlo_tpu.geometry import square_loop as j_square
from dcrmontecarlo_tpu.models import poisson_square as j_poisson
from dcrmontecarlo_tpu.models import polynomial_manufactured as j_poly
from dcrmontecarlo_tpu.models import trig_manufactured as j_trig
from dcrmontecarlo_tpu.models import variable_coefficient_problem as j_vc
from dcrmontecarlo_tpu.problems.fields import gaussian_bump as j_bump
from dcrmontecarlo_tpu.solver import WoStSolver as JSolver
from dcrmontecarlo_tpu_torch.geometry import Polyline, circle_loop, \
    square_loop
from dcrmontecarlo_tpu_torch.models import poisson_square, \
    polynomial_manufactured, trig_manufactured, variable_coefficient_problem
from dcrmontecarlo_tpu_torch.ops import walk_kernel as wk
from dcrmontecarlo_tpu_torch.problems import Problem, fields
from dcrmontecarlo_tpu_torch.solver import WoStSolver
from dcrmontecarlo_tpu_torch.utils.autodiff import gradient, laplacian

torch.set_num_threads(1)

F = fields


def _sin_exp(sign_minus):
    """``sin x sinh y`` (``sign_minus``) or ``sin x cosh y``."""
    return F.terms(0.0, F.term(0.5, ay=1.0, sx=("sin", 1.0)),
                   F.term(-0.5 if sign_minus else 0.5, ay=-1.0,
                          sx=("sin", 1.0)))


# every field of the reference's analytic checks: (port spec, JAX lambda)
SPECS = {
    # Dirichlet data
    "x+2y": (F.polynomial({(1, 0): 1.0, (0, 1): 2.0}),
             lambda x, y: x + 2.0 * y),
    "x2-y2": (F.polynomial({(2, 0): 1.0, (0, 2): -1.0}),
              lambda x, y: x * x - y * y),
    "3.5": (F.constant(3.5), lambda x, y: 3.5 + 0.0 * x),
    "0": (F.constant(0.0), lambda x, y: 0.0 * x),
    "y": (F.polynomial({(0, 1): 1.0}), lambda x, y: y),
    "x/5": (F.polynomial({(1, 0): 0.2}), lambda x, y: x / 5.0),
    "x+y": (F.polynomial({(1, 0): 1.0, (0, 1): 1.0}), lambda x, y: x + y),
    "x2+y2": (F.polynomial({(2, 0): 1.0, (0, 2): 1.0}),
              lambda x, y: x * x + y * y),
    "x": (F.polynomial({(1, 0): 1.0}), lambda x, y: x),
    "sin_sinh": (_sin_exp(True), lambda x, y: jnp.sin(x) * jnp.sinh(y)),
    "sin_cosh": (_sin_exp(False), lambda x, y: jnp.sin(x) * jnp.cosh(y)),
    "poly_u": (polynomial_manufactured()[0].bc_dirichlet,
               j_poly()[0].bc_dirichlet),
    "sin_pi_sin_pi": (trig_manufactured()[0].bc_dirichlet,
                      j_trig()[0].bc_dirichlet),
    # sources
    "-4": (F.constant(-4.0), lambda x, y: -4.0 + 0.0 * x),
    "1": (F.constant(1.0), lambda x, y: 1.0 + 0.0 * x),
    "poly_f": (polynomial_manufactured()[0].source, j_poly()[0].source),
    "trig_f": (trig_manufactured()[0].source, j_trig()[0].source),
    "varcoeff_f": (variable_coefficient_problem().source, j_vc().source),
    # diffusion coefficients
    "2+0.5x+0.5y": (polynomial_manufactured()[0].alpha, j_poly()[0].alpha),
    "x+2": (trig_manufactured()[0].alpha, j_trig()[0].alpha),
    "5": (F.constant(5.0), lambda x, y: 5.0 + 0.0 * x),
    "varcoeff_alpha": (variable_coefficient_problem().alpha, j_vc().alpha),
    "exp(0.5y)": (F.terms(0.0, F.term(1.0, ay=0.5)),
                  lambda x, y: jnp.exp(0.5 * y) + 0.0 * x),
    "2+0.3sin(0.5x)+0.2y": (
        F.terms(2.0, F.term({(0, 1): 0.2}), F.term(0.3, sx=("sin", 0.5))),
        lambda x, y: 2.0 + jnp.sin(0.5 * x) * 0.3 + 0.2 * y),
    # absorption
    "2+xy": (polynomial_manufactured()[0].sigma, j_poly()[0].sigma),
    "y2+1": (trig_manufactured()[0].sigma, j_trig()[0].sigma),
    "4": (F.constant(4.0), lambda x, y: 4.0 + 0.0 * x),
    "varcoeff_sigma": (variable_coefficient_problem().sigma, j_vc().sigma),
    "gaussian_bump": (F.gaussian_bump((0.0, -6.0), 9.0, 1.0),
                      j_bump((0.0, -6.0), 9.0, 1.0)),
}


def _grid():
    g = np.linspace(-1.45, 1.45, 23, dtype=np.float32)
    X, Y = np.meshgrid(g, g, indexing="ij")
    return X.ravel(), Y.ravel()


def _jax_parts(f, x, y):
    """Value, gradient and Laplacian of a JAX lambda by ``jax.grad``."""
    fs = lambda a, b: jnp.asarray(f(a, b), jnp.float32)
    gx, gy = jax.grad(fs, 0), jax.grad(fs, 1)
    fxx, fyy = jax.grad(gx, 0), jax.grad(gy, 1)
    ev = lambda h: np.asarray(jax.vmap(h)(jnp.asarray(x), jnp.asarray(y)))
    return ev(fs), ev(gx), ev(gy), ev(fxx) + ev(fyy), \
        np.abs(ev(fxx)).max() + np.abs(ev(fyy)).max()


def _close(got, want, floor_scale, what):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    atol = 1e-5 * max(floor_scale, 1e-30)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=atol, err_msg=what)


@pytest.mark.parametrize("name", sorted(SPECS))
def test_spec_matches_jax_lambda(name):
    spec, jf = SPECS[name]
    assert fields.is_spec(spec)
    x, y = _grid()
    v, gx, gy, lap, lap_scale = _jax_parts(jf, x, y)
    tv, tgx, tgy, tlap = (t.numpy() for t in spec.value_grad_lap(
        torch.from_numpy(x), torch.from_numpy(y)))
    call = spec(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    _close(call, v, np.abs(v).max(), f"{name} value")
    _close(tv, v, np.abs(v).max(), f"{name} value (parts)")
    for a, b, what in ((tgx, gx, "d/dx"), (tgy, gy, "d/dy")):
        _close(a, b, np.abs(b).max(), f"{name} {what}")
    _close(tlap, lap, lap_scale, f"{name} laplacian")


@pytest.mark.parametrize("name", sorted(SPECS))
def test_spec_derivatives_match_torch_func(name):
    spec, _ = SPECS[name]
    x, y = (torch.from_numpy(v) for v in _grid())
    _, tgx, tgy, tlap = spec.value_grad_lap(x, y)
    fgx, fgy = gradient(spec)(x, y)
    flap = laplacian(spec)(x, y)
    for a, b, what in ((tgx, fgx, "d/dx"), (tgy, fgy, "d/dy"),
                       (tlap, flap, "laplacian")):
        b = b.detach().numpy()
        _close(a.numpy(), b, np.abs(b).max(), f"{name} {what}")


def test_terms_table_layout():
    # the kernel's row: 16 polynomial coefficients (x^i y^j at 4 i + j),
    # ax, ay, g, cx, cy, then (kind, k, phase) of S1 and of S2
    t = F.term({(1, 2): 3.0}, ax=0.5, g=2.0, center=(1.0, -1.0),
               sx=("sin", 2.0, 0.25), sy=("cos", 3.0))
    row = t.row()
    assert len(row) == F.TERM_COLS == 27
    assert row[4 * 1 + 2] == 3.0 and sum(row[:16]) == 3.0
    assert row[16:21] == (0.5, 0.0, 2.0, 1.0, -1.0)
    assert row[21:] == (F.S_SIN, 2.0, 0.25, F.S_COS, 3.0, 0.0)
    spec = F.terms(1.5, t, t)
    kind, params = spec.table()
    assert kind == F.TERMS and params == (1.5,) + row + row


# ---- the model problems against the JAX package ---------------------------

def _neumann_box(alpha_t, alpha_j):
    box = [[-5.0, 0.0], [-5.0, -10.0], [5.0, -10.0], [5.0, 0.0]]
    wall = [[-5.0, 0.0], [5.0, 0.0]]
    return (Problem(dirichlet=Polyline.from_points(box),
                    neumann=Polyline.from_points(wall),
                    bc_dirichlet=F.polynomial({(1, 0): 0.2}), alpha=alpha_t),
            JProblem(dirichlet=JPolyline.from_points(box),
                     neumann=JPolyline.from_points(wall),
                     bc_dirichlet=lambda x, y: x / 5.0, alpha=alpha_j))


PROBLEMS = {
    "polynomial_manufactured": lambda: (polynomial_manufactured()[0],
                                        j_poly()[0]),
    "trig_manufactured": lambda: (trig_manufactured()[0], j_trig()[0]),
    "variable_coefficient_problem": lambda: (variable_coefficient_problem(),
                                             j_vc()),
    "poisson_square": lambda: (poisson_square()[0], j_poisson()[0]),
    "poisson_square_obstacle": lambda: (poisson_square(True)[0],
                                        j_poisson(True)[0]),
    "screened_disk": lambda: (
        Problem(dirichlet=circle_loop(1.0, n=256),
                bc_dirichlet=F.constant(1.0), sigma=SPECS["4"][0]),
        JProblem(dirichlet=j_circle(1.0, n=256),
                 bc_dirichlet=lambda x, y: 1.0 + 0.0 * x,
                 sigma=SPECS["4"][1])),
    "constant_alpha": lambda: (
        Problem(dirichlet=square_loop(1.0), bc_dirichlet=SPECS["x+2y"][0],
                alpha=SPECS["5"][0]),
        JProblem(dirichlet=j_square(1.0), bc_dirichlet=SPECS["x+2y"][1],
                 alpha=SPECS["5"][1])),
    "exp_alpha_wall": lambda: _neumann_box(*SPECS["exp(0.5y)"]),
}


@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_problem_matches_jax(name):
    tp, jp = PROBLEMS[name]()
    assert tp.use_delta_tracking == jp.use_delta_tracking
    for tpoly, jpoly in ((tp.dirichlet, jp.dirichlet),
                         (tp.neumann, jp.neumann)):
        assert (tpoly is None) == (jpoly is None)
        for f in () if tpoly is None else jpoly._fields:
            np.testing.assert_array_equal(getattr(tpoly, f).numpy(),
                                          np.asarray(getattr(jpoly, f)))
    mode = WoStSolver(tp, device="cpu")._robin_enabled()
    assert mode == JSolver(jp)._robin_enabled()
    if not jp.use_delta_tracking:
        assert tp.sigma_bar is None and jp.sigma_bar is None
        return
    np.testing.assert_allclose(tp.sigma_bar, jp.sigma_bar, rtol=1e-4)
    x, y = _grid()
    want = np.asarray(jax.vmap(jp.sigma_prime)(jnp.asarray(x),
                                               jnp.asarray(y)))
    got = tp.sigma_prime(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())
    params = wk.make_walk_params(
        tp, eps=1e-3, max_steps=10, t_min=1e-5, rmin=5e-4, project=True,
        rejection_rounds=2, roulette_threshold=None, snap=False, seed=1,
        robin_correction=mode)
    assert params.specs is not None and params.variant in wk.KERNEL_VARIANTS
    params.pack()


def test_varcoeff_resolves_to_the_chain_with_its_constants():
    # on the JAX package: max gamma 0.546, sigma_bar 6.57, "auto" -> chain
    tp, jp = PROBLEMS["variable_coefficient_problem"]()
    np.testing.assert_allclose(tp.max_boundary_gamma(),
                               jp.max_boundary_gamma(), rtol=1e-4)
    assert WoStSolver(tp, device="cpu")._robin_enabled() == "chain"
    assert 0.5 < tp.max_boundary_gamma() < 0.6
    assert 6.0 < tp.sigma_bar < 7.0
    assert wk.geometry_size(tp) == 4 + 32 + 31
