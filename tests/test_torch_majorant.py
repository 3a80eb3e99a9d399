"""The two-level local majorant of the PyTorch port against the JAX package.

``LocalMajorant.distance`` on numpy-made points inside and outside boxes
and bands: rel 1e-6 (float32, same operation order). The derivation from
a ``sigma'`` grid is numpy and scipy on both sides: equal regions, and
``sigma_bar_bg`` to rel 1e-4 when the grids come from each package's own
``sigma'`` (float32 evaluations of the same field).
"""

import numpy as np
import pytest
import torch

from dcrmontecarlo_tpu.geometry import square_loop as j_square
from dcrmontecarlo_tpu.models import notebook_survey as j_nb
from dcrmontecarlo_tpu.problems import Problem as JProblem
from dcrmontecarlo_tpu.problems import fields as jf
from dcrmontecarlo_tpu.problems import majorant as jm
from dcrmontecarlo_tpu_torch import interop
from dcrmontecarlo_tpu_torch.geometry import square_loop
from dcrmontecarlo_tpu_torch.models import notebook_survey
from dcrmontecarlo_tpu_torch.problems import Problem, fields
from dcrmontecarlo_tpu_torch.problems import majorant as tm

torch.set_num_threads(1)

REGIONS = dict(boxes=((-259.84, 15.75, -215.75, 12.82), (7.87, 236.2, -192.1,
                                                          12.82)),
               bands=((-30.0, -20.0), (-500.5, -480.25)), sigma_bar_bg=6.8e-5)


@pytest.fixture(scope="module")
def notebook_auto():
    ts, _ = notebook_survey()
    ts.local_majorant = "auto"
    js, _ = j_nb()
    js.local_majorant = "auto"
    return ts.build_problem(), js.build_problem()


@pytest.mark.parametrize("regions", ["boxes", "bands", "both"])
def test_distance_matches_jax(regions):
    kw = dict(REGIONS)
    if regions == "boxes":
        kw["bands"] = ()
    elif regions == "bands":
        kw["boxes"] = ()
    rng = np.random.default_rng(3)
    # a uniform cloud over the domain plus points inside each region
    x = rng.uniform(-500, 500, 4000)
    y = rng.uniform(-1000, 1, 4000)
    for (x0, x1, y0, y1) in kw["boxes"]:
        x = np.append(x, rng.uniform(x0, x1, 200))
        y = np.append(y, rng.uniform(y0, y1, 200))
    for (y0, y1) in kw["bands"]:
        x = np.append(x, rng.uniform(-500, 500, 200))
        y = np.append(y, rng.uniform(y0, y1, 200))
    x, y = x.astype(np.float32), y.astype(np.float32)
    want = np.asarray(jm.LocalMajorant(**kw).distance(x, y))
    got = tm.LocalMajorant(**kw).distance(torch.from_numpy(x),
                                          torch.from_numpy(y))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    inside = want == 0.0
    assert inside.sum() >= 200 and (~inside).sum() >= 1000


def test_notebook_auto_majorant_matches_jax(notebook_auto):
    tp, jp = notebook_auto
    tmj, jmj = tp.local_majorant, jp.local_majorant
    assert isinstance(tmj, tm.LocalMajorant) and len(tmj.boxes) == 2
    assert tmj.bands == jmj.bands == ()
    np.testing.assert_allclose(np.asarray(tmj.boxes), np.asarray(jmj.boxes),
                               rtol=0, atol=1e-9)
    np.testing.assert_allclose(tmj.sigma_bar_bg, jmj.sigma_bar_bg, rtol=1e-4)
    np.testing.assert_allclose(tmj.sigma_bar_bg, 6.83e-5, rtol=1e-3)
    # the JAX package's majorant carried over equals the port's own
    carried = interop.local_majorant_from(jmj)
    assert carried.boxes == jmj.boxes and carried.bands == jmj.bands
    assert carried.sigma_bar_bg == pytest.approx(tmj.sigma_bar_bg, rel=1e-4)
    assert interop.local_majorant_from(None) is None


def test_derive_from_one_grid_matches_jax(notebook_auto):
    # the same float32 grid and refinement samples into both derivations
    tp, _ = notebook_auto
    v = tp._sigma_prime_grid()
    _, _, pts = tp._refine_sigma_extrema(v)
    xs, ys = tp._grid_axes()
    for extra in (None, pts):
        want = jm.derive_local_majorant(v, xs, ys, tp.sigma_bar,
                                        extra_points=extra)
        got = tm.derive_local_majorant(v, xs, ys, tp.sigma_bar,
                                       extra_points=extra)
        assert got.boxes == want.boxes and got.bands == want.bands
        assert got.sigma_bar_bg == want.sigma_bar_bg


def test_derive_bands_merge_and_refusals():
    xs = np.linspace(-10.0, 10.0, 64)
    ys = np.linspace(-10.0, 0.0, 32)
    X, Y = np.meshgrid(xs, ys, indexing="ij")
    # a full-width layer (a band), nine separate blobs (merged into one
    # box: more than max_boxes=8), and a non-finite cell
    v = 1e-4 * np.ones_like(X)
    v[:, 28] = 0.5
    for k in range(9):
        v[4 + 6 * k, 10] = -0.3
    v[60, 3] = np.nan
    out = {}
    for name, mod in (("jax", jm), ("port", tm)):
        out[name] = [mod.derive_local_majorant(v, xs, ys, 1.0),
                     mod.derive_local_majorant(v, xs, ys, 1e-4),
                     mod.derive_local_majorant(np.full_like(v, 0.5), xs, ys,
                                               1.0),
                     mod.derive_local_majorant(np.zeros_like(v), xs, ys, 1.0)]
    assert out["port"][0].boxes == out["jax"][0].boxes
    assert out["port"][0].bands == out["jax"][0].bands
    assert len(out["port"][0].boxes) == 1 and len(out["port"][0].bands) == 1
    assert out["port"][0].sigma_bar_bg == out["jax"][0].sigma_bar_bg
    # background not below half the global majorant; load everywhere; none
    assert out["port"][1:] == [None, None, None] == out["jax"][1:]


def test_override_rescans_and_no_delta_drops_majorant():
    wall = square_loop(10.0)
    alpha = fields.bump_sum(1.0, [(2.0, fields.smooth_circle((2.0, 1.0), 1.5,
                                                             2.0))])
    tp = Problem(dirichlet=wall, alpha=alpha, sigma_bar_override=0.5,
                 local_majorant="auto")
    assert tp.sigma_bar == 0.5 and isinstance(tp.local_majorant,
                                              tm.LocalMajorant)
    circle = jf.smooth_circle((2.0, 1.0), 1.5, 2.0)
    jp = JProblem(dirichlet=j_square(10.0),
                  alpha=lambda x, y: 1.0 + 2.0 * circle(x, y),
                  sigma_bar_override=0.5, local_majorant="auto")
    np.testing.assert_allclose(np.asarray(tp.local_majorant.boxes),
                               np.asarray(jp.local_majorant.boxes), atol=1e-9)
    np.testing.assert_allclose(tp.local_majorant.sigma_bar_bg,
                               jp.local_majorant.sigma_bar_bg, rtol=1e-4)
    plain = Problem(dirichlet=wall, local_majorant="auto")
    assert not plain.use_delta_tracking and plain.local_majorant is None
    with pytest.raises(ValueError, match="local_majorant"):
        Problem(dirichlet=wall, alpha=alpha, local_majorant="global")
