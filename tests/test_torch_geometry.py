"""Polyline queries of the PyTorch port against the JAX package.

The survey's own boundaries (the JAX package's ``Polyline`` arrays, carried
over with ``interop.polyline_from_numpy``) are queried at random points and
rays over the survey domain. Distances agree to rel 1e-6; hit flags on at
least 99.9% of rays (a ray grazing a segment end may flip on one ulp).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcrmontecarlo_tpu.geometry import Polyline as JPolyline
from dcrmontecarlo_tpu.geometry import circle_loop as j_circle
from dcrmontecarlo_tpu.geometry import queries as jq
from dcrmontecarlo_tpu.geometry import square_loop as j_square
from dcrmontecarlo_tpu.survey import halfspace_domain as j_halfspace
from dcrmontecarlo_tpu_torch import interop
from dcrmontecarlo_tpu_torch.geometry import Polyline, circle_loop, queries, \
    square_loop
from dcrmontecarlo_tpu_torch.survey import halfspace_domain

torch.set_num_threads(1)

N = 20000


def _carry(jpoly):
    return interop.polyline_from_numpy(*(np.asarray(a) for a in jpoly))


def _survey_polys():
    jd, jn = j_halfspace(100.0, 200.0)
    return [(jd, _carry(jd)), (jn, _carry(jn))]


def _points(seed, n=N):
    r = np.random.default_rng(seed)
    x = r.uniform(-100.0, 100.0, n).astype(np.float32)
    y = r.uniform(-200.0, 0.0, n).astype(np.float32)
    # a share of points close to the walls, where the queries matter most
    k = n // 4
    y[:k] = -r.exponential(0.5, k).astype(np.float32)
    x[k:2 * k] = (100.0 - r.exponential(0.5, k)).astype(np.float32)
    return x, y


def test_from_points_fields_equal_jax():
    pts = np.array([[-100, 0], [-100, -200], [100, -200], [100, 0]],
                   np.float32)
    for jp, tp in ((JPolyline.from_points(pts), Polyline.from_points(pts)),
                   (j_square(2.0), square_loop(2.0)),
                   (j_circle(1.5, n=40), circle_loop(1.5, n=40))):
        for a, b in zip(jp, tp):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
    jc = JPolyline.concat([j_square(1.0), j_circle(3.0, n=12)])
    tc = Polyline.concat([square_loop(1.0), circle_loop(3.0, n=12)])
    for a, b in zip(jc, tc):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_halfspace_domain_matches_jax():
    for (jp, _), tp in zip(_survey_polys(), halfspace_domain(100.0, 200.0)):
        for a, b in zip(jp, tp):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
    d, n = halfspace_domain(100.0, 200.0)
    assert d.num_segments == 3 and n.num_segments == 1
    assert n.num_vertices == 0


@pytest.mark.parametrize("which", [0, 1])
def test_closest_point_and_distance(which):
    jp, tp = _survey_polys()[which]
    x, y = _points(which)
    jd, jcx, jcy = (np.asarray(v) for v in
                    jq.closest_point(jp, jnp.asarray(x), jnp.asarray(y)))
    td, tcx, tcy = (v.numpy() for v in queries.closest_point(
        tp, torch.from_numpy(x), torch.from_numpy(y)))
    np.testing.assert_allclose(td, jd, rtol=1e-6)
    np.testing.assert_allclose(tcx, jcx, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tcy, jcy, rtol=1e-6, atol=1e-6)
    dist = queries.distance(tp, torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(dist.numpy(), jd, rtol=1e-6)


def test_closest_point_chord():
    jp, tp = _survey_polys()[1]
    x, y = _points(2)
    want = [np.asarray(v) for v in
            jq.closest_point_chord(jp, jnp.asarray(x), jnp.asarray(y))]
    got = [v.numpy() for v in queries.closest_point_chord(
        tp, torch.from_numpy(x), torch.from_numpy(y))]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("on_wall", [False, True])
def test_first_hit_random_rays(on_wall):
    jp, tp = _survey_polys()[1]  # the Neumann surface: the walk's ray target
    r = np.random.default_rng(3 + on_wall)
    x, y = _points(4 + on_wall)
    if on_wall:  # half the walkers stand on the wall, with the self-hit guard
        y[: N // 2] = 0.0
    theta = r.uniform(0.0, 2 * np.pi, N)
    dx = np.cos(theta).astype(np.float32)
    dy = np.sin(theta).astype(np.float32)
    rad = r.uniform(0.45, 60.0, N).astype(np.float32)
    t_min = np.float32(1e-5 * np.hypot(200.0, 200.0)) if on_wall else 0.0
    want = [np.asarray(v) for v in jq.first_hit(
        jp, *(jnp.asarray(a) for a in (x, y, dx, dy, rad)), t_min=t_min)]
    got = [v.numpy() for v in queries.first_hit(
        tp, *(torch.from_numpy(a) for a in (x, y, dx, dy, rad)),
        t_min=float(t_min))]
    hit_eq = got[5] == want[5]
    assert hit_eq.mean() >= 0.999
    assert want[5].any() and (~want[5]).any()
    m = hit_eq
    for g, w in zip(got[:5], want[:5]):
        np.testing.assert_allclose(g[m], w[m], rtol=1e-6, atol=1e-5)


def test_first_hit_per_walker_t_min():
    jp, tp = _survey_polys()[1]
    x = np.array([0.0, 5.0], np.float32)
    y = np.array([0.0, -1.0], np.float32)
    dx = np.array([0.0, 0.0], np.float32)
    dy = np.array([1.0, 1.0], np.float32)
    rad = np.array([2.0, 2.0], np.float32)
    tm = np.array([1e-3, 0.0], np.float32)
    want = jq.first_hit(jp, *(jnp.asarray(a) for a in (x, y, dx, dy, rad)),
                        t_min=jnp.asarray(tm)[:, None])
    got = queries.first_hit(tp, *(torch.from_numpy(a)
                                  for a in (x, y, dx, dy, rad)),
                            t_min=torch.from_numpy(tm))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # the on-wall walker skips its own wall; the interior one hits it
    assert not bool(got[5][0]) and bool(got[5][1])
