"""The large-table build's scans against the JAX package's geometry.

The JAX package walks a boundary past its Pallas kernel's 8,192 rows on
its XLA step, whose geometry is ``dcrmontecarlo_tpu/geometry/queries.py``
(``closest_point``, ``silhouette_distance``, ``first_hit``). Here the
port's large-table build (``walk_kernel.large_scans``: the silhouette
culled by chunk and group records, the first hit by group records), built
by the host compiler (``tests/host_cuda/host_walk.py``), runs its scans
on 1,536 probe points below the topographic survey's 5 cm DEM (16,002
rows), drawn from a seed with numpy, with random directions and limits;
the JAX package's queries run on the same polylines. The star radius
``min(dD, silhouette)``, the first hit's distance, its hit point and its
row's normal agree to float32 rounding: a relative 2e-5 on distances
(the two packages round the scans' arithmetic apart), 1e-4 m on hit
points, 1e-5 on normals, and the same rays hit within their limits.
"""

import numpy as np
import pytest
import torch

from dcrmontecarlo_tpu.geometry import queries as jq
from dcrmontecarlo_tpu.models import topographic_survey_problem as j_topo
from dcrmontecarlo_tpu_torch.models import drape_electrodes, \
    topographic_survey_problem
from dcrmontecarlo_tpu_torch.solver import SolverOptions, WoStSolver
from host_cuda.host_walk import load, start_build
from test_torch_host_culled_scans import SURVEY
from test_torch_host_large_scans import PROBE, _probe

torch.set_num_threads(1)

N = 1536
RTOL, HIT_ATOL, NORMAL_ATOL = 2e-5, 1e-4, 1e-5


@pytest.fixture(scope="module")
def probed(tmp_path_factory):
    prob, h = topographic_survey_problem(resolution=0.05)
    jprob, _ = j_topo(resolution=0.05)
    pts = drape_electrodes(h, np.arange(-40.0, 41.0, 10.0), nudge=0.5)
    solver = WoStSolver(prob, SolverOptions(target_slots=256), device="cpu")
    state, params, _, _ = solver._setup(pts, 256, 600, 0.5, 3)
    assert params.variant == SURVEY and params.large
    walk = load(start_build(tmp_path_factory.mktemp("large_jax"), SURVEY,
                            False, False, PROBE, large=True), SURVEY)
    rng = np.random.default_rng(1919)
    x = rng.uniform(-90.0, 90.0, N)
    y = h(x) - rng.uniform(0.05, 40.0, N)
    ang = rng.uniform(0.0, 2 * np.pi, N)
    lanes = np.stack([x, y, np.cos(ang), np.sin(ang), np.zeros(N),
                      rng.uniform(0.1, 60.0, N), np.full(N, -1.0)],
                     1).astype(np.float32)
    got = _probe(walk, params, state, lanes)
    px, py, dx, dy, _, lim, _ = (np.asarray(c) for c in lanes.T)
    d_j, _, _ = jq.closest_point(jprob.dirichlet, px, py)
    sil_j = jq.silhouette_distance(jprob.neumann, px, py)
    hx, hy, nx, ny, t_hit, hit = jq.first_hit(jprob.neumann, px, py, dx, dy,
                                              lim, t_min=0.0)
    want = dict(dD=np.asarray(d_j), star=np.minimum(np.asarray(d_j),
                                                    np.asarray(sil_j)),
                hx=np.asarray(hx), hy=np.asarray(hy), nx=np.asarray(nx),
                ny=np.asarray(ny), t=np.asarray(t_hit),
                hit=np.asarray(hit))
    return lanes, got, want


def test_star_radius_matches_jax(probed):
    _, got, want = probed
    np.testing.assert_allclose(got[:, 0], want["dD"], rtol=RTOL)
    np.testing.assert_allclose(got[:, 3], want["star"], rtol=RTOL)
    # the silhouette sets the radius on most of these lanes
    assert (want["star"] < want["dD"]).mean() > 0.5


def test_first_hit_matches_jax(probed):
    lanes, got, want = probed
    dx, dy, lim = lanes[:, 2], lanes[:, 3], lanes[:, 5]
    hit = got[:, 5] <= lim
    np.testing.assert_array_equal(hit, want["hit"])
    assert 0.2 < hit.mean() < 0.9
    np.testing.assert_allclose(got[hit, 5], want["t"][hit], rtol=RTOL)
    np.testing.assert_allclose(got[hit, 8], want["hx"][hit], atol=HIT_ATOL)
    np.testing.assert_allclose(got[hit, 9], want["hy"][hit], atol=HIT_ATOL)
    # the row's CCW normal, turned against the ray as the JAX query does
    flip = got[:, 6] * dx + got[:, 7] * dy > 0
    nx = np.where(flip, -got[:, 6], got[:, 6])
    ny = np.where(flip, -got[:, 7], got[:, 7])
    np.testing.assert_allclose(nx[hit], want["nx"][hit], atol=NORMAL_ATOL)
    np.testing.assert_allclose(ny[hit], want["ny"][hit], atol=NORMAL_ATOL)
