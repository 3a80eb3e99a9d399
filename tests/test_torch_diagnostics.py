"""Walk histories, the occupancy profile and the plotting utilities on
the port (``tests/test_diagnostics.py:25-172`` of the JAX package), and
held against the JAX functions walk for walk.

The port runs them on one-step launches of the solver's own walk (the
CUDA kernel on the card, its plain version here); each record comes from
the walker planes before and after a launch and from the geometry
queries. On a square with constant sources the plain walk follows the
JAX XLA step walk for walk: equal walk lengths, activity and occupancy
counts, positions and distances to 1e-5 (a few ulps: one-ulp library
differences accumulate along a walk), source and boundary terms and totals
to 2e-6 of their scale.
"""

import numpy as np
import pytest
import torch

import dcrmontecarlo_tpu as J
from dcrmontecarlo_tpu.diagnostics import profile_occupancy as j_profile
from dcrmontecarlo_tpu.diagnostics import trace_walks as j_trace
from dcrmontecarlo_tpu_torch import Problem, WoStSolver, square_loop
from dcrmontecarlo_tpu_torch.diagnostics import WalkHistory, \
    profile_occupancy, trace_walks
from dcrmontecarlo_tpu_torch.problems import fields
from dcrmontecarlo_tpu_torch.solver import SolverOptions
from dcrmontecarlo_tpu_torch.utils.plotting import plot_multiple_walks, \
    plot_walk_history, plot_walk_statistics

torch.set_num_threads(1)

XY = fields.polynomial({(1, 0): 1.0, (0, 1): 2.0})


def _solver():
    prob = Problem(dirichlet=square_loop(1.0), bc_dirichlet=XY,
                   source=fields.constant(1.0))
    return prob, WoStSolver(prob, SolverOptions(target_slots=64),
                            device="cpu")


def _pair(bc, sources, side=1.0, slots=64):
    """The same problem in the JAX package and in the port."""
    jp = J.Problem(dirichlet=J.square_loop(side), bc_dirichlet=bc[0],
                   source=[s[0] for s in sources])
    tp = Problem(dirichlet=square_loop(side), bc_dirichlet=bc[1],
                 source=[s[1] for s in sources])
    return (J.WoStSolver(jp, J.SolverOptions(target_slots=slots)),
            WoStSolver(tp, SolverOptions(target_slots=slots), device="cpu"))


def test_trace_walks_capture():
    prob, solver = _solver()
    hist = trace_walks(solver, (0.2, 0.1), n_walks=8, max_steps=100,
                       eps=1e-3)
    assert isinstance(hist, WalkHistory)
    assert hist.positions.shape == (8, 102, 2)
    assert (hist.walk_length >= 1).all()
    np.testing.assert_allclose(hist.positions[:, 0], [[0.2, 0.1]] * 8,
                               atol=1e-6)
    for w in range(8):
        L = int(hist.walk_length[w]) + 1
        assert (np.abs(hist.positions[w, :L]) <= 1.0 + 1e-4).all()
    assert np.isfinite(hist.total).all()


def test_trace_walks_reference_schema():
    prob, solver = _solver()
    hist = trace_walks(solver, (0.0, 0.0), n_walks=4, max_steps=50,
                       eps=1e-3)
    d = hist.to_dict()
    assert set(d.keys()) == {0}
    walk = d[0][0]
    assert {"walk_id", "path", "contributions", "total_contribution"} \
        <= set(walk)
    assert {"point", "dirichlet_distance", "neumann_distance"} \
        <= set(walk["path"][0])
    types = {c["type"] for c in walk["contributions"]}
    assert "boundary" in types and "source" in types
    # the walk's terms add up to its total
    parts = sum(c["contribution"] for c in walk["contributions"])
    assert parts == pytest.approx(walk["total_contribution"], rel=1e-5,
                                  abs=1e-6)


def test_occupancy_profile():
    prob, solver = _solver()
    profile = profile_occupancy(solver, np.array([[0.0, 0.0]]), n_walks=32,
                                max_steps=100, eps=1e-3)
    assert profile.iterations > 1
    assert 0.0 < profile.mean_occupancy <= 1.0
    assert profile.walks_done_per_iter.sum() == 32


def test_plotting_smoke(tmp_path):
    import matplotlib.pyplot as plt

    prob, solver = _solver()
    hist = trace_walks(solver, (0.1, -0.2), n_walks=6, max_steps=50,
                       eps=1e-3)
    plot_walk_history(hist, 0, problem=prob, save_path=tmp_path / "h.png")
    plot_multiple_walks(hist, problem=prob, save_path=tmp_path / "m.png")
    plot_walk_statistics(hist, save_path=tmp_path / "s.png")
    for p in ("h.png", "m.png", "s.png"):
        assert (tmp_path / p).stat().st_size > 0
    plt.close("all")


def test_survey_figures_build(tmp_path):
    import matplotlib.pyplot as plt

    from dcrmontecarlo_tpu_torch.models import geophysical_scenario
    from dcrmontecarlo_tpu_torch.survey import run_pseudosection
    from dcrmontecarlo_tpu_torch.utils.plotting import plot_pseudosection, \
        plot_voltage_profile

    survey, electrodes = geophysical_scenario()
    opts = SolverOptions(target_slots=2048)
    result = survey.run(electrodes, n_walks=64, max_steps=300, eps=0.9,
                        seed=0, options=opts, device="cpu")
    f1 = tmp_path / "profile.png"
    plot_voltage_profile(result, survey=survey, save_path=str(f1))
    assert f1.stat().st_size > 10_000
    ps = run_pseudosection(survey, electrodes, num_rx_per_src=3, n_walks=32,
                           max_steps=300, eps=0.9, seed=0, options=opts,
                           device="cpu")
    f2 = tmp_path / "pseudo.png"
    plot_pseudosection(ps, save_path=str(f2))
    assert f2.stat().st_size > 10_000
    plt.close("all")


def test_trace_walks_multi_source_contributions():
    prob = Problem(dirichlet=square_loop(2.0),
                   bc_dirichlet=fields.constant(0.0),
                   source=[fields.constant(1.0), fields.constant(3.0)])
    solver = WoStSolver(prob, SolverOptions(target_slots=64), device="cpu")
    h = trace_walks(solver, (0.1, 0.2), n_walks=6, max_steps=60)
    assert h.n_src == 2
    assert h.source_contrib_all.shape[0] == 2
    assert h.total_all.shape == (2, 6)
    np.testing.assert_array_equal(h.source_contrib, h.source_contrib_all[0])
    np.testing.assert_array_equal(h.total, h.total_all[0])
    # the same walks: source 1's terms are exactly 3x source 0's
    np.testing.assert_allclose(h.source_contrib_all[1],
                               3.0 * h.source_contrib_all[0], rtol=1e-5)
    d0 = h.to_dict(source=0)[0]
    d1 = h.to_dict(source=1)[0]
    assert len(d0) == len(d1) == 6
    np.testing.assert_allclose(
        [w["total_contribution"] for w in d1],
        [3.0 * w["total_contribution"] for w in d0], rtol=1e-5)


def test_diagnostics_multi_source_problems():
    prob = Problem(dirichlet=square_loop(2.0),
                   bc_dirichlet=fields.polynomial({(1, 0): 1.0,
                                                   (0, 1): 1.0}),
                   source=[fields.constant(-4.0), fields.constant(1.0)])
    solver = WoStSolver(prob, SolverOptions(target_slots=256), device="cpu")
    h = trace_walks(solver, (0.1, 0.2), n_walks=4, max_steps=40)
    assert np.isfinite(h.total).all()
    occ = profile_occupancy(solver, np.array([[0.0, 0.0]]), n_walks=16,
                            max_steps=40, max_iters=64)
    assert occ.active_per_iter[0] > 0


@pytest.mark.parametrize("case", ["harmonic_two_sources", "neumann_box"])
def test_trace_walks_matches_jax_walk_for_walk(case):
    if case == "harmonic_two_sources":
        js, ts = _pair((lambda x, y: x + 2.0 * y, XY),
                       [(lambda x, y: 1.0 + 0.0 * x, fields.constant(1.0)),
                        (lambda x, y: 3.0 + 0.0 * x, fields.constant(3.0))])
        point = (0.2, 0.1)
    else:
        # a Neumann wall: the silhouette distance and hemisphere steps
        box = [[-2.0, 0.0], [-2.0, -4.0], [2.0, -4.0], [2.0, 0.0]]
        wall = [[-2.0, 0.0], [2.0, 0.0]]
        jp = J.Problem(dirichlet=J.Polyline.from_points(box),
                       neumann=J.Polyline.from_points(wall),
                       bc_dirichlet=lambda x, y: x + 0.0 * y,
                       source=lambda x, y: 1.0 + 0.0 * x)
        tp = Problem(dirichlet=J_to_port(box), neumann=J_to_port(wall),
                     bc_dirichlet=fields.polynomial({(1, 0): 1.0}),
                     source=fields.constant(1.0))
        js = J.WoStSolver(jp, J.SolverOptions(target_slots=64))
        ts = WoStSolver(tp, SolverOptions(target_slots=64), device="cpu")
        point = (0.3, -0.5)
    want = j_trace(js, point, n_walks=16, max_steps=80, eps=1e-3, seed=3)
    got = trace_walks(ts, point, n_walks=16, max_steps=80, eps=1e-3, seed=3)
    np.testing.assert_array_equal(got.walk_length, want.walk_length)
    np.testing.assert_array_equal(got.active, want.active)
    for k in ("positions", "d_dirichlet", "radius"):
        np.testing.assert_allclose(getattr(got, k), getattr(want, k),
                                   rtol=0, atol=1e-5, err_msg=k)
    np.testing.assert_array_equal(np.isfinite(got.d_silhouette),
                                  np.isfinite(want.d_silhouette))
    fin = np.isfinite(want.d_silhouette)
    np.testing.assert_allclose(got.d_silhouette[fin],
                               want.d_silhouette[fin], rtol=0, atol=1e-5)
    for k in ("source_contrib_all", "boundary_contrib", "total_all"):
        a, b = getattr(got, k), getattr(want, k)
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=2e-6 * np.abs(b).max(), err_msg=k)
    assert got.n_src == want.n_src


def J_to_port(points):
    from dcrmontecarlo_tpu_torch.geometry import Polyline

    return Polyline.from_points(points)


def test_occupancy_profile_matches_jax():
    js, ts = _pair((lambda x, y: x + 2.0 * y, XY),
                   [(lambda x, y: 1.0 + 0.0 * x, fields.constant(1.0))])
    pts = np.array([[0.0, 0.0], [0.4, -0.3]])
    want = j_profile(js, pts, n_walks=32, max_steps=100, eps=1e-3, seed=2)
    got = profile_occupancy(ts, pts, n_walks=32, max_steps=100, eps=1e-3,
                            seed=2)
    np.testing.assert_array_equal(got.active_per_iter, want.active_per_iter)
    np.testing.assert_array_equal(got.walks_done_per_iter,
                                  want.walks_done_per_iter)
    assert got.n_slots == want.n_slots
    assert got.mean_occupancy == want.mean_occupancy
    # and the profile's steps are the solve's
    res = ts.solve(pts, n_walks=32, max_steps=100, eps=1e-3, seed=2)
    assert got.active_per_iter.sum() == res.total_steps


def test_solve_return_history():
    # solve(return_history=True) as the JAX package's: (result, history),
    # history[i] the reference schema of trace_walks from point i with
    # seed + i
    js, ts = _pair((lambda x, y: x + 2.0 * y, XY),
                   [(lambda x, y: 1.0 + 0.0 * x, fields.constant(1.0))])
    pts = np.array([[0.1, 0.1], [0.2, -0.3]])
    kw = dict(n_walks=64, max_steps=100, eps=1e-3, seed=5,
              return_history=True, history_walks=5)
    res, hist = ts.solve(pts, **kw)
    jres, jhist = js.solve(pts, **kw)
    assert res.mean.shape == (2,) and set(hist) == set(jhist) == {0, 1}
    for i in (0, 1):
        assert len(hist[i]) == len(jhist[i]) == 5
        t = trace_walks(ts, pts[i], n_walks=5, max_steps=100, eps=1e-3,
                        seed=5 + i).to_dict()[0]
        for w, tw, jw in zip(hist[i], t, jhist[i]):
            assert w["total_contribution"] == tw["total_contribution"]
            assert len(w["path"]) == len(jw["path"])
            # the bank reads x + 2y where the walk ends: a few ulps
            assert w["total_contribution"] == pytest.approx(
                jw["total_contribution"], rel=1e-5, abs=3e-5)
    assert ts.solve(pts, n_walks=64, max_steps=100, eps=1e-3,
                    seed=5).mean.tolist() == res.mean.tolist()
