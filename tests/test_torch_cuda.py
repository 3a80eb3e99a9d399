"""The CUDA walk kernel against its plain PyTorch version, on the card.

Every test here needs an NVIDIA GPU and skips without one. The module
imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Kernel and plain version run the same launch from one state on the card:
every plane must agree on >= 99% of the lanes to rel 1e-4 (integers
exactly; ``walk_kernel.compare_planes`` states the floor under tiny
accumulator values), and all values must be finite. Whole solves draw the
same counter-hash streams in both, so their means agree to rounding and
their step counts exactly. The variants cover what the survey's main
path does not: more than one source, no Neumann wall, no boundary snap,
no projection, and the round caps 1, 2 and 64; the accuracy path's
kernel instantiations on the notebook survey: the Robin chord chain, the
reflectance fold, and the local majorant on its own, each one launch,
plus a whole solve of the accuracy configuration; and the flagship gate's
path: MIS on the survey and the flagship instantiation (chain + majorant
+ MIS + freeze, the launch frozen at 4.0), the ``max_attenuation`` clip,
a whole host-loop solve with the split (equal steps and clone counts),
and the flagship notebook gate itself at seed 0 against the pinned
oracle; and the topographic survey: the table form (Robin off, and with
the chord chain) and the static form with silhouette vertices, one launch
each, a whole solve at the test size, and a terrain of 16,002 rows (past
the JAX kernel's 8,192), one launch and a whole solve; and the
analytic-check problems:
walks without delta tracking in both geometry forms and the transport
sampler (with the chain and with Robin off) with ``TERMS`` field specs,
one launch each, a whole Poisson solve, and the reference's
``test_transport_sampler_solution_unbiased`` on the card; and the survey
products: MIS without delta tracking, chain + MIS and the wide forms (the
scenario line's 6 sources, the Born demo's 8 sources and 9 components,
the notebook line's 18 sources and 19 components), one launch each, a
whole 18-source notebook-line solve, and the reference's
``test_mis_nee_unbiased_and_lower_variance`` on the card; and the
validation path: the flagship switches with a gridded Dirichlet field
(the cylinder oracle's Monte Carlo tier), one launch, and the tier's
checks at seed 0; one-step launches equal to one many-step launch; and the
diagnostics (walk histories, the occupancy profile, the martingale audit)
through the kernel; and the sharded solve: the flagship's instantiation
without the freeze, one launch, a mesh of four shards on one card equal to
its shards solved one by one, and sharded solves (the survey, the flagship
with the split) through the kernel and the plain version; and every
switch combination: the sixteen variants of ``chip_smoke.py``'s sweep, one
launch each, and the survey with the split through the host loop; and
the freeze builds' repack loop (the flagship and the grid flagship) in
the cases of ``chip_smoke.py::REPACK_CASES``, and the flagship's freeze
build launched on two cards in turns (two cards, else it skips); and the
chain builds without the freeze (with MIS: the sharded flagship's and the
notebook line's; without it: the accuracy path's and the variable
coefficients'), whose chain's wall work (and without MIS the rejection
sampler's redraw rounds) runs from a queue, in the cases of
``chip_smoke.py::CHAIN_CASES`` against the same builds with the
one-thread loop (bit for bit) and the plain walk; and the survey builds'
dealt loop (the survey's, the wide survey with MIS and without, and the
survey's with the transport sampler and with MIS, and the wide surveys'
general rows builds with constants, bump sums, ``TERMS`` fields and
dipoles past the fourth source), a launch that drains uneven quotas from
fresh walks against the one-thread loop in 256-step launches (bit for
bit) and the plain walk; and the general rows build's Gaussian pole
sources, from their records, against the same launch by the ``TERMS``
text (bit for bit) and the plain walk; and the plain walk's steps
replayed from a CUDA graph against its kernels launched one by one (bit
for bit); and the table chain at ``chip_smoke.py`` phase 48's state (its
chord frame and first hit culled) and MIS without delta tracking at phase
49's (its direction and Box-Muller pair from one ``sincosf``), the solve's
single launch against the same build in 256-step launches (bit for bit)
and a launch of 8,192 of its lanes against the plain walk.
"""

import os


import numpy as np
import pytest
import torch

from dcrmontecarlo_tpu_torch.geometry import Polyline, square_loop
from dcrmontecarlo_tpu_torch.models import drape_electrodes, \
    geophysical_scenario, interior_grid, notebook_survey, poisson_square, \
    polynomial_manufactured, topographic_survey_problem
from dcrmontecarlo_tpu_torch.ops import walk_kernel as wk
from dcrmontecarlo_tpu_torch.problems import Problem, fields
from dcrmontecarlo_tpu_torch.solver import SolverOptions, WoStSolver
from dcrmontecarlo_tpu_torch.solver.state import state_planes
from dcrmontecarlo_tpu_torch.survey import survey_default_options
from chip_smoke import CHAIN_CASES, REPACK_CASES, chain_case, \
    repack_case, repack_schedule

pytestmark = pytest.mark.cuda

EPS = 0.9
ELECTRODES = np.stack([np.linspace(-40, 40, 9), np.full(9, -0.1)],
                      1).astype(np.float32)


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


def _survey_problem(n_sources=1):
    prob = geophysical_scenario()[0].build_problem()
    if n_sources > 1:
        prob.set_source_term([
            fields.gaussian_dipole((-10.0 - 5 * i, -1.0), (10.0 + 5 * i, -1.0))
            for i in range(n_sources)])
    return prob


def _box_problem():
    return Problem(dirichlet=square_loop(20.0),
                   bc_dirichlet=fields.constant(0.5),
                   source=fields.constant(0.01),
                   alpha=fields.bump_sum(1.0, [
                       (2.0, fields.smooth_circle((3.0, -2.0), 5.0, 1.0))]))


def _notebook_problem(majorant=None, mis=False):
    survey, _ = notebook_survey()
    survey.local_majorant = majorant
    survey.source_mis = mis
    return survey.build_problem()


def _survey_mis_problem():
    survey, _ = geophysical_scenario()
    survey.source_mis = True
    return survey.build_problem()


NOTEBOOK_ELECTRODES = np.asarray(notebook_survey()[1], np.float32)


def _topography(resolution):
    prob, h = topographic_survey_problem(half_width=100.0, depth=150.0,
                                         resolution=resolution)
    return prob, drape_electrodes(h, np.arange(-40.0, 41.0, 10.0), 0.5)


def _compare(a, b, names):
    frac, _, finite = wk.compare_planes(a, b, names)
    assert finite
    assert min(frac.values()) >= wk.PLANE_MIN_FRAC, frac


CASES = {
    "survey_defaults": (_survey_problem, dict(
        common_random_numbers=True, roulette_threshold=0.05,
        rejection_rounds=2)),
    "survey_rounds64_no_snap": (_survey_problem, dict(
        rejection_rounds=64, boundary_snap=None)),
    "survey_rounds1_no_projection": (_survey_problem, dict(
        rejection_rounds=1, project_to_boundary=False)),
    "three_sources": (lambda: _survey_problem(3), dict(
        common_random_numbers=True, roulette_threshold=0.05,
        rejection_rounds=2)),
    "box_no_neumann": (_box_problem, dict(rejection_rounds=4)),
    "notebook_chain": (_notebook_problem, dict(
        common_random_numbers=True, roulette_threshold=0.05,
        rejection_rounds=2)),
    "notebook_reflectance": (_notebook_problem, dict(
        robin_correction="reflectance", rejection_rounds=2)),
    "notebook_majorant_robin_off": (lambda: _notebook_problem("auto"), dict(
        robin_correction=False, common_random_numbers=True,
        rejection_rounds=2)),
    "survey_mis": (_survey_mis_problem, dict(
        common_random_numbers=True, roulette_threshold=0.05,
        rejection_rounds=2)),
    "notebook_flagship_freeze": (lambda: _notebook_problem("auto", True),
                                 dict(common_random_numbers=True,
                                      roulette_threshold=0.05,
                                      rejection_rounds=2,
                                      split_threshold=4.0)),
    "notebook_chain_max_attenuation": (_notebook_problem, dict(
        common_random_numbers=True, roulette_threshold=0.05,
        rejection_rounds=2, max_attenuation=1.5)),
    "topography_table": (lambda: _topography(4.0), {}),
    "topography_table_chain": (lambda: _topography(4.0), dict(
        robin_correction="chain")),
    "topography_static_silhouettes": (lambda: _topography(8.0), {}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_matches_plain_one_launch(device, case):
    make, opts = CASES[case]
    prob = make()
    if case.startswith("topography"):
        prob, pts = prob
        assert prob.neumann.num_vertices > 0
    elif case.startswith("notebook"):
        pts = NOTEBOOK_ELECTRODES
    elif prob.neumann is not None:
        pts = ELECTRODES
    else:
        pts = np.array([[0.0, 0.0], [15.0, -12.0], [-19.0, 3.0]], np.float32)
    solver = WoStSolver(prob, SolverOptions(target_slots=8192, **opts),
                        device=device)
    state, params, _, _ = solver._setup(pts, 4096, 60, EPS, 3)
    wk.walk_plain(state, params, 100)  # mid-walk states, some recycled
    ref = {k: v.clone() for k, v in state.items()}
    thr = 4.0 if params.freeze else None
    launches = wk.run_walk.launches
    wk.run_walk(state, params, 48, freeze_thr=thr)
    torch.cuda.synchronize()
    assert wk.run_walk.launches == launches + 1
    wk.walk_plain(ref, params, 48, freeze_thr=thr)
    _compare(state, ref, state_planes(params.n_src))
    assert bool((state["ndone"] > 0).any())
    assert params.variant in wk.KERNEL_VARIANTS


def test_kernel_whole_solve_matches_plain(device):
    solver = WoStSolver(_survey_problem(2), SolverOptions(
        common_random_numbers=True, roulette_threshold=0.05,
        rejection_rounds=2), device=device)
    rk = solver._solve_raw(ELECTRODES, 128, 300, EPS, 5)
    rp = solver._solve_raw(ELECTRODES, 128, 300, EPS, 5, walk=wk.walk_plain)
    assert rk.mean.shape == (2, 9)
    assert np.isfinite(rk.mean).all() and np.isfinite(rk.stderr).all()
    se = np.sqrt(rk.stderr ** 2 + rp.stderr ** 2)
    assert (np.abs(rk.mean - rp.mean) <= 1e-3 * (np.abs(rp.mean) + se)).all()
    assert rk.total_steps == rp.total_steps


def test_kernel_whole_notebook_solve_matches_plain(device):
    solver = WoStSolver(_notebook_problem("auto"), SolverOptions(
        common_random_numbers=True, roulette_threshold=0.05,
        rejection_rounds=2, target_slots=1 << 17), device=device)
    assert solver._robin_enabled() == "chain"
    launches = wk.run_walk.launches
    rk = solver._solve_raw(NOTEBOOK_ELECTRODES, 256, 6000, 1.0, 5)
    assert wk.run_walk.launches > launches
    rp = solver._solve_raw(NOTEBOOK_ELECTRODES, 256, 6000, 1.0, 5,
                           walk=wk.walk_plain)
    assert np.isfinite(rk.mean).all() and np.isfinite(rk.stderr).all()
    se = np.sqrt(rk.stderr ** 2 + rp.stderr ** 2)
    assert (np.abs(rk.mean - rp.mean) <= 1e-3 * (np.abs(rp.mean) + se)).all()
    assert rk.total_steps == rp.total_steps


def test_kernel_rejects_what_it_cannot_run(device):
    # callables, and the capacities (every switch combination builds)
    prob = Problem(dirichlet=square_loop(1.0),
                   alpha=lambda x, y: 1.0 + 0.0 * x, sigma_bar_override=0.1)
    solver = WoStSolver(prob, device=device)
    with pytest.raises(NotImplementedError, match="field specs"):
        solver.solve([[0.0, 0.0]], n_walks=8, max_steps=10, eps=1e-2)
    many = Problem(dirichlet=square_loop(1.0), source=[
        fields.gaussian_dipole((-0.5, 0.01 * i), (0.5, 0.01 * i))
        for i in range(wk.MAX_WIDE_SRC + 1)])
    with pytest.raises(NotImplementedError, match="up to 32 sources"):
        WoStSolver(many, device=device).solve([[0.0, 0.0]], n_walks=8,
                                              max_steps=10, eps=1e-2)


def test_kernel_whole_host_loop_solve_matches_plain(device):
    # the flagship configuration through the host launch loop: the same
    # walks, splits and clones on both sides (64-lane-row blocks would
    # fill 8,192 lanes with clones; one row per block keeps it short)
    solver = WoStSolver(_notebook_problem("auto", True), SolverOptions(
        common_random_numbers=True, roulette_threshold=0.05,
        rejection_rounds=2, target_slots=1 << 17, split_threshold=4.0,
        pallas_block_rows=1), device=device)
    launches = wk.run_walk.launches
    rk = solver._solve_raw(NOTEBOOK_ELECTRODES, 64, 300, 1.0, 5)
    stats_k = solver.last_solve_stats
    assert wk.run_walk.launches - launches == stats_k["launches"] > 1
    rp = solver._solve_raw(NOTEBOOK_ELECTRODES, 64, 300, 1.0, 5,
                           walk=wk.walk_plain)
    assert solver.last_solve_stats == stats_k and stats_k["clones"] > 0
    assert np.isfinite(rk.mean).all() and np.isfinite(rk.stderr).all()
    se = np.sqrt(rk.stderr ** 2 + rp.stderr ** 2)
    assert (np.abs(rk.mean - rp.mean) <= 1e-3 * (np.abs(rp.mean) + se)).all()
    assert rk.total_steps == rp.total_steps


def test_flagship_notebook_gate_seed0(device):
    # tests/test_dcr_survey.py::test_notebook_survey_matches_fdm_oracle
    # on the card, seed 0, with its configuration and its three bounds
    # (:233-243); not its sign checks at the current electrodes, which the
    # host loop's heavy tail flips on this seed (PERF.md, section 6)
    survey, electrodes = notebook_survey()
    survey.source_mis = True
    survey.local_majorant = "auto"
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with np.load(os.path.join(root, "dcrmontecarlo_tpu", "validation", "pins",
                              "notebook_oracle.npz")) as z:
        ref, dv_ref = z["fdm_401"], z["dv_401"]
    from dcrmontecarlo_tpu_torch.survey import survey_default_options

    solver = survey.make_solver(survey_default_options(
        target_slots=65536, split_threshold=4.0), device=device)
    result = survey.run(electrodes, n_walks=2500, max_steps=6000, eps=1.0,
                        seed=0, solver=solver)
    assert solver.last_solve_stats["clones"] > 0
    err = result.potentials - ref
    dev = np.abs(err) / (4.0 * result.potentials_stderr + 3.5)
    assert (dev < 1.0).sum() >= 19, (result.potentials, ref, dev)
    assert -25.0 < np.median(err) < 3.0
    dv_dev = np.abs(result.voltages - dv_ref) / (
        4.0 * result.voltages_stderr + 0.25)
    assert (dv_dev < 1.0).all(), dv_dev


def test_kernel_whole_topography_solve_matches_plain(device):
    # chip_smoke.py phase 19: the test-size terrain (table form), 9 draped
    # electrodes; both sides draw the same streams
    prob, pts = _topography(4.0)
    solver = WoStSolver(prob, SolverOptions(), device=device)
    name = wk.kernel_name((wk.ROBIN_OFF, False, False, False, True, True,
                           False, False, False))
    launches = wk.run_walk.variant_launches[name]
    rk = solver._solve_raw(pts, 512, 600, 0.5, 5)
    assert wk.run_walk.variant_launches[name] > launches
    rp = solver._solve_raw(pts, 512, 600, 0.5, 5, walk=wk.walk_plain)
    assert np.isfinite(rk.mean).all() and np.isfinite(rk.stderr).all()
    se = np.sqrt(rk.stderr ** 2 + rp.stderr ** 2)
    assert (np.abs(rk.mean - rp.mean) <= 1e-3 * (np.abs(rp.mean) + se)).all()
    assert rk.total_steps == rp.total_steps


def test_large_table_matches_plain(device):
    # chip_smoke.py phase 45's terrain over a 5 cm DEM: 16,002 rows, past
    # the JAX kernel's 8,192; one launch and a whole solve, both sides
    # drawing the same streams
    prob, h = topographic_survey_problem(resolution=0.05)
    assert wk.geometry_size(prob) == 16002
    pts = drape_electrodes(h, np.arange(-40.0, 41.0, 10.0), 0.5)
    solver = WoStSolver(prob, SolverOptions(target_slots=8192),
                        device=device)
    state, params, _, _ = solver._setup(pts, 4096, 600, 0.5, 3)
    assert params.table and wk.culled_scans(params.variant)
    wk.walk_plain(state, params, 100)
    ref = {k: v.clone() for k, v in state.items()}
    launches = wk.run_walk.launches
    wk.run_walk(state, params, 48)
    torch.cuda.synchronize()
    assert wk.run_walk.launches == launches + 1
    wk.walk_plain(ref, params, 48)
    _compare(state, ref, state_planes(params.n_src))
    rk = solver._solve_raw(pts, 64, 300, 0.5, 5)
    rp = solver._solve_raw(pts, 64, 300, 0.5, 5, walk=wk.walk_plain)
    assert np.isfinite(rk.mean).all() and np.isfinite(rk.stderr).all()
    se = np.sqrt(rk.stderr ** 2 + rp.stderr ** 2)
    assert (np.abs(rk.mean - rp.mean) <= 1e-3 * (np.abs(rp.mean) + se)).all()
    assert rk.total_steps == rp.total_steps


def _table_square():
    """The Poisson square with 25 segments per side: the table form."""
    c = [(2.0, 2.0), (-2.0, 2.0), (-2.0, -2.0), (2.0, -2.0)]
    pts = [[a[0] + k / 25 * (b[0] - a[0]), a[1] + k / 25 * (b[1] - a[1])]
           for a, b in zip(c, c[1:] + c[:1]) for k in range(25)]
    return Problem(dirichlet=Polyline.from_points(pts + [list(c[0])]),
                   bc_dirichlet=fields.polynomial({(2, 0): 1.0, (0, 2): 1.0}),
                   source=fields.constant(-4.0))


def _transport_box():
    """tests/test_pallas_walk.py:120-139 with alpha as a TERMS spec."""
    box = [[-2.0, 0.0], [-2.0, -4.0], [2.0, -4.0], [2.0, 0.0]]
    return Problem(dirichlet=Polyline.from_points(box),
                   neumann=Polyline.from_points([[-2.0, 0.0], [2.0, 0.0]]),
                   bc_dirichlet=fields.polynomial({(1, 0): 1.0, (0, 1): 1.0}),
                   alpha=fields.terms(2.0, fields.term({(0, 1): 0.2}),
                                      fields.term(0.3, sx=("sin", 0.5))))


POISSON_POINTS = np.array([[0.0, 0.0], [1.0, 0.5], [-1.2, -0.7], [0.3, 1.5]],
                          np.float32)
ANALYTIC_CASES = {
    # (problem, points, options, eps, variant)
    "no_delta_static_silhouettes": (
        lambda: poisson_square(with_obstacle=True)[0],
        [[1.0, 1.0], [0.7, 0.0], [0.0, -1.5], [-0.55, 0.1]], {}, 1e-3,
        (wk.ROBIN_OFF, False, False, False, False, False, False, False,
         False)),
    "no_delta_table": (_table_square, POISSON_POINTS, {}, 1e-3,
                       (wk.ROBIN_OFF, False, False, False, True, False,
                        False, False, False)),
    "transport_chain": (_transport_box, [[0.0, -1.0], [0.5, -0.5]],
                        dict(screened_sampler="transport"), 1e-2,
                        (wk.ROBIN_CHAIN, False, False, False, False, True,
                         True, False, False)),
    "transport_robin_off": (lambda: polynomial_manufactured()[0],
                            interior_grid(n_points=3),
                            dict(screened_sampler="transport"), 1e-3,
                            (wk.ROBIN_OFF, False, False, False, False, True,
                             True, False, False)),
}


@pytest.mark.parametrize("case", sorted(ANALYTIC_CASES))
def test_analytic_instantiation_matches_plain_one_launch(device, case):
    make, pts, opts, eps, variant = ANALYTIC_CASES[case]
    solver = WoStSolver(make(), SolverOptions(target_slots=8192, **opts),
                        device=device)
    state, params, _, _ = solver._setup(np.asarray(pts, np.float32), 8192,
                                        300, eps, 3)
    assert params.variant == variant
    ref = {k: v.clone() for k, v in state.items()}
    launches = wk.run_walk.variant_launches[params.kernel_name]
    wk.run_walk(state, params, 256)
    torch.cuda.synchronize()
    assert wk.run_walk.variant_launches[params.kernel_name] == launches + 1
    wk.walk_plain(ref, params, 256)
    _compare(state, ref, state_planes(params.n_src))
    assert bool((state["ndone"] > 0).any())


def test_kernel_whole_poisson_solve_matches_plain(device):
    # a walk without delta tracking, its source by the Green's radius:
    # the same streams on both sides
    solver = WoStSolver(poisson_square()[0], SolverOptions(target_slots=8192),
                        device=device)
    rk = solver._solve_raw(POISSON_POINTS, 2048, 300, 1e-3, 5)
    rp = solver._solve_raw(POISSON_POINTS, 2048, 300, 1e-3, 5,
                           walk=wk.walk_plain)
    assert np.isfinite(rk.mean).all() and np.isfinite(rk.stderr).all()
    se = np.sqrt(rk.stderr ** 2 + rp.stderr ** 2)
    assert (np.abs(rk.mean - rp.mean) <= 1e-3 * (np.abs(rp.mean) + se)).all()
    assert rk.total_steps == rp.total_steps


def test_transport_sampler_solution_unbiased(device):
    # tests/test_solver_varcoeff.py:112-137 on the card, with its bounds
    prob, u_exact = polynomial_manufactured(2.0)
    solver = WoStSolver(prob, SolverOptions(target_slots=16384,
                                            screened_sampler="transport"),
                        device=device)
    g = np.linspace(-0.7, 0.7, 4)
    X, Y = np.meshgrid(g, g, indexing="ij")
    pts = np.stack([X.ravel(), Y.ravel()], axis=1)
    launches = wk.run_walk.launches
    res = solver.solve(pts, n_walks=3000, max_steps=800, eps=1e-3, seed=2)
    assert wk.run_walk.launches > launches
    exact = u_exact(pts)
    err = np.abs(res.mean - exact)
    assert np.sqrt(np.mean((res.mean - exact) ** 2)) < 0.08
    assert (err < 5.0 * res.stderr + 0.03).mean() > 0.85


def test_solve_is_reproducible_on_the_card(device):
    # tests/test_solver_laplace.py::test_reproducible_given_seed on the
    # card: one seed gives one answer (the moments are summed without
    # float atomics), another seed another
    prob = Problem(dirichlet=square_loop(1.0), bc_dirichlet=fields.terms(
        0.0, fields.term(0.5, ay=1.0, sx=("sin", 1.0)),
        fields.term(0.5, ay=-1.0, sx=("sin", 1.0))))
    solver = WoStSolver(prob, SolverOptions(target_slots=512), device=device)
    pts = np.array([[0.2, -0.3]])
    r1, r2, r3 = (solver.solve(pts, n_walks=500, max_steps=100, eps=1e-3,
                               seed=s) for s in (7, 7, 8))
    np.testing.assert_array_equal(r1.walk_sum, r2.walk_sum)
    assert r1.mean[0] == r2.mean[0] != r3.mean[0]


W_NARROW = 0.05


def _narrow_gaussian(mis=True, center=(0.0, 0.0), neumann=False):
    """tests/test_pseudosection.py:150-175's narrow Gaussian source (unit
    mass) on its square, or on a Neumann box."""
    kw = dict(source=fields.gaussian_bump(
        center, 1.0 / (2 * np.pi * W_NARROW ** 2), W_NARROW),
        bc_dirichlet=fields.constant(0.0),
        source_importance=fields.GaussianMixture.from_components(
            [(center, W_NARROW, 1.0)]) if mis else None)
    if neumann:
        return Problem(dirichlet=Polyline.from_points(
            [[-2.0, 0.0], [-2.0, -4.0], [2.0, -4.0], [2.0, 0.0]]),
            neumann=Polyline.from_points([[-2.0, 0.0], [2.0, 0.0]]), **kw)
    return Problem(dirichlet=square_loop(2.0), **kw)


def _line(survey, electrodes, rx):
    from dcrmontecarlo_tpu_torch.survey.dcr import _line_problem

    prob, pts, _, _ = _line_problem(survey, electrodes, rx)
    return prob, pts


def _notebook_line():
    survey, electrodes = notebook_survey()
    survey.source_mis = True
    return _line(survey, electrodes, 8)


def _born_demo():
    from dcrmontecarlo_tpu_torch.survey import DCRSurvey, \
        surface_electrode_line
    from dcrmontecarlo_tpu_torch.survey.sensitivity import _jacobian_problem

    elec = surface_electrode_line((-20.0, 20.0), 5.0)
    survey = DCRSurvey(half_width=60.0, depth=60.0, current_a=tuple(elec[0]),
                       current_b=tuple(elec[1]),
                       conductivity=fields.constant(1.0), source_width=1.5,
                       source_mis=True)
    g = np.meshgrid(np.linspace(-22.0, 22.0, 12), np.linspace(-20.0, -3.0, 7),
                    indexing="ij")
    return (_jacobian_problem(survey, elec),
            np.stack([a.ravel() for a in g], 1)[:21].astype(np.float32))


PRODUCT_CASES = {
    # (make -> (problem, points), options, eps, max_steps, variant)
    "mis_no_delta_square": (
        lambda: (_narrow_gaussian(), [[0.5, 0.0], [1.0, 1.0]]), {}, 1e-3, 300,
        (wk.ROBIN_OFF, False, True, False, False, False, False, False,
         False)),
    "mis_no_delta_neumann_box": (
        lambda: (_narrow_gaussian(center=(0.0, -0.3), neumann=True),
                 [[0.5, -0.2], [-1.0, -0.01], [0.0, -1.5]]), {}, 1e-2, 300,
        (wk.ROBIN_OFF, False, True, False, False, False, False, False,
         False)),
    "chain_mis_notebook": (
        lambda: (_notebook_problem(mis=True), NOTEBOOK_ELECTRODES),
        dict(common_random_numbers=True), 1.0, 6000,
        (wk.ROBIN_CHAIN, False, True, False, False, True, False, False,
         False)),
    "wide_survey_scenario_line": (
        lambda: _line(geophysical_scenario()[0], ELECTRODES, 3),
        dict(common_random_numbers=True, roulette_threshold=0.05,
             rejection_rounds=2), EPS, 500,
        (wk.ROBIN_OFF, False, False, False, False, True, False, True, False)),
    "wide_survey_mis_born_demo": (
        _born_demo, dict(common_random_numbers=True), 0.3, 500,
        (wk.ROBIN_OFF, False, True, False, False, True, False, True, False)),
    "wide_chain_mis_notebook_line": (
        _notebook_line, dict(common_random_numbers=True), 1.0, 6000,
        (wk.ROBIN_CHAIN, False, True, False, False, True, False, True, False)),
}


@pytest.mark.parametrize("case", sorted(PRODUCT_CASES))
def test_product_instantiation_matches_plain_one_launch(device, case):
    make, opts, eps, max_steps, variant = PRODUCT_CASES[case]
    prob, pts = make()
    solver = WoStSolver(prob, SolverOptions(target_slots=8192, **opts),
                        device=device)
    state, params, _, _ = solver._setup(np.asarray(pts, np.float32), 8192,
                                        max_steps, eps, 3)
    assert params.variant == variant and params.wide == variant[7]
    assert params.variant in wk.KERNEL_VARIANTS
    ref = {k: v.clone() for k, v in state.items()}
    launches = wk.run_walk.variant_launches[params.kernel_name]
    wk.run_walk(state, params, 256)
    torch.cuda.synchronize()
    assert wk.run_walk.variant_launches[params.kernel_name] == launches + 1
    wk.walk_plain(ref, params, 256)
    _compare(state, ref, state_planes(params.n_src))
    # every source past the narrow form's four accumulated
    for i in range(wk.MAX_SRC, params.n_src):
        assert bool((state[f"acc{i}"] != 0).any()
                    | (state[f"asum{i}"] != 0).any()), i


def test_notebook_line_whole_solve_matches_plain(device):
    # the 18-source notebook line (chain + MIS, the wide form): the same
    # streams on both sides
    prob, pts = _notebook_line()
    solver = WoStSolver(prob, SolverOptions(target_slots=1 << 14,
                                            common_random_numbers=True),
                        device=device)
    name = wk.kernel_name((wk.ROBIN_CHAIN, False, True, False, False, True,
                           False, True, False))
    launches = wk.run_walk.variant_launches[name]
    rk = solver._solve_raw(pts, 32, 6000, 1.0, 5)
    assert wk.run_walk.variant_launches[name] > launches
    rp = solver._solve_raw(pts, 32, 6000, 1.0, 5, walk=wk.walk_plain)
    assert rk.mean.shape == (18, 21)
    assert np.isfinite(rk.mean).all() and np.isfinite(rk.stderr).all()
    se = np.sqrt(rk.stderr ** 2 + rp.stderr ** 2)
    assert (np.abs(rk.mean - rp.mean) <= 1e-3 * (np.abs(rp.mean) + se)).all()
    assert rk.total_steps == rp.total_steps


def test_mis_nee_unbiased_and_lower_variance(device):
    # tests/test_pseudosection.py:150-175 on the card with its bounds: MIS
    # without delta tracking agrees with the Green's-radius NEE within 4
    # sigma and cuts the stderr at least 3x
    pts = np.array([[0.5, 0.0], [1.0, 1.0]])
    res = {}
    for label, mis in (("plain", False), ("mis", True)):
        solver = WoStSolver(_narrow_gaussian(mis), SolverOptions(
            target_slots=8192), device=device)
        res[label] = solver.solve(pts, n_walks=6000, max_steps=300,
                                  eps=1e-3, seed=0)
    a, b = res["plain"], res["mis"]
    dev = np.abs(a.mean - b.mean) / np.sqrt(a.stderr ** 2 + b.stderr ** 2)
    assert (dev < 4).all(), (a.mean, b.mean)
    assert (b.stderr < a.stderr / 3).all(), (a.stderr, b.stderr)


def test_grid_instantiation_matches_plain_one_launch(device):
    # chip_smoke.py phase 32 at 64 steps: the cylinder's grid as Dirichlet
    # data, freeze 4.0; the zero field banks otherwise on the same paths
    import dataclasses

    from chip_smoke import cylinder_problem

    prob, pins = cylinder_problem()
    solver = WoStSolver(prob, survey_default_options(
        target_slots=8192, split_threshold=4.0), device=device)
    state, params, _, _ = solver._setup(pins["electrodes"].astype(
        np.float32), 8192, 6000, 1.0, 3)
    assert params.grid and params.variant in wk.KERNEL_VARIANTS
    ref = {k: v.clone() for k, v in state.items()}
    zero = {k: v.clone() for k, v in state.items()}
    launches = wk.run_walk.variant_launches[params.kernel_name]
    wk.run_walk(state, params, 64, freeze_thr=4.0)
    assert wk.run_walk.variant_launches[params.kernel_name] == launches + 1
    wk.walk_plain(ref, params, 64, freeze_thr=4.0)
    frac, _, finite = wk.compare_planes(state, ref, state_planes(1))
    assert finite and min(frac.values()) >= wk.PLANE_MIN_FRAC, frac
    c0 = fields.constant(0.0)
    wk.run_walk(zero, dataclasses.replace(
        params, bc=c0, specs=(c0,) + params.specs[1:]), 64, freeze_thr=4.0)
    assert torch.equal(zero["px"], state["px"])
    assert bool((zero["asum0"] != state["asum0"]).any())


def _freeze_build(device, which):
    """The flagship's (the notebook survey) or the grid flagship's (the
    cylinder) freeze build: its solver, points, max_steps and eps."""
    from chip_smoke import cylinder_problem

    opts = survey_default_options(target_slots=8192, split_threshold=4.0)
    if which == "grid_flagship":
        prob, pins = cylinder_problem()
        pts = pins["electrodes"]
    else:
        prob, pts = _notebook_problem("auto", True), NOTEBOOK_ELECTRODES
    return WoStSolver(prob, opts, device=device), \
        np.asarray(pts, np.float32), 6000, 1.0


@pytest.mark.parametrize("case", ["chain_mis", "survey", "flagship",
                                  "grid_flagship"])
def test_one_step_launches_equal_one_launch(device, case):
    # the counter hash depends on (seed, counter, stream, lane) only, so
    # the diagnostics' one-step launches walk the solver's walks; in the
    # freeze builds (the repack loop) a lane's budget counts its own
    # iterations, so a one-step launch takes one iteration a lane
    thr = None
    if case == "survey":
        prob, pts, ms, eps = _survey_problem(), ELECTRODES, 500, EPS
    elif case == "chain_mis":
        survey, el = notebook_survey()
        survey.source_mis = True
        prob, pts, ms, eps = survey.build_problem(), el, 6000, 1.0
    if case in ("flagship", "grid_flagship"):
        solver, pts, ms, eps = _freeze_build(device, case)
        thr = 4.0
    else:
        solver = WoStSolver(prob, survey_default_options(target_slots=8192),
                            device=device)
    state, params, _, _ = solver._setup(np.asarray(pts, np.float32), 8192,
                                        ms, eps, 7)
    assert params.freeze == (thr is not None)
    many = {k: v.clone() for k, v in state.items()}
    wk.run_walk(state, params, 32, freeze_thr=thr)
    for _ in range(32):
        wk.run_walk(many, params, 1, freeze_thr=thr)
    for k in state_planes(params.n_src):
        assert torch.equal(state[k], many[k]), k


@pytest.mark.parametrize("case", REPACK_CASES)
@pytest.mark.parametrize("which", ["flagship", "grid_flagship"])
def test_repacked_freeze_build_matches_plain(device, which, case):
    # the repack loop (csrc/walk_kernel.cu, walk_repacked) against the
    # plain walk: budgets about a round's length, a block whose every
    # lane is heavy, one with a single steppable lane, no threshold
    solver, pts, ms, eps = _freeze_build(device, which)
    state, params, _, _ = solver._setup(pts, 8192, ms, eps, 3)
    assert params.freeze and params.grid == (which == "grid_flagship")
    wk.walk_plain(state, params, 100, freeze_thr=4.0)
    start, budget, thr = repack_case(
        state, case, 4.0,
        repack_schedule(wk._library(wk._canonical(params.variant))))
    kern = {k: v.clone() for k, v in start.items()}
    plain = {k: v.clone() for k, v in start.items()}
    launches = wk.run_walk.variant_launches[params.kernel_name]
    wk.run_walk(kern, params, budget, freeze_thr=thr)
    torch.cuda.synchronize()
    assert wk.run_walk.variant_launches[params.kernel_name] == launches + 1
    wk.walk_plain(plain, params, budget, freeze_thr=thr)
    _compare(kern, plain, state_planes(params.n_src))
    moved = (kern["life"] - start["life"]) + (kern["ndone"] - start["ndone"])
    assert 0 < int(moved.max()) <= budget


def _chain_build(device, which):
    """The chain builds without the freeze at 8,192 lanes: the sharded
    flagship's switches on the notebook survey, or the notebook line's 18
    sources and 19 components (the wide form); without MIS the accuracy
    path (the notebook survey with its majorant) and the variable
    coefficients (the chain on a ``TERMS`` alpha, 64 rejection rounds).
    Returns the solver, points, max_steps and eps."""
    from dcrmontecarlo_tpu_torch.models import varcoeff_solve_points, \
        variable_coefficient_problem
    from dcrmontecarlo_tpu_torch.survey.dcr import _line_problem

    if which == "varcoeff":
        return WoStSolver(variable_coefficient_problem(), SolverOptions(
            target_slots=8192, max_attenuation=50.0), device=device), \
            varcoeff_solve_points(), 500, 1e-3
    if which == "accuracy":
        survey, el = notebook_survey()
        survey.local_majorant = "auto"
        return survey.make_solver(survey_default_options(
            target_slots=8192), device=device), \
            np.asarray(el, np.float32), 6000, 1.0

    survey, el = notebook_survey()
    survey.source_mis = True
    if which == "flagship_no_freeze":
        survey.local_majorant = "auto"
        return WoStSolver(survey.build_problem(), survey_default_options(
            target_slots=8192), device=device), \
            np.asarray(el, np.float32), 6000, 1.0
    prob, pts, _, _ = _line_problem(survey, el, 8)
    return WoStSolver(prob, SolverOptions(
        target_slots=8192, common_random_numbers=True), device=device), \
        pts, 6000, 1.0


@pytest.fixture(scope="module")
def one_thread_chain(tmp_path_factory):
    """``variant: library`` of the chain builds without the freeze with
    the one-thread loop in place of the repack loop, built by ``nvcc`` from
    a copy of the
    source (``tests/host_cuda/host_walk.py::ONE_THREAD``)."""
    import shutil
    import subprocess
    from concurrent.futures import ThreadPoolExecutor

    from host_cuda.host_walk import ONE_THREAD

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    src = tmp_path_factory.mktemp("one_thread_csrc")
    shutil.copytree(wk._SRC.parent, src, dirs_exist_ok=True)
    text = (src / "walk_kernel.cu").read_text()
    for old, new in ONE_THREAD:
        assert text.count(old) == 1, old
        text = text.replace(old, new)
    (src / "walk_kernel.cu").write_text(text)
    variants = [(1, True, True, False, False, True, False, False, False),
                (1, False, True, False, False, True, False, True, False),
                (1, True, False, False, False, True, False, False, False),
                (1, False, False, False, False, True, False, False, False)]

    def build(v):
        out = src / f"one_thread_{wk.variant_code(v)}.so"
        subprocess.run([wk._nvcc(), *wk.NVCC_FLAGS, *wk.variant_macros(v),
                        "-o", str(out), str(src / "walk_kernel.cu")],
                       check=True, capture_output=True)
        return out

    with ThreadPoolExecutor(max_workers=len(variants)) as pool:
        paths = dict(zip(variants, pool.map(build, variants)))
    return paths


@pytest.mark.parametrize("case", CHAIN_CASES)
@pytest.mark.parametrize("which", ["flagship_no_freeze", "wide_line",
                                   "accuracy", "varcoeff"])
def test_chain_phases_build_matches_one_thread_and_plain(
        device, which, case, one_thread_chain, monkeypatch):
    # the chain builds without the freeze (walk_variant.h::chain_phases)
    # queue the chain's wall work (and without MIS the redraw rounds): bit
    # for bit the one-thread loop's result, and the plain walk's by
    # compare_planes, with a block all on the wall, none on it, one lane on
    # it, and budgets about a round's length
    solver, pts, ms, eps = _chain_build(device, which)
    state, params, _, _ = solver._setup(pts, 8192, ms, eps, 3)
    assert wk.chain_phases(params.variant)
    assert params.wide == (which == "wide_line")
    wk.walk_plain(state, params, 100)
    block, steps, _ = repack_schedule(
        wk._library(wk._canonical(params.variant)))
    start, budget = chain_case(state, case, block, steps)
    kern, one, plain = ({k: v.clone() for k, v in start.items()}
                        for _ in range(3))
    launches = wk.run_walk.variant_launches[params.kernel_name]
    wk.run_walk(kern, params, budget)
    torch.cuda.synchronize()
    assert wk.run_walk.variant_launches[params.kernel_name] == launches + 1
    # the same build with one thread a lane
    monkeypatch.setattr(wk, "_library_path", lambda v: one_thread_chain[
        tuple(params.variant)])
    lib = wk._library.__wrapped__(wk._canonical(params.variant))
    monkeypatch.setattr(wk, "_library", lambda v: lib)
    wk.run_walk(one, params, budget)
    torch.cuda.synchronize()
    monkeypatch.undo()
    for k in state_planes(params.n_src):
        assert torch.equal(kern[k], one[k]), k
    wk.walk_plain(plain, params, budget)
    _compare(kern, plain, state_planes(params.n_src))
    moved = (kern["life"] - start["life"]) + (kern["ndone"] - start["ndone"])
    assert 0 < int(moved.max()) <= budget


def test_freeze_build_on_each_card():
    # the repack loop's pool counter lives once per card, and each launch
    # resets the one of its own card: launches that alternate between two
    # cards walk the same state alike
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA GPUs")
    ends = []
    for d in (0, 1, 1, 0):
        dev = torch.device("cuda", d)
        solver, pts, ms, eps = _freeze_build(dev, "flagship")
        state, params, _, _ = solver._setup(pts, 8192, ms, eps, 3)
        start = state["life"].clone()
        wk.run_walk(state, params, 32, freeze_thr=4.0)
        torch.cuda.synchronize(dev)
        assert int((state["life"] - start).sum()) > 0, d
        ends.append({k: v.cpu() for k, v in state.items()})
    for d, end in zip((1, 1, 0), ends[1:]):
        for k in state_planes(params.n_src):
            assert torch.equal(ends[0][k], end[k]), (d, k)


def test_cylinder_mc_tier_seed0(device):
    # tests/test_cylinder_oracle.py::test_mc_matches_cylinder_series at
    # seed 0, with all of its checks
    from chip_smoke import cylinder_checks, cylinder_problem

    prob, pins = cylinder_problem()
    solver = WoStSolver(prob, survey_default_options(
        target_slots=16384, split_threshold=4.0), device=device)
    el = pins["electrodes"].astype(np.float32)
    r = solver.solve(el, n_walks=2500, max_steps=6000, eps=1.0, seed=0)
    ref = pins["ref_conductor"] + pins["delta_smooth_conductor"]
    n_ok, cm, signed = cylinder_checks(r, ref, el[:, 0])
    assert n_ok >= 18, (n_ok, r.mean - ref)
    assert -30.0 < cm < 6.0, cm
    assert min(signed) > 0.0, signed


def test_diagnostics_launch_the_kernel(device):
    from dcrmontecarlo_tpu_torch.diagnostics import martingale_audit, \
        profile_occupancy, trace_walks

    prob = Problem(dirichlet=square_loop(1.0),
                   bc_dirichlet=fields.polynomial({(1, 0): 1.0, (0, 1): 2.0}),
                   source=fields.constant(1.0))
    solver = WoStSolver(prob, SolverOptions(target_slots=64), device=device)
    before = wk.run_walk.launches
    h = trace_walks(solver, (0.2, 0.1), n_walks=8, max_steps=100, eps=1e-3)
    assert wk.run_walk.launches > before and (h.walk_length >= 1).all()
    occ = profile_occupancy(solver, np.array([[0.0, 0.0]]), n_walks=32,
                            max_steps=100, eps=1e-3)
    assert occ.walks_done_per_iter.sum() == 32
    res, hist = solver.solve(np.array([[0.1, 0.1]]), n_walks=32,
                             max_steps=100, eps=1e-3, return_history=True,
                             history_walks=4)
    assert len(hist[0]) == 4 and np.isfinite(res.mean).all()
    before = wk.run_walk.launches
    rep = martingale_audit(
        prob, SolverOptions(target_slots=1024), (0.0, 0.0),
        continuation=lambda x, y: x + 2.0 * y, eps=1e-3, n_steps=8,
        n_walkers=1024, n_seeds=2, device=device)
    assert wk.run_walk.launches == before + 16
    assert rep.n.sum() > 0 and np.isfinite(rep.mean).all()


# ---- the sharded solve (parallel/mesh.py) -------------------------------

def _shards(device, n):
    from dcrmontecarlo_tpu_torch.parallel.mesh import Mesh

    return Mesh([device] * n)


def test_sharded_flagship_instantiation_matches_plain_one_launch(device):
    # the flagship configuration on a mesh splits without the freeze: one
    # 32-step launch of chain + majorant + MIS (no freeze) after 200 plain
    # steps; the mixture acts
    import dataclasses

    from dcrmontecarlo_tpu_torch.parallel import ShardedWoStSolver

    solver = ShardedWoStSolver(_notebook_problem("auto", True),
                               _shards(device, 1), survey_default_options(
                                   target_slots=8192, split_threshold=4.0))
    shard = solver._shard(solver._plan(NOTEBOOK_ELECTRODES, 8192, 6000, 1.0,
                                       3), 0)
    state, params = shard.state, shard.params
    assert params.variant == (wk.ROBIN_CHAIN, True, True, False, False, True,
                              False, False, False)
    wk.walk_plain(state, params, 200)
    ref = {k: v.clone() for k, v in state.items()}
    no_mix = {k: v.clone() for k, v in state.items()}
    launches = wk.run_walk.variant_launches[params.kernel_name]
    wk.run_walk(state, params, 32)
    assert wk.run_walk.variant_launches[params.kernel_name] == launches + 1
    wk.walk_plain(ref, params, 32)
    _compare(state, ref, state_planes(1))
    wk.walk_plain(no_mix, dataclasses.replace(params, mis_table=None), 32)
    assert (no_mix["asum0"] != state["asum0"]).double().mean() >= 0.01


def test_mesh_equals_its_shards_one_by_one(device):
    # shards that share the card launch together, one launch over their
    # buffer a loop step (the kernel's shard table gives each lane its
    # shard's seed): four shards advanced together equal the four solved
    # one by one, bit for bit
    from dcrmontecarlo_tpu_torch.parallel import ShardedWoStSolver

    solver = ShardedWoStSolver(_survey_problem(), _shards(device, 4),
                               survey_default_options())
    plan = solver._plan(ELECTRODES, 512, 500, EPS, 11)
    together = solver._combine(plan, solver._run_shards(plan, range(4)))
    alone = solver._combine(plan, torch.cat(
        [solver._run_shards(plan, [d]) for d in range(4)]))
    for k in together._fields:
        assert np.array_equal(np.asarray(getattr(together, k)),
                              np.asarray(getattr(alone, k))), k
    assert together.total_steps > 0


@pytest.mark.parametrize("case", ["survey", "flagship_split"])
def test_sharded_solve_matches_plain(device, case):
    # the sharded launch loop (K9) through the kernel and through the
    # plain version on the same shards: equal steps, launches and clones
    # per shard; the card's shards take one launch a loop step together
    from dcrmontecarlo_tpu_torch.parallel import ShardedWoStSolver

    if case == "survey":
        solver = ShardedWoStSolver(_survey_problem(), _shards(device, 4),
                                   survey_default_options())
        args = (ELECTRODES, 256, 500, EPS, 11)
    else:  # 2 shards: shard 1's clone ids start at 0xA0000000
        solver = ShardedWoStSolver(
            _notebook_problem("auto", True), _shards(device, 2),
            survey_default_options(target_slots=1 << 17, split_threshold=4.0,
                                   pallas_block_rows=1))
        args = (NOTEBOOK_ELECTRODES, 32, 100, 1.0, 5)
    launches = wk.run_walk.launches
    rk = solver._solve_raw(*args)
    stats_k = solver.last_solve_stats
    assert wk.run_walk.launches - launches == max(stats_k["shard_launches"])
    rp = solver._solve_raw(*args, walk=wk.walk_plain)
    assert solver.last_solve_stats == stats_k
    assert rk.total_steps == rp.total_steps
    assert np.isfinite(rk.mean).all()
    se = np.sqrt(rk.stderr ** 2 + rp.stderr ** 2)
    assert (np.abs(rk.mean - rp.mean) <= 1e-3 * (np.abs(rp.mean) + se)).all()
    if case != "survey":
        assert min(stats_k["shard_clones"]) > 0


# ---- every switch combination: the variant sweep (chip_smoke.py phase 42)
# ---- and the survey with the split (phase 40)

def _sweep_cases():
    import chip_smoke
    return chip_smoke.SWEEP


@pytest.mark.parametrize("case", _sweep_cases(), ids=lambda c: c[0])
def test_sweep_variant_matches_plain_one_launch(device, case):
    import chip_smoke as cs

    spec = cs.sweep_spec(case)
    solver = WoStSolver(cs.sweep_problem(spec),
                        cs.sweep_options(spec, target_slots=8192),
                        device=device)
    state, params, _, _ = solver._setup(cs.SWEEP_POINTS, 1 << 13,
                                        cs.SWEEP_MAX_STEPS, cs.SWEEP_EPS, 3)
    assert params.variant == case[1] and state["px"].numel() == 8192
    thr = spec["split"] if params.freeze else None
    ks = {k: v.clone() for k, v in state.items()}
    launches = wk.run_walk.variant_launches[params.kernel_name]
    wk.run_walk(ks, params, 64, thr)
    assert wk.run_walk.variant_launches[params.kernel_name] == launches + 1
    ps = wk.walk_plain({k: v.clone() for k, v in state.items()}, params, 64,
                       thr)
    frac, _, finite = wk.compare_planes(ks, ps, state_planes(params.n_src))
    assert finite and min(frac.values()) >= wk.PLANE_MIN_FRAC, frac
    assert int(ks["ndone"].sum()) > 0


def test_survey_split_host_loop_matches_plain(device):
    import chip_smoke as cs

    survey, electrodes = geophysical_scenario(sharpness=0.5)
    solver = WoStSolver(survey.build_problem(), cs.survey_split_options(
        target_slots=4096, min_quota=1), device=device)
    pts = cs.survey_points(electrodes, -0.5)
    rk = solver._solve_raw(pts, 256, cs.P1_MAX_STEPS, cs.P1_EPS, 11)
    stats_k = solver.last_solve_stats
    rp = solver._solve_raw(pts, 256, cs.P1_MAX_STEPS, cs.P1_EPS, 11,
                           walk=wk.walk_plain)
    assert solver.last_solve_stats == stats_k and stats_k["clones"] > 0
    assert rk.total_steps == rp.total_steps
    se = np.sqrt(rk.stderr ** 2 + rp.stderr ** 2)
    assert (np.abs(rk.mean - rp.mean) <= 1e-3 * (np.abs(rp.mean) + se)).all()


@pytest.mark.parametrize("which", ["survey", "wide_mis", "transport",
                                   "survey_mis", "wide", "wide_rows",
                                   "wide_mis_rows"])
def test_dealt_launch_matches_drained_one_thread_loop(device, which):
    # a launch of the survey builds that drains every quota from fresh
    # walks deals its walks to the threads: every plane equals the
    # one-thread loop's in 256-step launches until drained, bit for bit,
    # and the plain walk's under compare_planes; the wide survey's general
    # rows builds with sources of mixed kinds past the fourth too
    import chip_smoke as cs

    variant, extra = {
        "survey": ((0, False, False, False, False, True, False, False,
                    False), {}),
        "wide_mis": ((0, False, True, False, False, True, False, True,
                      False), dict(mis=True, n_src=5)),
        "transport": ((0, False, False, False, False, True, True, False,
                       False), dict(sampler="transport")),
        "survey_mis": ((0, False, True, False, False, True, False, False,
                        False), dict(mis=True)),
        "wide": ((0, False, False, False, False, True, False, True, False),
                 dict(n_src=5)),
        "wide_rows": ((0, False, False, False, False, True, False, True,
                       False, False, True),
                      dict(n_src=8, rows=((4, "bump"), (5, "bumps"),
                                          (6, "const"), (7, "poly")))),
        "wide_mis_rows": ((0, False, True, False, False, True, False, True,
                           False, False, True),
                          dict(mis=True, n_src=6, rows=((4, "const"),
                                                        (5, "bumps"))))}[which]
    spec = cs.sweep_spec(("dealt", variant, extra))
    solver = WoStSolver(cs.sweep_problem(spec), cs.sweep_options(
        spec, target_slots=8192), device=device)
    state, params, _, _ = solver._setup(cs.SWEEP_POINTS, 1 << 15, 64,
                                        cs.SWEEP_EPS, 3)
    assert params.variant == variant and wk.dealt(variant)
    n = state["px"].numel()
    state["quota"] = torch.tensor([0, 1, 7, 40], dtype=torch.int32,
                                  device=device).repeat(n // 4)[:n].view_as(
                                      state["quota"]).clone()
    budget = 40 * (params.max_steps + 1)
    dealt, one = ({k: v.clone() for k, v in state.items()} for _ in "ab")
    wk.run_walk.loop_launches.clear()
    wk.run_walk(dealt, params, budget)
    assert dict(wk.run_walk.loop_launches) == {"dealt": 1}
    while bool((one["quota"] > 0).any()):
        wk.run_walk(one, params, 256)
    assert set(wk.run_walk.loop_launches) == {"dealt", "lanes"}
    names = state_planes(params.n_src)
    for k in names:
        assert torch.equal(dealt[k], one[k]), k
    plain = wk.walk_plain({k: v.clone() for k, v in state.items()}, params,
                          budget)
    frac, _, finite = wk.compare_planes(dealt, plain, names)
    assert finite and min(frac.values()) >= wk.PLANE_MIN_FRAC, frac


def _poles_state(device, n_src=9):
    """The sweep box's 8,192 lanes with ``n_src`` Gaussian poles in the
    wide survey's general rows build (every source marked)."""
    import chip_smoke as cs

    rows = WIDE_ROWS
    spec = cs.sweep_spec(("poles", rows, dict(n_src=n_src)))
    problem = cs.sweep_problem(spec)
    problem.set_source_term([
        fields.gaussian_bump((-1.6 + 0.4 * i, -0.5 - 0.35 * (i % 4)),
                             1.0 + 0.15 * i, 0.3 + 0.02 * i)
        for i in range(n_src)])
    solver = WoStSolver(problem, cs.sweep_options(spec, target_slots=8192),
                        device=device)
    state, params, _, _ = solver._setup(cs.SWEEP_POINTS, 1 << 15, 64,
                                        cs.SWEEP_EPS, 3)
    assert params.variant == rows and params.poles == tuple(range(n_src))
    return state, params


WIDE_ROWS = (0, False, False, False, False, True, False, True, False, False,
             True)


def test_pole_records_equal_the_terms_text_and_plain(device):
    # the general rows build evaluates the marked poles from their records:
    # the dealt launch equals the same launch with no source marked (every
    # pole by the TERMS text) bit for bit, and the plain walk
    import dataclasses

    state, params = _poles_state(device)

    class Unmarked(type(params)):
        poles = ()

    unmarked = Unmarked(**{f.name: getattr(params, f.name)
                           for f in dataclasses.fields(params) if f.init})
    budget = int(state["quota"].max()) * (params.max_steps + 1)
    marked, general = ({k: v.clone() for k, v in state.items()}
                       for _ in "ab")
    wk.run_walk.loop_launches.clear()
    wk.run_walk(marked, params, budget)
    wk.run_walk(general, unmarked, budget)
    assert dict(wk.run_walk.loop_launches) == {"dealt": 2}
    names = state_planes(params.n_src)
    for k in names:
        assert torch.equal(marked[k], general[k]), k
    plain = wk.walk_plain({k: v.clone() for k, v in state.items()}, params,
                          budget)
    _compare(marked, plain, names)


@pytest.mark.parametrize("case", ["survey_defaults", "poles", "split"])
def test_plain_graph_equals_its_kernels_one_by_one(device, case):
    # walk_plain replays a captured CUDA graph of its step: the same
    # planes, bit for bit, as the step's kernels launched one by one
    import dataclasses

    thr = None
    if case == "poles":  # at 2 rejection rounds (64 loop on a host test)
        state, params = _poles_state(device)
        params = dataclasses.replace(params, rejection_rounds=2)
    else:
        opts = (dict(split_threshold=4.0) if case == "split" else
                dict(common_random_numbers=True, roulette_threshold=0.05,
                     rejection_rounds=2))
        solver = WoStSolver(_survey_problem(), survey_default_options(
            target_slots=8192, **opts), device=device)
        state, params, _, _ = solver._setup(ELECTRODES, 4096, 500, EPS, 3)
        thr = 4.0 if case == "split" else None
    assert wk._graphable(params)
    graphed, eager = ({k: v.clone() for k, v in state.items()}
                      for _ in "ab")
    wk.walk_plain(graphed, params, 200, thr)
    graphable = wk._graphable
    wk._graphable = lambda P: False
    try:
        wk.walk_plain(eager, params, 200, thr)
    finally:
        wk._graphable = graphable
    for k in state_planes(params.n_src):
        assert torch.equal(graphed[k], eager[k]), k


@pytest.mark.parametrize("which", ["table_chain", "mis_no_delta"])
def test_redesigned_build_at_its_full_state_matches_loop_and_plain(device,
                                                                   which):
    # phase 48's table chain and phase 49's MIS without delta tracking at
    # their full-size states: the single launch drains every quota and
    # equals the build's own 256-step launches on every plane; 64 plain
    # steps into 8,192 of the lanes' walks, a 32-step launch follows the
    # plain walk under phase 3's rule
    import chip_smoke as cs

    if which == "table_chain":
        prob, pts, options = cs.shallow_terrain_config()
        run = (cs.P2_WALKS, cs.P2_MAX_STEPS, cs.P2_EPS)
        rule, lanes = wk.culled_chord, cs.P48_LANES
    else:
        (prob, options), pts = cs.narrow_source_config(), cs.NARROW_POINTS
        run, rule, lanes = cs.NARROW_RUN, wk.one_sincos, cs.P49_LANES
    solver = WoStSolver(prob, options, device=device)
    state, params, _, step_bound = solver._setup(pts, *run, 5)
    assert state["px"].numel() == lanes and rule(params.variant)
    whole, drained = ({k: v.clone() for k, v in state.items()}
                      for _ in "ab")
    wk.run_walk(whole, params, step_bound)
    assert int(whole["quota"].max()) == 0
    while bool((drained["quota"] > 0).any()):
        wk.run_walk(drained, params, 256)
    for k in state_planes(params.n_src):
        assert torch.equal(whole[k], drained[k]), k
    small = {k: v.reshape(-1)[:8192].clone() for k, v in state.items()}
    wk.walk_plain(small, params, 64)
    ks, ps = ({k: v.clone() for k, v in small.items()} for _ in "ab")
    wk.run_walk(ks, params, 32)
    wk.walk_plain(ps, params, 32)
    frac, _, finite = wk.compare_planes(ks, ps, state_planes(params.n_src))
    assert finite and min(frac.values()) >= wk.PLANE_MIN_FRAC, frac
