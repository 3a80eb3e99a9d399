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
each, and a whole solve at the test size.
"""

import os


import numpy as np
import pytest
import torch

from dcrmontecarlo_tpu_torch.geometry import square_loop
from dcrmontecarlo_tpu_torch.models import drape_electrodes, \
    geophysical_scenario, notebook_survey, topographic_survey_problem
from dcrmontecarlo_tpu_torch.ops import walk_kernel as wk
from dcrmontecarlo_tpu_torch.problems import Problem, fields
from dcrmontecarlo_tpu_torch.solver import SolverOptions, WoStSolver
from dcrmontecarlo_tpu_torch.solver.state import state_planes

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
    prob = Problem(dirichlet=square_loop(1.0),
                   alpha=lambda x, y: 1.0 + 0.0 * x, sigma_bar_override=0.1)
    solver = WoStSolver(prob, device=device)
    with pytest.raises(NotImplementedError, match="field specs"):
        solver.solve([[0.0, 0.0]], n_walks=8, max_steps=10, eps=1e-2)


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
    launches = wk.run_walk.variant_launches[
        "walk_kernel<0,false,false,false,true>"]
    rk = solver._solve_raw(pts, 512, 600, 0.5, 5)
    assert wk.run_walk.variant_launches[
        "walk_kernel<0,false,false,false,true>"] > launches
    rp = solver._solve_raw(pts, 512, 600, 0.5, 5, walk=wk.walk_plain)
    assert np.isfinite(rk.mean).all() and np.isfinite(rk.stderr).all()
    se = np.sqrt(rk.stderr ** 2 + rp.stderr ** 2)
    assert (np.abs(rk.mean - rp.mean) <= 1e-3 * (np.abs(rp.mean) + se)).all()
    assert rk.total_steps == rp.total_steps
