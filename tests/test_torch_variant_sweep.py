"""The variant sweep: the port's plain walk against the JAX package.

The CUDA kernel builds any switch combination the JAX kernel traces
(``ops/walk_kernel.py::valid_variant``). ``chip_smoke.py::SWEEP`` lists
twelve variants in which, with the paths' own, every pair of switch values
occurs; each is built here the same way on both sides (the port by
``chip_smoke.py::sweep_problem``, the JAX package by :func:`jax_problem`)
and one 32-step launch from one numpy-built state of 256 lanes goes
through the interpreted Pallas kernel (``make_pallas_walk(...).run`` under
``pltpu.force_tpu_interpret_mode()``, with the freeze at the case's split
threshold) and through the port's plain walk. Every plane must agree on >=
99% of the lanes under ``walk_kernel.compare_planes``.

The Pallas kernel refuses a gridded field (it captures its node table), so
in the grid cases the JAX side banks the field the grid holds exactly (a
bilinear one) in closed form: the walks are the same, the banked values
agree to rounding. The interpolant itself is held to the JAX package's
``grid_continuation`` in ``test_torch_grid.py``, and a grid solve to its
XLA backend there.

The cases split across this file and ``test_torch_variant_sweep_b.py`` to
``_e.py`` (each under a minute alone on the CPU); the CUDA kernel is held
to the plain walk on the same cases by ``chip_smoke.py`` phase 42 and
``test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

import chip_smoke as cs
from dcrmontecarlo_tpu_torch import interop
from dcrmontecarlo_tpu_torch.ops import walk_kernel as wk
from dcrmontecarlo_tpu_torch.sampling.rng import stream_seed
from dcrmontecarlo_tpu_torch.solver import WoStSolver
from dcrmontecarlo_tpu_torch.solver.state import state_planes
from test_torch_walk_kernel import numpy_planes

torch.set_num_threads(1)

SEED, STEPS, N_WALKS = 7, 32, 64
CASES = {c[0]: c for c in cs.SWEEP}
# the cases of this file and of test_torch_variant_sweep_b.py and _c.py
# (~40 s each alone on the CPU; the table form's interpreted loops are the
# slowest)
GROUPS = (("table+mis", "grid_no_delta"),
          ("reflectance_table_all",),
          ("table+majorant", "survey+grid", "no_delta_wide+terms"),
          ("table+wide", "reflectance+mis"),
          ("flagship_wide", "chain+freeze+terms", "transport+mis",
           "chain+majorant+terms"))
assert sorted(sum(GROUPS, ())) == sorted(CASES)


def jax_problem(spec):
    """The JAX package's problem of a sweep case, built as
    ``chip_smoke.py::sweep_problem`` builds the port's."""
    import jax.numpy as jnp
    from dcrmontecarlo_tpu import Problem
    from dcrmontecarlo_tpu.geometry import Polyline
    from dcrmontecarlo_tpu.models.dcr_scenarios import \
        _anomalous_conductivity
    from dcrmontecarlo_tpu.problems.fields import GaussianMixture, \
        gaussian_dipole
    from dcrmontecarlo_tpu.problems.majorant import LocalMajorant

    dirichlet, neumann = cs.sweep_boundary(spec["geometry"])
    alpha = {None: None,
             "terms": lambda x, y: 2.0 + jnp.sin(0.5 * x) * 0.3 + 0.2 * y,
             "bumps": _anomalous_conductivity(1.0, cs.SWEEP_ANOMALIES,
                                              8.0)}[spec["alpha"]]
    bc = {"zero": lambda x, y: 0.0 * x, "poly": lambda x, y: x + y,
          "grid": lambda x, y: 0.5 + 0.3 * x - 0.2 * y + 0.1 * x * y}[
              spec["bc"]]
    sources = [gaussian_dipole(a, b, 1.0, cs.SWEEP_WIDTH)
               for a, b in cs.SWEEP_DIPOLES[:spec["n_src"]]]
    a, b = cs.SWEEP_DIPOLES[0]
    return Problem(
        dirichlet=Polyline.from_points(dirichlet),
        neumann=Polyline.from_points(neumann), bc_dirichlet=bc,
        source=sources[0] if len(sources) == 1 else sources, alpha=alpha,
        source_importance=(GaussianMixture.from_components(
            [(a, cs.SWEEP_WIDTH, 0.5), (b, cs.SWEEP_WIDTH, 0.5)])
            if spec["mis"] else None),
        local_majorant=(LocalMajorant(boxes=(cs.SWEEP_MAJORANT_BOX,),
                                      sigma_bar_bg=0.01)
                        if spec["majorant"] else None))


def sweep_launch(name):
    """One launch of a sweep case on both sides; returns ``(got, want,
    params)``."""
    from jax.experimental.pallas import tpu as pltpu
    import jax.numpy as jnp
    from dcrmontecarlo_tpu.ops.pallas_walk import make_pallas_walk
    from dcrmontecarlo_tpu.solver import SolverOptions as JOptions
    from dcrmontecarlo_tpu.solver import WoStSolver as JSolver

    spec = cs.sweep_spec(CASES[name])
    opts = dict(target_slots=256, pallas_block_rows=2,
                common_random_numbers=True, roulette_threshold=0.05,
                robin_correction=spec["robin"],
                split_threshold=spec["split"],
                screened_sampler=spec["sampler"])
    jprob = jax_problem(spec)
    jsolver = JSolver(jprob, JOptions(**opts))
    planes = numpy_planes(jsolver, cs.SWEEP_POINTS, N_WALKS, cs.SWEEP_EPS)
    assert planes["px"].size == 256
    snap = "ob0" in planes
    eps, max_steps = cs.SWEEP_EPS, cs.SWEEP_MAX_STEPS
    freeze = spec["split"] is not None and jprob.use_delta_tracking
    plan = make_pallas_walk(
        jprob, eps=eps, max_steps=max_steps, t_min=1e-5 * jprob.diameter,
        rmin=0.5 * eps, project=True, n_inner=STEPS, block_rows=2,
        rejection_rounds=jsolver.options.rejection_rounds,
        screened_sampler=spec["sampler"],
        robin_correction=jsolver._robin_enabled(),
        roulette_threshold=0.05, snap_starts=snap, freeze_split=freeze)
    kw = dict(freeze_thr=spec["split"]) if freeze else {}
    with pltpu.force_tpu_interpret_mode():
        out = plan.run({k: jnp.asarray(v) for k, v in planes.items()},
                       stream_seed(SEED), inner_steps=STEPS, **kw)
    want = {k: np.asarray(v) for k, v in out.items()}

    tprob = cs.sweep_problem(spec)
    tsolver = WoStSolver(tprob, cs.sweep_options(spec, target_slots=256,
                                                 pallas_block_rows=2),
                         device="cpu")
    params = tsolver._walk_params(eps, max_steps, SEED, snap)
    got = interop.state_to_numpy(wk.run_walk(
        interop.state_from_numpy(planes), params, STEPS,
        spec["split"] if params.freeze else None))
    return got, want, params


def check_case(name):
    got, want, params = sweep_launch(name)
    assert params.variant == CASES[name][1], params.kernel_name
    assert params.variant in wk.KERNEL_VARIANTS
    params.pack()  # the card takes it
    names = state_planes(params.n_src)
    frac, _, finite = wk.compare_planes(
        {k: torch.tensor(got[k]) for k in names},
        {k: torch.tensor(want[k]) for k in names}, names)
    assert finite
    assert min(frac.values()) >= wk.PLANE_MIN_FRAC, frac
    assert (want["ndone"] > 0).any() and (want["life"] > 0).any()


@pytest.mark.parametrize("name", GROUPS[0])
def test_plain_walk_matches_reference(name):
    check_case(name)
