"""The accuracy path of the port's walk against the JAX package's Pallas kernel.

As ``test_torch_walk_kernel.py`` does for the survey's main path: one
numpy-built set of 1024 walker planes goes through the interpreted Pallas
kernel and through the port's plain walk for 32 steps, with common random
numbers, roulette 0.05, two rejection rounds and boundary-snap starts,
in three cases: the notebook survey's accuracy configuration (the Robin
chord chain with ``local_majorant="auto"``), the reflectance fold with the
majorant, and a chain case whose conductivity varies along the wall with
one snapped start. Both sides walk the JAX package's majorant (carried
over by ``interop.local_majorant_from``). Every plane must agree on >= 99%
of the lanes to rel 1e-4 (``walk_kernel.compare_planes``), and each
mechanism must have run: the same 32 steps with the Robin correction, or
the majorant, switched off change ``atten`` or ``px`` on >= 1% of lanes.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcrmontecarlo_tpu.geometry import Polyline as JPolyline
from dcrmontecarlo_tpu.models import notebook_survey as j_nb
from dcrmontecarlo_tpu.ops.pallas_walk import make_pallas_walk
from dcrmontecarlo_tpu.problems import Problem as JProblem
from dcrmontecarlo_tpu.problems import fields as jf
from dcrmontecarlo_tpu.solver import SolverOptions as JOptions
from dcrmontecarlo_tpu.solver import WoStSolver as JSolver
from dcrmontecarlo_tpu_torch import interop
from dcrmontecarlo_tpu_torch.geometry import Polyline
from dcrmontecarlo_tpu_torch.models import notebook_survey
from dcrmontecarlo_tpu_torch.ops import walk_kernel as wk
from dcrmontecarlo_tpu_torch.problems import Problem, fields
from dcrmontecarlo_tpu_torch.sampling.rng import stream_seed
from dcrmontecarlo_tpu_torch.solver.state import state_planes
from test_torch_walk_kernel import OPTS, SEED, STEPS, _compare, numpy_planes

torch.set_num_threads(1)


def _wall_bump_problems():
    """A chain case whose conductivity varies ALONG the Neumann wall (a
    bump centred on it), as ``tests/test_pallas_walk.py:639`` sets up."""
    wall = [[-5.0, 0.0], [5.0, 0.0]]
    box = [[-5.0, 0.0], [-5.0, -10.0], [5.0, -10.0], [5.0, 0.0]]
    circle = jf.smooth_circle((1.5, 0.5), 2.0, 1.5)
    jprob = JProblem(dirichlet=JPolyline.from_points(box),
                     neumann=JPolyline.from_points(wall),
                     bc_dirichlet=lambda x, y: x / 5.0,
                     alpha=lambda x, y: 1.0 + 2.0 * circle(x, y))
    tprob = Problem(dirichlet=Polyline.from_points(box),
                    neumann=Polyline.from_points(wall),
                    bc_dirichlet=lambda x, y: x / 5.0,
                    alpha=fields.bump_sum(1.0, [(2.0, fields.smooth_circle(
                        (1.5, 0.5), 2.0, 1.5))]))
    return tprob, jprob


@pytest.fixture(scope="module")
def accuracy_problems():
    """The notebook survey with ``local_majorant="auto"``; the port gets
    the JAX package's majorant through ``interop``, so both walk the same
    regions."""
    js, je = j_nb()
    js.local_majorant = "auto"
    jprob = js.build_problem()
    ts, _ = notebook_survey()
    ts.local_majorant = interop.local_majorant_from(jprob.local_majorant)
    return ts.build_problem(), jprob, np.asarray(je, np.float32)


# case -> (robin mode, majorant on, points, n_walks, eps, max_steps)
ACCURACY_CASES = {
    "notebook_chain_majorant": ("chain", True, None, 1024, 1.0, 6000),
    "notebook_reflectance_majorant": ("reflectance", True, None, 1024, 1.0,
                                      6000),
    "wall_bump_chain_snap": ("chain", False, np.array(
        [[1.0, -0.005], [2.0, -1.0]], np.float32), 2048, 0.02, 120),
}


@pytest.mark.parametrize("case", sorted(ACCURACY_CASES))
def test_accuracy_path_matches_pallas_kernel(accuracy_problems, case):
    from jax.experimental.pallas import tpu as pltpu

    mode, with_mj, pts, n_walks, eps, max_steps = ACCURACY_CASES[case]
    if with_mj:
        tprob, jprob, pts = accuracy_problems
    else:
        tprob, jprob = _wall_bump_problems()
    jsolver = JSolver(jprob, JOptions(robin_correction=mode, **OPTS))
    assert jsolver._robin_enabled() == mode
    assert (jprob.local_majorant is not None) == with_mj
    planes = numpy_planes(jsolver, pts, n_walks, eps)
    assert planes["px"].size == 1024
    common = dict(eps=eps, max_steps=max_steps, t_min=1e-5 * jprob.diameter,
                  rmin=0.5 * eps, project=True, rejection_rounds=2,
                  roulette_threshold=0.05)
    plan = make_pallas_walk(jprob, n_inner=STEPS, block_rows=8,
                            snap_starts=True, robin_correction=mode,
                            robin_arrival_clamp=0.02, **common)
    with pltpu.force_tpu_interpret_mode():
        out = plan.run({k: jnp.asarray(v) for k, v in planes.items()},
                       stream_seed(SEED), inner_steps=STEPS)
    want = {k: np.asarray(v) for k, v in out.items()}

    params = wk.make_walk_params(tprob, snap=True, seed=stream_seed(SEED),
                                 robin_correction=mode, **common)
    assert params.robin == (wk.ROBIN_CHAIN if mode == "chain"
                            else wk.ROBIN_REFLECTANCE)
    got = interop.state_to_numpy(wk.run_walk(interop.state_from_numpy(planes),
                                             params, STEPS))
    _compare(got, want, state_planes(1))
    assert (want["ndone"] > 0).any() and (want["ob"] != 0).any()
    if not with_mj:
        assert planes["ob0"].any()  # the snapped start
    # each mechanism ran: switching it off changes >= 1% of the lanes
    offs = [dataclasses.replace(params, robin=wk.ROBIN_OFF)]
    if with_mj:
        offs.append(dataclasses.replace(params, majorant=None))
    for p_off in offs:
        other = interop.state_to_numpy(wk.walk_plain(
            interop.state_from_numpy(planes), p_off, STEPS))
        differ = (other["atten"] != got["atten"]) | (other["px"] != got["px"])
        assert differ.mean() >= 0.01, (case, differ.mean())
