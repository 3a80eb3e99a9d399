"""The plain walk with silhouette vertices against the Pallas kernel.

One 16-step launch of the port's plain walk against the JAX package's
interpreted Pallas kernel on a staircase terrain (4 m steps: axis-aligned
walls with integer corners, so a hit point lies exactly on its wall and
walks stay in step across math libraries; ``test_torch_silhouette.py``
says why a sloped wall would not), in each geometry form: 16 m steps give
52 rows (the static form), 8 m steps 100 (the table form). The silhouette
vertices act: without them the radii change on >= 1% of the lanes.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcrmontecarlo_tpu.ops.pallas_walk import _geometry_size, \
    make_pallas_walk
from dcrmontecarlo_tpu.solver import SolverOptions as JOptions
from dcrmontecarlo_tpu.solver import WoStSolver as JSolver
from dcrmontecarlo_tpu_torch import interop
from dcrmontecarlo_tpu_torch.ops import walk_kernel as wk
from dcrmontecarlo_tpu_torch.sampling.rng import stream_seed
from dcrmontecarlo_tpu_torch.solver.state import state_planes
from test_torch_silhouette import STAIRS, STEPS, _staircase_problems
from test_torch_walk_kernel import OPTS, SEED, _compare, numpy_planes

torch.set_num_threads(1)


@pytest.mark.parametrize("step", sorted(STAIRS))
def test_plain_walk_matches_pallas_kernel_on_terrain(step):
    from jax.experimental.pallas import tpu as pltpu

    tprob, jprob = _staircase_problems(step)
    size, table = STAIRS[step]
    assert _geometry_size(jprob) == wk.geometry_size(tprob) == size
    points = np.stack([np.arange(-40.0, 41.0, 10.0), np.full(9, -0.7)],
                      1).astype(np.float32)
    eps = 0.5
    planes = numpy_planes(JSolver(jprob, JOptions(**OPTS)), points, 452, eps)
    assert planes["px"].size == 1024
    common = dict(eps=eps, max_steps=600, t_min=1e-5 * jprob.diameter,
                  rmin=0.5 * eps, project=True, rejection_rounds=2,
                  roulette_threshold=0.05)
    plan = make_pallas_walk(jprob, n_inner=STEPS, block_rows=8,
                            snap_starts=True, **common)
    with pltpu.force_tpu_interpret_mode():
        out = plan.run({k: jnp.asarray(v) for k, v in planes.items()},
                       stream_seed(SEED), inner_steps=STEPS)
    want = {k: np.asarray(v) for k, v in out.items()}
    params = wk.make_walk_params(tprob, snap=True, seed=stream_seed(SEED),
                                 **common)
    assert params.table == table and len(params.vert_table) > 0
    got = interop.state_to_numpy(wk.run_walk(
        interop.state_from_numpy(planes), params, STEPS))
    _compare(got, want, state_planes(1))
    assert (want["ob"] != 0).any() and (want["ndone"] > 0).any()
    # the silhouettes acted: without the vertices the radii change
    no_vert = interop.state_to_numpy(wk.walk_plain(
        interop.state_from_numpy(planes),
        dataclasses.replace(params, vert_table=params.vert_table[:0]), STEPS))
    differ = (no_vert["px"] != got["px"]) | (no_vert["atten"] != got["atten"])
    assert differ.mean() >= 0.01
