"""The sharded solver on a boundary of more than 8,192 rows.

``ShardedWoStSolver`` inherits the single-device solver's checks, so it
walks the 8,194-row terrain (``half_width=100, depth=150,
resolution=100/2048``) on the table form as the single device does, as
the JAX package's mesh walks it on its XLA loop (``parallel/mesh.py:130``).
A 2-shard CPU mesh and one device solve 3 draped electrodes x 64 walks
with the same seed (the shards draw other streams): every potential
within 4 combined standard errors of the other's.
"""

import numpy as np
import torch

from dcrmontecarlo_tpu_torch.models import drape_electrodes, \
    topographic_survey_problem
from dcrmontecarlo_tpu_torch.ops import walk_kernel as wk
from dcrmontecarlo_tpu_torch.parallel import ShardedWoStSolver, make_mesh
from dcrmontecarlo_tpu_torch.solver import SolverOptions, WoStSolver
from test_torch_large_table import LARGE_TERRAIN, XS

torch.set_num_threads(1)


def test_sharded_large_terrain_agrees_with_single_device():
    prob, h = topographic_survey_problem(**LARGE_TERRAIN)
    assert wk.geometry_size(prob) == 8194
    el = drape_electrodes(h, XS, nudge=0.5)
    kw = dict(n_walks=64, max_steps=150, eps=0.5, seed=0)
    opts = SolverOptions(target_slots=1024)
    single = WoStSolver(prob, opts, device="cpu").solve(el, **kw)
    sharded_solver = ShardedWoStSolver(prob, make_mesh(2, device="cpu"),
                                       opts)
    sharded = sharded_solver.solve(el, **kw)
    _, params, _, _ = sharded_solver._setup(el, 64, 150, 0.5, 0)
    assert params.table and params.kernel_name == \
        "walk_kernel<0,false,false,false,true,true,false>"
    se = np.hypot(single.stderr, sharded.stderr)
    assert np.isfinite(sharded.mean).all() and (sharded.stderr > 0).all()
    assert (np.abs(single.mean - sharded.mean) < 4.0 * se).all(), (
        single.mean, sharded.mean, se)
    assert sharded.total_steps > 0
