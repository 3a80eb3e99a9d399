"""A multi-process sharded solve of the port on ``torch.distributed``.

Two OS processes, each holding 2 CPU shards, join over a local gloo
rendezvous (``initialize_distributed(..., local_device_count=2,
device="cpu")``) into one 4-shard mesh and run the same solves: the
square of ``tests/test_multihost.py`` and the bump-alpha problem with the
split and common random numbers (global shards 2 and 3, whose clone
ranges are negative as int32, live in the second process), on all 4
shards and on the first 3 (the second process then holds one). Both
processes must print the same result, and it must equal the same mesh in
one process bit for bit: the shards' rows are gathered and summed in
shard order, so process boundaries do not show. The workers are fresh
subprocesses on a free port with a timeout of their own; the test process
never joins a process group.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from dcrmontecarlo_tpu_torch.parallel import ShardedWoStSolver, make_mesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CASES = r"""
import numpy as np, torch
from dcrmontecarlo_tpu_torch.geometry import square_loop
from dcrmontecarlo_tpu_torch.problems import Problem, fields
from dcrmontecarlo_tpu_torch.solver import SolverOptions

torch.set_num_threads(1)
SQUARE = (Problem(dirichlet=square_loop(2.0),
                  bc_dirichlet=lambda x, y: x * x - y * y),
          SolverOptions(target_slots=512),
          np.array([[0.0, 0.0], [0.5, -0.5]], np.float32),
          dict(n_walks=256, max_steps=200, eps=1e-2, seed=7))
BUMP = (Problem(dirichlet=square_loop(2.0),
                bc_dirichlet=lambda x, y: 1.0 + x * y,
                alpha=fields.bump_sum(1.0, [(3.0, fields.smooth_circle(
                    (0.0, 0.0), 0.4, 4.0))])),
        SolverOptions(target_slots=512, pallas_inner_steps=16,
                      pallas_block_rows=8, split_threshold=1.5,
                      common_random_numbers=True),
        np.array([[0.0, 0.0], [0.4, 0.2]], np.float32),
        dict(n_walks=128, max_steps=150, eps=2e-2, seed=9))


def result(solver, pts, kw):
    r = solver.solve(pts, **kw)
    return {"mean": r.mean.tolist(), "stderr": r.stderr.tolist(),
            "walk_sum": r.walk_sum.tolist(),
            "walk_sumsq": r.walk_sumsq.tolist(),
            "total_steps": r.total_steps, "iterations": r.iterations,
            "max_weight": r.max_weight, "max_banked": r.max_banked,
            "stats": solver.last_solve_stats}
"""

_WORKER = _CASES + r"""
import json, sys
import torch.distributed as dist
from dcrmontecarlo_tpu_torch.parallel import ShardedWoStSolver, \
    initialize_distributed, make_mesh

coord, nproc, pid = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
n_mesh = int(sys.argv[4])
n_global = initialize_distributed(coord, nproc, pid, local_device_count=2,
                                  device="cpu")
assert n_global == 2 * nproc, n_global
assert dist.get_backend() == "gloo"
mesh = make_mesh(n_mesh, device="cpu")
assert mesh.local_shards == list(range(2 * pid, min(2 * pid + 2, n_mesh)))
out = [result(ShardedWoStSolver(prob, mesh, opts), pts, kw)
       for prob, opts, pts, kw in (SQUARE, BUMP)]
dist.destroy_process_group()
print("RESULT", json.dumps(out), flush=True)
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("n_mesh", [4, 3])
def test_two_process_mesh_matches_single_process(n_mesh):
    # 3: the first 3 of the job's 4 shards, the second process holding one
    coord = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, coord, "2", str(pid), str(n_mesh)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for pid in (0, 1)]
    try:
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    got = [json.loads([ln for ln in out.splitlines()
                       if ln.startswith("RESULT")][0].split(" ", 1)[1])
           for out in outs]
    # both processes hold the same global result
    assert got[0] == got[1]
    # and it is the same mesh in one process, bit for bit
    scope = {}
    exec(_CASES, scope)
    mesh = make_mesh(n_mesh, device="cpu")
    for case, name in zip(got[0], ("SQUARE", "BUMP")):
        prob, opts, pts, kw = scope[name]
        want = scope["result"](ShardedWoStSolver(prob, mesh, opts), pts, kw)
        assert case == want, name
    bump = got[0][1]
    assert len(bump["stats"]["shard_clones"]) == n_mesh
    assert min(bump["stats"]["shard_clones"]) > 0  # shards 2, 3: negative
    assert np.isfinite(bump["mean"]).all()
    assert not torch.distributed.is_initialized()

