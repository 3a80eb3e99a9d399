"""Whole host-loop solves with the high-weight split against the JAX package.

The port's host launch loop (``WoStSolver._launch_loop``: fixed launches,
the split after each) against the JAX package's Pallas host loop in
interpret mode (``test_torch_split.py::_host_loop_pair``), at the size of
``tests/test_pallas_walk.py:524-550`` (``square_loop(2.0)``, a
``bump_sum`` of one ``smooth_circle`` as the conductivity, 1024 lanes,
16-step launches): equal total steps and clone counts, means to ``1e-3
(|mean| + stderr)``; split-on against split-off within 4 combined sigma;
the cross-point banking case (``test_pallas_walk.py:611-636``); the
progress callback's calls. The split itself, the freeze and the clip are
in ``test_torch_split.py``.
"""

import numpy as np
import pytest
import torch

from test_torch_split import _bump_problems, _host_loop_pair

torch.set_num_threads(1)


SPLIT_PTS = np.array([[0.0, 0.0], [0.4, 0.2]], np.float32)


@pytest.fixture(scope="module")
def split_solves():
    tprob, jprob = _bump_problems(lambda x, y: 1.0 + x * y)
    return {thr: _host_loop_pair(tprob, jprob, SPLIT_PTS, 96, 200, 9, thr)
            for thr in (None, 1.5)}


@pytest.mark.parametrize("thr", [None, 1.5])
def test_host_loop_solve_matches_pallas(split_solves, thr):
    r = split_solves[thr]
    got, want = r["got"], r["want"]
    assert got.total_steps == want.total_steps
    assert r["stats"]["clones"] == r["j_clones"]
    assert (r["j_clones"] > 0) == (thr is not None)
    se = np.sqrt(got.stderr ** 2 + np.asarray(want.stderr) ** 2)
    dm = np.abs(got.mean - np.asarray(want.mean))
    assert (dm <= 1e-3 * (np.abs(np.asarray(want.mean)) + se)).all(), (
        got.mean, want.mean)
    assert r["stats"]["launches"] > 1


def test_progress_calls_match_jax(split_solves):
    for r in split_solves.values():
        assert r["t_calls"] == r["j_calls"] and len(r["t_calls"]) > 1
        done, total, it = r["t_calls"][-1]
        assert done == total == 2 * 96 and it == 16 * len(r["t_calls"])


def test_split_on_agrees_with_split_off(split_solves):
    a, b = split_solves[None]["got"], split_solves[1.5]["got"]
    comb = np.sqrt(a.stderr ** 2 + b.stderr ** 2)
    dev = np.abs(a.mean - b.mean) / np.maximum(comb, 1e-12)
    assert (dev < 4.0).all(), (a.mean, b.mean, dev)
    assert b.total_steps > a.total_steps  # the clones walked


def test_split_banks_destination_stats_across_points():
    # the port's test_pallas_walk.py::test_split_banks_destination_stats_
    # across_points: the split pairs lanes globally, so a drained point-A
    # lane hosts a point-B clone; its banked sums must stay with A. With
    # strongly contrasting means the transfer would show: split-on agrees
    # with split-off per point, and with the JAX package's host loop
    tprob, jprob = _bump_problems(lambda x, y: 10.0 * x)
    pts = np.array([[-1.2, 0.0], [1.2, 0.0], [0.0, 0.1]], np.float32)
    runs = {thr: _host_loop_pair(tprob, jprob, pts, 128, 150, 3, thr,
                                 n_inner=8, min_quota=2)
            for thr in (None, 1.2)}
    a, b = runs[None]["got"], runs[1.2]["got"]
    comb = np.sqrt(a.stderr ** 2 + b.stderr ** 2)
    dev = np.abs(a.mean - b.mean) / np.maximum(comb, 1e-12)
    assert (dev < 4.0).all(), (a.mean, b.mean, dev)
    assert b.total_steps > a.total_steps  # the clones walked
    r = runs[1.2]
    assert r["got"].total_steps == r["want"].total_steps
    assert r["stats"]["clones"] == r["j_clones"] > 0
    np.testing.assert_allclose(r["got"].mean, np.asarray(r["want"].mean),
                               rtol=1e-4, atol=1e-4)
