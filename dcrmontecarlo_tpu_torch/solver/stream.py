"""Streaming and adaptive solves (port of ``solver/stream.py``).

``solve_stream`` runs fixed-size batches of walks, each a
``WoStSolver.solve`` with the seed ``seed + 1000003 * batch``, and merges
their ``(sum, sumsq)`` moments exactly; ``solve_to_tolerance`` adds
batches until every point's standard error meets a target. The running
:class:`StreamState` is plain numpy, so a run can be checkpointed and
resumed. Each batch runs where the solver runs: on the card unless the
solver was made with ``device="cpu"``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np

from .wost import SolveResult, WoStSolver

__all__ = ["StreamState", "solve_stream", "solve_to_tolerance"]


@dataclass
class StreamState:
    """Running accumulation over batches (checkpointable)."""

    sum: np.ndarray       # (..., N) running sum of walk totals
    sumsq: np.ndarray     # (..., N) running sum of squared walk totals
    n_walks: int = 0
    total_steps: float = 0.0
    batches: int = 0
    points: np.ndarray = None  # (N, 2) the points these statistics
                               # belong to; resuming elsewhere raises

    def result(self) -> SolveResult:
        mean = self.sum / max(self.n_walks, 1)
        var = np.maximum(self.sumsq / max(self.n_walks, 1) - mean * mean, 0.0)
        stderr = np.sqrt(var / max(self.n_walks, 1))
        return SolveResult(mean=mean, stderr=stderr, n_walks=self.n_walks,
                           total_steps=self.total_steps,
                           iterations=self.batches)


def solve_stream(solver: WoStSolver, points, n_walks_total: int,
                 batch_walks: int = 4096, max_steps: int = 1000,
                 eps: float = 1e-4, seed: int = 0,
                 callback: Optional[Callable[[int, SolveResult], None]] = None,
                 state: Optional[StreamState] = None) -> SolveResult:
    """Accumulate ``n_walks_total`` walks per point in batches.

    ``callback(batch_index, partial SolveResult)`` runs after each batch;
    ``state`` resumes an earlier run (``solve_stream`` leaves it on
    ``solver._stream_state``). Returns the combined result.
    """
    if n_walks_total <= 0:
        raise ValueError(f"n_walks_total must be positive, got {n_walks_total}")
    pts = np.asarray(points, np.float32).reshape(-1, 2)
    state = _check_resume_points(state, pts)
    done = state.n_walks if state is not None else 0
    while done < n_walks_total:
        n = min(batch_walks, n_walks_total - done)
        state = _accumulate_batch(solver, pts, n, max_steps, eps, seed,
                                  state, callback)
        done = state.n_walks
    solver._stream_state = state
    return state.result()


def _check_resume_points(state: Optional[StreamState], pts):
    """Refuse to resume statistics accumulated at different points."""
    if state is None:
        return None
    if state.points is not None and not (
            state.points.shape == pts.shape
            and np.array_equal(state.points, pts)):
        raise ValueError(
            "StreamState was accumulated at different evaluation points; "
            "resuming here would silently mix statistics for different "
            "locations. Start a fresh stream (state=None) instead.")
    return state


def _accumulate_batch(solver, pts, n, max_steps, eps, seed, state, callback):
    """One batch: solve, merge the raw moments, fire the callback."""
    batch_idx = state.batches if state is not None else 0
    res = solver.solve(pts, n_walks=n, max_steps=max_steps, eps=eps,
                       seed=seed + 1000003 * batch_idx)
    b_sum = np.asarray(res.walk_sum)
    b_sumsq = np.asarray(res.walk_sumsq)
    if state is None:
        state = StreamState(sum=b_sum, sumsq=b_sumsq, points=pts.copy())
    else:
        if np.shape(state.sum) != np.shape(b_sum):
            raise ValueError(
                f"StreamState moment shape {np.shape(state.sum)} does not "
                f"match this solve's {np.shape(b_sum)} — the problem's "
                "source list changed since the state was accumulated "
                "(set_source_term?). Start a fresh stream (state=None).")
        state.sum = state.sum + b_sum
        state.sumsq = state.sumsq + b_sumsq
        if state.points is None:
            state.points = pts.copy()
    state.n_walks += n
    state.total_steps += res.total_steps
    state.batches += 1
    if callback is not None:
        callback(state.batches, state.result())
    return state


def solve_to_tolerance(solver: WoStSolver, points, target_stderr: float,
                       relative: bool = False, relative_floor: float = 0.0,
                       batch_walks: int = 4096, max_walks: int = 1 << 20,
                       max_steps: int = 1000, eps: float = 1e-4,
                       seed: int = 0,
                       callback: Optional[
                           Callable[[int, SolveResult], None]] = None,
                       state: Optional[StreamState] = None) -> SolveResult:
    """Add walk batches until every point's standard error is at most
    ``target_stderr`` (times ``max(max|mean|, relative_floor)`` when
    ``relative``) or ``max_walks`` is spent. The state is left on
    ``solver._stream_state`` as by :func:`solve_stream`.
    """
    if max_walks <= 0:
        raise ValueError(f"max_walks must be positive, got {max_walks}")
    pts = np.asarray(points, np.float32).reshape(-1, 2)
    state = _check_resume_points(state, pts)
    done = state.n_walks if state is not None else 0
    while True:
        if state is not None:
            res = state.result()
            thr = target_stderr * (
                max(float(np.max(np.abs(res.mean))), relative_floor)
                if relative else 1.0)
            if np.max(res.stderr) <= thr:
                break
            if done >= max_walks:
                break
        n = min(batch_walks, max_walks - done)
        if n <= 0:
            break
        state = _accumulate_batch(solver, pts, n, max_steps, eps, seed,
                                  state, callback)
        done = state.n_walks
    solver._stream_state = state
    return state.result()
