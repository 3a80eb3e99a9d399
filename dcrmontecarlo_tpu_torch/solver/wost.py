"""Walk-on-Stars solver (port of ``solver/wost.py``).

The solve is the JAX package's Pallas path (``_build_solve_fn_pallas``):
lay out ``K`` recycled slots per evaluation point on ``(rows, 128)``
walker planes, advance them with the walk, and reduce the banked per-lane
sums to per-point moments. By default that is the adaptive single launch
(``solver/wost.py:1897-1968``): ONE launch whose step budget covers the
whole remaining quota bound, and a second as a safety net. A high-weight
split (``split_threshold``) or a ``progress`` callback runs the host
launch loop instead (``solver/wost.py:1970-2072``): fixed launches of
``pallas_inner_steps`` steps with the in-launch freeze and, between
launches, the split (``solver/split.py::make_launch_split``) and the
callback.

The walk runs where the planes live: the CUDA kernel on a CUDA device,
its plain version on the CPU (``ops/walk_kernel.py::run_walk``). A solver
runs on the card unless the caller asks for ``device="cpu"``. Options the
port does not run yet raise ``NotImplementedError`` naming the reference
function.
"""

from __future__ import annotations

import math
import warnings
from dataclasses import dataclass
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..geometry import queries
from ..ops.walk_kernel import MAX_SMEM_SEGMENTS, geometry_size, \
    make_walk_params, run_walk, stream_ids
from ..problems.problem import Problem
from ..sampling.rng import stream_seed
from .split import make_launch_split, reserve_quota_row
from .state import LANES, init_state, point_sums

__all__ = ["WoStSolver", "SolveResult", "SolverOptions", "RawSolveOut"]

_REF = "dcrmontecarlo_tpu/"


def _unported(what: str, reference: str):
    return NotImplementedError(f"{what} is not ported yet; reference: "
                               f"{_REF}{reference}")


@dataclass(frozen=True)
class SolverOptions:
    """Solver-level knobs, with the JAX package's fields and defaults.

    The port runs ``screened_sampler`` (``"exact"``, ``"transport"``),
    ``rejection_rounds``, ``min_quota``, ``target_slots``,
    ``common_random_numbers``, ``roulette_threshold``, ``split_threshold``,
    ``split_reserve``, ``max_attenuation``, ``boundary_snap``,
    ``project_to_boundary``, ``t_min_frac``, ``rmin_factor``,
    ``robin_correction`` (off, ``"chain"``, ``"reflectance"``, ``"auto"``),
    ``robin_arrival_clamp``, ``adaptive_launches``,
    ``pallas_inner_steps`` and ``pallas_block_rows``; the others raise
    when set away from their inert values.
    """

    target_slots: int = 65536
    project_to_boundary: bool = True
    t_min_frac: float = 1e-5
    rmin_factor: float = 0.5
    screened_sampler: str = "exact"
    rejection_rounds: int = 64
    min_quota: int = 4
    common_random_numbers: bool = False
    roulette_threshold: float = None
    split_threshold: float = None
    split_reserve: float = 0.25
    max_attenuation: float = None
    robin_correction: object = "auto"
    robin_interior: str = "arrival"
    robin_arrival_clamp: float = 0.02
    boundary_snap: object = "auto"
    rng: str = "fast"
    backend: str = "auto"
    pallas_inner_steps: int = 256
    adaptive_launches: bool = True
    pallas_block_rows: int = 64
    compaction: object = False

    def __post_init__(self):
        if self.compaction is True:
            raise ValueError(
                "compaction=True (the host-driven grid-shrink loop) was "
                "removed in round 5: the TPU compaction matrix "
                "(tools/compaction_matrix.py, 2026-08-21) measured it "
                "slower in every regime — 0.22x sustained, 0.05x "
                "short-walk, 2.2x worse on the straggler-bound "
                "no-roulette workload it once won — because adaptive "
                "single-launch mode now absorbs straggler tails "
                "in-kernel. Use the default compaction=False, or "
                "'pack' on sharded Pallas.")


class RawSolveOut(NamedTuple):
    """Per-source ``(n_src, N)`` moments and solve-wide diagnostics."""

    mean: np.ndarray
    stderr: np.ndarray
    walk_sum: np.ndarray
    walk_sumsq: np.ndarray
    total_steps: float       # walker-steps executed (sum of lane lifetimes)
    iterations: int          # max per-lane live steps
    truncated_walks: float   # walks ended by max_steps with nonzero weight
    truncated_weight: float  # sum of |atten| those walks dropped
    max_weight: float        # max |atten| any stepping lane reached
    max_banked: float        # max |walk total| any finished walk banked


class SolveResult(NamedTuple):
    mean: np.ndarray        # (N,) MC estimate per evaluation point
    stderr: np.ndarray      # (N,) empirical standard error of the mean
    n_walks: int
    total_steps: float      # active walker-steps executed
    iterations: int         # max per-lane live steps
    walk_sum: np.ndarray = None
    walk_sumsq: np.ndarray = None
    truncated_walks: float = None
    truncated_weight: float = None
    max_weight: float = None
    max_banked: float = None


class WoStSolver:
    """Walk-on-Stars Monte Carlo solver for
    ``-div(alpha grad u) + sigma u = f`` with mixed polyline boundaries.

    ``device``: where the walker planes live: the card (``"cuda"``, the
    default) or ``"cpu"`` (the plain walk), never the CPU unasked.
    ``last_solve_stats`` holds the last solve's walk launches and split
    clones.
    """

    def __init__(self, problem: Problem,
                 options: SolverOptions = SolverOptions(), device="cuda"):
        self.problem = problem
        self.options = options
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the solver runs on the card unless asked; "
                "pass device=\"cpu\" for the plain walk on the CPU")
        self.last_solve_stats = None
        if options.screened_sampler not in ("exact", "transport"):
            raise ValueError(
                "screened_sampler must be 'exact' (rejection) or "
                "'transport' (map + IS weight); got "
                f"{options.screened_sampler!r}")
        self._robin_cache = None  # (problem.version, resolved mode)

    def _robin_enabled(self):
        """Resolve ``robin_correction`` to ``False``, ``"chain"``,
        ``"reflectance"`` or ``"arrival-only"``; ``"auto"`` is ``"chain"``
        when ``max_boundary_gamma * min(diameter, 1/sqrt(sigma_bar))``
        exceeds 0.05, else off."""
        pb = self.problem
        mode = self.options.robin_correction
        if not mode:
            return False
        if mode == "residual":
            raise ValueError(
                "robin_correction='residual' was removed in round 4: the "
                "antithetic two-leg resummation measured strictly worse "
                "than the 'chain' realization on every workload "
                "(THEORY.md 4e records the design and the measurements). "
                "Use 'chain' (default under 'auto') or 'reflectance'.")
        if not (pb.use_delta_tracking and pb.neumann is not None):
            return False
        if mode in ("reflectance", "arrival-only"):
            return mode
        if mode != "auto":
            return "chain"
        if self._robin_cache is not None and self._robin_cache[0] == pb.version:
            return self._robin_cache[1]
        gmax = pb.max_boundary_gamma()
        scale = gmax * min(pb.diameter, 1.0 / np.sqrt(max(pb.sigma_bar, 1e-30)))
        enabled = "chain" if scale > 0.05 else False
        self._robin_cache = (pb.version, enabled)
        return enabled

    def _warn_supercritical(self, max_banked: float, walk_sumsq,
                            n_walks: int):
        """Warn when one banked walk holds > 90% of the worst point's walk
        sum-of-squares and no variance-control knob is set (the JAX
        package's round-5 criterion, same message)."""
        o = self.options
        if (o.split_threshold is not None
                or o.roulette_threshold is not None
                or o.max_attenuation is not None):
            return
        if n_walks < 256:
            return
        top = float(np.max(walk_sumsq)) if np.size(walk_sumsq) else 0.0
        if (np.isfinite(max_banked) and top > 0.0
                and max_banked * max_banked > 0.9 * top):
            warnings.warn(
                f"a single walk banked |total| = {max_banked:.3g}, more "
                "than half the worst point's walk sum-of-squares "
                f"({top:.3g}): that point's estimate and stderr are set "
                "by one sample (supercritical weight compounding). Tame "
                "it with SolverOptions.split_threshold (unbiased "
                "splitting), roulette_threshold (unbiased low-weight "
                "kill), or max_attenuation (biased cap); if "
                "robin_interior='chord' is set, switch back to "
                "'arrival' (THEORY.md 4g).",
                stacklevel=3,
            )

    def _slot_layout(self, n_points: int, n_walks: int):
        """``K`` recycled slots per point, each running >= ``min_quota``
        walks, and the per-slot quota row."""
        k_cap = max(1, n_walks // max(self.options.min_quota, 1))
        K = int(np.clip(self.options.target_slots // max(n_points, 1), 1, k_cap))
        frac = (self.options.split_reserve
                if self.options.split_threshold is not None else 0.0)
        return K, reserve_quota_row(n_walks, K, frac)

    def _boundary_snap_tol(self, eps):
        """``boundary_snap`` as a distance (``"auto"`` = ``eps / 2``) or
        None."""
        bs = self.options.boundary_snap
        if self.problem.neumann is None or bs in (None, 0, 0.0, False):
            return None
        if bs == "auto":
            return 0.5 * float(eps)
        return float(bs)

    def _snap_points(self, points, tol):
        """Snap evaluation points within ``tol`` of the Neumann wall onto
        it. Returns ``(px, py, ob0, n0x, n0y)``: snapped coordinates, the
        on-boundary start mask and inward start normals (None without
        snapping). Points exactly on the wall are left alone."""
        ptx, pty = points[:, 0], points[:, 1]
        if tol is None:
            return ptx, pty, None, None, None
        d0, f0x, f0y, t0x, t0y, _, _ = queries.closest_point_chord(
            self.problem.neumann, ptx, pty)
        m0 = (d0 <= tol) & (d0 > 0.0)
        dotn = (ptx - f0x) * (-t0y) + (pty - f0y) * t0x
        sg = torch.where(dotn >= 0.0, 1.0, -1.0)
        return (torch.where(m0, f0x, ptx), torch.where(m0, f0y, pty), m0,
                torch.where(m0, sg * (-t0y), 0.0),
                torch.where(m0, sg * t0x, 0.0))

    def _check_supported(self):
        """Raise on every option the port does not run yet."""
        pb, o = self.problem, self.options
        if geometry_size(pb) > MAX_SMEM_SEGMENTS:
            # the JAX package walks such a boundary on its XLA path
            raise _unported(f"a boundary of more than {MAX_SMEM_SEGMENTS} "
                            "segments and vertices",
                            "solver/wost.py::_build_solve_fn_xla")
        robin = self._robin_enabled()
        if robin == "arrival-only":
            # the reference runs this diagnostic arm on its XLA path only
            raise _unported("robin_correction='arrival-only'",
                            "solver/wost.py::_make_step_core")
        if robin == "chain" and o.robin_interior != "arrival":
            raise _unported(f"robin_interior={o.robin_interior!r}",
                            "solver/wost.py::_make_step_core")
        if o.compaction:
            raise _unported(f"compaction={o.compaction!r}",
                            "solver/wost.py::_build_solve_fn_pallas (pack)")
        if o.rng != "fast":
            raise _unported(f"rng={o.rng!r}", "sampling/rng.py")
        if o.backend == "xla":
            raise _unported("backend='xla'",
                            "solver/wost.py::_build_solve_fn_xla")
        if o.backend not in ("auto", "pallas"):
            raise ValueError(f"unknown backend {o.backend!r}")

    def _setup(self, points, n_walks: int, max_steps: int, eps: float,
               seed: int):
        """Fresh walker planes and walk parameters for a solve.

        Returns ``(state, params, point_id, step_bound)``: ``point_id``
        maps each lane to its evaluation point (padding lanes to 0, with
        quota 0) and ``step_bound`` is the step count that drains every
        slot's quota.
        """
        self._check_supported()
        pb, opts, dev = self.problem, self.options, self.device
        pts = torch.as_tensor(np.asarray(points, np.float32).reshape(-1, 2),
                              device=dev)
        n_points = int(pts.shape[0])
        K, quota_row = self._slot_layout(n_points, n_walks)
        block_rows = opts.pallas_block_rows
        lane_block = block_rows * LANES
        W = n_points * K
        rows = max(block_rows,
                   ((W + lane_block - 1) // lane_block) * block_rows)
        crn = ("tile", K, n_points) if opts.common_random_numbers else None
        snap_tol = self._boundary_snap_tol(eps)
        params = make_walk_params(
            pb, eps=eps, max_steps=max_steps,
            t_min=opts.t_min_frac * pb.diameter, rmin=opts.rmin_factor * eps,
            project=opts.project_to_boundary,
            rejection_rounds=opts.rejection_rounds,
            roulette_threshold=opts.roulette_threshold,
            snap=snap_tol is not None, seed=stream_seed(seed),
            robin_correction=self._robin_enabled(),
            robin_arrival_clamp=opts.robin_arrival_clamp,
            max_attenuation=opts.max_attenuation,
            freeze_split=opts.split_threshold is not None,
            screened_sampler=opts.screened_sampler)
        n_src = params.n_src

        quotas = np.zeros((rows * LANES,), np.int32)
        quotas[:W] = np.tile(quota_row, n_points)
        point_id = np.zeros((rows * LANES,), np.int64)
        point_id[:W] = np.repeat(np.arange(n_points), K)
        ptx, pty, ob0, n0x, n0y = self._snap_points(pts, snap_tol)
        state = init_state(
            ptx, pty, None if ob0 is None else (ob0, n0x, n0y), K, rows,
            torch.as_tensor(quotas.reshape(rows, LANES), device=dev),
            stream_ids(rows, crn, dev), n_src)
        step_bound = int(quota_row.max()) * (max_steps + 1) + 2
        return (state, params, torch.as_tensor(point_id, device=dev),
                step_bound)

    def _solve_raw(self, points, n_walks: int, max_steps: int, eps: float,
                   seed: int, walk: Callable = run_walk,
                   progress: Callable = None) -> RawSolveOut:
        """One solve; ``walk`` advances the planes (the kernel's wrapper,
        unless a test hands in another walk)."""
        state, params, pid, step_bound = self._setup(points, n_walks,
                                                     max_steps, eps, seed)
        opts = self.options
        n_src = params.n_src
        n_points = np.asarray(points).reshape(-1, 2).shape[0]
        carry_sum = torch.zeros(n_src, n_points, dtype=torch.float32,
                                device=pid.device)
        carry_sq = torch.zeros_like(carry_sum)
        launches, clones = 0, 0
        if (opts.adaptive_launches and opts.split_threshold is None
                and progress is None):
            # one launch covers the whole step bound; each lane stops when
            # its quota drains. The loop is a safety net (it runs once).
            while launches < 2 and bool((state["quota"] > 0).any()):
                walk(state, params, step_bound)
                launches += 1
        else:
            launches, clones = self._launch_loop(
                state, params, pid, step_bound, max_steps,
                n_points * n_walks, walk, progress, carry_sum, carry_sq)
        self.last_solve_stats = {"launches": launches, "clones": clones}

        moments = point_sums(
            torch.zeros(2 * n_src, n_points, dtype=torch.float32,
                        device=pid.device), pid,
            torch.stack([state[f"{k}{i}"].reshape(-1)
                         for k in ("asum", "asq") for i in range(n_src)]))
        # the split's banked destination sums (zero without the split)
        sums = moments[:n_src] + carry_sum
        sumsq = moments[n_src:] + carry_sq
        mean = sums / n_walks
        var = torch.clamp(sumsq / n_walks - mean * mean, min=0.0)
        stderr = torch.sqrt(var / n_walks)
        life = state["life"]
        return RawSolveOut(
            mean=mean.cpu().numpy(), stderr=stderr.cpu().numpy(),
            walk_sum=sums.cpu().numpy(), walk_sumsq=sumsq.cpu().numpy(),
            total_steps=float(life.sum(dtype=torch.int64)),
            iterations=int(life.max()),
            truncated_walks=float(state["tn"].sum()),
            truncated_weight=float(state["tw"].sum()),
            max_weight=float(state["wmax"].max()),
            max_banked=float(state["bmax"].max()),
        )

    def _launch_loop(self, state, params, pid, step_bound: int,
                     max_steps: int, total_walks: int, walk, progress,
                     carry_sum, carry_sq):
        """The host launch loop (``solver/wost.py:1970-2072``): fixed
        launches of ``pallas_inner_steps`` steps; after each, the progress
        callback and, while ``launches < launch_cap``, the split, whose
        banked destination sums go into ``carry_sum``/``carry_sq``.
        Returns ``(launches, clones)``.

        With the split the walk is a freeze build: heavy lanes stop inside
        a launch until the split halves them. Frozen lanes defer their
        steps, so the drain bound doubles; the freeze fails open (+inf)
        for the next launch when every active lane is heavy, and for good
        once splits stop at ``launch_cap``, after which every clone has
        ``split_reserve`` launches to finish its walk.
        """
        opts = self.options
        n_inner = int(opts.pallas_inner_steps)
        launch_cap = step_bound // n_inner + 2
        use_split = opts.split_threshold is not None
        if use_split:
            thr = float(np.float32(opts.split_threshold))
            split = make_launch_split(thr, params.n_src, carry_sum.shape[1])
            split_reserve = max_steps // n_inner + 1
            hard_cap = 2 * launch_cap + split_reserve
        else:
            thr, hard_cap = None, launch_cap
        cur_thr = thr
        sid_base = 1 << 30  # clone stream ids live above all lane ids
        launches, clones = 0, 0
        while launches < hard_cap:
            walk(state, params, n_inner, cur_thr)
            launches += 1
            active = int((state["quota"] > 0).sum())
            if progress is not None:
                done = max(total_walks - int(state["quota"].sum()), 0)
                progress(done, total_walks, launches * n_inner)
            if active == 0:
                break
            if use_split and launches < launch_cap:
                n, dsum, dsq = split(state, pid, sid_base)
                sid_base += n
                clones += n
                carry_sum += dsum
                carry_sq += dsq
                live = state["quota"] > 0
                active = int(live.sum())
                heavy = int((live & (torch.abs(state["atten"]) > thr)).sum())
                cur_thr = math.inf if 0 < heavy == active else thr
            elif use_split:
                cur_thr = math.inf
        return launches, clones

    def solve(
        self,
        points,
        n_walks: int = 1000,
        max_steps: int = 1000,
        eps: float = 1e-4,
        seed: int = 0,
        return_history: bool = False,
        history_walks: int = 16,
        progress: Callable = None,
    ):
        """Estimate the PDE solution at ``points`` (``(N, 2)``).

        Returns a :class:`SolveResult`; multi-source problems return
        ``(n_src, N)`` means. ``progress``: an optional
        ``callback(done_walks, total_walks, iteration)``, called once per
        launch of the host launch loop, which it selects.
        ``return_history`` is not ported yet and raises.
        """
        if return_history:
            raise _unported("return_history",
                            "diagnostics/history.py::trace_walks")
        raw = self._solve_raw(points, int(n_walks), int(max_steps),
                              float(eps), seed, progress=progress)
        mean, stderr = raw.mean, raw.stderr
        sums, sumsq = raw.walk_sum, raw.walk_sumsq
        if len(self.problem.source_fields) <= 1:
            mean, stderr, sums, sumsq = mean[0], stderr[0], sums[0], sumsq[0]
        result = SolveResult(
            mean=mean, stderr=stderr, n_walks=int(n_walks),
            total_steps=raw.total_steps, iterations=raw.iterations,
            truncated_walks=raw.truncated_walks,
            truncated_weight=raw.truncated_weight,
            max_weight=raw.max_weight, max_banked=raw.max_banked,
            walk_sum=sums, walk_sumsq=sumsq,
        )
        self._warn_supercritical(result.max_banked, sumsq, int(n_walks))
        return result
