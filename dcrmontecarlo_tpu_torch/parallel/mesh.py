"""Sharded solve over a mesh of shards (port of ``parallel/mesh.py``).

The JAX package shards the walker slots of a solve over a 1D device mesh
(``shard_map``): each device runs the whole kernel launch loop on its own
shard, and one ``psum`` combines the per-point moments at the end. Here a
mesh is an ordered list of global shards, each a ``torch.device``. A
device may repeat: that is how the CPU and one card run several shards.

Each shard holds ``K / n`` slots of every point, slot-major (lane
``j * P + i`` holds slot ``j`` of point ``i``, ``mesh.py:502-535``),
draws the stream seed of its global index
(``sampling/rng.py::shard_seed``) and, with the split, hands out clone
stream ids from its own range of ``[2^30, 2^32)``. Its launch loop is the
JAX package's (``mesh.py:576-650``): launches of ``pallas_inner_steps``
steps up to ``launch_cap``; with the split (delta tracking only), the
launch-boundary split after each launch while ``launches + 1 <
launch_cap``, then ``split_reserve`` more launches for the clones to
finish; no in-launch freeze and no fail-open threshold (those belong to
the single-device host loop); with ``compaction="pack"``, a stable sort
that puts the active lanes first after each launch.

Lockstep is not copied. The JAX loop keeps every device at the same
launch count (a psum of the active lanes per launch, for interpret mode's
barrier). Here one process advances its shards together and processes do
not talk per launch: a walk does not depend on how its steps are cut into
launches, and a shard's split depends only on its own lanes and its
launch count, so a shard's result is the same whatever the others do.
The shards a process holds on one device (up to ``MAX_SHARDS``) keep
their planes in one buffer, shard after shard, each shard's planes a view
of its segment, and each loop step launches once over the buffer while
any of them is live: the kernel's shard table gives each lane its shard's
seed (``WalkParams.shard_table``), and a drained shard's lanes have no
quota, so a step changes nothing there. Then each live shard splits and
packs in its own segment, and one read brings back the device's live
counts. (The JAX reference advances every shard in one program per loop
step too, ``mesh.py:576-650``.) A device takes one launch at a time on its
current stream: the kernel's ``__constant__`` block (shard table, plane
pointers) and its pool counter exist once per device, written on the
launch's stream before each launch. The only collective is one
``all_gather`` per
solve of every shard's moment row, summed in shard order, so every process
gets the same bits and a job of several processes equals one process
holding the same shards, bit for bit.

``backend="xla"`` (the JAX package's sharded XLA step loop,
``_build_solve_fn_xla_sharded`` and ``_sharded_split_loop``) is not
ported.
"""

from __future__ import annotations

import dataclasses
import os
import warnings
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..ops.walk_kernel import MAX_SHARDS, WalkParams, run_walk, stream_ids
from ..problems.problem import Problem
from ..sampling.rng import shard_seed
from ..solver.split import make_launch_split, reserve_quota_row
from ..solver.state import LANES, point_sums, slot_planes
from ..solver.wost import RawSolveOut, SolverOptions, WoStSolver, _unported

__all__ = ["ShardedWoStSolver", "make_mesh", "initialize_distributed",
           "Mesh"]

CLONE_BASE = 1 << 30  # clone stream ids start above every lane and CRN id
_STATS = ("steps", "life_max", "tn", "tw", "wmax", "bmax", "launches",
          "clones")  # the scalars of a shard's row, after its moments

# this process's place in a multi-process job, as the process group it
# mirrors: (rank, processes, shards per process, device type); set once by
# initialize_distributed
_JOB: Optional[tuple] = None


def _check_kind(kind: str):
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"a mesh lives on \"cuda\" or \"cpu\", got {kind!r}")
    if kind == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the mesh runs on the card unless asked; pass "
            "device=\"cpu\" for shards of the plain walk on the CPU")


def _shard_device(kind: str, d: int) -> torch.device:
    """Global shard ``d``'s device: card ``d`` modulo the cards, or the
    CPU."""
    if kind == "cpu":
        return torch.device("cpu")
    return torch.device("cuda", d % torch.cuda.device_count())


def _i32(v: int) -> int:
    """A Python integer wrapped to int32, as int32 arithmetic wraps."""
    return (int(v) + 2**31) % 2**32 - 2**31


class Mesh:
    """A 1D mesh of global shards: ``devices``, a numpy object array of
    ``torch.device`` (``mesh.devices.size`` is the shard count, as in
    JAX), and ``axis_names``. Process ``rank`` of ``world`` holds global
    shards ``[rank * per_process, (rank + 1) * per_process)``; without a
    process group the one process holds them all."""

    def __init__(self, devices, axis_names=("walkers",), rank: int = 0,
                 world: int = 1, per_process: Optional[int] = None):
        self.devices = np.empty(len(devices), object)
        self.devices[:] = list(devices)
        self.axis_names = tuple(axis_names)
        self.rank, self.world = int(rank), int(world)
        self.per_process = (len(devices) if per_process is None
                            else int(per_process))

    @property
    def local_shards(self) -> list:
        """The global indices of the shards this process holds."""
        lo = self.rank * self.per_process
        return list(range(lo, min(lo + self.per_process, self.devices.size)))


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           local_device_count: Optional[int] = None,
                           device="cuda") -> int:
    """Join a multi-process job, then build meshes as usual.

    Every process calls this once, then ``make_mesh()`` (which sees the
    GLOBAL shards) and :class:`ShardedWoStSolver` behave as in one
    process; the only traffic between processes is one ``all_gather`` of
    the shards' moment rows per solve::

        # process 0                       # process 1
        initialize_distributed(           initialize_distributed(
            "10.0.0.1:1234", 2, 0)            "10.0.0.1:1234", 2, 1)
        solver = ShardedWoStSolver(prob, make_mesh())   # both

    ``coordinator_address`` is ``host:port`` (``tcp://`` init); without it
    ``torch.distributed`` reads ``MASTER_ADDR``/``MASTER_PORT`` and the
    rank and size come from ``RANK``/``WORLD_SIZE`` when not given.
    ``local_device_count``: the shards each process holds (the counterpart
    of ``jax_num_cpu_devices``), by default one per card, or one on the
    CPU; process ``r`` holds global shards ``[r L, (r + 1) L)``, shard
    ``d`` on card ``d`` modulo the cards of its host. ``device``: the
    shards' device type, the card unless the caller asks for ``"cpu"``.
    The backend is NCCL when each process's first shard has a card of its
    own, else gloo (CPU shards, or several processes on one card, which
    NCCL refuses). Returns the global shard count.
    """
    global _JOB
    kind = torch.device(device).type
    _check_kind(kind)
    rank = int(process_id if process_id is not None else os.environ["RANK"])
    world = int(num_processes if num_processes is not None
                else os.environ["WORLD_SIZE"])
    per = (int(local_device_count) if local_device_count is not None
           else torch.cuda.device_count() if kind == "cuda" else 1)
    firsts = {_shard_device(kind, r * per) for r in range(world)}
    nccl = kind == "cuda" and len(firsts) == world
    if nccl:
        torch.cuda.set_device(_shard_device(kind, rank * per))
    dist.init_process_group(
        "nccl" if nccl else "gloo",
        init_method=(f"tcp://{coordinator_address}"
                     if coordinator_address is not None else "env://"),
        rank=rank, world_size=world)
    _JOB = (rank, world, per, kind)
    return world * per


def make_mesh(n_devices: Optional[int] = None, axis: str = "walkers",
              device="cuda") -> Mesh:
    """1D mesh of global shards over the walker axis.

    After :func:`initialize_distributed` the global shards are every
    process's, and ``n_devices`` takes the first of them (``mesh.py:71-77``).
    In one process there is one shard per card by default (one on the
    CPU), and ``n_devices`` may exceed the cards: shards then share them,
    shard ``d`` on card ``d`` modulo the cards. ``device``: the card
    (``"cuda"``, the default) or ``"cpu"`` (the plain walk).
    """
    kind = torch.device(device).type
    _check_kind(kind)
    if _JOB is not None:
        rank, world, per, job_kind = _JOB
        if kind != job_kind:
            raise ValueError(f"the job's shards are on {job_kind!r}, not "
                             f"{kind!r}")
        n = world * per if n_devices is None else int(n_devices)
        if not 1 <= n <= world * per:
            raise ValueError(f"the job holds {world * per} shards, asked "
                             f"for {n}")
    else:
        rank, world = 0, 1
        n = ((torch.cuda.device_count() if kind == "cuda" else 1)
             if n_devices is None else int(n_devices))
        if n < 1:
            raise ValueError(f"a mesh needs a shard, asked for {n}")
        per = n
    return Mesh([_shard_device(kind, d) for d in range(n)], (axis,),
                rank=rank, world=world, per_process=per)


class _Plan(NamedTuple):
    """One sharded solve's layout, shared by its shards."""

    points: np.ndarray      # (P, 2) float32
    n_walks: int
    seed: int
    K: int                  # slots per point over the mesh
    k_local: int            # slots per point on a shard
    rows: int               # plane rows of a shard
    quota_row: np.ndarray   # (K,) walks per slot
    crn: Optional[tuple]
    snap_tol: Optional[float]
    params: WalkParams      # without the shard's seed
    n_inner: int
    launch_cap: int
    loop_cap: int           # launch_cap, plus split_reserve with the split
    split: Optional[Callable]


class _Shard:
    """One shard's planes and carry through the launch loop."""

    def __init__(self, d, state, pid, params, nsid, bank):
        self.d, self.state, self.pid, self.params = d, state, pid, params
        self.nsid, self.bank = nsid, bank
        self.q0 = int(state["quota"].sum())
        self.launches, self.clones, self.live = 0, 0, self.q0 > 0


class _Group:
    """The shards that one launch advances: up to ``MAX_SHARDS`` shards of
    one device, their planes moved into one buffer, shard after shard (each
    shard's ``state`` becomes a view of its segment), with the parameters
    of a launch over it: the shard table of their seeds (one shard keeps
    its own parameters)."""

    def __init__(self, shards, rows: int):
        self.shards = shards
        n = rows * LANES
        self.state = {k: torch.cat([s.state[k].reshape(-1) for s in shards]
                                   ).view(len(shards) * rows, LANES)
                      for k in shards[0].state}
        for i, s in enumerate(shards):
            s.state = {k: v.view(-1)[i * n:(i + 1) * n].view(rows, LANES)
                       for k, v in self.state.items()}
        self.params = (shards[0].params if len(shards) == 1 else
                       dataclasses.replace(
                           shards[0].params, shard_lanes=n,
                           shard_seeds=tuple(s.params.seed for s in shards)))

    def live_counts(self):
        """Each shard's lanes with quota, in one device-to-host read."""
        quota = self.state["quota"].view(len(self.shards), -1)
        return (quota > 0).sum(1).tolist()


def _pack(state: dict, pid):
    """Active lanes first, in lane order (a stable sort), in place: every
    plane and the point ids take the same permutation, so walks are
    unchanged and only the kernel blocks' occupancy moves
    (``mesh.py:561-571``)."""
    perm = torch.argsort((state["quota"].reshape(-1) <= 0).to(torch.int8),
                         stable=True)
    for v in list(state.values()) + [pid]:
        flat = v.view(-1)
        flat.copy_(flat[perm])


class ShardedWoStSolver(WoStSolver):
    """:class:`WoStSolver` with walker slots sharded across a mesh.

    Geometry, fields and evaluation points are replicated; only the slot
    axis is split. Results depend on the mesh size through the shards'
    seeds only, like independent chains per shard. ``last_solve_stats``
    holds the last solve's launches (the most any shard took), clones,
    and both per shard.
    """

    _packs_lanes = True  # compaction="pack", as the JAX sharded path

    def __init__(self, problem: Problem, mesh: Mesh,
                 options: SolverOptions = SolverOptions()):
        local = mesh.local_shards
        super().__init__(problem, options,
                         device=mesh.devices[local[0] if local else 0])
        self.mesh = mesh
        self.axis = mesh.axis_names[0]

    def _slot_layout(self, n_points: int, n_walks: int):
        """Like the base layout but with ``K`` a multiple of the shard
        count (``mesh.py:113-125``)."""
        n = self.mesh.devices.size
        K = super()._slot_layout(n_points, n_walks)[0]
        K = max(n, (K // n) * n)
        o = self.options
        frac = o.split_reserve if o.split_threshold is not None else 0.0
        return K, reserve_quota_row(n_walks, K, frac)

    def _check_supported(self):
        """The single-device checks, with ``compaction`` honoured (lane
        packing) and the sharded XLA loop refused."""
        o = self.options
        if o.backend == "xla":
            raise _unported("backend='xla' on a mesh",
                            "parallel/mesh.py::_build_solve_fn_xla_sharded")
        super()._check_supported()

    def _walk_params(self, eps: float, max_steps: int, seed: int,
                     snap: bool):
        """The single-device walk's parameters without the in-launch
        freeze: the sharded loop splits but never freezes
        (``mesh.py:409-425``)."""
        return dataclasses.replace(
            super()._walk_params(eps, max_steps, seed, snap), freeze=False)

    def _plan(self, points, n_walks: int, max_steps: int, eps: float,
              seed: int) -> _Plan:
        self._check_supported()
        opts, pb = self.options, self.problem
        pts = np.asarray(points, np.float32).reshape(-1, 2)
        n_points = pts.shape[0]
        K, quota_row = self._slot_layout(n_points, n_walks)
        k_local = K // self.mesh.devices.size
        block = opts.pallas_block_rows
        rows = max(block, -(-n_points * k_local // (block * LANES)) * block)
        snap_tol = self._boundary_snap_tol(eps)
        params = self._walk_params(eps, max_steps, seed, snap_tol is not None)
        n_inner = int(opts.pallas_inner_steps)
        launch_cap = (int(quota_row.max()) * (max_steps + 1) + 2) // n_inner + 2
        use_split = opts.split_threshold is not None and pb.use_delta_tracking
        if opts.split_threshold is not None and not use_split:
            warnings.warn(
                "split_threshold is inert here: splitting applies to "
                "delta-tracking problems (weights stay at 1.0 otherwise).",
                stacklevel=4)
        split = (make_launch_split(opts.split_threshold, params.n_src,
                                   n_points) if use_split else None)
        return _Plan(
            points=pts, n_walks=n_walks, seed=seed, K=K, k_local=k_local,
            rows=rows, quota_row=quota_row,
            crn=(("repeat", K, n_points) if opts.common_random_numbers
                 else None),
            snap_tol=snap_tol, params=params, n_inner=n_inner,
            launch_cap=launch_cap,
            loop_cap=launch_cap + (max_steps // n_inner + 1 if use_split
                                   else 0),
            split=split)

    def _shard(self, plan: _Plan, d: int) -> _Shard:
        """Fresh planes of global shard ``d`` on its device."""
        dev = self.mesh.devices[d]
        n_points, k = plan.points.shape[0], plan.k_local
        rows = plan.rows
        quotas = np.zeros(rows * LANES, np.int32)
        quotas[:n_points * k] = np.repeat(plan.quota_row[d * k:(d + 1) * k],
                                          n_points)
        pid = np.zeros(rows * LANES, np.int64)
        pid[:n_points * k] = np.tile(np.arange(n_points), k)
        pts = torch.as_tensor(plan.points, device=dev)
        ptx, pty, ob0, n0x, n0y = self._snap_points(pts, plan.snap_tol)
        n_src = plan.params.n_src
        state = slot_planes(
            ptx, pty, None if ob0 is None else (ob0, n0x, n0y), k, rows,
            torch.as_tensor(quotas.reshape(rows, LANES), device=dev),
            stream_ids(rows, plan.crn, dev), n_src, slot_major=True)
        stride = (2**32 - CLONE_BASE) // self.mesh.devices.size
        return _Shard(
            d, state, torch.as_tensor(pid, device=dev),
            dataclasses.replace(plan.params, seed=shard_seed(plan.seed, d)),
            nsid=_i32(CLONE_BASE + d * stride),
            bank=torch.zeros(2 * n_src, n_points, dtype=torch.float32,
                             device=dev))

    def _groups(self, plan: _Plan, shards) -> list:
        """``shards`` in launch groups (:class:`_Group`): those of one
        device together, in shard order, up to ``MAX_SHARDS`` a group."""
        by_device = {}
        for s in shards:
            by_device.setdefault(str(self.mesh.devices[s.d]), []).append(s)
        return [_Group(same[i:i + MAX_SHARDS], plan.rows)
                for same in by_device.values()
                for i in range(0, len(same), MAX_SHARDS)]

    def _run_shards(self, plan: _Plan, shards, walk: Callable = run_walk,
                    progress: Callable = None):
        """The launch loop (K9, ``mesh.py:576-650``) of the global shards
        ``shards``, advanced together: each loop step launches once over
        each group of a device's shards that holds a live shard, then each
        live shard splits and packs, and each group's live counts come back
        in one read. Returns their rows ``(len(shards), R)`` float64 on the
        host: the moments ``(2 n_src, P)`` flattened, then the scalars of
        ``_STATS``."""
        live = [self._shard(plan, d) for d in shards]
        groups = self._groups(plan, live)
        n_dev = self.mesh.devices.size
        total = plan.points.shape[0] * plan.n_walks
        pack = bool(self.options.compaction)
        first = [s for s in live if s.d == 0] if progress is not None else []
        launches = 0
        while launches < plan.loop_cap and any(s.live for s in live):
            running = [s for s in live if s.live]
            for g in groups:
                if any(s.live for s in g.shards):
                    walk(g.state, g.params, plan.n_inner)
            launches += 1
            for s in first:  # shard 0 reports, drained or not
                done = max(s.q0 - int(s.state["quota"].sum()), 0)
                progress(min(done * n_dev, total), total,
                         launches * plan.n_inner)
            for s in running:
                s.launches += 1
                if plan.split is not None and launches < plan.launch_cap:
                    n, dsum, dsq = plan.split(s.state, s.pid, s.nsid)
                    s.nsid = _i32(s.nsid + n)
                    s.clones += n
                    s.bank += torch.cat([dsum, dsq])
                if pack:
                    _pack(s.state, s.pid)
            for g in groups:
                if any(s.live for s in g.shards):
                    for s, c in zip(g.shards, g.live_counts()):
                        s.live = s.live and c > 0
        n_src = plan.params.n_src
        rows = []
        for s in live:
            st = s.state
            moments = point_sums(s.bank, s.pid, torch.stack(
                [st[f"{k}{i}"].reshape(-1) for k in ("asum", "asq")
                 for i in range(n_src)]))
            life = st["life"]
            stats = [float(life.sum(dtype=torch.int64)), float(life.max()),
                     float(st["tn"].sum()), float(st["tw"].sum()),
                     float(st["wmax"].max()), float(st["bmax"].max()),
                     s.launches, s.clones]
            rows.append(torch.cat([moments.reshape(-1).double().cpu(),
                                   torch.tensor(stats, dtype=torch.float64)]))
        width = 2 * n_src * plan.points.shape[0] + len(_STATS)
        return (torch.stack(rows) if rows
                else torch.zeros(0, width, dtype=torch.float64))

    def _gather(self, rows):
        """Every shard's row, in global shard order: the one collective
        of a solve, an ``all_gather`` of each process's rows (padded to
        ``per_process``)."""
        mesh = self.mesh
        if mesh.world == 1:
            return rows
        pad = torch.zeros(mesh.per_process, rows.shape[1],
                          dtype=torch.float64)
        pad[:rows.shape[0]] = rows
        if dist.get_backend() == "nccl":
            pad = pad.cuda()
        out = [torch.empty_like(pad) for _ in range(mesh.world)]
        dist.all_gather(out, pad)
        return torch.cat(out).cpu()[:mesh.devices.size]

    def _combine(self, plan: _Plan, rows) -> RawSolveOut:
        """Sum the shards' rows in shard order (float64, rounded once to
        float32) into the solve's moments and diagnostics
        (``mesh.py:651-698``)."""
        n_src = plan.params.n_src
        n_points = plan.points.shape[0]
        m = 2 * n_src * n_points
        acc = torch.zeros(m, dtype=torch.float64)
        for row in rows:  # a fixed order, the same in every process
            acc += row[:m]
        stat = dict(zip(_STATS, rows[:, m:].T))
        self.last_solve_stats = {
            "launches": int(stat["launches"].max()),
            "clones": int(stat["clones"].sum()),
            "shard_launches": [int(v) for v in stat["launches"]],
            "shard_clones": [int(v) for v in stat["clones"]]}
        moments = acc[:m].float().reshape(2 * n_src, n_points)
        sums, sumsq = moments[:n_src], moments[n_src:]
        n_walks = plan.n_walks
        mean = sums / n_walks
        var = torch.clamp(sumsq / n_walks - mean * mean, min=0.0)
        return RawSolveOut(
            mean=mean.numpy(), stderr=torch.sqrt(var / n_walks).numpy(),
            walk_sum=sums.numpy(), walk_sumsq=sumsq.numpy(),
            total_steps=float(stat["steps"].sum()),
            iterations=int(stat["life_max"].max()),
            truncated_walks=float(stat["tn"].sum()),
            truncated_weight=float(stat["tw"].sum()),
            max_weight=float(stat["wmax"].max()),
            max_banked=float(stat["bmax"].max()))

    def _solve_raw(self, points, n_walks: int, max_steps: int, eps: float,
                   seed: int, walk: Callable = run_walk,
                   progress: Callable = None) -> RawSolveOut:
        """One sharded solve: this process's shards through the launch
        loop, every shard's row gathered, the rows combined. ``walk``
        advances the planes (the kernel's wrapper, unless a check hands in
        another walk); ``progress`` reports shard 0's walks done times the
        shard count once per launch, in the process that holds shard 0."""
        plan = self._plan(points, n_walks, max_steps, eps, seed)
        rows = self._run_shards(plan, self.mesh.local_shards, walk, progress)
        return self._combine(plan, self._gather(rows))
