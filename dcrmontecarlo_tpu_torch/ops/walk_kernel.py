"""The fused Walk-on-Stars walk: CUDA kernel wrapper and its plain version.

Port of the JAX package's one Pallas kernel,
``dcrmontecarlo_tpu/ops/pallas_walk.py::make_pallas_walk`` (its
``pl.pallas_call`` and step body), in the variants the DCR surveys run:
delta tracking, a Neumann wall without silhouette vertices, source
next-event estimation, the exact screened-radius rejection at any round
cap, roulette, common random numbers and boundary-snap starts; the
notebook survey's accuracy path: the Robin correction (the chord chain or
the reflectance fold, with the wall-arrival weight) and the two-level
local majorant; and the flagship notebook gate's path: MIS next-event
estimation toward a Gaussian-mixture source density, the in-launch freeze
of heavy lanes for the host loop's high-weight split, and the
``max_attenuation`` clip; the topographic survey's boundaries: a
Neumann polyline with silhouette vertices, in the two geometry forms of
the JAX kernel (the static form up to ``MAX_UNROLL_SEGMENTS`` boundary
rows, with segment data formed on the host in float64 and rounded once,
and the table form above it, any number of rows of float32 endpoints,
everything else formed in float32 per step); and the analytic-check
problems: walks without delta tracking (no alpha or sigma: the walker
jumps to the ball's edge or its Neumann hit, and sources are sampled at
the Green's radius ``R sqrt(u2 u3)`` with the weight ``R^2 / 4``), the
transport sampler of the screened radius, and the ``TERMS`` field kind of
their coefficients; and the survey products: MIS next-event estimation
without delta tracking, and the wide form of the kernel for more than
``MAX_SRC`` sources or ``MAX_MIX`` mixture components (up to
``MAX_WIDE_SRC`` and ``MAX_WIDE_MIX``; sources from ``MAX_SRC`` on of any
kind but the grid, in the general rows build where one is not a Gaussian
dipole); and the validation path: a gridded Dirichlet field
(``fields.Grid``, the cylinder oracle's Monte Carlo tier) on the
flagship's switches; and the sharded solve (``parallel/mesh.py``), whose
launch loop splits without the freeze: the flagship's switches without
it. Any combination of these switches that the JAX kernel traces is a
variant (:func:`valid_variant`; :data:`KERNEL_VARIANTS` holds them all).
The survey's culled table variant has a second build for large
boundaries (:func:`large_scans`: its silhouette and first hit culled by
chunk and group records, :func:`large_records`), which the host asks for
by the table's size. The kernel is ``csrc/walk_kernel.cu`` (one thread
per walker lane, one library per variant); :func:`walk_plain` is the
same step, op for op, on tensors of lanes, on any device.

:func:`run_walk` advances every lane by up to ``inner_steps`` steps and
updates ``state`` in place. A CPU state runs :func:`walk_plain`; a CUDA
state launches the kernel, whose variant's library is built from the
checkout's source the first time a launch needs it (``nvcc`` with the
switches as ``-D`` macros, :func:`nvcc_command`; plain C interface,
``ctypes``); :func:`build_library` builds a set of variants ahead, in
parallel. There is no fallback between the two.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools
import hashlib
import itertools
import math
import os
import shutil
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..problems import fields
from ..problems.majorant import MAX_BANDS, MAX_BOXES, LocalMajorant
from ..sampling import rng
from ..sampling.radial import _exact_rejection, sample_greens_radius, \
    sample_screened_radius_transport
from ..solver.state import CONST_PLANES, LANES, SNAP_PLANES, plane_dtype, \
    state_planes
from .greens import (
    greens_2d,
    greens_norm_2d,
    screened_chord_integral,
    screened_greens_2d,
    screened_greens_norm_2d,
    screened_greens_wall_ratio,
    screened_interior_prob,
)

__all__ = ["EXIT_CHECK", "MAX_SRC", "MAX_UNROLL_SEGMENTS",
           "MAX_SMEM_SEGMENTS", "MAX_MIX", "MAX_WIDE_SRC", "MAX_WIDE_MIX",
           "KERNEL_VARIANTS", "terms_fields", "valid_variant",
           "variant_fault", "WalkParams", "kernel_name", "variant_code",
           "geometry_size", "make_walk_params", "stream_ids", "run_walk",
           "walk_plain", "compare_planes", "PLANE_RTOL", "PLANE_FLOOR",
           "PLANE_MIN_FRAC", "build_library", "nvcc_command",
           "variant_macros", "SWITCHES", "NVCC_FLAGS", "ROBIN_OFF",
           "ROBIN_CHAIN", "ROBIN_REFLECTANCE", "MAX_SHARDS", "CHUNK_ROWS",
           "culled_scans", "chunk_records", "dealt", "launch_loop",
           "LARGE_TABLE_ROWS", "SIL_ROWS", "GROUP_CHUNKS", "large_scans",
           "silhouette_records", "large_records", "build_code",
           "pole_record", "POLE_KIND", "culled_closest", "one_sincos",
           "culled_chord"]

EXIT_CHECK = 16      # plain-path drain check cadence (steps): exact, since
                     # a step of a lane without quota mutates nothing
PLANE_RTOL = 1e-4    # compare_planes: per-lane relative tolerance,
PLANE_FLOOR = 1e-6   # absolute floor as a fraction of the plane's scale,
PLANE_MIN_FRAC = 0.99  # and the share of lanes that must agree per plane
MAX_SRC = 4          # kernel capacities (csrc/walk_kernel.cu)
MAX_UNROLL_SEGMENTS = 96   # boundary rows of the static form
MAX_SMEM_SEGMENTS = 8192   # rows above which the JAX package leaves its
                           # Pallas kernel for its XLA step (ops/
                           # pallas_walk.py:50-51); the table form here
                           # takes any count, and backend="pallas" raises
                           # above it as the JAX solver does
MAX_MIX = 8          # MIS mixture components
MAX_WIDE_SRC = 32    # the wide form: sources (from MAX_SRC on rows)
MAX_WIDE_MIX = 64    # and mixture components
MAX_SHARDS = 64      # shards one launch holds (its shard table)
CHUNK_ROWS = 8       # rows per chunk of the table form's culled scans
SIL_ROWS = 8         # the large-table build: vertex rows per silhouette
GROUP_CHUNKS = 8     # chunk and chunks per group record, both scans
LARGE_TABLE_ROWS = 1000  # Neumann or vertex rows from which the culled
                         # variant takes its large-table build
                         # (csrc/walk_variant.h::large_scans)
LARGE_CODE = 4096    # added to a variant's code for its large-table build
SCAN_ELEMS = 1 << 24  # lanes x rows a plain scan forms at once
POLE_KIND = 5        # a source's kind word in the general rows build for a
                     # TERMS field that is one Gaussian pole (pole_record;
                     # csrc/walk_kernel.cu's K_POLE)
# Robin realization, as the kernel's template parameter: off, the chord
# chain (``True`` means the chain, as in the JAX package), the
# reflectance fold
ROBIN_OFF, ROBIN_CHAIN, ROBIN_REFLECTANCE = 0, 1, 2
_ROBIN_CODES = {False: ROBIN_OFF, True: ROBIN_CHAIN, "chain": ROBIN_CHAIN,
                "reflectance": ROBIN_REFLECTANCE}
# a variant's switches: (robin, majorant, mis, freeze, table, delta,
# transport, wide, grid), then True for a TERMS form, then True for the
# general rows build; wide, for more than MAX_SRC sources or MAX_MIX
# mixture components, carries the survey products' lines; grid, a gridded
# Dirichlet field (fields.Grid), the cylinder oracle's Monte Carlo tier;
# rows, a wide source past the MAX_SRC-th that is not a Gaussian dipole
SWITCHES = ("robin", "majorant", "mis", "freeze", "table", "delta",
            "transport", "wide", "grid", "terms", "rows")
_TWO_PI = 2.0 * np.pi
_BIG = float(np.float32(3e38))
_SRC = Path(__file__).resolve().parents[1] / "csrc" / "walk_kernel.cu"
_RULES = _SRC.with_name("walk_variant.h")  # the switch rules, included
_STEP = _SRC.with_name("walk_step.inc")    # a lane's iteration, included
_BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-fmad=false",
              "-Xptxas", "-v")


# ---------------------------------------------------------------------- #
# parameters                                                             #
# ---------------------------------------------------------------------- #

def _switches(variant) -> tuple:
    """The eleven switches of a variant tuple (9 items, 10 with the TERMS
    form, 11 with the general rows last): the Robin mode as an int, the
    others as bools."""
    v = tuple(variant)
    if len(v) not in (9, 10, 11):
        raise ValueError(f"a variant has 9 to 11 switches {SWITCHES}, got "
                         f"{v!r}")
    return (int(v[0]),) + tuple(bool(f) for f in v[1:]) + (False,) * (
        11 - len(v))


def _canonical(variant) -> tuple:
    """A variant as :attr:`WalkParams.variant` gives it: nine switches,
    then the TERMS form and the general rows up to the last one set."""
    s = _switches(variant)
    return s[:9] + (s[9:] if s[10] else (True,) if s[9] else ())


def kernel_name(variant) -> str:
    """``walk_kernel<robin,majorant,mis,freeze,table,delta,transport>``
    for a variant tuple, then ``wide``, ``grid``, the TERMS form and the
    general rows up to the last one set (the template's defaulted
    switches; the general rows build is a macro of its library, not a
    template switch)."""
    r, *flags = _switches(variant)
    head, tail = flags[:6], flags[6:]
    while tail and not tail[-1]:
        tail.pop()
    return "walk_kernel<{}>".format(",".join(
        [str(r)] + ["true" if f else "false" for f in head + tail]))


def terms_fields(variant) -> bool:
    """Whether the variant ``variant`` evaluates ``TERMS`` field specs
    without its TERMS form (``csrc/walk_variant.h::terms_fields``): those
    of the analytic-check problems, without majorant, freeze or
    reflectance, with MIS and in the table form only without delta
    tracking. The others are compiled without the kind, which keeps their
    code as it was, and evaluate it only in their TERMS form."""
    robin, majorant, mis, freeze, table, delta = variant[:6]
    return (not (majorant or freeze or (table and delta) or (mis and delta))
            and robin != ROBIN_REFLECTANCE)


def chain_phases(variant) -> bool:
    """Whether the variant ``variant`` runs the Robin chain's wall work in
    full warps (``csrc/walk_variant.h::chain_phases``): the chain without
    the freeze, with MIS in every form, without MIS except in the table form
    and the TERMS forms (which ran slower so). Its chord mass, wall-arrival
    weight and chord branch go through a queue in the block's shared
    memory of the repack loop, bit for bit the one-thread loop's
    results."""
    robin, _, mis, freeze, table, *_, terms_form, _ = _switches(variant)
    return (robin == ROBIN_CHAIN and not freeze
            and (mis or not (table or terms_form)))


def repacked(variant) -> bool:
    """Whether ``variant`` runs the repack loop (``walk_variant.h::
    repacked``): the freeze builds and :func:`chain_phases`'; the others
    run one thread a lane for the whole launch."""
    return _switches(variant)[3] or chain_phases(variant)


def dealt(variant) -> bool:
    """Whether ``variant`` deals walks, not lanes, to its threads in a
    launch that drains every quota from fresh walks
    (``walk_variant.h::dealt``): the survey's build
    ``<0,false,false,false,false,true,false>`` (the main path, phase 6),
    the wide survey with MIS (phase 31's Jacobian) and without
    ``<0,false,false,false,false,true,false,true>`` (phase 44's scenario
    pseudosection), the survey's build with the transport sampler
    ``<0,false,false,false,false,true,true>`` or with MIS
    ``<0,false,true,false,false,true,false>`` (phase 43), and the two
    wide builds' general rows builds (phase 46's pole line). Its other
    launches run one thread a lane (:func:`launch_loop`); the builds
    without delta tracking keep one thread a lane (the short walk's ran
    slower dealt, and with a draining lane's bank and next step in one
    iteration: :func:`one_sincos`)."""
    robin, majorant, mis, freeze, table, delta, transport, wide, grid, \
        terms, _ = _switches(variant)
    return (robin == ROBIN_OFF and delta
            and not (transport and (mis or wide))
            and not (majorant or freeze or table or grid or terms))


def culled_scans(variant) -> bool:
    """Whether ``variant``'s first-hit scan skips the chunks of rows that
    cannot change its result (``walk_variant.h::culled_scans``): the
    survey's table form ``<0,false,false,false,true,true,false>`` (phase
    20), the one table build that ran faster so at its path's size (the
    table chain culls its chord frame instead, :func:`culled_chord`, and
    the table form without delta tracking its closest point,
    :func:`culled_closest`). Its launches take the chunk records of its
    Neumann rows (:meth:`WalkParams.chunk_table`)."""
    return _switches(variant) == (ROBIN_OFF, False, False, False, True,
                                  True, False, False, False, False, False)


def culled_chord(variant) -> bool:
    """Whether ``variant``'s Robin chain takes its chord frame (the nearest
    Neumann row's tangent and chord extents) by chunks of the Neumann rows
    from the chunk of the least box distance outward, skipping the chunks
    whose box proves no row of them can win
    (``walk_variant.h::culled_chord``): the table chain
    ``<1,false,false,false,true,true,false>`` (phase 48's terrain over
    shallow bodies); the first minimum in row order, bit for bit the full
    scan's. Its launches take the chunk records of its Neumann rows
    (:meth:`WalkParams.chunk_table`); its first hit keeps the full scan
    (culled beside the chord frame, it ran slower on the card)."""
    return _switches(variant) == (ROBIN_CHAIN, False, False, False, True,
                                  True, False, False, False, False, False)


def culled_closest(variant) -> bool:
    """Whether ``variant``'s closest point runs the Dirichlet rows by
    chunks from the chunk of the least box distance outward and skips the
    chunks whose box proves no row of them can win
    (``walk_variant.h::culled_closest``): the table form without delta
    tracking ``<0,false,false,false,true,false,false>`` (phase 47's
    Poisson bubble, every row of its 256 a step in the full scan); the
    first minimum in row order, bit for bit the full scan's. Its launches
    take the chunk records of its Dirichlet rows
    (:meth:`WalkParams.chunk_table`)."""
    return _switches(variant) == (ROBIN_OFF, False, False, False, True,
                                  False, False, False, False, False, False)


def one_sincos(variant) -> bool:
    """Whether ``variant``'s step takes its direction, and with MIS its
    Box-Muller pair, from one ``sincosf`` each
    (``walk_variant.h::one_sincos``, the bits of ``cosf`` and ``sinf``):
    the static form without delta tracking
    ``<0,false,false,false,false,false,false>`` (phase 25's short walk),
    which keeps one thread a lane and one bank or step an iteration (dealt
    walks and a bank with the next walk's first step in one iteration ran
    slower on the card), and the same with MIS
    ``<0,false,true,false,false,false,false>`` (phase 49's narrow
    source)."""
    robin, majorant, mis, freeze, table, delta, transport, wide, grid, \
        terms, rows = _switches(variant)
    return (robin == ROBIN_OFF and not (majorant or freeze or table or delta
                                        or transport or wide or grid or terms
                                        or rows))


def large_scans(variant, n_neu: int, n_vert: int) -> bool:
    """Whether a launch of ``variant`` over a table of ``n_neu`` Neumann
    and ``n_vert`` vertex rows takes the variant's large-table build
    (``walk_variant.h::large_scans``): the :func:`culled_scans` variant at
    ``LARGE_TABLE_ROWS`` rows of either kind or more, where its silhouette
    culls chunks and groups of vertex rows by box distance and oriented
    cone and its first hit skips groups of chunks; the same variant, its
    name and its results bit for bit, another library."""
    return culled_scans(variant) and max(int(n_neu), int(n_vert)) >= \
        LARGE_TABLE_ROWS


def build_code(variant, large: bool = False) -> int:
    """The code of a build in its library's name: the variant's, plus
    ``LARGE_CODE`` for its large-table build."""
    return variant_code(variant) + (LARGE_CODE if large else 0)


def variant_fault(variant) -> Optional[str]:
    """Why ``variant`` is not a switch combination the JAX kernel traces,
    with the reference's reason; None for a valid one
    (``csrc/walk_variant.h::valid_variant`` holds the same rule)."""
    robin, majorant, _, freeze, _, delta, transport, wide, _, terms, \
        rows = _switches(variant)
    if robin not in (ROBIN_OFF, ROBIN_CHAIN, ROBIN_REFLECTANCE):
        return f"unknown Robin mode {robin}"
    if rows and not wide:
        return ("the general rows are the wide form's sources past the "
                f"{MAX_SRC}th (dcrmontecarlo_tpu/ops/pallas_walk.py:663-677)")
    if not delta:
        ref = "dcrmontecarlo_tpu/ops/pallas_walk.py"
        for on, what, where in (
                (robin != ROBIN_OFF, "the Robin correction",
                 f"{ref}:611: use_robin = use_delta and ..."),
                (majorant, "the local majorant",
                 f"{ref}:559: local_mj = ... if use_delta else None"),
                (freeze, "the in-launch freeze",
                 "dcrmontecarlo_tpu/solver/wost.py:1780: use_split = "
                 "split_threshold is not None and use_delta_tracking; "
                 "split_threshold is inert without it"),
                (transport, "the transport sampler",
                 f"{ref}:884-900: the screened radius is drawn only with "
                 "delta tracking")):
            if on:
                return f"{what} needs delta tracking ({where})"
    if terms and terms_fields(variant):
        return ("a TERMS form exists only for a variant that lacks the "
                "kind (terms_fields): this one evaluates TERMS fields "
                "already")
    return None


def valid_variant(variant) -> bool:
    """Whether ``variant`` (nine switches, ten with the TERMS form, eleven
    with the general rows) is one the kernel builds: the JAX kernel's rule
    (the Robin correction, the local majorant, the freeze and the
    transport sampler need delta tracking; every other combination is
    traced), a TERMS form only where :func:`terms_fields` is false, and
    the general rows only in the wide form."""
    return variant_fault(variant) is None


# every variant the kernel builds: 400 switch combinations, the TERMS
# forms of the 368 that lack the kind, and the general rows builds of the
# 384 wide ones of those
KERNEL_VARIANTS = frozenset(
    _canonical(v) for v in itertools.product(
        (ROBIN_OFF, ROBIN_CHAIN, ROBIN_REFLECTANCE), *[(False, True)] * 10)
    if valid_variant(v))


def variant_code(variant) -> int:
    """The variant's code, in its library's name: its switches up to
    ``transport`` read as binary digits after the Robin mode, plus 256 for
    the wide form, 512 for the grid, 1024 for the TERMS form and 2048 for
    the general rows."""
    r, *flags = _switches(variant)
    code = r
    for f in flags[:6]:
        code = 2 * code + int(f)
    wide, grid, terms, rows = flags[6:]
    return (code + 256 * int(wide) + 512 * int(grid) + 1024 * int(terms)
            + 2048 * int(rows))


def geometry_size(problem) -> int:
    """Boundary rows as the JAX kernel counts them to pick its form
    (``ops/pallas_walk.py:60-66``): both boundaries' segments plus the
    Neumann boundary's interior vertices. Up to ``MAX_UNROLL_SEGMENTS`` is
    the static form, above it the table form."""
    n = problem.dirichlet.num_segments
    if problem.neumann is not None:
        n += problem.neumann.num_segments + problem.neumann.num_vertices
    return n


def _dir_table(poly) -> np.ndarray:
    """``(S, 5)`` float32 ``[ax, ay, ux, uy, uu]``: edge vector and squared
    length formed in float64 and rounded once, as the JAX kernel's static
    unroll does (``ops/pallas_walk.py:139-160``)."""
    rows = []
    for ax, ay, bx, by in poly.valid_segments().astype(np.float64):
        ux, uy = bx - ax, by - ay
        rows.append((ax, ay, ux, uy, max(ux * ux + uy * uy, 1e-30)))
    return np.asarray(rows, np.float32).reshape(-1, 5)


def _neu_table(poly) -> np.ndarray:
    """``(S, 6)`` float32 ``[ax, ay, ux, uy, nx, ny]`` with the CCW normal
    computed in float32 (``ops/pallas_walk.py:230-238``)."""
    rows = []
    for ax, ay, bx, by in poly.valid_segments().astype(np.float64):
        ux32, uy32 = np.float32(bx - ax), np.float32(by - ay)
        ulen = np.float32(np.sqrt(np.float32(np.maximum(
            ux32 * ux32 + uy32 * uy32, np.float32(1e-30)))))
        rows.append((ax, ay, ux32, uy32, np.float32(-uy32 / ulen),
                     np.float32(ux32 / ulen)))
    return np.asarray(rows, np.float32).reshape(-1, 6)


def _mis_table(mixture) -> np.ndarray:
    """``(k, 7)`` float32 ``[cx, cy, w, a, cum, 2 w^2, 2 pi w^2]``: the
    mixture constants as the JAX kernel forms them at trace time
    (``ops/pallas_walk.py:569-576``, ``:975-979``): the cumulative weights
    a float32 ``np.cumsum``; ``w^2`` a float64 product of the float32
    width, ``2 w^2`` and ``2 pi w^2`` from it, each rounded once."""
    cx, cy, w, a = (np.asarray(v, np.float32).reshape(-1) for v in (
        mixture.cx, mixture.cy, mixture.width, mixture.weight))
    cum = np.cumsum(a)
    rows = []
    for i in range(len(cx)):
        w2 = float(w[i]) * float(w[i])
        rows.append((cx[i], cy[i], w[i], a[i], cum[i], 2.0 * w2,
                     _TWO_PI * w2))
    return np.asarray(rows, np.float32).reshape(-1, 7)


def _chord_table(poly) -> np.ndarray:
    """``(S, 8)`` float32 ``[ax, ay, ux, uy, uu, ul, tx, ty]``: the Robin
    chord frame's segment data in float32 arithmetic from float32
    endpoints, as ``ops/pallas_walk.py::_chord_frame_unrolled`` forms it
    (``:180-188``)."""
    rows = []
    for ax, ay, bx, by in poly.valid_segments().astype(np.float64):
        ax32, ay32 = np.float32(ax), np.float32(ay)
        ux32 = np.float32(np.float32(bx) - ax32)
        uy32 = np.float32(np.float32(by) - ay32)
        uu32 = np.float32(np.maximum(ux32 * ux32 + uy32 * uy32,
                                     np.float32(1e-30)))
        ul32 = np.float32(np.sqrt(uu32))
        rows.append((ax32, ay32, ux32, uy32, uu32, ul32,
                     np.float32(ux32 / ul32), np.float32(uy32 / ul32)))
    return np.asarray(rows, np.float32).reshape(-1, 8)


def _valid_vertices(poly) -> np.ndarray:
    """``(V, 6)`` float32 ``[ax, ay, bx, by, cx, cy]`` of the interior
    vertices."""
    return poly.vert_abc.numpy()[poly.vert_valid.numpy()].reshape(-1, 6)


def _vert_table(poly) -> np.ndarray:
    """``(V, 8)`` float32 ``[ax, ay, bx, by, abx, aby, bcx, bcy]``: the
    static form's silhouette constants, the edge vectors formed in float64
    and rounded once (``ops/pallas_walk.py:205-218``)."""
    rows = []
    for ax, ay, bx, by, cx, cy in _valid_vertices(poly).astype(np.float64):
        rows.append((ax, ay, bx, by, bx - ax, by - ay, cx - bx, cy - by))
    return np.asarray(rows, np.float32).reshape(-1, 8)


def _empty(cols: int) -> np.ndarray:
    return np.zeros((0, cols), np.float32)


def _outward(x: np.ndarray, up: bool) -> np.ndarray:
    """float64 values rounded to the float32 at or past them (``up``: at
    or above)."""
    y = x.astype(np.float32)
    past = (y < x) if up else (y > x)
    return np.where(past, np.nextafter(y, np.float32(np.inf if up else
                                                        -np.inf)), y)


def _chunk_cone(rows: np.ndarray) -> tuple:
    """A Neumann chunk's second float4 ``(mx, my, g, 0)``: a unit ``m``
    and ``g >= 2 sin(gamma) + slack``, where every row's unit direction, or
    its negative, lies within ``gamma`` of ``m`` (rows of zero length never
    hit); ``g = 4`` (no bound) for a cone of 30 degrees or more, a row
    shorter than 1e-20 or no row with a direction."""
    u = rows[:, 2:4].astype(np.float64) - rows[:, 0:2].astype(np.float64)
    length = np.hypot(u[:, 0], u[:, 1])
    if ((length > 0) & (length < 1e-20)).any() or not (length > 0).any():
        return 0.0, 0.0, 4.0, 0.0
    u = u[length > 0] / length[length > 0, None]
    u = u * np.where(u @ u[np.argmax(length[length > 0])] < 0, -1.0,
                     1.0)[:, None]
    m = u.sum(0)
    m /= np.hypot(m[0], m[1])
    gamma = float(np.arccos(np.clip(np.abs(u @ m).min(), -1.0, 1.0)))
    if gamma >= np.pi / 6:
        return 0.0, 0.0, 4.0, 0.0
    return m[0], m[1], 2.0 * np.sin(gamma) + 1e-5, 0.0


def chunk_records(neu_rows, rows_per_chunk: Optional[int] = None
                  ) -> np.ndarray:
    """The table form's chunk records (``csrc/walk_kernel.cu``,
    ``chunk_skips``): ``(chunks, 8)`` float32, for each ``CHUNK_ROWS``
    consecutive Neumann rows ``[ax, ay, bx, by]`` the box ``(x0, y0, x1,
    y1)`` of their float32 endpoints, widened by ``2^-20`` of their
    largest coordinate and rounded outward, then their direction cone
    (:func:`_chunk_cone`). ``rows_per_chunk`` other than ``CHUNK_ROWS``
    serves the host replay of the cull (``chip_probes/table_cull.py``)."""
    rows_per_chunk = rows_per_chunk or CHUNK_ROWS
    rows = np.asarray(neu_rows, np.float32)
    out = []
    for c0 in range(0, len(rows), rows_per_chunk):
        chunk = rows[c0:c0 + rows_per_chunk]
        pts = chunk[:, :4].reshape(-1, 2).astype(np.float64)
        widen = float(np.abs(pts).max()) * 2.0 ** -20 + 1e-30
        lo = _outward(pts.min(0) - widen, up=False)
        hi = _outward(pts.max(0) + widen, up=True)
        out.append([lo[0], lo[1], hi[0], hi[1], *_chunk_cone(chunk)])
    # the boxes are float32 already; g rounds up
    return _outward(np.asarray(out, np.float64).reshape(-1, 8), up=True)


def _oriented_cone(edges: np.ndarray) -> tuple:
    """A silhouette record's third float4 ``(mx, my, g, 0)``: a float32
    ``m`` and ``g`` such that every edge of ``edges`` ``(k, 2)`` (float32
    differences) but a zero one has its unit direction ``u`` within ``|u
    - m| <= g``, ``g`` rounded up with slack; ``g = 4`` (no bound) where
    an edge is shorter than 1e-20, none has a length, or the directions
    spread past ``|u - m| = 1``."""
    e = edges.astype(np.float64)
    length = np.hypot(e[:, 0], e[:, 1])
    if ((length > 0) & (length < 1e-20)).any() or not (length > 0).any():
        return 0.0, 0.0, 4.0, 0.0
    u = e[length > 0] / length[length > 0, None]
    m = u.sum(0)
    norm = float(np.hypot(m[0], m[1]))
    if not norm > 0.0:
        return 0.0, 0.0, 4.0, 0.0
    m32 = (m / norm).astype(np.float32).astype(np.float64)
    g = float(np.hypot(*(u - m32).T).max())
    if g > 1.0:
        return 0.0, 0.0, 4.0, 0.0
    return m32[0], m32[1], g * (1.0 + 2.0 ** -20) + 1e-6, 0.0


def silhouette_records(vert_rows, rows_per_chunk: Optional[int] = None
                       ) -> np.ndarray:
    """The large-table build's silhouette records (``csrc/walk_kernel.cu``,
    ``sil_skips``): ``(chunks, 12)`` float32, for each ``SIL_ROWS``
    consecutive vertex rows ``[ax, ay, bx, by, cx, cy]`` the box ``(x0,
    y0, x1, y1)`` of their a, b and c points widened as
    :func:`chunk_records` widens a chunk's, the box of their b points as
    they are, and the oriented cone of their float32 edges ``b - a`` and
    ``c - b`` (:func:`_oriented_cone`). ``rows_per_chunk`` other than
    ``SIL_ROWS`` forms the group records (``SIL_ROWS * GROUP_CHUNKS``) and
    serves the host replay (``chip_probes/table_cull.py``)."""
    rows_per_chunk = rows_per_chunk or SIL_ROWS
    rows = np.asarray(vert_rows, np.float32).reshape(-1, 6)
    out = []
    for c0 in range(0, len(rows), rows_per_chunk):
        chunk = rows[c0:c0 + rows_per_chunk]
        pts = chunk.reshape(-1, 2).astype(np.float64)
        widen = float(np.abs(pts).max()) * 2.0 ** -20 + 1e-30
        lo = _outward(pts.min(0) - widen, up=False)
        hi = _outward(pts.max(0) + widen, up=True)
        b = chunk[:, 2:4]
        edges = np.concatenate([chunk[:, 2:4] - chunk[:, 0:2],
                                chunk[:, 4:6] - chunk[:, 2:4]])
        cone = _oriented_cone(edges)
        out.append([lo[0], lo[1], hi[0], hi[1], *b.min(0), *b.max(0),
                    cone[0], cone[1], float(_outward(np.float64(cone[2]),
                                                     up=True)), 0.0])
    return np.asarray(out, np.float32).reshape(-1, 12)


def pole_record(spec) -> Optional[Tuple[float, float, float, float]]:
    """``(cx, cy, amp, g)`` of a field spec that is exactly one Gaussian
    pole ``amp exp(-g |p - c|^2)`` (``fields.gaussian_bump``): a ``TERMS``
    field of background +0, one term whose polynomial is its constant
    ``amp != 0`` alone, ``ax = ay = 0``, ``g != 0`` and no sin or cos
    factor; None for any other spec (a non-zero background, a second term,
    any other coefficient, ax, ay or a factor). The general rows build
    evaluates such a source from this record, bit for bit the ``TERMS``
    text (``csrc/walk_kernel.cu``: ``pole_value``, and ``pole_record``,
    the same rule, which refuses a mark on any other field)."""
    if (spec.kind != fields.TERMS or len(spec.terms) != 1
            or spec.background != 0.0
            or math.copysign(1.0, spec.background) < 0.0):
        return None
    t = spec.terms[0]
    amp, *rest = sum(t.poly, ())
    if (amp == 0.0 or any(c != 0.0 for c in rest) or t.ax != 0.0
            or t.ay != 0.0 or t.g == 0.0 or t.s1[0] != fields.S_NONE
            or t.s2[0] != fields.S_NONE):
        return None
    return t.cx, t.cy, amp, t.g


def large_records(neu_rows, vert_rows) -> np.ndarray:
    """The large-table build's records, one float32 buffer in the order
    ``walk_launch`` reads it: the first hit's chunk records
    (:func:`chunk_records`), its group records (the same over
    ``CHUNK_ROWS * GROUP_CHUNKS`` rows), the silhouette's chunk records
    (:func:`silhouette_records`) and its group records."""
    group = CHUNK_ROWS * GROUP_CHUNKS
    parts = [chunk_records(neu_rows), chunk_records(neu_rows, group),
             silhouette_records(vert_rows),
             silhouette_records(vert_rows, SIL_ROWS * GROUP_CHUNKS)]
    return np.ascontiguousarray(np.concatenate([a.reshape(-1)
                                                for a in parts]), np.float32)


@dataclass(frozen=True)
class WalkParams:
    """Everything one launch needs besides the planes."""

    seed: int                    # int32 bit pattern of the stream seed
    eps: float
    rmin: float
    t_min: float
    max_steps: int
    sigma_bar: float
    rejection_rounds: int
    roulette_threshold: Optional[float]
    project: bool
    snap: bool
    dir_table: np.ndarray        # (S, 5) float32; table form (S, 4) rows
    neu_table: np.ndarray        # (S, 6) float32, S may be 0; table (S, 4)
    bc: Callable
    sources: Tuple[Callable, ...]
    alpha_c: Callable
    sigma_prime: Callable
    specs: Optional[tuple]       # (bc, alpha, sigma, *sources) FieldSpecs
                                 # when every field is one, else None
    robin: int = ROBIN_OFF       # ROBIN_OFF | ROBIN_CHAIN | ROBIN_REFLECTANCE
    robin_arrival_clamp: float = 0.02
    gamma_floor: float = 0.0     # chord branch-rate floor
    chord_table: np.ndarray = None   # (S, 8) float32, with neu_table's S
                                     # (static form; the table form forms
                                     # the chord frame from neu_table)
    grad_log_alpha: Optional[Callable] = None
    majorant: Optional[LocalMajorant] = None
    sb_bg: float = 0.0           # the majorant's background sigma_bar and
    mfp_bg: float = 0.0          # the two progress scales 1/sqrt(sigma_bar)
    mfp_gl: float = 0.0
    mis_table: Optional[np.ndarray] = None  # (k, 7) float32 (_mis_table):
                                            # MIS NEE when set
    max_attenuation: Optional[float] = None  # symmetric |atten| cap
    freeze: bool = False         # the in-launch freeze build (its launches
                                 # take a threshold, +inf = no freeze)
    table: bool = False          # the table form: dir_table, neu_table are
                                 # float32 endpoint rows [ax, ay, bx, by],
                                 # vert_table [a, b, c] rows (V, 6)
    vert_table: np.ndarray = field(default_factory=lambda: _empty(8))
                                 # silhouette vertices: static (V, 8)
                                 # (_vert_table), table form (V, 6)
    delta: bool = True           # delta tracking (a problem with alpha or
                                 # sigma); without it the walker jumps to
                                 # the ball's edge or its Neumann hit
    transport: bool = False      # the screened radius by the transport
                                 # map (screened_sampler="transport")
    shard_seeds: Tuple[int, ...] = ()  # a launch over several shards'
    shard_lanes: int = 0         # lanes, shard_lanes each, shard after
                                 # shard, lane i drawing from shard_seeds[
                                 # i // shard_lanes]; () for one shard that
                                 # draws from seed (shard_table)
    _cache: dict = field(init=False, default_factory=dict, compare=False,
                         repr=False)  # tables as tensors, per device

    @property
    def n_src(self) -> int:
        return max(1, len(self.sources))

    @property
    def variant(self) -> tuple:
        """The kernel's variant ``(robin, majorant, mis, freeze, table,
        delta, transport, wide, grid)``, then the TERMS form
        (:attr:`terms_form`) and the general rows (:attr:`rows`) up to the
        last one set."""
        base = (self.robin, self.majorant is not None,
                self.mis_table is not None, self.freeze, self.table,
                self.delta, self.transport, self.wide, self.grid)
        return _canonical(base + (self.terms_form, self.rows))

    @property
    def terms_form(self) -> bool:
        """Whether a launch takes its variant's TERMS form: a ``TERMS``
        field where :func:`terms_fields` compiles no such kind."""
        return (self.specs is not None
                and any(f.kind == fields.TERMS for f in self.specs)
                and not terms_fields((self.robin, self.majorant is not None,
                                      self.mis_table is not None,
                                      self.freeze, self.table, self.delta)))

    @property
    def grid(self) -> bool:
        """Whether the Dirichlet data is a gridded field
        (:class:`fields.Grid`), whose instantiations read its table."""
        return isinstance(self.bc, fields.Grid)

    @property
    def wide(self) -> bool:
        """Whether a launch takes the kernel's wide form: more than
        ``MAX_SRC`` sources or ``MAX_MIX`` mixture components."""
        return (len(self.sources) > MAX_SRC
                or (self.mis_table is not None
                    and len(self.mis_table) > MAX_MIX))

    @property
    def rows(self) -> bool:
        """Whether a launch takes its wide variant's general rows build: a
        source past the ``MAX_SRC``-th that is not a Gaussian dipole."""
        return (self.specs is not None
                and any(f.kind != fields.DIPOLE
                        for f in self.specs[3 + MAX_SRC:]))

    @property
    def poles(self) -> Tuple[int, ...]:
        """The sources a launch evaluates from pole records
        (:func:`pole_record`): in the general rows build every source, in
        the header or past it, that is one Gaussian pole; ``()`` in any
        other build."""
        if not self.rows:
            return ()
        return tuple(i for i, f in enumerate(self.specs[3:])
                     if pole_record(f) is not None)

    @property
    def kernel_name(self) -> str:
        """The instantiation's name (the launch counters' key)."""
        return kernel_name(self.variant)

    @property
    def large(self) -> bool:
        """Whether a launch takes its variant's large-table build
        (:func:`large_scans`, by the table's rows)."""
        return large_scans(self.variant, len(self.neu_table),
                           len(self.vert_table))

    @property
    def build_name(self) -> str:
        """The library's build: :attr:`kernel_name`, with ``" (large)"``
        for the large-table build (``run_walk.build_launches``' key)."""
        return self.kernel_name + (" (large)" if self.large else "")

    def pack(self):
        """Kernel parameter buffers ``(float32 array, int32 array)`` in the
        layout ``walk_launch`` unpacks (``csrc/walk_kernel.cu``)."""
        if self.specs is None:
            raise NotImplementedError(
                "the CUDA walk evaluates field specs only "
                "(dcrmontecarlo_tpu_torch.problems.fields); arbitrary "
                "callables run on CPU tensors")
        if self.specs[1].kind not in (fields.CONST, fields.BUMPS,
                                      fields.TERMS):
            raise NotImplementedError(
                "the CUDA walk takes a constant, bump-sum or terms "
                "conductivity")
        if any(isinstance(f, fields.Grid) for f in self.specs[1:]):
            raise NotImplementedError(
                "a gridded field may be the Dirichlet data only (it has no "
                "derivatives); reference: dcrmontecarlo_tpu/diagnostics/"
                "martingale.py::grid_continuation")
        fault = variant_fault(self.variant)
        if fault is not None:
            raise ValueError(f"{self.kernel_name}: {fault}")
        for spec in self.specs:
            if spec.kind == fields.TERMS and len(spec.terms) > \
                    fields.MAX_TERMS:
                raise NotImplementedError(
                    f"the CUDA walk holds up to {fields.MAX_TERMS} terms "
                    f"per field, got {len(spec.terms)}; reference: "
                    "dcrmontecarlo_tpu/ops/pallas_walk.py::make_pallas_walk")
            if spec.kind == fields.BUMPS and len(spec.bumps) > \
                    fields.MAX_BUMPS:
                raise NotImplementedError(
                    f"the CUDA walk holds up to {fields.MAX_BUMPS} bumps "
                    f"per field, got {len(spec.bumps)}; reference: "
                    "dcrmontecarlo_tpu/ops/pallas_walk.py::make_pallas_walk")
        if len(self.sources) > MAX_WIDE_SRC:
            raise NotImplementedError(
                f"the CUDA walk holds up to {MAX_WIDE_SRC} sources, got "
                f"{len(self.sources)}; reference: "
                "dcrmontecarlo_tpu/ops/pallas_walk.py::make_pallas_walk")
        rows = (len(self.dir_table) + len(self.neu_table)
                + len(self.vert_table))
        if not self.table and rows > MAX_UNROLL_SEGMENTS:
            raise ValueError(
                f"the static form holds up to {MAX_UNROLL_SEGMENTS} boundary "
                f"rows, got {rows}: a larger boundary takes the table form")
        mj = self.majorant
        boxes, bands = (mj.table() if mj is not None
                        else (np.zeros((0, 4), np.float32),
                              np.zeros((0, 2), np.float32)))
        if len(boxes) > MAX_BOXES or len(bands) > MAX_BANDS:
            raise NotImplementedError(
                f"the CUDA walk holds a local majorant of up to {MAX_BOXES} "
                f"boxes and {MAX_BANDS} bands, got {len(boxes)} and "
                f"{len(bands)}; reference: "
                "dcrmontecarlo_tpu/problems/majorant.py::LocalMajorant")
        mix = (self.mis_table if self.mis_table is not None
               else np.zeros((0, 7), np.float32))
        if len(mix) > MAX_WIDE_MIX:
            raise NotImplementedError(
                f"the CUDA walk holds an MIS mixture of up to {MAX_WIDE_MIX} "
                f"components, got {len(mix)}; reference: "
                "dcrmontecarlo_tpu/ops/pallas_walk.py::make_pallas_walk")
        ip = [self.seed, self.max_steps, self.rejection_rounds,
              int(self.roulette_threshold is not None), int(self.project),
              int(self.snap), self.n_src, int(len(self.sources) > 0),
              len(self.dir_table), len(self.neu_table), self.robin,
              int(mj is not None), len(boxes), len(bands),
              int(self.max_attenuation is not None), len(mix),
              int(self.freeze), len(self.vert_table), int(self.table),
              int(self.delta), int(self.transport)]
        fp = [self.eps, self.rmin, self.t_min, self.sigma_bar,
              0.0 if self.roulette_threshold is None
              else self.roulette_threshold, self.gamma_floor,
              self.robin_arrival_clamp, self.sb_bg, self.mfp_bg, self.mfp_gl,
              0.0 if self.max_attenuation is None else self.max_attenuation]
        if not self.table:  # the table form's rows go by device_tables
            fp += (self.dir_table.ravel().tolist()
                   + self.neu_table.ravel().tolist()
                   + self.chord_table.ravel().tolist())
        fp += boxes.ravel().tolist() + bands.ravel().tolist()
        fp += mix.ravel().tolist()
        if not self.table:
            fp += self.vert_table.ravel().tolist()
        poles = {3 + i for i in self.poles}
        for f, spec in enumerate(self.specs):
            kind, params = spec.table()
            ip += [POLE_KIND if f in poles else kind, len(params)]
            fp += list(params)
        return np.asarray(fp, np.float32), np.asarray(ip, np.int32)

    def columns(self, name: str, device):
        """Table ``name``'s columns as ``(1, rows)`` float32 tensors on
        ``device`` (copied there once per params)."""
        key = (name, str(device))
        if key not in self._cache:
            t = torch.from_numpy(np.array(getattr(self, name).T, np.float32))
            self._cache[key] = [c[None, :] for c in t.to(device)]
        return self._cache[key]

    def shard_table(self, n_lanes: int):
        """``(seeds, lanes)``: the launch's shard table, int32 seed
        patterns and lanes per shard; one shard of ``n_lanes`` lanes with
        ``seed`` unless :attr:`shard_seeds` is set. Raises above
        ``MAX_SHARDS`` shards or where a lane lies past the last shard."""
        if not self.shard_seeds:
            return np.asarray([self.seed], np.int64).astype(np.int32), \
                max(int(n_lanes), 1)
        seeds = np.asarray(self.shard_seeds, np.int64).astype(np.int32)
        if not 1 <= len(seeds) <= MAX_SHARDS:
            raise NotImplementedError(
                f"a launch holds up to {MAX_SHARDS} shards, got "
                f"{len(seeds)}: launch them in groups")
        if self.shard_lanes < 1 or len(seeds) * self.shard_lanes < n_lanes:
            raise ValueError(f"{n_lanes} lanes do not fit {len(seeds)} "
                             f"shards of {self.shard_lanes}")
        if self.shard_lanes % LANES or self.freeze:
            raise ValueError("a launch of several shards holds whole rows "
                             f"of {LANES} lanes a shard and no freeze (the "
                             "sharded loop never freezes)")
        return seeds, int(self.shard_lanes)

    def chunk_table(self, device):
        """The Neumann rows' chunk records (:func:`chunk_records`) in the
        :func:`culled_scans` and :func:`culled_chord` variants (in the
        large-table build all of
        :func:`large_records`, which begin with them), or in the
        :func:`culled_closest` variant the Dirichlet rows', as a contiguous
        float32 tensor on ``device``, uploaded once per params; None
        outside those variants."""
        if not (culled_scans(self.variant) or culled_chord(self.variant)
                or culled_closest(self.variant)):
            return None
        key = ("chunks", str(device))
        if key not in self._cache:
            recs = (chunk_records(self.dir_table)
                    if culled_closest(self.variant) else
                    large_records(self.neu_table, self.vert_table)
                    if self.large else chunk_records(self.neu_table))
            self._cache[key] = torch.from_numpy(recs).to(device)
        return self._cache[key]

    def grid_table(self, device):
        """The gridded Dirichlet field's node values as a contiguous float32
        tensor on ``device`` (uploaded once per field, so once per solve),
        None without one."""
        return self.bc.device_table(device) if self.grid else None

    def device_tables(self, device):
        """The table form's ``(dir, neu, vert)`` rows as contiguous float32
        tensors on ``device``, ``(S, 4)``, ``(S, 4)`` and ``(V, 8)`` (the
        vertex rows padded to two float4), uploaded once per params, so
        once per solve; ``()`` in the static form."""
        if not self.table:
            return ()
        key = ("rows", str(device))
        if key not in self._cache:
            vert = np.zeros((len(self.vert_table), 8), np.float32)
            vert[:, :6] = self.vert_table
            self._cache[key] = tuple(
                torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
                    device) for a in (self.dir_table, self.neu_table, vert))
        return self._cache[key]


def make_walk_params(problem, *, eps, max_steps, t_min, rmin, project,
                     rejection_rounds, roulette_threshold, snap, seed,
                     robin_correction=False,
                     robin_arrival_clamp=0.02, max_attenuation=None,
                     freeze_split=False,
                     screened_sampler="exact") -> WalkParams:
    """Walk parameters for ``problem``.

    ``robin_correction`` is the RESOLVED mode (``WoStSolver._robin_enabled``:
    False, ``"chain"`` or ``"reflectance"``); the local majorant and the
    MIS importance mixture (``source_importance``, used when the problem
    has a source) are the problem's. ``freeze_split`` builds the in-launch
    freeze, whose launches take a threshold (:func:`run_walk`).
    ``screened_sampler`` is ``"exact"`` (the rejection) or ``"transport"``.
    Without delta tracking (no alpha or sigma) the JAX kernel ignores the
    Robin mode, roulette, ``max_attenuation`` and the sampler
    (``ops/pallas_walk.py:611``, ``:1100``, ``:1120``) and the JAX solver
    the split (``solver/wost.py:1780``); so do these parameters.
    """
    sources = tuple(problem.source_fields)
    delta = bool(problem.use_delta_tracking)
    if screened_sampler not in ("exact", "transport"):
        raise ValueError(f"unknown screened sampler {screened_sampler!r}")
    # without delta tracking the kernel reads no coefficient
    alpha = problem.alpha if delta else fields.constant(1.0)
    sigma = problem.sigma if delta else fields.constant(0.0)
    all_fields = (problem.bc_dirichlet, alpha, sigma) + sources
    if any(isinstance(f, fields.Grid) for f in all_fields[1:]):
        raise NotImplementedError(
            "a gridded field may be the Dirichlet data only (it has no "
            "derivatives); reference: dcrmontecarlo_tpu/diagnostics/"
            "martingale.py::grid_continuation")
    specs = (all_fields if all(fields.is_spec(f) for f in all_fields)
             else None)
    if robin_correction not in _ROBIN_CODES:
        raise ValueError(f"unknown Robin mode {robin_correction!r}")
    robin = (_ROBIN_CODES[robin_correction]
             if problem.neumann is not None and delta else ROBIN_OFF)
    # the form by the JAX kernel's rule (pallas_walk.py:577): a 1-ulp
    # difference of the two arithmetics desynchronizes walks
    table = geometry_size(problem) > MAX_UNROLL_SEGMENTS
    neumann = problem.neumann
    if table:
        dirt = problem.dirichlet.valid_segments()
        neu = neumann.valid_segments() if neumann is not None else _empty(4)
        chord = _empty(8)
        vert = _valid_vertices(neumann) if neumann is not None else _empty(6)
    else:
        dirt = _dir_table(problem.dirichlet)
        neu = _neu_table(neumann) if neumann is not None else _empty(6)
        chord = _chord_table(neumann) if neumann is not None else _empty(8)
        vert = _vert_table(neumann) if neumann is not None else _empty(8)
    mj = problem.local_majorant
    if mj is not None:
        # the progress scales in float64, rounded once (pallas_walk.py:559-563)
        maj = dict(majorant=mj, sb_bg=float(max(mj.sigma_bar_bg, 1e-12)),
                   mfp_bg=float(1.0 / np.sqrt(max(mj.sigma_bar_bg, 1e-12))),
                   mfp_gl=float(1.0 / np.sqrt(max(problem.sigma_bar,
                                                  1e-30))))
    else:
        maj = {}
    return WalkParams(
        seed=int(seed), eps=float(eps), rmin=float(rmin), t_min=float(t_min),
        max_steps=int(max_steps),
        sigma_bar=float(problem.sigma_bar) if delta else 0.0,
        rejection_rounds=int(rejection_rounds),
        roulette_threshold=(None if roulette_threshold is None or not delta
                            else float(roulette_threshold)),
        project=bool(project), snap=bool(snap),
        dir_table=dirt, neu_table=neu, table=table, vert_table=vert,
        bc=problem.bc_dirichlet, sources=sources, alpha_c=problem.alpha_c,
        sigma_prime=problem.sigma_prime, specs=specs, robin=robin,
        robin_arrival_clamp=float(robin_arrival_clamp),
        gamma_floor=(float(0.25 * problem.max_boundary_gamma())
                     if robin != ROBIN_OFF else 0.0),
        chord_table=chord, grad_log_alpha=problem.grad_log_alpha,
        mis_table=(_mis_table(problem.source_importance)
                   if sources and problem.source_importance is not None
                   else None),
        # python floats rounded to float32, as the JAX kernel's weakly
        # typed constants are
        max_attenuation=(None if max_attenuation is None or not delta
                         else float(np.float32(max_attenuation))),
        freeze=bool(freeze_split) and delta, delta=delta,
        transport=delta and screened_sampler == "transport", **maj)


def stream_ids(rows: int, crn=None, device=None):
    """Per-lane RNG stream ids for a ``(rows, 128)`` state: the lane index,
    or the common-random-numbers map ``(mode, period, reps)`` — ``"tile"``
    (point-major, ``lane % period``) or slot-major (``lane // reps``)."""
    ids = torch.arange(rows * LANES, dtype=torch.int64, device=device)
    if crn is not None:
        mode, period, reps = crn
        ids = ids % period if mode == "tile" else ids // reps
    return ids.to(torch.int32).reshape(rows, LANES)


# ---------------------------------------------------------------------- #
# plain version                                                          #
# ---------------------------------------------------------------------- #

@functools.lru_cache(maxsize=None)
def _stream_keys(streams: tuple, device) -> torch.Tensor:
    """The hash keys of stream indices ``streams`` on ``device``, made
    once: a copy from the host in every step would wait for the device
    (and could not be captured in a CUDA graph)."""
    return torch.tensor([(rng.C_STREAM * k) & rng.MASK32 for k in streams],
                        dtype=torch.int64, device=device)


def _uniforms(seed: int, ctr, sid, streams):
    """Counter-hash uniforms for stream indices ``streams`` (1-based),
    stacked on a leading axis: one hash over every stream at once."""
    base = rng.mix32((seed & rng.MASK32) ^ rng.mul32(ctr, rng.C_COUNTER))
    ks = _stream_keys(tuple(streams), ctr.device)
    ks = ks.view((-1,) + (1,) * ctr.dim())
    return rng._to_unit(rng.mix32((sid ^ base)[None] ^ ks))


def _row_blocks(lanes: int, rows: int):
    """The plain scans' row blocks ``[(r0, r1), ...]``: ``SCAN_ELEMS``
    lane-rows at most a block (one row at least), so a scan's lanes x rows
    temporaries stay bounded at any table size; one empty block for no
    row."""
    per = max(1, SCAN_ELEMS // max(int(lanes), 1))
    return [(r0, min(r0 + per, rows)) for r0 in range(0, rows, per)] \
        or [(0, 0)]


def _first_min(block, lanes: int, rows: int):
    """Row-wise the sequential scan ``if key < best: take the row`` from
    ``best = _BIG`` over the ``(W, S)`` keys that ``block(r0, r1)`` gives
    with their payloads (``(W, r1 - r0)`` or ``(1, r1 - r0)``) block by
    block (:func:`_row_blocks`): the minimum below ``_BIG`` and the
    payloads of its FIRST row, ``_BIG`` and zeros where no row is below
    ``_BIG``. A block's first minimum replaces the running one only where
    strictly smaller (or NaN where the running one is not, as ``argmin``
    takes the first NaN), so the result is the one-pass ``argmin``'s at
    any block size."""
    best, out = None, None
    for r0, r1 in _row_blocks(lanes, rows):
        key, payloads = block(r0, r1)
        idx = torch.argmin(key, dim=1, keepdim=True)
        kb = torch.gather(key, 1, idx)[:, 0]
        pb = [torch.gather(p.expand_as(key), 1, idx)[:, 0]
              for p in payloads]
        if best is None:
            best, out = kb, pb
            continue
        take = (kb < best) | (torch.isnan(kb) & ~torch.isnan(best))
        best = torch.where(take, kb, best)
        out = [torch.where(take, b, a) for a, b in zip(out, pb)]
    found = best < _BIG
    return torch.where(found, best, _BIG), [torch.where(found, p, 0.0)
                                            for p in out]


def _cols(cols, r0, r1):
    """Rows ``r0:r1`` of ``(1, S)`` row columns."""
    return [c[:, r0:r1] for c in cols]


def _closest_point(P: WalkParams, px, py):
    """Distance to the Dirichlet boundary and the foot: the static form
    reads host-formed ``[ax, ay, ux, uy, uu]``
    (``_closest_point_unrolled``), the table form forms the edge in
    float32 from the endpoints (``_closest_point_smem``); both divide."""
    if P.table:
        ax, ay, bx, by = P.columns("dir_table", px.device)
        ux, uy = bx - ax, by - ay
        uu = torch.clamp(ux * ux + uy * uy, min=1e-30)
    else:
        ax, ay, ux, uy, uu = P.columns("dir_table", px.device)

    def block(r0, r1):
        a_x, a_y, u_x, u_y, u_u = _cols((ax, ay, ux, uy, uu), r0, r1)
        vx = px[:, None] - a_x
        vy = py[:, None] - a_y
        # divide, not reciprocal-multiply: a 1-ulp t flips dD at the shell
        t = torch.clamp((vx * u_x + vy * u_y) / u_u, 0.0, 1.0)
        cx = a_x + t * u_x
        cy = a_y + t * u_y
        ex, ey = cx - px[:, None], cy - py[:, None]
        return ex * ex + ey * ey, (cx, cy)

    best, (bcx, bcy) = _first_min(block, px.numel(), ax.shape[1])
    return torch.sqrt(best), bcx, bcy


def _first_hit(P: WalkParams, px, py, dx, dy, r, t_min):
    """First Neumann hit within ``r``: the static form reads host-formed
    edges and normals and multiplies by ``1 / den``
    (``_first_hit_unrolled``); the table form forms them in float32 and
    divides (``_first_hit_smem``). ``t_min`` is a float or per lane."""
    if P.table:
        ax, ay, bx, by = P.columns("neu_table", px.device)
        ux, uy = bx - ax, by - ay
        ulen = torch.sqrt(torch.clamp(ux * ux + uy * uy, min=1e-30))
        nxs, nys = -uy / ulen, ux / ulen
    else:
        ax, ay, ux, uy, nxs, nys = P.columns("neu_table", px.device)
    dxe, dye = dx[:, None], dy[:, None]
    t_lo = t_min[:, None] if isinstance(t_min, torch.Tensor) else t_min

    def block(r0, r1):
        a_x, a_y, u_x, u_y, n_x, n_y = _cols((ax, ay, ux, uy, nxs, nys),
                                             r0, r1)
        wx = px[:, None] - a_x
        wy = py[:, None] - a_y
        den = dxe * u_y - dye * u_x
        den_safe = torch.where(torch.abs(den) < 1e-30, 1e-30, den)
        if P.table:
            t = (u_x * wy - u_y * wx) / den_safe
            s = (dxe * wy - dye * wx) / den_safe
        else:
            inv_den = 1.0 / den_safe
            t = (u_x * wy - u_y * wx) * inv_den
            s = (dxe * wy - dye * wx) * inv_den
        ok = ((s >= 0.0) & (s <= 1.0) & (t >= t_lo)
              & (torch.abs(den) > 1e-30))
        return torch.where(ok, t, _BIG), (n_x, n_y, a_x + s * u_x,
                                          a_y + s * u_y)

    t_best, (nx, ny, hxs, hys) = _first_min(block, px.numel(), ax.shape[1])
    hit = t_best <= r
    t_hit = torch.where(hit, t_best, r)
    flip = (nx * dx + ny * dy) > 0.0
    nx = torch.where(flip, -nx, nx)
    ny = torch.where(flip, -ny, ny)
    nx = torch.where(hit, nx, 0.0)
    ny = torch.where(hit, ny, 0.0)
    hx = torch.where(hit, hxs, px + r * dx)
    hy = torch.where(hit, hys, py + r * dy)
    return hx, hy, nx, ny, t_hit, hit


def _chord_frame(P: WalkParams, px, py):
    """The nearest Neumann segment's unit tangent and the chord interval
    ``[s_lo, s_hi]`` keeping ``foot + s * t_hat`` on it
    (``_chord_frame_unrolled`` / ``_chord_frame_smem``: the same float32
    arithmetic, formed on the host or per step)."""
    if P.table:
        ax, ay, bx, by = P.columns("neu_table", px.device)
        ux, uy = bx - ax, by - ay
        uu = torch.clamp(ux * ux + uy * uy, min=1e-30)
        ul = torch.sqrt(uu)
        tx, ty = ux / ul, uy / ul
    else:
        ax, ay, ux, uy, uu, ul, tx, ty = P.columns("chord_table", px.device)

    def block(r0, r1):
        a_x, a_y, u_x, u_y, u_u, u_l, t_x, t_y = _cols(
            (ax, ay, ux, uy, uu, ul, tx, ty), r0, r1)
        vx = px[:, None] - a_x
        vy = py[:, None] - a_y
        t = torch.clamp((vx * u_x + vy * u_y) / u_u, 0.0, 1.0)
        ex = (a_x + t * u_x) - px[:, None]
        ey = (a_y + t * u_y) - py[:, None]
        return ex * ex + ey * ey, (t_x, t_y, -t * u_l, (1.0 - t) * u_l)

    _, (btx, bty, bslo, bshi) = _first_min(block, px.numel(), ax.shape[1])
    return btx, bty, bslo, bshi


def _silhouette(P: WalkParams, px, py):
    """Distance to the nearest silhouette vertex, ``sqrt(3e38)`` for none:
    vertex ``b`` is one seen from ``p`` when ``cross(ab, ap) *
    cross(bc, bp) < 0`` (``_silhouette_unrolled`` with host-formed edges,
    ``_silhouette_smem`` with float32 ones); the rows in blocks
    (:func:`_row_blocks`), whose minima give the one-pass minimum."""
    if P.table:
        ax, ay, bx, by, cx, cy = P.columns("vert_table", px.device)
        abx, aby, bcx, bcy = bx - ax, by - ay, cx - bx, cy - by
    else:
        ax, ay, bx, by, abx, aby, bcx, bcy = P.columns("vert_table",
                                                       px.device)
    d2_min = None
    for r0, r1 in _row_blocks(px.numel(), ax.shape[1]):
        a_x, a_y, b_x, b_y, ab_x, ab_y, bc_x, bc_y = _cols(
            (ax, ay, bx, by, abx, aby, bcx, bcy), r0, r1)
        apx = px[:, None] - a_x
        apy = py[:, None] - a_y
        bpx = px[:, None] - b_x
        bpy = py[:, None] - b_y
        sgn = (ab_x * apy - ab_y * apx) * (bc_x * bpy - bc_y * bpx)
        d2 = torch.min(torch.where(sgn < 0, bpx * bpx + bpy * bpy, _BIG),
                       dim=1).values
        d2_min = d2 if d2_min is None else torch.minimum(d2_min, d2)
    return torch.sqrt(torch.clamp(d2_min, max=_BIG))


def _robin_chord_mass(P: WalkParams, px, py, nxv, nyv, ob, r, sbar):
    """On-boundary Robin chord mass ``c = 4 gamma J(r)`` with the radius
    shrunk (4 rounds) until ``|c| <= 1/2``; returns ``(r, c_mag, c_ch)``:
    the shrunk radius, the branch-rate magnitude (|gamma| floored at
    ``gamma_floor``) and the signed mass, both zero off the wall."""
    glx0, gly0 = P.grad_log_alpha(px, py)
    gamma0 = -0.5 * (nxv * glx0 + nyv * gly0)
    g_eff = torch.clamp(torch.abs(gamma0), min=P.gamma_floor)
    chord_j = screened_chord_integral(r, sbar)
    c_mag = 4.0 * g_eff * chord_j
    for _ in range(4):
        shrink = ob & (c_mag > 0.5)
        if not bool(shrink.any()):
            break  # nothing shrinks, nor will in a later round
        r_new = torch.clamp(r * (0.5 / torch.clamp(c_mag, min=1e-12)),
                            min=P.rmin)
        r = torch.where(shrink, r_new, r)
        chord_j = torch.where(shrink, screened_chord_integral(r, sbar),
                              chord_j)
        c_mag = torch.where(shrink, 4.0 * g_eff * chord_j, c_mag)
    c_ch = 4.0 * gamma0 * chord_j
    c_mag = torch.where(ob, torch.clamp(c_mag, max=0.9), 0.0)
    c_ch = torch.where(ob, torch.clamp(c_ch, -0.9, 0.9), 0.0)
    return r, c_mag, c_ch


def _chord_branch(P: WalkParams, u10, u11, px, py, nxv, nyv, r, sbar, a_p):
    """The chord continuation's point ``z`` on the wall, its weight
    ``2 gamma(z) G_s(|zeta|) / p_mix(zeta) * sqrt(alpha_z / alpha_x)``
    (zero past the segment's ends) and ``alpha_z``: ``|zeta|`` from the
    balanced mixture of a log sampler and a truncated exponential."""
    q_scr = torch.sqrt(torch.clamp(sbar, min=1e-12))
    side = torch.where(u10 < 0.5, -1.0, 1.0)
    v = torch.abs(2.0 * u10 - 1.0)
    tech_log = u11 < 0.5
    u2 = torch.abs(2.0 * u11 - 1.0)
    z_log = r * torch.clamp(v * u2, min=1e-12)
    trunc = 1.0 - torch.exp(-q_scr * r)
    z_exp = -torch.log(torch.clamp(1.0 - v * trunc, min=1e-12)) / q_scr
    az = torch.minimum(torch.where(tech_log, z_log, z_exp), r)
    zeta = side * az
    p_log = -torch.log(torch.clamp(az / r, min=1e-12)) / (2.0 * r)
    p_exp = q_scr * torch.exp(-q_scr * az) / (
        2.0 * torch.clamp(trunc, min=1e-12))
    p_mix = 0.5 * (p_log + p_exp)
    g_ch = torch.clamp(screened_greens_2d(az, r, sbar), min=0.0)
    t_cx, t_cy, s_lo, s_hi = _chord_frame(P, px, py)
    zx = px + zeta * t_cx
    zy = py + zeta * t_cy
    glxz, glyz = P.grad_log_alpha(zx, zy)
    gamma_z = -0.5 * (nxv * glxz + nyv * glyz)
    a_z = P.alpha_c(zx, zy)
    w_ch = (2.0 * gamma_z * g_ch / torch.clamp(p_mix, min=1e-30)
            * torch.sqrt(a_z / a_p))
    w_ch = torch.where((zeta >= s_lo) & (zeta <= s_hi), w_ch, 0.0)
    return zx, zy, w_ch, a_z


def _mis_nee(P: WalkParams, u5, u6, u7, u8, px, py, gx, gy, r, sbar, ob,
             t_min_w, a_p):
    """Source-directed MIS next-event estimation
    (``ops/pallas_walk.py:932-997``): the sample ``y`` from
    ``0.5 * ball Green's + 0.5 * mixture`` (``(gx, gy)`` is the Green's
    draw) and its balance-heuristic weight, before the walk weight. With
    delta tracking the ball's screened Green's function over
    ``sqrt(alpha_y alpha_x)``; without it (``a_p`` None) ``ln(R/r) /
    (2 pi)`` and its norm ``R^2 / 4`` (``:956-961``). Returns
    ``(yx, yy, w)``."""
    tab = P.mis_table.tolist()
    take_src = u5 < 0.5
    # unrolled component pick: idx = #{i < k-1 : u6 > cum_i}
    mx = torch.full_like(px, tab[0][0])
    my = torch.full_like(px, tab[0][1])
    mw = torch.full_like(px, tab[0][2])
    for ci in range(1, len(tab)):
        passed = u6 > tab[ci - 1][4]
        mx = torch.where(passed, tab[ci][0], mx)
        my = torch.where(passed, tab[ci][1], my)
        mw = torch.where(passed, tab[ci][2], mw)
    rad = torch.sqrt(-2.0 * torch.log(torch.clamp(u7, min=1e-12)))
    ang = _TWO_PI * u8
    mx = mx + mw * rad * torch.cos(ang)
    my = my + mw * rad * torch.sin(ang)
    yx = torch.where(take_src, mx, gx)
    yy = torch.where(take_src, my, gy)
    ex, ey = yx - px, yy - py
    d_y = torch.sqrt(ex * ex + ey * ey)
    d_safe = torch.clamp(d_y, min=1e-12)
    if a_p is None:
        g_val = torch.clamp(greens_2d(d_safe, r), min=0.0)
        norm = greens_norm_2d(r)
    else:
        g_val = torch.clamp(screened_greens_2d(d_safe, r, sbar), min=0.0)
        norm = screened_greens_norm_2d(r, sbar)
    in_ball = d_y < r
    if len(P.neu_table) > 0:
        # the star test: a wall between x and y blocks the sample
        _, _, _, _, t_y, hit_y = _first_hit(
            P, px, py, ex / d_safe, ey / d_safe, d_y, t_min_w)
        in_star = in_ball & ~(hit_y & (t_y < d_y))
    else:
        in_star = in_ball
    q = torch.zeros_like(px)
    for cx, cy, _, a, _, two_w2, two_pi_w2 in tab:
        qx, qy = yx - cx, yy - cy
        q = q + a * torch.exp(-(qx * qx + qy * qy) / two_w2) / two_pi_w2
    # an on-boundary walker samples a hemisphere: double its density
    m_ob = 1.0 + ob.to(torch.float32)
    p_ball = torch.where(in_ball, m_ob * g_val / norm, 0.0)
    p_mix = 0.5 * p_ball + 0.5 * q
    w = torch.where(in_star & (p_mix > 1e-30),
                    m_ob * g_val / torch.clamp(p_mix, min=1e-30), 0.0)
    if a_p is None:
        return yx, yy, w
    a_y = P.alpha_c(yx, yy)
    return yx, yy, w / torch.sqrt(a_y * a_p)


def _step(s, P: WalkParams, consts, a_p0, a_cur, freeze_thr=None):
    """One walk step over every lane (the kernel's step body, masked);
    ``freeze_thr`` (freeze builds) stops lanes with ``|atten|`` above it.
    ``consts`` ends with the stream seed."""
    p0x, p0y, sid, ob0, n0x, n0y, seed = consts
    n_src = P.n_src
    px, py, nxv, nyv, atten = s["px"], s["py"], s["nx"], s["ny"], s["atten"]
    accs = [s[f"acc{i}"] for i in range(n_src)]
    quota, steps, ndone = s["quota"], s["steps"], s["ndone"]
    ob = s["ob"] != 0
    act = quota > 0

    # per-lane (walk#, step#) counter, u32
    ctr = (rng.mul32(ndone.to(torch.int64), P.max_steps + 2)
           + steps.to(torch.int64)) & rng.MASK32
    chain = P.robin == ROBIN_CHAIN
    mis = P.mis_table is not None
    delta = P.delta
    # delta tracking draws stream 4 (the collision), a walk without it
    # streams 2/3 (the Green's radius) when it samples a source; MIS
    # draws streams 5-8; the chain 9/10/11 (branch, side + U1, technique +
    # U2)
    streams = ((1,) + ((4,) if delta else (2, 3) if P.sources else ())
               + ((5, 6, 7, 8) if mis else ())
               + ((9, 10, 11) if chain else ()))
    u = dict(zip(streams, _uniforms(seed, ctr, sid, streams)))
    u1 = u[1]

    dD, cx, cy = _closest_point(P, px, py)
    done_eps = dD <= P.eps
    walk_done = act & (done_eps | (steps >= P.max_steps))
    if P.project:
        bx = torch.where(done_eps, cx, px)
        by = torch.where(done_eps, cy, py)
    else:
        bx, by = px, py
    g_bc = P.bc(bx, by) * atten
    bank_mag = torch.zeros_like(g_bc)
    for i in range(n_src):
        contrib = accs[i] + g_bc
        s[f"asum{i}"] = s[f"asum{i}"] + torch.where(walk_done, contrib, 0.0)
        s[f"asq{i}"] = s[f"asq{i}"] + torch.where(
            walk_done, contrib * contrib, 0.0)
        bank_mag = torch.maximum(bank_mag, torch.abs(contrib))
    s["bmax"] = torch.maximum(s["bmax"], torch.where(walk_done, bank_mag, 0.0))
    wd_i = walk_done.to(torch.int32)
    s["ndone"] = ndone + wd_i
    s["quota"] = quota - wd_i
    truncated = walk_done & ~done_eps & (torch.abs(atten) > 0.0)
    s["tn"] = s["tn"] + truncated.to(torch.float32)
    s["tw"] = s["tw"] + torch.where(truncated, torch.abs(atten), 0.0)

    px = torch.where(walk_done, p0x, px)
    py = torch.where(walk_done, p0y, py)
    accs = [torch.where(walk_done, 0.0, a) for a in accs]
    atten = torch.where(walk_done, 1.0, atten)
    if P.snap:
        ob = (walk_done & ob0) | (ob & ~walk_done)
        nxv = torch.where(walk_done, n0x, nxv)
        nyv = torch.where(walk_done, n0y, nyv)
    else:
        ob = ob & ~walk_done
    steps = torch.where(walk_done, 0, steps)
    stepping = act & ~walk_done
    if freeze_thr is not None:
        # heavy lanes wait for the launch-boundary split: they draw
        # nothing and advance no counter, a fixed point for the launch
        stepping = stepping & (torch.abs(atten) <= freeze_thr)

    if len(P.vert_table) > 0:
        # the star radius stops at the nearest silhouette vertex
        r = torch.clamp(torch.minimum(dD, _silhouette(P, px, py)),
                        min=P.rmin)
    else:
        r = torch.clamp(dD, min=P.rmin)
    if P.majorant is not None:
        # two-level local majorant: shrink the ball out of the high-sigma'
        # regions and walk at the background majorant where that promises
        # more progress min(radius, 1/sqrt(sigma_bar))
        d_far = P.majorant.distance(px, py)
        rB = torch.minimum(r, d_far)
        useB = (d_far >= P.rmin) & (torch.clamp(rB, max=P.mfp_bg)
                                    > torch.clamp(r, max=P.mfp_gl))
        r = torch.where(useB, rB, r)
        sbar = torch.where(useB, torch.full_like(r, P.sb_bg),
                           torch.full_like(r, P.sigma_bar))
    else:
        sbar = torch.full_like(r, P.sigma_bar)
    if P.robin != ROBIN_OFF:
        r, c_mag, c_ch = _robin_chord_mass(P, px, py, nxv, nyv, ob, r, sbar)
        if P.robin == ROBIN_REFLECTANCE:
            atten = torch.where(stepping & ob, atten / (1.0 - c_ch), atten)

    # one sin/cos pair: free direction at 2 phi, hemisphere rotation at phi
    phi = math.pi * u1
    cphi = torch.cos(phi)
    sphi = torch.sin(phi)
    dx = 1.0 - 2.0 * sphi * sphi
    dy = 2.0 * sphi * cphi
    has_neumann = len(P.neu_table) > 0
    if has_neumann:
        cb = sphi
        sb = -cphi
        hdx = nxv * cb - nyv * sb
        hdy = nyv * cb + nxv * sb
        dx = torch.where(ob, hdx, dx)
        dy = torch.where(ob, hdy, dy)
        t_min_w = torch.where(ob, P.t_min, 0.0)
        hx, hy, hnx, hny, t_hit, hit = _first_hit(
            P, px, py, dx, dy, r, t_min_w)
    else:
        hx = px + r * dx
        hy = py + r * dy
        hnx = torch.zeros_like(px)
        hny = torch.zeros_like(px)
        t_hit = r
        hit = torch.zeros_like(ob)

    def draw_r(round_idx):
        sd = (seed ^ 0xA5A5A5A5 ^ (round_idx * 0x68E31DA4)) & rng.MASK32
        return _uniforms(sd, ctr, sid, (1, 2, 3, 4))

    if delta:
        if P.transport:
            r_s, w_rej = sample_screened_radius_transport(draw_r, r, sbar)
        else:
            r_s, w_rej = _exact_rejection(draw_r, r, sbar,
                                          P.rejection_rounds,
                                          with_weight=True)
        atten = torch.where(stepping, atten * w_rej, atten)
    elif P.sources:
        r_s = sample_greens_radius(r, u[2], u[3])
    else:
        r_s = r
    beyond = r_s > t_hit
    sx = torch.where(beyond, hx, px + r_s * dx)
    sy = torch.where(beyond, hy, py + r_s * dy)

    if delta:
        a_p = torch.where(walk_done, a_p0, a_cur)
        a_s = P.alpha_c(sx, sy)
        if mis:
            yx, yy, w_mis = _mis_nee(
                P, u[5], u[6], u[7], u[8], px, py, px + r_s * dx,
                py + r_s * dy, r, sbar, ob,
                t_min_w if has_neumann else None, a_p)
            w_mis = torch.where(stepping, w_mis * atten, 0.0)
            for i, f in enumerate(P.sources):
                accs[i] = accs[i] + torch.where(stepping, f(yx, yy) * w_mis,
                                                0.0)
        elif P.sources:
            w_src = (screened_greens_norm_2d(r, sbar) / torch.sqrt(a_s * a_p)
                     * atten)
            live = stepping & ~beyond
            w_eff = torch.where(live, w_src, 0.0)
            for i, f in enumerate(P.sources):
                accs[i] = accs[i] + torch.where(live, f(sx, sy) * w_eff,
                                                0.0)

        p_int = screened_interior_prob(r, sbar)
        interior = u[4] < p_int
        collide = interior & ~(hit & (r_s >= t_hit - P.t_min))
        a_h = P.alpha_c(hx, hy)
        sp_s = P.sigma_prime(sx, sy)
        # signed null-collision factor: no zero clamp (weighted delta
        # tracking)
        scale_int = torch.sqrt(a_s / a_p) * (1.0 - sp_s / sbar)
        scale_edge = torch.sqrt(a_h / a_p)
        atten_pre = atten  # chord-branch lanes skip the move's scale
        if P.robin != ROBIN_OFF and bool(hit.any()):
            # Robin wall-arrival weight 1 + gamma rho / cos(phi): signed,
            # with the grazing cosine clamped (lanes that hit no wall keep
            # their factor 1)
            glx, gly = P.grad_log_alpha(hx, hy)
            gamma = -0.5 * (hnx * glx + hny * gly)
            cosphi = torch.clamp(-(dx * hnx + dy * hny),
                                 min=P.robin_arrival_clamp)
            rho = screened_greens_wall_ratio(t_hit, r, sbar)
            scale_edge = scale_edge * torch.where(
                hit, 1.0 + gamma * rho / cosphi, 1.0)
        atten = torch.where(
            stepping, atten * torch.where(collide, scale_int, scale_edge),
            atten)
        newx = torch.where(collide, sx, hx)
        newy = torch.where(collide, sy, hy)
        a_next = torch.where(collide, a_s, a_h)
        new_ob = hit & ~collide
        if chain:
            # on-boundary chord continuation: branch with q = min(1/2, |c|);
            # the branch weight is an O(1) density ratio, the other lanes of
            # the wall pay 1 / (1 - q)
            q_c = torch.where(ob, torch.clamp(c_mag, max=0.5), 0.0)
            branch = stepping & (u[9] < q_c) & (q_c > 1e-6)
            stay = atten * torch.where(stepping & ob & (q_c > 1e-6),
                                       1.0 / (1.0 - q_c), 1.0)
            if bool(branch.any()):  # else every lane keeps its move
                zx, zy, w_ch, a_z = _chord_branch(
                    P, u[10], u[11], px, py, nxv, nyv, r, sbar, a_p)
                newx = torch.where(branch, zx, newx)
                newy = torch.where(branch, zy, newy)
                a_next = torch.where(branch, a_z, a_next)
                new_ob = new_ob | branch
                stay = torch.where(
                    branch, atten_pre * w_ch / torch.clamp(q_c, min=1e-6),
                    stay)
            atten = stay
        if P.max_attenuation is not None:
            # symmetric: chord weights can be negative (the kernel clips the
            # lanes it steps; a cap >= 1 leaves the others as they are)
            m = P.max_attenuation
            atten = torch.where(stepping, torch.clamp(atten, -m, m), atten)
    else:
        # the walker jumps to the ball's edge or its Neumann hit; a source
        # is sampled at the Green's radius with the weight R^2 / 4, or
        # toward the MIS mixture
        if mis:
            yx, yy, w_mis = _mis_nee(
                P, u[5], u[6], u[7], u[8], px, py, px + r_s * dx,
                py + r_s * dy, r, sbar, ob,
                t_min_w if has_neumann else None, None)
            w_mis = torch.where(stepping, w_mis, 0.0)
            for i, f in enumerate(P.sources):
                accs[i] = accs[i] + torch.where(stepping, f(yx, yy) * w_mis,
                                                0.0)
        elif P.sources:
            live = stepping & ~beyond
            w_eff = torch.where(live, greens_norm_2d(r), 0.0)
            for i, f in enumerate(P.sources):
                accs[i] = accs[i] + torch.where(live, f(sx, sy) * w_eff,
                                                0.0)
        newx, newy, new_ob = hx, hy, hit

    px = torch.where(stepping, newx, px)
    py = torch.where(stepping, newy, py)
    ob = (stepping & new_ob) | (~stepping & ob)
    upd_n = stepping & hit
    if chain:
        upd_n = upd_n & ~branch  # a chord stays on its own wall
    nxv = torch.where(upd_n, hnx, nxv)
    nyv = torch.where(upd_n, hny, nyv)
    steps = steps + stepping.to(torch.int32)

    if P.roulette_threshold is not None:
        thr = P.roulette_threshold
        (u_r,) = _uniforms(seed ^ 0x0F1E2D3C, ctr, sid, (1,))
        low = stepping & (torch.abs(atten) < thr)
        survive = u_r * thr < torch.abs(atten)
        atten = torch.where(
            low,
            torch.where(survive, torch.where(atten < 0.0, -thr, thr), 0.0),
            atten)
        steps = torch.where(low & ~survive, P.max_steps, steps)

    s["life"] = s["life"] + stepping.to(torch.int32)
    s["wmax"] = torch.maximum(
        s["wmax"], torch.where(stepping, torch.abs(atten), 0.0))
    if delta:
        a_cur = torch.where(stepping, a_next,
                            torch.where(walk_done, a_p0, a_cur))
    s.update(px=px, py=py, nx=nxv, ny=nyv, atten=atten, steps=steps,
             ob=ob.to(torch.int32))
    for i in range(n_src):
        s[f"acc{i}"] = accs[i]
    return a_cur


def _freeze_threshold(params: WalkParams, freeze_thr):
    """The launch's freeze threshold as a float32 value: ``+inf`` for a
    freeze build given none, ``None`` without the freeze."""
    if not params.freeze:
        if freeze_thr is not None:
            raise ValueError("freeze_thr needs a freeze build: "
                             "make_walk_params(..., freeze_split=True)")
        return None
    return math.inf if freeze_thr is None else float(np.float32(freeze_thr))


def _movable(P: WalkParams, thr: float, flat: dict, idx):
    """Which lanes ``idx`` (with quota) a freeze launch can still change:
    those at or under the threshold, and those whose walk ends at the next
    step (it banks before the freeze test)."""
    atten = flat["atten"][idx]
    px, py = flat["px"][idx], flat["py"][idx]
    due = ((flat["steps"][idx] >= P.max_steps)
           | (_closest_point(P, px, py)[0] <= P.eps))
    return (torch.abs(atten) <= thr) | due


def _graphable(P: WalkParams) -> bool:
    """Whether the plain step holds no host synchronization, so that a
    CUDA graph can capture it: without the Robin correction (its wall
    tests and chain branch ask the host) and with at most four rejection
    rounds (more loop on a host test)."""
    return P.robin == ROBIN_OFF and (not P.delta or P.transport
                                     or P.rejection_rounds <= 4)


def _captured_step(flat: dict, carried, P: WalkParams, consts, a_p0, thr):
    """One :func:`_step` over every lane of ``flat``, its ``carried``
    planes updated in place, captured as a CUDA graph: each replay runs the
    step's kernels, the same as launched one by one, from one host call."""
    side = torch.cuda.Stream(device=flat["px"].device)
    side.wait_stream(torch.cuda.current_stream(flat["px"].device))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side):
        graph.capture_begin()
        s = {k: flat[k] for k in carried}
        s["a_cur"] = _step(s, P, consts, a_p0, s["a_cur"], thr)
        for k in carried:
            flat[k].copy_(s[k])
        graph.capture_end()
    torch.cuda.current_stream(flat["px"].device).wait_stream(side)
    return graph


def walk_plain(state: dict, params: WalkParams, inner_steps: int,
               freeze_thr=None) -> dict:
    """The plain PyTorch version of the walk kernel, on any device.

    Same step, op for op, as ``csrc/walk_kernel.cu``; work whose result
    no lane takes (a chord-mass shrink round, the chain's branch, the
    Robin arrival weight of a step without a wall hit) is skipped, which
    changes no value. Every ``EXIT_CHECK``
    steps the lanes that can still change are gathered and only those are
    stepped until the next check: exact, because a step of a lane without
    quota changes nothing, nor does one of a lane frozen by ``freeze_thr``
    (freeze builds) whose walk is not due to end, for the rest of the
    launch (the kernel's per-thread exits rest on the same facts). On a
    card, a step without host synchronization (:func:`_graphable`) is
    captured once as a CUDA graph over every lane after the launch's first
    step and replayed, the lanes still checked every ``EXIT_CHECK`` steps:
    the same kernels on the same values (a step that leaves a lane
    unchanged does so on every lane it covers), without the host's cost of
    some hundred kernel launches a step. A launch over several shards
    (:meth:`WalkParams.shard_table`) walks each shard's lanes with its
    seed, one shard after another: the same batches
    of lanes as a launch of that shard alone (PyTorch's CPU kernels may
    round an element by where it falls in a batch: its ``sigmoid`` rounds a
    batch's tail through another ``exp``). Updates the mutable planes of
    ``state`` in place and returns it.
    """
    seeds, per = params.shard_table(state["px"].numel())
    if len(seeds) > 1:
        for k, seed in enumerate(seeds.tolist()):
            one = params._cache.get(("shard", k))
            if one is None:
                one = params._cache[("shard", k)] = dataclasses.replace(
                    params, seed=seed, shard_seeds=(), shard_lanes=0)
            walk_plain({n: v.reshape(-1)[k * per:(k + 1) * per]
                        for n, v in state.items()}, one, inner_steps,
                       freeze_thr)
        return state
    P = params
    thr = _freeze_threshold(P, freeze_thr)
    names = state_planes(P.n_src)
    flat = {k: v.reshape(-1) for k, v in state.items()}
    # the alpha cache of delta tracking (a walk without it reads none)
    alpha_c = P.alpha_c if P.delta else (lambda x, y: torch.zeros_like(x))
    flat["a_p0"] = alpha_c(flat["p0x"], flat["p0y"])
    flat["a_cur"] = alpha_c(flat["px"], flat["py"])
    flat["sid64"] = flat["sid"].to(torch.int64) & rng.MASK32
    carried = list(names) + ["a_cur"]
    idx, sub = None, None
    graph = flat["px"].is_cuda and _graphable(P)
    for i in range(int(inner_steps)):
        if graph and i > 0:
            if i == 1:  # the first step ran: every table is on the card
                for k in carried:
                    flat[k][idx] = sub[k]
                sub = None
                consts = (flat["p0x"], flat["p0y"], flat["sid64"],
                          flat["ob0"] != 0 if P.snap else None,
                          flat["n0x"] if P.snap else None,
                          flat["n0y"] if P.snap else None, P.seed)
                step = _captured_step(flat, carried, P, consts,
                                      flat["a_p0"], thr)
            if i % EXIT_CHECK == 0:
                live = flat["quota"] > 0
                if thr is not None:
                    live = live & _movable(P, thr, flat, slice(None))
                if not bool(live.any()):
                    break
            step.replay()
            continue
        if i % EXIT_CHECK == 0:
            if sub is not None:
                for k in carried:
                    flat[k][idx] = sub[k]
            idx = torch.nonzero(flat["quota"] > 0).squeeze(1)
            if thr is not None:
                idx = idx[_movable(P, thr, flat, idx)]
            if idx.numel() == 0:
                sub = None
                break
            sub = {k: flat[k][idx] for k in carried}
            consts = (flat["p0x"][idx], flat["p0y"][idx], flat["sid64"][idx],
                      flat["ob0"][idx] != 0 if P.snap else None,
                      flat["n0x"][idx] if P.snap else None,
                      flat["n0y"][idx] if P.snap else None, P.seed)
            a_p0 = flat["a_p0"][idx]
        sub["a_cur"] = _step(sub, P, consts, a_p0, sub["a_cur"], thr)
    if sub is not None:
        for k in carried:
            flat[k][idx] = sub[k]
    for k in names:  # a no-op for contiguous planes, whose flat form is a view
        state[k] = flat[k].view(state[k].shape)
    return state


def compare_planes(a: dict, b: dict, names):
    """How closely two walker states agree, plane by plane.

    Integer planes agree on a lane when they are equal. Float planes agree
    where ``|a - b| <= PLANE_RTOL * max(|a|, |b|) + PLANE_FLOOR * max|b|``
    over the plane, after values below float32's smallest normal are
    flushed to zero. The floor and the flush serve the accumulator
    planes: far from the electrodes the source is a Gaussian tail (e^-85
    at 6.5 m from a 0.5 m wide electrode), where one-ulp sin/cos/exp
    differences between math libraries grow to ~3e-4 relative on values
    1e-6 of the plane's scale and below; XLA's CPU backend also flushes
    subnormal results to zero where PyTorch keeps them. Two walks match when every plane agrees
    on at least ``PLANE_MIN_FRAC`` of the lanes and all values are finite
    (rare one-ulp trajectory flips are allowed).

    Returns ``(frac, max_err, finite)``: the agreeing fraction of lanes per
    plane, the largest ``|a - b|`` over agreeing float lanes, and whether
    every float value of both states is finite.
    """
    tiny = torch.finfo(torch.float32).tiny
    frac, max_err, finite = {}, 0.0, True
    for k in names:
        x, y = a[k].reshape(-1), b[k].reshape(-1)
        if x.dtype.is_floating_point:
            finite &= bool(torch.isfinite(x).all() & torch.isfinite(y).all())
            x = torch.where(x.abs() < tiny, 0.0, x.double())
            y = torch.where(y.abs() < tiny, 0.0, y.double())
            err = (x - y).abs()
            ok = err <= PLANE_RTOL * torch.maximum(x.abs(), y.abs()) \
                + PLANE_FLOOR * y.abs().max()
            if bool(ok.any()):
                max_err = max(max_err, float(err[ok].max()))
        else:
            ok = x == y
        frac[k] = float(ok.double().mean())
    return frac, max_err, finite


# ---------------------------------------------------------------------- #
# CUDA kernel: build, bind, launch                                       #
# ---------------------------------------------------------------------- #

def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    return "/usr/local/cuda/bin/nvcc"


def variant_macros(variant, large: bool = False) -> list:
    """The ``-D`` macros that build ``variant``'s library
    (``csrc/walk_kernel.cu`` compiles the one variant they name), and
    ``WALK_LARGE`` for its large-table build (:func:`large_scans`)."""
    return [f"-DWALK_{name.upper()}={int(v)}"
            for name, v in zip(SWITCHES, _switches(variant))] + (
                ["-DWALK_LARGE=1"] if large else [])


@functools.lru_cache(maxsize=1)
def _source_key() -> str:
    """The hash of the kernel's source, the files it includes and the
    flags: a library built from other sources or flags is never loaded."""
    return hashlib.sha256(_SRC.read_bytes() + _RULES.read_bytes()
                          + _STEP.read_bytes()
                          + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]


def _library_path(variant, large: bool = False) -> Path:
    return (_BUILD_DIR / f"walk_kernel-{_source_key()}-"
                         f"{build_code(variant, large)}.so")


def nvcc_command(variant, out, large: bool = False) -> list:
    """The ``nvcc`` command line that builds ``variant``'s library (its
    large-table build with ``large``) into ``out``: the flags, the
    variant's switches as macros, the source."""
    return [_nvcc(), *NVCC_FLAGS, *variant_macros(variant, large), "-o",
            str(out), str(_SRC)]


# ptxas's resource report of each library this process built, by code
build_logs = {}


def _build_one(variant, large=False):
    """Compile ``variant``'s library (its large-table build with
    ``large``) unless it is there; atomic (a build into a private file,
    then ``os.replace``), so processes building the same variant at once
    each leave a whole library. Returns ``(code, path, log, built)``, the
    code :func:`build_code`'s; raises with nvcc's log when it fails."""
    # (the variant's own build by one argument, as callers that stand in
    # for _library_path and _library give them)
    code = build_code(variant, large)
    path = _library_path(variant, True) if large else _library_path(variant)
    if path.exists():
        return code, path, "", False
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(nvcc_command(variant, tmp, large),
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}) building "
                f"{kernel_name(variant)}{' (large)' if large else ''} "
                f"(code {code}):\n{proc.stdout}")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    build_logs[code] = proc.stdout
    return code, path, proc.stdout, True


def build_library(variants, large=()):
    """Build the libraries of ``variants`` (variant tuples; invalid ones
    raise), and the large-table builds of the variants in ``large``
    (:func:`culled_scans` ones), into ``_build/``, one ``nvcc`` process
    per CPU at a time, skipping those of the same source and flags already
    there. Returns ``(paths, seconds, log)``: the libraries by build code
    (:func:`build_code`), the wall time and nvcc's resource reports of the
    libraries built (empty when nothing was built). Every failure raises,
    with nvcc's log, after the other builds end."""
    todo = {}
    for v, big in [(v, False) for v in variants] + [(v, True)
                                                     for v in large]:
        fault = variant_fault(v)
        if fault is None and big and not culled_scans(v):
            fault = "a large-table build is the culled variant's"
        if fault is not None:
            raise ValueError(f"{kernel_name(v)}: {fault}")
        todo[build_code(v, big)] = (_canonical(v), big)
    t0 = time.perf_counter()
    paths, logs, failed, built = {}, [], [], False
    with ThreadPoolExecutor(max_workers=os.cpu_count() or 1) as pool:
        futures = [pool.submit(_build_one, *b) for b in todo.values()]
        for fut in futures:
            try:
                code, path, out, fresh = fut.result()
            except RuntimeError as exc:
                failed.append(str(exc))
                continue
            paths[code] = path
            logs.append(out)
            built |= fresh
    if failed:
        raise RuntimeError("\n".join(failed))
    seconds = time.perf_counter() - t0 if built else 0.0
    return paths, seconds, "".join(logs)


@functools.lru_cache(maxsize=None)
def _library(variant, large=False):
    """The loaded library of ``variant`` (canonical; its large-table
    build with ``large``), built first if it is not there; its compiled
    switches are read back and must be the build's."""
    _, path, _, _ = _build_one(variant, large)
    lib = ctypes.CDLL(str(path))
    got = (ctypes.c_int * (len(SWITCHES) + 1))()
    if lib.walk_switches(got, len(SWITCHES) + 1) != 0 or \
            tuple(got) != tuple(int(v) for v in _switches(variant)) + (
                int(large),):
        raise RuntimeError(f"{path} holds switches {tuple(got)}, not "
                           f"{kernel_name(variant)}'s"
                           f"{' large-table build' if large else ''}")
    layout = (ctypes.c_int * 2)()
    if large and (lib.walk_large_layout(layout, 2) != 0
                  or tuple(layout) != (SIL_ROWS, GROUP_CHUNKS)):
        raise RuntimeError(f"{path} reads records of {tuple(layout)} rows "
                           f"and chunks, not {(SIL_ROWS, GROUP_CHUNKS)}")
    # (a library built from a checkout before the shard table and the
    # chunk records, as chip_probes/ launch for an A/B, has no
    # walk_chunk_rows and leaves the trailing arguments unread)
    if hasattr(lib, "walk_chunk_rows") and \
            lib.walk_chunk_rows() != CHUNK_ROWS:
        raise RuntimeError(f"{path} cuts its tables into chunks of "
                           f"{lib.walk_chunk_rows()} rows, not {CHUNK_ROWS}")
    lib.walk_launch.argtypes = LAUNCH_ARGTYPES
    lib.walk_launch.restype = ctypes.c_int
    if hasattr(lib, "walk_plan"):
        lib.walk_plan.argtypes = PLAN_ARGTYPES
        lib.walk_plan.restype = ctypes.c_int
    return lib


# walk_launch's arguments (csrc/walk_kernel.cu)
LAUNCH_ARGTYPES = [ctypes.c_void_p, ctypes.c_int,   # fp
                   ctypes.c_void_p, ctypes.c_int,   # ip
                   ctypes.c_void_p, ctypes.c_int,   # planes
                   ctypes.c_int, ctypes.c_int,      # lanes, budget
                   ctypes.c_float,                  # freeze
                   ctypes.c_void_p, ctypes.c_int,   # geom, grid
                   ctypes.c_void_p,                 # stream
                   ctypes.c_void_p, ctypes.c_int,   # the shard table
                   ctypes.c_int,
                   ctypes.c_void_p,                 # chunk records
                   ctypes.c_void_p, ctypes.c_void_p,  # a dealt launch's
                   ctypes.c_int]                    # plan and records
# walk_plan's: walk_launch's first sixteen, then the plan's buffers
PLAN_ARGTYPES = LAUNCH_ARGTYPES[:16] + [ctypes.c_void_p] * 3


def launch_args(state: dict, params: WalkParams):
    """``walk_launch``'s arguments but the budget, the threshold and the
    stream, for ``state`` (checked planes) and ``params``: ``(fp, ip,
    planes, geom, seeds, per_shard, chunks)``, ctypes-ready; the arrays
    stay alive with the returned tuple."""
    px = state["px"]
    fp, ip = params.pack()
    names = set(CONST_PLANES) | set(state_planes(params.n_src))
    if params.snap:
        names |= set(SNAP_PLANES)
    ptrs = [None] * len(_PLANE_ORDER)
    for name in names:
        t = state[name]
        if (t.device != px.device or t.dtype != plane_dtype(name)
                or t.shape != px.shape or not t.is_contiguous()):
            raise ValueError(
                f"plane {name!r}: expected contiguous {plane_dtype(name)} "
                f"{tuple(px.shape)} on {px.device}, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")
        ptrs[_PLANE_INDEX[name]] = t.data_ptr()
    geom = [t.data_ptr() if t.numel() else None
            for t in params.device_tables(px.device)] or [None] * 3
    grid = params.grid_table(px.device)
    geom.append(None if grid is None else grid.data_ptr())
    seeds, per = params.shard_table(px.numel())
    chunks = params.chunk_table(px.device)
    return (fp, ip, (ctypes.c_void_p * len(ptrs))(*ptrs),
            (ctypes.c_void_p * len(geom))(*geom), seeds, per,
            None if chunks is None else chunks.data_ptr())


# the kernel's planes: the narrow form's, then the wide form's moment
# planes of sources MAX_SRC..
_PLANE_ORDER = (CONST_PLANES + SNAP_PLANES + tuple(state_planes(MAX_SRC))
                + tuple(f"{k}{i}" for k in ("acc", "asum", "asq")
                        for i in range(MAX_SRC, MAX_WIDE_SRC)))
_PLANE_INDEX = {name: i for i, name in enumerate(_PLANE_ORDER)}


def launch_loop(lib, state: dict, params: WalkParams, inner_steps: int,
                freeze_thr=None, stream=None) -> str:
    """One launch of ``lib`` (``params``' variant's library, or a host
    build of it) over ``state``'s planes, in place; returns the loop it
    ran: ``"dealt"`` (walks dealt to the threads), ``"lanes"`` (one thread
    a lane), ``"shards"`` (the same over several shards) or ``"repack"``
    (the repack loop). A launch of a :func:`dealt` build that holds one
    shard and whose budget covers a walk (``max_steps + 1`` iterations)
    asks the library for its plan (``walk_plan``: one read back): if every
    lane with quota stands at a walk's start and the budget covers every
    quota (``quota * (max_steps + 1)``), its walks are dealt to the
    threads and each writes a record that the fold adds in walk order
    (``"dealt"``); every other launch runs the build's own loop. The plan
    and the records are tensors on the planes' device."""
    thr = _freeze_threshold(params, freeze_thr)
    fp, ip, arr, garr, seeds, per, chunks = launch_args(state, params)
    budget = int(min(max(int(inner_steps), 0), 2**31 - 1))
    n = state["px"].numel()
    head = (fp.ctypes.data, len(fp), ip.ctypes.data, len(ip), arr,
            len(arr), n, budget, math.inf if thr is None else thr, garr,
            len(garr), stream, seeds.ctypes.data, len(seeds), per, chunks)
    v = params.variant
    loop = ("repack" if repacked(v) else
            "shards" if len(seeds) > 1 else "lanes")
    deal, keep = (None, None, 0), ()
    if (loop == "lanes" and dealt(v) and n > 0
            and budget >= params.max_steps + 1 and hasattr(lib, "walk_plan")):
        dev = state["px"].device
        layout = (ctypes.c_int * 2)()  # lanes a plan tile, record head
        if lib.walk_dealt_layout(layout, 2) != 0:
            raise RuntimeError("the library reports no dealt layout")
        tile_lanes, rec_head = layout
        offsets = torch.empty(n + 1, dtype=torch.int32, device=dev)
        tiles = torch.empty(3 * -(-n // tile_lanes), dtype=torch.int64,
                            device=dev)
        stats = torch.empty(3, dtype=torch.int32, device=dev)
        err = lib.walk_plan(*head, offsets.data_ptr(), tiles.data_ptr(),
                            stats.data_ptr())
        if err != 0:
            raise RuntimeError(f"walk kernel plan failed: CUDA error {err}")
        walks, quota_max, stale = stats.tolist()
        if (walks > 0 and stale == 0
                and budget >= quota_max * (params.max_steps + 1)):
            records = torch.empty(walks * (rec_head + params.n_src),
                                  dtype=torch.int32, device=dev)
            deal = (offsets.data_ptr(), records.data_ptr(), walks)
            keep = (offsets, records)
            loop = "dealt"
    err = lib.walk_launch(*head, *deal)
    if err != 0:
        raise RuntimeError(f"walk kernel launch failed: CUDA error {err}")
    del keep  # the stream orders the buffers' next use after the launch
    return loop


def _launch_cuda(state: dict, params: WalkParams, inner_steps: int,
                 freeze_thr=None) -> dict:
    px = state["px"]
    if px.device.type != "cuda":
        raise RuntimeError(
            f"run_walk takes CPU or CUDA tensors, got {px.device}")
    _freeze_threshold(params, freeze_thr)  # before any build
    lib = (_library(params.variant, True) if params.large
           else _library(params.variant))
    with torch.cuda.device(px.device):
        stream = torch.cuda.current_stream(px.device).cuda_stream
        loop = launch_loop(lib, state, params, inner_steps, freeze_thr,
                           stream)
    run_walk.launches += 1
    run_walk.variant_launches[params.kernel_name] += 1
    run_walk.build_launches[params.build_name] += 1
    run_walk.loop_launches[loop] += 1
    run_walk.pole_sources[params.build_name] += len(params.poles)
    return state


def run_walk(state: dict, params: WalkParams, inner_steps: int,
             freeze_thr=None) -> dict:
    """Advance every lane by up to ``inner_steps`` steps, in place.

    CPU planes run :func:`walk_plain`; CUDA planes launch the kernel (one
    launch, counted in ``run_walk.launches``, per instantiation in
    ``run_walk.variant_launches[params.kernel_name]``, per build in
    ``run_walk.build_launches[params.build_name]`` and per loop in
    ``run_walk.loop_launches``, :func:`launch_loop`; the sources the host
    marked as poles, :attr:`WalkParams.poles`, summed per build in
    ``run_walk.pole_sources``) or raise.
    ``freeze_thr`` is the launch's freeze threshold (freeze builds only;
    ``None`` there means ``+inf``, no lane freezes).
    """
    if state["px"].device.type == "cpu":
        return walk_plain(state, params, inner_steps, freeze_thr)
    return _launch_cuda(state, params, inner_steps, freeze_thr)


run_walk.launches = 0
run_walk.variant_launches = collections.Counter()
run_walk.build_launches = collections.Counter()
run_walk.loop_launches = collections.Counter()
run_walk.pole_sources = collections.Counter()
