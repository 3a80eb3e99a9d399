#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Drives ``dcrmontecarlo_tpu_torch`` through its eight paths, each on the
kernel variants it runs: the DCR-survey forward solve (phases 3-7), the
1000 m notebook survey's accuracy path, the Robin chord chain with the
two-level local majorant (phases 8-11), the flagship notebook gate's
path, which adds MIS next-event estimation and the high-weight split
(the host launch loop with the in-launch freeze; phases 12-15), and the
topographic survey: DC resistivity over rolling hills, a heightmap
Neumann surface with silhouette vertices, walked in the kernel's table
form (phases 16-20), and the analytic-check problems: the Laplace, Poisson
and manufactured models, walks without delta tracking, the transport
sampler and the ``TERMS`` field specs of their coefficients (phases
21-26), and the survey products: the dipole-dipole pseudosection, the
E-field, the sensitivity maps and the survey Jacobian, with MIS without
delta tracking and the kernel's wide form for more than four sources or
eight mixture components (phases 27-31), and the validation and
diagnostics path: the cylinder-series oracle's Monte Carlo tier on a
gridded Dirichlet field, walk histories, the occupancy profile and the
martingale audit (phases 32-35), and the sharded solve: a mesh of
shards, each running the kernel's launch loop with its own seed and clone
range, on virtual shards of the one card and across two processes
(phases 36-39), and the paths the kernel's other switch combinations open
on the card: the survey with the high-weight split, the terrain with the
flagship's estimator, and a sweep of twelve variants in which every pair
of switch values occurs (phases 40-42), and the main path's survey with
the transport sampler and with MIS at full size (phase 43). Each phase
reports on its own line:

1. environment: torch, CUDA, nvcc and the card (name and power limit);
2. build of the walk kernel from ``csrc/walk_kernel.cu``, one library per
   variant the script launches (``SCRIPT_VARIANTS``: the paths' 21,
   phases 40-41's two, the sweep's twelve), one ``nvcc`` process per
   CPU at a time; at the end, no library was built after it and as many
   were loaded. The freeze builds and the chain builds without the
   freeze (``walk_variant.h::repacked``) run the repack loop
   (``csrc/walk_kernel.cu``, ``walk_repacked``): its block size, round
   length and refill threshold are printed with each such build's
   registers, shared memory and blocks on the card at once, and the
   phase fails if the flagship's or the grid flagship's build spills.
   Beside them, phases 11, 26, 30 and 38's four variants with site clocks
   in the one-thread loop (``chip_probes/step_sites.py``);
3. kernel vs plain version, one 32-step launch at 8,192 lanes of the
   survey problem with its default options (``walk_kernel.compare_planes``:
   every plane agrees on >= 99% of lanes to rel 1e-4 above a floor of
   1e-6 x the plane's largest value);
4. kernel vs plain version, a whole solve of 9 points x 512 walks: both
   draw the same counter-hash streams, so total steps must be equal and
   each mean within 1e-3 x (|mean| + combined stderr);
5. physics: the survey against the finite-volume oracle (the port's own
   copy, ``dcrmontecarlo_tpu_torch.validation``; >= 8/9 electrodes within
   4 sigma + 2e-4);
6. full size: the benchmark configuration (9 points x 2^19 walks,
   147,456 walker lanes): one warm-up solve through ``WoStSolver.solve``
   (its launches counted, by variant and by loop: its one launch deals
   walks to the threads), then 3 timed solves (walker-steps/s, s/solve,
   lane occupancy, the kernel's share of the wall time);
7. kernel vs plain version for 256 steps at the full-size state of
   phase 6 (rounds 1, no CRN or roulette; one thread a lane): both timed,
   then held to the rule of phase 3. The survey variant's record takes
   its numbers from here. Then the solve's single launch from that
   state, its walks dealt to the threads (``dealt_launch``): timed, its
   bound, bit for bit equal to the one-thread loop in 256-step launches
   until drained, and to the plain walk at 1,152 lanes.
8. kernel vs plain version, one 32-step launch at 8,192 lanes of the
   notebook accuracy configuration (``local_majorant="auto"``, survey
   defaults) after 200 plain steps, with the chord chain and with the
   reflectance fold, under the rule of phase 3; and each mechanism ran:
   the same launch with the Robin correction, or the majorant, switched
   off differs on >= 1% of lanes in ``atten`` or ``px``;
9. kernel vs plain version, a whole solve of 21 points x 512 walks at the
   accuracy configuration: equal total steps, each mean within
   1e-3 x (|mean| + combined stderr);
10. physics: the ``bench.py --preset accuracy`` configuration (8 seeds x
    4096 walks, ``target_slots=1<<17``) through ``DCRSurvey.run`` at the
    survey's electrodes, against the pinned 401^2 finite-volume oracle
    (``validation/pins/notebook_oracle.npz``); every seed must hold all 20
    dipole voltages within 4 sigma + 0.25, a median signed potential error
    in (-25, +3) and >= 19/21 potentials within 4 sigma + 3.5;
11. full size of the accuracy path: 21 points x 2^20 walks,
    ``target_slots=1<<21, min_quota=32`` (688,128 lanes), a warm-up and
    3 timed solves as in phase 6, then 256
    steps of kernel and plain version at that state, timed and held to
    the rule of phase 3 (on the first 147,456 lanes if the plain version
    would take over 30 s), the variant's registers and its step's sites'
    shares (the site clocks of phase 2). The accuracy variant's record
    takes its numbers from here; the reflectance fold with the majorant
    and the
    majorant alone, which no path launches, get their times and bounds
    from the same state (a log line each, no record).
12. kernel vs plain version, one 32-step launch at 8,192 lanes of the
    flagship configuration (``source_mis=True``, ``local_majorant="auto"``,
    ``split_threshold=4.0``: chain + majorant + MIS + freeze) after 200
    plain steps, with the freeze at 4.0, under the rule of phase 3; and
    each mechanism ran: without the mixture >= 1% of lanes bank otherwise,
    >= 1 lane ends the launch frozen, the same launch at ``thr = +inf``
    differs. Then the same for the survey with ``source_mis`` (MIS on the
    survey path), whose record takes its times from 256 steps at phase
    7's full-size state with the mixture, and its launches from a survey
    solve with ``source_mis``; then the solve's single launch from that
    state, its walks dealt to the threads, as in phase 7
    (``dealt_launch``).
13. kernel vs plain version, a whole host-loop solve of the flagship
    configuration, 21 points x 256 walks, ``target_slots=1<<17``, with
    ``max_steps=150``: equal total steps, launches and clone counts, each
    mean within 1e-3 x (|mean| + combined stderr); launches and clones
    printed. (The host loop runs ~quota x max_steps steps while the
    splits go on, and the plain version's step is a few hundred small
    kernels: at ``max_steps=6000`` it had not finished after 950 s.)
14. physics: the flagship notebook gate (``tests/test_dcr_survey.py``
    ``test_notebook_survey_matches_fdm_oracle``) on the card:
    ``survey_default_options(target_slots=65536, split_threshold=4.0)``,
    2500 walks, max_steps 6000, eps 1.0, seeds 0, 1, 2, each against the
    pinned 401^2 oracle: >= 19/21 potentials within 4 sigma + 3.5, median
    signed potential error in (-25, +3), all 20 dipole voltages within
    4 sigma + 0.25.
15. full size of the flagship path: 21 points x 2^20 walks,
    ``survey_default_options(target_slots=1<<21, min_quota=32,
    split_threshold=4.0)`` (688,128 lanes), one warm-up solve through
    ``WoStSolver.solve`` and 3 timed solves (walker-steps/s, s/solve,
    launches and clones per solve, lane occupancy, and the kernel's share
    of the wall time: summed CUDA-event kernel time over the solve's), one
    more solve (seed 0) with each launch recorded (``launch_anatomy``: the
    median and max kernel ms per launch and the warp efficiency, iterations
    over the thread-slots the repack loop issues, replayed on the host),
    then 256 steps of kernel and plain version at that state with the
    freeze at 4.0, timed and held to the rule of phase 3 (on the first
    147,456 lanes if the plain version would take over 30 s). The flagship
    variant's record takes its numbers from here.
16. the table form, one launch: ``topographic_survey_problem()`` at its
    defaults (200 Neumann segments, 199 vertices: 402 rows), 9 electrodes
    draped at x = -40..40, 8,192 lanes, 256 steps of kernel and plain
    version, timed and held to the rule of phase 3; the silhouettes act
    (the same launch without the vertex table changes >= 1% of lanes in
    ``px`` or ``atten``); and a 100-segment square whose right edge is its
    table's last three rows keeps every walker inside.
17. the static form with silhouettes, the same at ``half_width=100,
    depth=150, resolution=8`` (52 rows), its launches counted over a solve
    through ``WoStSolver.solve``.
18. the chord chain on a table geometry: the test size (``resolution=4``,
    102 rows) with ``robin_correction="chain"``, the same, the chain shown
    to act (Robin off changes >= 1% of lanes).
19. kernel vs plain version, a whole solve at the test size: 9 draped
    electrodes x 512 walks, eps 0.5, max_steps 600, under phase 4's rule.
20. full size of the topographic path: the defaults, the 9 electrodes x
    2^17 walks, ``SolverOptions(target_slots=1<<21)`` (294,912 lanes),
    eps 0.5, max_steps 600: a warm-up and 3 timed solves as in phase 6
    (with the share of walks the step cap truncated), the physics of
    ``tests/test_topography.py`` (the +20 m side positive, the -20 m side
    negative, every |potential| < 1), then 256 steps of kernel and plain
    version at that state. The topographic variant's record takes its
    numbers from here.
21. no delta tracking, one launch: 256 steps of kernel and plain version
    from a fresh 8,192-lane state, held to phase 3's rule, on the harmonic
    square (``x + 2y``), the Poisson square (source -4), the Neumann box
    of ``tests/test_pallas_walk.py:142-151``, ``poisson_square(
    with_obstacle=True)`` (the static form, 31 silhouette vertices) and a
    100-row table-form square; the Green's-radius NEE acts (without the
    source >= 1% of lanes bank otherwise).
22. the transport sampler, one launch: the configuration of
    ``tests/test_pallas_walk.py:120-139`` with its alpha as a ``TERMS``
    spec (the chain resolves), the same, the sampler shown to act (the
    exact sampler in its place changes >= 1% of lanes), its launches
    counted over that test's solve; then 256 steps at phase 7's full-size
    survey state with the exact sampler at rounds 1 and 2 and with the
    transport map (best of 3 each), and the transport kernel vs plain
    there; then the solve's single launch with the transport map from
    that state, its walks dealt to the threads, as in phase 7
    (``dealt_launch``). The transport variant's record takes its numbers
    from here.
23. ``TERMS`` field specs on the card: ``variable_coefficient_problem()``
    (a ``TERMS`` alpha through the chain's alpha parts), one launch as in
    phase 21.
24. the reference's analytic checks on the card, each with the JAX test's
    configuration and bounds: the six tests of
    ``tests/test_solver_laplace.py``, the four of
    ``tests/test_solver_source.py``, four of
    ``tests/test_solver_varcoeff.py`` (the screened disk, constant alpha,
    the polynomial manufactured solution with the rejection and with the
    transport sampler) and the model tests of
    ``tests/test_models.py:17-73``, their launches counted; one whole
    Poisson solve kernel vs plain under phase 4's rule; and
    ``solve_to_tolerance`` on ``poisson_square()`` reaching its target.
25. the short-walk harmonic preset at full size (``bench.py --preset
    short``: ``x + 2y`` on the unit square, 3 points x 2^21 walks,
    ``SolverOptions(target_slots=1<<19, min_quota=32)``: 196,608 lanes):
    a warm-up and 10 timed solves (walker-steps/s, s/solve, mean walk
    length, the kernel's share), every mean within 4 sigma + 5e-3 of
    ``x + 2y``, then 256 steps at that state, whose numbers the no-delta
    record takes.
26. variable coefficients at full size: ``varcoeff_solve_points()`` (652
    points) x 4096 walks, ``SolverOptions(target_slots=1<<21,
    max_attenuation=50.0)`` (667,648 working lanes), max_steps 500: a
    warm-up and 3 timed solves (rates, occupancy, truncated share, the
    Robin mode ``"auto"`` resolves to), every solve finite with
    ``max |mean| < 5``; then 256 steps of kernel and plain version at that
    state as in phase 11 (the variant's record), its registers and its
    step's sites' shares.
27. kernel vs plain version, one launch of each new instantiation: 256
    steps from a fresh 8,192-lane state, held to phase 3's rule and timed:
    MIS without delta tracking on the square of
    ``tests/test_pseudosection.py:158-168`` and on a Neumann box (the star
    test acts), chain + MIS on the notebook survey, and the wide forms: the
    scenario line (6 sources), the Born demo's Jacobian
    (``examples/inversion_demo.py``: 8 unit dipoles, 9 components) and the
    notebook line (``examples/pseudosection_figure.py``: 18 sources, 19
    components, chain + MIS); each mechanism acts (without the mixture >=
    1% of lanes bank otherwise; the accumulators of sources 4 and on are
    non-zero).
28. kernel vs plain version, a whole solve of the scenario line's
    pseudosection problem (``survey_default_options``, 9 points x 512
    walks): equal total steps, each mean within 1e-3 x (|mean| + combined
    stderr); ``run_pseudosection`` at that size gives the kernel solve's
    means bit for bit and launches the wide survey only.
29. the reference's survey-product checks on the card, each with the JAX
    test's configuration and bounds: the nine tests of
    ``tests/test_pseudosection.py``, the three of ``tests/test_efield.py``
    and the four of ``tests/test_sensitivity.py`` (their finite-volume
    oracles by ``validation/fdm.py`` on the host).
30. full size, the notebook pseudosection (``examples/pseudosection_figure.py``:
    21 electrodes, 18 sources, 19 components, MIS + CRN, chain, eps 1.0,
    max_steps 6000) at 2^20 walks per electrode
    (``SolverOptions(target_slots=1<<21, min_quota=32,
    common_random_numbers=True)``: 688,128 lanes): ``run_pseudosection`` as
    the warm-up (its launches counted), 2 timed solves, 256 steps of kernel
    and plain version at that state, the variant's registers and its
    step's sites' shares of the one-thread loop's warp-cycles (the site
    clocks of phase 2); then at the figure's own 2000 walks,
    three source rows against single-source ``DCRSurvey.run`` solves of the
    same dipoles (>= 20/21 electrodes within 4 sigma + 0.25 each).
31. full size, the survey Jacobian at ``examples/inversion_demo.py``'s
    configuration (9 electrodes, 84 grid points, 6000 walks,
    ``n_batches=4``): a warm-up call (its launches counted, by variant
    and by loop: each batch's launch deals walks) and one timed call, then
    256 steps of kernel and plain version at its stencil state, and a
    batch's single launch there as phase 7's (``dealt_launch``).
32. the grid instantiation (the flagship's switches with the cylinder
    oracle's 257 x 257 grid as Dirichlet data): 256 steps of kernel and
    plain version from a fresh 8,192-lane state, freeze 4, held to phase
    3's rule and timed; with zero Dirichlet data the same paths, and >= 1%
    of lanes bank otherwise; 64 one-step launches equal one 64-step launch
    on every plane, bit for bit, on chain + MIS, the survey and the grid
    instantiation; a host-loop solve (21 x 128 walks, max_steps 100)
    kernel vs plain: equal steps and clones, means within 1e-3 x (|mean| +
    combined stderr).
33. the cylinder oracle's Monte Carlo tier at its test's configuration
    (``tests/test_cylinder_oracle.py::test_mc_matches_cylinder_series``:
    ``survey_default_options(target_slots=16384, split_threshold=4.0)``,
    2500 walks, max_steps 6000, eps 1.0) on seeds 0-2 with all of its
    checks: >= 18/21 potentials within 4 sigma + 3.0 of the pinned series,
    the median error in (-30, 6), the stderr-weighted sign at both current
    electrodes.
34. full size, the cylinder: 21 electrodes x 2^20 walks
    (``target_slots=1<<21, min_quota=32``: 688,128 lanes), a warm-up (its
    launches counted) and 2 timed solves, one more solve with each launch
    recorded as in phase 15, then 256 steps of kernel and plain version at
    that state; the grid record takes its numbers here.
35. the diagnostics on the card: the notebook audit of
    ``tests/test_martingale_audit.py`` (2^15 walkers x 24 steps x 4 seeds,
    normalized, the port's 201^2 finite-volume oracle as continuation)
    with its bounds; ``trace_walks`` and ``solve(return_history=True)`` on
    the survey against a solve of the same walks (equal totals and steps);
    ``profile_occupancy`` against a solve's steps.
36. the sharded launch loop (K9): a 4-shard mesh on the card
    (``make_mesh(4)``), the survey with ``survey_default_options()``, 9
    points x 128 walks, kernel vs the plain version on the same shards
    (equal steps, launches and clones per shard, phase 4's rule for the
    means); the same four shards advanced together equal them solved one
    by one, bit for bit (shards on one card launch in turn on one
    stream); one 32-step launch at 8,192 lanes of the flagship's
    instantiation without the freeze (chain + majorant + MIS, the
    flagship on a mesh) after 200 plain steps under phase 3's rule, the
    mixture shown to act; a whole sharded flagship solve with the split
    at 4.0, 21 x 64 walks, ``max_steps=100``, on 2 shards (shard 1's
    clone ids start at 0xA0000000, negative as an int32): kernel vs
    plain, equal steps and clones.
37. the configurations of ``__graft_entry__.py::dryrun_multichip`` on a
    4-shard mesh at the sizes of the tests they mirror: the survey
    against phase 5's finite-volume oracle and bound (1500 walks); CRN
    with a second source, a finite ``(2, 9)`` mean; the split at 1.5 with
    the chain within 4 sigma of the single-device chain solve; and
    ``compaction="pack"`` with the unpacked solve's steps.
38. full size on a 4-shard mesh: phase 6's configuration (a warm-up, its
    launches counted, and 3 timed solves; each within 4 sigma of phase
    6's solve of the same seed), then 256 steps of kernel and plain
    version at a shard's state (36,864 working lanes padded to 40,960),
    the K9 record; phase 15's
    flagship configuration without the freeze (a warm-up and 2 timed
    solves: launches, clones, ``max_weight``, ``max_banked``), then 256
    steps at a shard's state (172,032 lanes), the record of its
    instantiation, its registers and its step's sites' shares as in
    phase 30.
39. two processes on the card, each holding 2 of a 4-shard mesh
    (``initialize_distributed`` over gloo on a local port): both print the
    survey's 9 x 2^15-walk solve, equal to each other and to the
    one-process 4-shard mesh bit for bit.
40. the survey with the split: phase 6's configuration with
    ``split_threshold=4.0`` (``survey_split_options``: the survey's freeze
    build through the host launch loop), a warm-up (its launches counted)
    and 3 timed solves (walker-steps/s, s/solve, launches and clones,
    kernel share), each within 4 sigma of phase 6's solve of the same
    seed (split on against split off); a host-loop solve kernel vs plain
    at 9 x 256 walks (one walk a slot): equal steps, launches and clones,
    means under phase 4's rule; 256 steps at the full-size state with the
    freeze at 4, the record of its variant.
41. the terrain with the flagship's estimator
    (``terrain_flagship_problem``: ``topographic_survey_problem()`` with
    MIS toward the survey's two-component mixture at the buried current
    electrodes and ``local_majorant="auto"``, its boxes printed),
    ``survey_default_options(target_slots=1<<21, split_threshold=4.0)``,
    9 draped electrodes x 2^17 walks, eps 0.5, max_steps 600 (294,912
    lanes): a warm-up (launches counted) and 2 timed solves (rates,
    launches and clones, kernel and truncated shares), phase 20's physics
    gate, the warm-up's means within 4 sigma of phase 20's (the same
    walks and seed, the survey's estimator); 256 steps at that state,
    freeze 4, the record of its variant.
42. the variant sweep (``SWEEP``: twelve variants, each built as
    ``sweep_problem`` builds it): one 64-step launch of 8,192 lanes from
    fresh starts per variant (its launch counted), kernel vs plain under
    phase 3's rule, timed, a record each.
43. full size, the survey's transport and MIS builds
    (``survey_build_phase``): phase 6's configuration with
    ``SolverOptions(screened_sampler="transport")`` and with
    ``source_mis=True``, a warm-up (its launches counted, by variant and
    by loop: its one launch deals walks) and 3 timed solves each
    (walker-steps/s, s/solve, lane occupancy, kernel share), each within
    4 sigma of phase 6's solve of the same seed.

The second to last line of standard output is the card's
``nvidia-smi --query-gpu=name,power.limit`` line, the line before it the
kernels' JSON record (one entry per kernel variant on a path: name,
route, source, the TPU code it replaces, launches on its path's main run,
max |err| against the plain version, kernel and plain times, the bound
and what sets it, ``library_ms`` null: no single PyTorch call computes
the walk), and the last line ``{"ok": true, "device": ...}``.
Any failure exits non-zero before that line. Without a CUDA device, or
without the package beside this file, it exits non-zero and prints no
result.

    python3 chip_smoke.py              # every phase, on one GPU

A variant launched outside ``SCRIPT_VARIANTS`` would build its library at
its first launch (a few seconds of ``nvcc``).
"""

import ctypes
import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

NVSMI_QUERY = ["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"]
# the H100 SXM's published peaks (NVIDIA data sheet, at 700 W)
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
SOURCE = "dcrmontecarlo_tpu_torch/csrc/walk_kernel.cu"
REPLACES = "dcrmontecarlo_tpu/ops/pallas_walk.py:1295"


# phase 6's full-size solve: walks, max_steps, eps; and a batch of phase
# 31's Jacobian (6,000 walks in 4 batches)
SURVEY_RUN = (1 << 19, 500, 0.9)
JACOBIAN_RUN = (1500, 500, 0.3)


def survey_config(build="survey"):
    """Phase 6's main path at full size: ``(survey, electrodes,
    options)``, the geophysical scenario at sharpness 0.5 and the options
    that lay its solves on 147,456 lanes; ``build`` "transport" draws the
    screened radius by the transport map, "mis" adds the survey's MIS
    mixture (phase 43's two solves)."""
    from dcrmontecarlo_tpu_torch.models import geophysical_scenario
    from dcrmontecarlo_tpu_torch.solver import SolverOptions

    survey, electrodes = geophysical_scenario(sharpness=0.5)
    survey.source_mis = build == "mis"
    return survey, electrodes, SolverOptions(
        target_slots=1 << 21, min_quota=32, rejection_rounds=1,
        screened_sampler="transport" if build == "transport" else "exact")


def born_line():
    """The Born demo's line of phases 29-31 (``examples/inversion_demo.py``:
    9 electrodes, 8 unit dipoles, 9 mixture components): ``(survey,
    electrodes, the Jacobian's problem, its 84 grid points)``."""
    from dcrmontecarlo_tpu_torch.problems import fields
    from dcrmontecarlo_tpu_torch.survey import DCRSurvey, \
        surface_electrode_line
    from dcrmontecarlo_tpu_torch.survey import sensitivity as ssens

    elec = surface_electrode_line((-20.0, 20.0), 5.0)
    survey = DCRSurvey(half_width=60.0, depth=60.0,
                       current_a=tuple(elec[0]), current_b=tuple(elec[1]),
                       conductivity=fields.constant(1.0),
                       source_width=1.5, source_mis=True)
    gx, gy = np.linspace(-22.0, 22.0, 12), np.linspace(-20.0, -3.0, 7)
    grid = np.stack([a.ravel() for a in np.meshgrid(gx, gy, indexing="ij")],
                    1)
    return survey, elec, ssens._jacobian_problem(survey, elec), grid


def born_stencil(h=1.5):
    """Phase 31's solve points: the 5-point stencil of the Born grid
    (``survey/efield.py``), with the Jacobian's problem: ``(problem,
    points)``."""
    _, _, prob, grid = born_line()
    return prob, np.concatenate([grid + d for d in (
        [0.0, 0.0], [h, 0.0], [-h, 0.0], [0.0, h], [0.0, -h])]).astype(
            np.float32)


def log(msg):
    print(msg, flush=True)


def fail(msg):
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def survey_points(electrodes, y):
    pts = np.asarray(electrodes, np.float32).copy()
    pts[:, 1] = y
    return pts


def check_planes(wk, a, b, names, what):
    """Hold two walker states to ``walk_kernel.compare_planes``'s rule;
    returns (worst plane's agreeing fraction, max |err| on agreeing
    lanes)."""
    frac, max_err, finite = wk.compare_planes(a, b, names)
    check(finite, f"{what}: a plane holds non-finite values")
    worst = min(frac, key=frac.get)
    check(frac[worst] >= wk.PLANE_MIN_FRAC,
          f"{what}: plane {worst} agrees on only {frac[worst]:.4f} of "
          f"lanes (need {wk.PLANE_MIN_FRAC})")
    return frac[worst], max_err


def clone_state(state):
    return {k: v.clone() for k, v in state.items()}


def ptxas_report(build_log):
    """``ptxas -v``'s report per compiled kernel variant, keyed as
    ``WalkParams.kernel_name`` (``walk_kernel.kernel_name`` of the
    mangled name's switches; the kernel that a launch of several shards
    runs, in the builds without the freeze, with `` (shards)`` after it,
    and the dealt loop's, in ``walk_kernel.dealt``'s builds, with
    `` (dealt)``; the dealt launch's plan and fold kernels as
    ``walk_fold<true>`` etc. by their wide switch): registers, spill stores
    and loads (bytes) and static shared memory (bytes a block)."""
    from dcrmontecarlo_tpu_torch.ops.walk_kernel import kernel_name

    report, entry, spills = {}, None, (0, 0)
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry, spills = m.group(1), (0, 0)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            t = re.search(r"walk_(kernel|dealt)ILi(\d)((?:ELb\d)+)E", entry)
            aux = re.search(r"(walk_[a-z_]+)ILb(\d)E", entry)
            if t:
                flags = [v == "1" for v in re.findall(r"Lb(\d)", t.group(3))]
                # the last switch: the kernel of a launch of several shards
                sharded = t.group(1) == "kernel" and len(flags) == 10 and \
                    flags.pop()
                entry = kernel_name((int(t.group(2)), *flags)) + (
                    " (shards)" if sharded else
                    " (dealt)" if t.group(1) == "dealt" else "")
            elif aux:
                entry = dealt_aux_name(aux.group(1), aux.group(2) == "1")
            smem = re.search(r"(\d+) bytes smem", line)
            report[entry] = dict(registers=int(m.group(1)),
                                 spill_stores=spills[0],
                                 spill_loads=spills[1],
                                 smem=int(smem.group(1)) if smem else 0)
            entry = None
    return report


def dealt_aux_name(kernel, wide):
    """The ``ptxas_report`` key of a dealt launch's plan or fold kernel."""
    return f"{kernel}<{'true' if wide else 'false'}>"


DEALT_AUX = ("walk_plan_tiles", "walk_plan_scan", "walk_plan_offsets",
             "walk_fold")


def built_kernels(wk, v):
    """The ``ptxas_report`` keys of variant ``v``'s library: its kernel,
    the shards' kernel without the freeze, and in ``walk_kernel.dealt``'s
    builds the dealt loop and its plan and fold kernels."""
    name = wk.kernel_name(v)
    out = {name} | ({name + " (shards)"} if not v[3] else set())
    if wk.dealt(v):
        out |= {name + " (dealt)"} | {dealt_aux_name(k, v[7])
                                      for k in DEALT_AUX}
    return out


def ptxas_registers(build_log):
    """Registers per compiled kernel variant (``ptxas_report``)."""
    return {k: v["registers"] for k, v in ptxas_report(build_log).items()}


def repack_schedule(lib):
    """``(threads a block, iterations a round, free threads at which a
    block refills)`` of a loaded walk library's launch, as it exports them
    (``walk_schedule``); the last two are None in a build that runs one
    thread a lane for the whole launch."""
    out = (ctypes.c_int * 3)()
    if lib.walk_schedule(out, 3) != 0:
        raise RuntimeError("walk_schedule failed")
    block, steps, refill = out
    return block, steps or None, refill or None


def resident_blocks(block, registers, smem, sms):
    """Blocks of ``block`` threads that ``sms`` SMs hold at once at
    ``registers`` a thread and ``smem`` bytes of shared memory a block
    (H100 limits: 64K registers an SM, allocated per warp in multiples of
    8 a thread, and 228 KB of shared memory an SM, 1 KB of it reserved
    per block; 2,048 threads and 32 blocks an SM)."""
    regs = -(-registers // 8) * 8
    return sms * min(65536 // (regs * block), 233472 // (smem + 1024),
                     2048 // block, 32)


def library_resources(wk, variant):
    """``(registers a thread, static shared memory bytes a block)`` of
    ``variant``'s built library, from ``cuobjdump --dump-resource-usage``
    (a library found built has no ``ptxas`` report in this run)."""
    cuobjdump = os.path.join(os.path.dirname(wk._nvcc()), "cuobjdump")
    usage = subprocess.run([cuobjdump, "--dump-resource-usage",
                            str(wk._library_path(variant))],
                           capture_output=True, text=True,
                           timeout=120).stdout
    # a library of a build without the freeze holds a second kernel, for
    # launches of several shards (its last switch set): take the other
    kernels = re.findall(r"Function (\S+):\s*REG:(\d+)[^\n]*?SHARED:(\d+)",
                         usage)
    one = [k for k in kernels if not k[0].endswith("Lb1EEEviif")] or kernels
    if not one:  # a report without function names: its first kernel
        one = [(None, re.search(r"REG:(\d+)", usage).group(1),
                re.search(r"SHARED:(\d+)", usage).group(1))]
    return int(one[0][1]), int(one[0][2])


def issued_slots(it, schedule, resident):
    """Thread-slots a launch issues for the per-lane iterations ``it``
    (int64, in lane order) under ``schedule`` (``repack_schedule``). One
    thread per lane: each warp of 32 lanes runs to its longest lane. The
    repack loop, replayed in rounds on ``resident`` blocks at once: a
    block's free threads take the next lanes of the pool in lane order
    when at least ``refill`` are free, every live lane takes up to
    ``steps`` iterations a round and a warp costs its longest, and once
    the pool is empty a block's live lanes move to its lowest threads
    whenever that frees a warp."""
    block, steps, refill = schedule
    if steps is None:
        pad = (-it.numel()) % 32
        it = torch.cat([it, it.new_zeros(pad)]) if pad else it
        return 32 * int(it.view(-1, 32).amax(1).sum())
    n, dev = it.numel(), it.device
    rem = torch.zeros(resident, block, dtype=torch.long, device=dev)
    packed = torch.full((resident,), block, device=dev)
    p, total = 0, 0
    while True:
        live = rem > 0
        if p < n:  # the free threads of each block take the next lanes
            free = block - live.sum(1)
            take = torch.where(free >= refill, free, 0)
            start = p + take.cumsum(0) - take
            lane = start[:, None] + (~live).long().cumsum(1) - 1
            fill = ~live & (take[:, None] > 0) & (lane < n)
            rem = torch.where(fill, it[lane.clamp(max=n - 1)], rem)
            p += int(take.sum())
            live = rem > 0
        elif not bool(live.any()):
            return total
        run = rem.clamp(max=steps)
        total += 32 * int(run.view(resident, -1, 32).amax(2).sum())
        rem = rem - run
        if p >= n:  # the tail: pack a block's live lanes to free a warp
            live = rem > 0
            k = live.sum(1)
            pack = (k + 31) // 32 < (packed + 31) // 32
            if bool(pack.any()):
                order = torch.argsort((~live).long(), dim=1, stable=True)
                rem = torch.where(pack[:, None], rem.gather(1, order), rem)
                packed = torch.where(pack, k, packed)


# the cases in which the repack loop is held to the plain walk (the tests:
# tests/test_torch_host_repack.py on the CPU, tests/test_torch_cuda.py on
# the card): budgets of one iteration and one past one and two rounds, a
# block whose every lane is heavy, a block with one steppable lane, no
# threshold
REPACK_CASES = ("budget_1", "budget_round_plus_1",
                "budget_two_rounds_plus_1", "budget_64", "every_lane_heavy",
                "one_steppable_lane", "no_threshold")


def repack_case(state, case, thr, schedule):
    """``(state, budget, thr)`` of a ``REPACK_CASES`` case: a copy of
    ``state`` changed in its first block of lanes (of the launch's
    ``schedule``, ``repack_schedule``) as the case says."""
    block, steps, _ = schedule
    s = clone_state(state)
    first = slice(0, block)
    if case == "every_lane_heavy":
        a = s["atten"].view(-1)
        a[first] = torch.where(a[first] < 0, -5.0 * thr, 5.0 * thr)
        return s, 64, thr
    if case == "one_steppable_lane":
        q = s["quota"].view(-1)
        keep = int(torch.nonzero(q[first] > 0)[7])
        s["atten"].view(-1)[keep] = 1.0
        q[:keep] = 0
        q[keep + 1:block] = 0
        return s, 64, thr
    if case == "no_threshold":
        return s, 64, math.inf
    return s, {"budget_1": 1, "budget_round_plus_1": steps + 1,
               "budget_two_rounds_plus_1": 2 * steps + 1,
               "budget_64": 64}[case], thr


# the cases in which the chain builds' queued wall work is held to the
# one-thread loop and the plain walk (tests/test_torch_host_chain_
# phases*.py on the CPU, tests/test_torch_cuda.py on the card): a block
# whose every lane stands on the wall, one in which none does, one with
# a single wall lane, and budgets of one iteration and one past one and
# two rounds
CHAIN_CASES = ("every_lane_on_wall", "no_lane_on_wall", "one_wall_lane",
               "budget_1", "budget_round_plus_1", "budget_two_rounds_plus_1")


def chain_case(state, case, block, steps):
    """``(state, budget)`` of a ``CHAIN_CASES`` case: a copy of ``state``
    whose first ``block`` lanes stand on the wall as the case says (lanes
    moved to the positions, normals and wall flags of other lanes of the
    state), and the launch's iterations (``steps`` a round)."""
    s = clone_state(state)
    flat = {k: s[k].view(-1) for k in ("px", "py", "nx", "ny", "ob",
                                       "quota")}
    working = flat["quota"] > 0
    wall = torch.nonzero(working & (flat["ob"] == 1)).squeeze(1)
    free = torch.nonzero(working & (flat["ob"] == 0)).squeeze(1)
    free = free[free >= block]
    dev = s["px"].device
    first = torch.arange(block, device=dev)

    def place(dst, src):
        for k in ("px", "py", "nx", "ny", "ob"):
            flat[k][dst] = flat[k][src].clone()

    if case == "every_lane_on_wall":
        place(first, wall[first % len(wall)])
    elif case in ("no_lane_on_wall", "one_wall_lane"):
        on = torch.nonzero(flat["ob"][:block] == 1).squeeze(1)
        place(on, free[torch.arange(len(on), device=dev) % len(free)])
        if case == "one_wall_lane":
            keep = int(torch.nonzero(working[:block])[7])
            place(torch.tensor([keep], device=dev), wall[-1:])
    budget = {"budget_1": 1, "budget_round_plus_1": steps + 1,
              "budget_two_rounds_plus_1": 2 * steps + 1}.get(case, 64)
    return s, budget


def launch_anatomy(wk, solver, pts, n_walks, max_steps, eps, seed,
                   schedule, resident, replay_every=1):
    """One solve through the host launch loop (``solver._solve_raw``)
    with each launch recorded: its kernel ms (CUDA events), whether it ran
    at ``thr = +inf``, the lanes steppable at its start (quota left, and
    light or due to bank), its lane-steps (the ``life`` delta), its
    iterations (a step, a bank, or a frozen lane's last partial
    iteration), its longest lane (steps, iterations), and the
    thread-slots issued (``issued_slots``) for its lane-steps and
    iterations with one thread a lane (``issued_life``, ``issued_lane``)
    and for its iterations under the kernel's ``schedule`` on
    ``resident`` blocks (``issued_sched``; on every ``replay_every``-th
    launch only, None on the others: a replay takes up to ~60 ms).
    Returns ``(launches, summary)``: the records, and the launches, the
    median and max ms, the kernel ms, and the warp efficiencies:
    lane-steps over ``issued_life`` and iterations over ``issued_sched``
    (over the launches replayed)."""
    one_thread = (32, None, None)
    launches = []

    def walk(state, params, n, thr=None):
        flat = {k: v.reshape(-1) for k, v in state.items()}
        life0, nd0 = flat["life"].clone(), flat["ndone"].clone()
        has = flat["quota"] > 0
        idx = torch.nonzero(has).squeeze(1)
        t_eff = math.inf if thr is None else thr
        steppable = int(wk._movable(params, t_eff, flat, idx).sum())
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        wk.run_walk(state, params, n, thr)
        stop.record()
        torch.cuda.synchronize()
        dl = (flat["life"] - life0).long()
        it = dl + (flat["ndone"] - nd0).long()
        it = it + (has & (flat["quota"] > 0) & (it < n)).long()
        launches.append(dict(
            ms=start.elapsed_time(stop), inf=math.isinf(t_eff),
            steppable=steppable, lane_steps=int(dl.sum()),
            iters=int(it.sum()), longest=int(dl.max()),
            longest_it=int(it.max()),
            issued_life=issued_slots(dl, one_thread, None),
            issued_lane=issued_slots(it, one_thread, None),
            issued_sched=issued_slots(it, schedule, resident)
            if len(launches) % replay_every == 0 else None))
        return state

    solver._solve_raw(pts, n_walks, max_steps, eps, seed, walk=walk)
    ms = np.array([r["ms"] for r in launches])
    total = lambda k: sum(r[k] for r in launches)  # noqa: E731
    replayed = [r for r in launches if r["issued_sched"] is not None]
    return launches, dict(
        launches=len(launches), kernel_ms=float(ms.sum()),
        ms_median=float(np.median(ms)), ms_max=float(ms.max()),
        inf_launches=sum(r["inf"] for r in launches),
        eff_life=total("lane_steps") / max(total("issued_life"), 1),
        eff_sched=sum(r["iters"] for r in replayed)
        / max(sum(r["issued_sched"] for r in replayed), 1))


def field_ops(spec):
    """FP32 operations of one evaluation of a field spec's value
    (``field_value``): a constant 2, a bump 16, the dipole 20; a ``TERMS``
    term 31 (five Horner rules and the add), 12 more with its exponential
    and 4 per sin/cos factor."""
    kind, tab = spec.table()
    if kind == 0:
        return 2
    if kind == 1:
        return 2 + 16 * ((len(tab) - 1) // 6)
    if kind == 2:
        return 20
    return 2 + sum(31 + (12 if t.has_exp else 0)
                   + 4 * ((t.s1[0] != 0) + (t.s2[0] != 0))
                   for t in spec.terms)


# the transport map per walker-step: the 13 T_j(omega) (33), the 29
# coefficients c_i(omega) (29 x 24), the T/U recurrences (27 x 11), the
# warp, the clamp and the map's density (46), the free draw (8) and the
# exact weight (two i0e and two k0e, a ratio, the norm: 120)
TRANSPORT_OPS = 33 + 29 * 24 + 27 * 11 + 46 + 8 + 120


def fp32_ops_per_step(params, rows=None):
    """A lower bound on the FP32 operations of one walker-step of the
    instantiation ``params`` selects, counted by hand from
    ``csrc/walk_kernel.cu``: every add, multiply, compare or select,
    divide, square root and transcendental (exp, log, sin, cos) is one
    operation (the precise divide and transcendentals take several); only
    the work every stepping lane does counts: the rejection's first round
    (or the transport map), the cheaper of the two moves, and not the
    Robin chord mass, the arrival weight, the chain branch, later
    rejection rounds or the roulette's kill, whose share depends on the
    walk. The geometry loops count every row: in the table form a
    closest-point row forms its edge (4 more), a first-hit row its edge
    but divides instead of taking a reciprocal (1 more), a silhouette row
    its two edges (4 more). A walk without delta tracking moves to the
    ball's edge: no sampler, no alpha, no interior test; with a source, a
    Green's-radius sample (3), its point (5), the weight R^2 / 4 (2) and
    the sum (2) besides the source; with MIS, the MIS sample and weight
    as with delta tracking but over ``ln(R/r) / (2 pi)`` and ``R^2 / 4``
    (4 in place of the screened Green's function's 102) and no alpha. The
    sources and mixture components count one by one (the wide form's
    too). ``rows`` (``cull_rows``): the Neumann rows a lane's culled first
    hit visits a step, counted in place of every Neumann row of that scan
    (the other scans visit every row)."""
    n_dir, n_neu = len(params.dir_table), len(params.neu_table)
    n_vert = len(params.vert_table)
    if rows is not None:
        n_neu = rows["first_hit"]["lane"] if n_neu else 0
    alpha = field_ops(params.specs[1]) + 1      # alpha_c
    src = sum(field_ops(f) for f in params.specs[3:])
    cp_row, hit_row, sil_row = (22, 23, 20) if params.table else (18, 22, 16)
    ops = cp_row * n_dir + 2                    # closest point
    ops += 9 + 6 + hit_row * n_neu              # radius, direction, hit
    ops += sil_row * n_vert + (2 if n_vert else 0)  # silhouette radius
    if not params.delta:
        ops += 4                                # counters
        if params.mis_table is not None:
            k = len(params.mis_table)
            ops += (8 + 36 + 4 + 31 + 2 + hit_row * n_neu + 11 * k + 13
                    + src)                      # MIS NEE, Green's radius
        elif params.sources:
            ops += 12 + src                     # Green's-radius NEE
        return ops
    ops += TRANSPORT_OPS if params.transport else 165  # the screened radius
    ops += 6 + alpha                            # sample point, alpha there
    ops += 34 + alpha + 3 + 12                  # interior test, edge move,
                                                # roulette and counters
    if params.majorant is not None:
        boxes, bands = params.majorant.table()
        ops += 6 + 13 * len(boxes) + 3 * len(bands)
    if params.mis_table is not None:
        k = len(params.mis_table)
        ops += (36 + 102 + 31 + 2 + hit_row * n_neu + 11 * k + 13 + alpha
                + src)                          # MIS NEE
    elif params.sources:
        ops += 35 + src                         # NEE
    if params.freeze:
        ops += 2
    return ops


def bound(params, lanes, walker_steps, launches, visited=None):
    """``(bound_ms, bound_by)``: the least time the card could take for
    ``walker_steps`` steps of ``params``' instantiation over ``lanes``
    lanes in ``launches`` launches, the larger of the operations over the
    FP32 peak and the planes' bytes (inputs read once, outputs written
    once, per launch) over the memory rate; with ``visited``, over the
    table rows the culled scans visit (``fp32_ops_per_step``)."""
    state = 5 + 3 * params.n_src + 9            # read and written
    const = 3 + (3 if params.snap else 0)       # read
    rows = sum(t.nbytes for t in params.device_tables("cpu"))  # table form
    if params.grid:                             # the grid's nodes
        rows += params.grid_table("cpu").nbytes
    nbytes = (4.0 * lanes * (2 * state + const) + rows) * launches
    t_ops = (fp32_ops_per_step(params, visited) * walker_steps
             / PEAK_FP32_FLOPS)
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def kernel_record(params, variant, launches, timed, regs, tolerance,
                  replaces=REPLACES, rows=None):
    """The kernels line's entry for ``params``' instantiation: its
    launches on its path's main run and ``timed``, a ``steps_256``
    result; for a culled table build (``rows``, ``cull_rows``) also the
    bound over the rows its scans visit."""
    bound_ms, bound_by = bound(params, timed["lanes"], timed["steps"], 1)
    extra = {} if rows is None else {
        "bound_visited_ms": bound(params, timed["lanes"], timed["steps"], 1,
                                  rows)[0],
        "rows_visited": round(rows["first_hit"]["lane"], 2)}
    return {"name": params.kernel_name, "variant": variant, "route": "cuda",
            "source": SOURCE, "replaces": replaces, "launches": launches,
            "max_abs_err": timed["max_err"], "ms": timed["ms"],
            "plain_ms": timed["plain_ms"], "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None,
            "lanes": timed["lanes"], "walker_steps": timed["steps"],
            "agree_frac": timed["worst"],
            "registers": regs.get(params.kernel_name + (
                " (shards)" if len(params.shard_seeds) > 1 else "")),
            "tolerance": tolerance, **extra}


def cull_rows(wk, params, state):
    """Rows a step's culled first hit visits from ``state`` (the host
    replay of the kernel's skip test at its chunks,
    ``chip_probes/table_cull.py``): ``{"first_hit": {lane, warp, pairs,
    all}}``; None outside the culled build."""
    if not wk.culled_scans(params.variant):
        return None
    from chip_probes import table_cull as tc

    rows = tc.replay(params, state, sizes=(wk.CHUNK_ROWS,))[wk.CHUNK_ROWS]
    return {"first_hit": rows["first_hit"]}


def cull_text(rows):
    """``cull_rows`` as a log phrase."""
    if rows is None:
        return "full scans"
    v = rows["first_hit"]
    return (f"first hit {v['lane']:.1f} rows a lane, {v['warp']:.1f} a warp "
            f"of {v['all']}")


def life_steps(before, after):
    """Walker-steps taken between two states (sum of ``life``)."""
    return int((after["life"].long() - before["life"].long()).sum())


def lanes_differ(a, b, names=("atten", "px")):
    """Share of lanes on which any plane of ``names`` differs."""
    d = torch.zeros_like(a["px"], dtype=torch.bool)
    for k in names:
        d |= a[k] != b[k]
    return float(d.double().mean())


def full_size_solves(wk, solver, pts, n_walks, max_steps, eps, lanes, what,
                     reps=3, warm_up=None):
    """A path at full size: one warm-up solve through ``WoStSolver.solve``
    (or ``warm_up()``, a product's entry point) with the launch counts set
    to 0 just before it and read just after, then ``reps`` timed solves
    whose walk launches are bracketed by CUDA events.
    Returns a dict of the counts (by instantiation, and by loop:
    ``loops``), each solve's launches and clones, the
    walker-steps/s, s/solve, steps/solve, lane occupancy (steps over
    lanes x longest lane), the kernel's share of each solve's wall time
    and the longest lane."""
    wk.run_walk.launches = 0
    wk.run_walk.variant_launches.clear()
    wk.run_walk.loop_launches.clear()
    warm = (warm_up() if warm_up is not None else
            solver.solve(pts, n_walks=n_walks, max_steps=max_steps, eps=eps,
                         seed=0))                              # warm-up
    counts = dict(wk.run_walk.variant_launches)
    loops = dict(wk.run_walk.loop_launches)
    check(sum(counts.values()) == wk.run_walk.launches > 0,
          f"{what}: the full-size solve launched {counts}")
    stats, events = [solver.last_solve_stats], []

    def timed_walk(state, params, n, thr=None):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        wk.run_walk(state, params, n, thr)
        stop.record()
        events.append((start, stop))

    steps, times, lane_steps, share, trunc, raws = 0.0, [], 0.0, [], [], []
    for rep in range(reps):
        events.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = solver._solve_raw(pts, n_walks, max_steps, eps, rep + 1,
                                walk=timed_walk)
        times.append(time.perf_counter() - t0)
        share.append(sum(a.elapsed_time(b) for a, b in events) / 1e3
                     / times[-1])
        stats.append(solver.last_solve_stats)
        steps += res.total_steps
        trunc.append(res.truncated_walks / (len(pts) * n_walks))
        raws.append(res)
        lane_steps += float(lanes) * res.iterations
        check(np.isfinite(res.mean).all() and np.isfinite(res.stderr).all(),
              f"{what}: full-size solve not finite")
    return dict(counts=counts, loops=loops, stats=stats,
                rate=steps / sum(times),
                times=times, steps=steps / reps, occupancy=steps / lane_steps,
                share=share, longest=res.iterations, warm=warm, trunc=trunc,
                raws=raws)


def steps_256(wk, state, params, what, thr=None, subset=False):
    """256 steps of the kernel and of the plain version from one state,
    each warmed on a copy for 16 steps, timed, and held to phase 3's
    rule. With ``subset``, the first 147,456 lanes when the plain version
    would take over 30 s. Returns a dict of the lanes, ms, plain_ms, the
    worst plane's agreeing share, the max |err| on agreeing lanes, the
    walker-steps the kernel took, the plain 16-step time when cut and the
    kernel's end state."""
    from dcrmontecarlo_tpu_torch.solver.state import state_planes

    wk.run_walk(clone_state(state), params, 16, freeze_thr=thr)
    t16 = cuda_ms(lambda: wk.walk_plain(clone_state(state), params, 16,
                                        freeze_thr=thr))
    cut = subset and t16 * 16 > 30e3
    if cut:
        state = {k: v[:1152].clone() for k, v in state.items()}
    ks, ps = clone_state(state), clone_state(state)
    ms = cuda_ms(lambda: wk.run_walk(ks, params, 256, freeze_thr=thr))
    plain_ms = cuda_ms(lambda: wk.walk_plain(ps, params, 256,
                                             freeze_thr=thr))
    worst, max_err = check_planes(wk, ks, ps, state_planes(params.n_src),
                                  what)
    return dict(lanes=state["px"].numel(), ms=ms, plain_ms=plain_ms,
                worst=worst, max_err=max_err, steps=life_steps(state, ks),
                t16=t16 if cut else None, end=ks)


def dealt_launch(wk, state, params, step_bound, what, plain_lanes=1152,
                 plain_quota=2):
    """Phases 7 and 31: a solve's single launch from the fresh ``state``
    (budget ``step_bound``), which deals its walks to the threads, timed
    and held bit for bit on every plane to the one-thread loop run in
    256-step launches until drained (their kernel times summed), then to
    the plain walk under phase 3's rule on the first ``plain_lanes`` lanes
    at quotas of at most ``plain_quota``. Returns a dict of the lanes, the
    whole launch's ms and walker-steps, the loops each side ran, the
    drained launches and their summed ms, and the plain comparison's
    worst agreeing share and max |err|."""
    from dcrmontecarlo_tpu_torch.solver.state import state_planes

    names = state_planes(params.n_src)
    wk.run_walk(clone_state(state), params, step_bound)  # warm-up
    wk.run_walk.loop_launches.clear()
    dealt = clone_state(state)
    ms = cuda_ms(lambda: wk.run_walk(dealt, params, step_bound))
    loops = dict(wk.run_walk.loop_launches)
    check(loops == {"dealt": 1},
          f"{what}: the whole-solve launch ran the loops {loops}")
    wk.run_walk.loop_launches.clear()
    one, drained_ms, launches = clone_state(state), 0.0, 0
    while bool((one["quota"] > 0).any()):
        drained_ms += cuda_ms(lambda: wk.run_walk(one, params, 256))
        launches += 1
        check(launches <= step_bound // 256 + 1,
              f"{what}: 256-step launches did not drain")
    drained = dict(wk.run_walk.loop_launches)
    check(drained == {"lanes": launches},
          f"{what}: the 256-step launches ran the loops {drained}")
    differ = [k for k in names if not torch.equal(dealt[k], one[k])]
    check(not differ, f"{what}: the dealt launch and the drained one-thread "
                      f"loop differ on {differ}")
    small = {k: v.reshape(-1)[:plain_lanes].clone() for k, v in state.items()}
    small["quota"].clamp_(max=plain_quota)
    ks, ps = clone_state(small), clone_state(small)
    wk.run_walk.loop_launches.clear()
    wk.run_walk(ks, params, step_bound)
    check(dict(wk.run_walk.loop_launches) == {"dealt": 1},
          f"{what}: the reduced launch ran {dict(wk.run_walk.loop_launches)}")
    wk.walk_plain(ps, params, plain_quota * (params.max_steps + 1))
    worst, max_err = check_planes(wk, ks, ps, names, f"{what} (plain)")
    return dict(lanes=state["px"].numel(), ms=ms,
                steps=life_steps(state, dealt), loops=loops,
                drained=drained, drained_ms=drained_ms,
                drained_launches=launches, plain_lanes=plain_lanes,
                plain_quota=plain_quota, plain_worst=worst,
                plain_err=max_err)


def dealt_text(d, params, card):
    """``dealt_launch``'s result as a log phrase, with the whole launch's
    bound over its walker-steps."""
    b_ms, b_by = bound(params, d["lanes"], d["steps"], 1)
    return (f"the solve's single launch ({d['steps']} walker-steps, loops "
            f"{d['loops']}): {d['ms']:.3f} ms, bound {b_ms:.4f} ms ({b_by}); "
            f"the one-thread loop in {d['drained_launches']} 256-step "
            f"launches (loops {d['drained']}) {d['drained_ms']:.3f} ms, "
            f"every plane bit-equal; against the plain walk at "
            f"{d['plain_lanes']} lanes, quotas <= {d['plain_quota']}: worst "
            f"plane agreement {d['plain_worst']:.5f}, max |err| "
            f"{d['plain_err']:.3g} ({card})")


def cuda_ms(fn, reps=1):
    """Milliseconds per call of ``fn`` on the current stream."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


# the cylinder oracle (tests/test_cylinder_oracle.py): a line-current
# dipole over a buried cylinder, the conductor contrast
CYL_CENTER, CYL_RADIUS, CYL_SIGMA0, CYL_SIGMA1 = (-120.0, -80.0), 60.0, \
    1e-2, 1e-1
CYL_SOURCES = (((-200.0, -9.0), 1.0), ((200.0, -9.0), -1.0))
CYL_WIDTH, CYL_SHARPNESS, CYL_SURFACE = 5.0, 0.1, 1.0


def cylinder_problem(bc=None):
    """``tests/test_cylinder_oracle.py::test_mc_matches_cylinder_series``'s
    problem in the port's field specs: the smoothed conductor, the
    Gaussian dipole with its MIS mixture, the local majorant, and the
    pinned series on a 257 x 257 grid as the Dirichlet data (``bc``
    replaces it)."""
    from dcrmontecarlo_tpu_torch.diagnostics import grid_continuation
    from dcrmontecarlo_tpu_torch.problems import Problem, fields
    from dcrmontecarlo_tpu_torch.survey.dcr import halfspace_domain
    from dcrmontecarlo_tpu_torch.validation import cylinder_oracle_pins

    pins = cylinder_oracle_pins()
    if bc is None:
        bc = grid_continuation(pins["gx"], pins["gy"],
                               pins["bc_grid_conductor"])
    dirichlet, neumann = halfspace_domain(500.0, 1001.0, CYL_SURFACE)
    (a, _), (b, _) = CYL_SOURCES
    bump = fields.smooth_circle(CYL_CENTER, CYL_RADIUS, CYL_SHARPNESS)
    return Problem(
        dirichlet=dirichlet, neumann=neumann, bc_dirichlet=bc,
        source=fields.gaussian_dipole(a, b, 1.0, CYL_WIDTH),
        alpha=fields.bump_sum(CYL_SIGMA0, [(CYL_SIGMA1 - CYL_SIGMA0, bump)]),
        source_importance=fields.GaussianMixture.from_components(
            [(a, CYL_WIDTH, 0.5), (b, CYL_WIDTH, 0.5)]),
        local_majorant="auto"), pins


def cylinder_checks(r, ref, x):
    """The checks of ``test_mc_matches_cylinder_series`` on one seed's
    solve ``r``: ``(n within 4 sigma + 3, median error, stderr-weighted
    means at the two current electrodes)``."""
    err = r.mean - ref
    n_ok = int((np.abs(err) / (4.0 * r.stderr + 3.0) < 1.0).sum())
    w = 1.0 / np.maximum(r.stderr, 1e-9) ** 2
    signed = []
    for sel, sign in ((np.abs(x + 200) <= 40, 1.0),
                      (np.abs(x - 200) <= 40, -1.0)):
        signed.append(sign * float(np.sum(w[sel] * r.mean[sel])
                                   / np.sum(w[sel])))
    return n_ok, float(np.median(err)), signed


# the variants the paths of phases 3-39 launch, (robin, majorant, mis,
# freeze, table, delta, transport, wide, grid)
PATH_VARIANTS = tuple((v[0],) + tuple(bool(f) for f in v[1:]) + (False,) * (
    9 - len(v)) for v in (
    (0, 0, 0, 0, 0, 1, 0), (0, 0, 1, 0, 0, 1, 0), (0, 1, 0, 0, 0, 1, 0),
    (1, 0, 0, 0, 0, 1, 0), (1, 1, 0, 0, 0, 1, 0), (1, 1, 1, 1, 0, 1, 0),
    (1, 1, 1, 0, 0, 1, 0), (2, 0, 0, 0, 0, 1, 0), (2, 1, 0, 0, 0, 1, 0),
    (0, 0, 0, 0, 1, 1, 0), (1, 0, 0, 0, 1, 1, 0), (0, 0, 0, 0, 0, 0, 0),
    (0, 0, 0, 0, 1, 0, 0), (0, 0, 0, 0, 0, 1, 1), (1, 0, 0, 0, 0, 1, 1),
    (0, 0, 1, 0, 0, 0, 0), (1, 0, 1, 0, 0, 1, 0), (0, 0, 0, 0, 0, 1, 0, 1),
    (0, 0, 1, 0, 0, 1, 0, 1), (1, 0, 1, 0, 0, 1, 0, 1),
    (1, 1, 1, 1, 0, 1, 0, 0, 1)))


# the chain builds without the freeze that phases 30, 38 (with MIS), 11
# and 26 (without) run, whose step's warp-cycles they break down by site
# with the one-thread loop's site clocks (chip_probes/step_sites.py; its
# builds start in phase 2)
SITE_VARIANTS = ((1, False, True, False, False, True, False, True, False),
                 (1, True, True, False, False, True, False, False, False),
                 (1, True, False, False, False, True, False, False, False),
                 (1, False, False, False, False, True, False, False, False))
SITE_BUILDS = {}   # variant code: the instrumented library's build
SITES_SHOWN = ("CHORD_MASS", "ARRIVAL", "BRANCH", "MIS", "PDF", "STAR", "ADD",
               "NEE", "RADIUS", "REDRAW", "BANK", "other")


def start_site_builds(wk, pool):
    """Start building ``SITE_VARIANTS``' libraries with the site clocks in
    the one-thread loop (``step_sites.instrumented_source``) on ``pool``."""
    from chip_probes import step_sites as ss

    src = ss.instrumented_source(wk._SRC.parent, ss.WORK / "csrc_sites")
    for v in SITE_VARIANTS:
        SITE_BUILDS[wk.variant_code(v)] = pool.submit(ss.build, "sites", src,
                                                      v)


def site_shares(wk, state, params):
    """Each site's share of the one-thread loop's warp-cycles in 256 steps
    of ``params``' variant from ``state`` (``step_sites.site_table``)."""
    from chip_probes import step_sites as ss

    path, _ = SITE_BUILDS[wk.variant_code(params.variant)].result()
    table = ss.site_shares(path, state, params)["sites"]
    return {k: round(float(table[k]["cycle_share"]), 4) for k in SITES_SHOWN}


def build_variants(wk, variants=PATH_VARIANTS):
    """Build ``variants`` with a checkout's ``walk_kernel`` module ``wk``
    (a checkout from before the on-demand build compiles its fixed set
    instead); returns ``build_library``'s ``(paths, seconds, log)``."""
    if hasattr(wk, "valid_variant"):
        return wk.build_library(variants)
    return wk.build_library()


# ---- the variant sweep ------------------------------------------------------
# Twelve variants in which, with the 21 that the paths above launch and the
# two of phases 40-41, every pair of switch values the rule allows occurs
# at least once: the switches are the Robin mode, the majorant, MIS, the
# freeze, the table form, delta tracking, the transport sampler, the wide
# form, the grid, and whether the variant evaluates TERMS fields. Each
# case: its name, its variant (WalkParams.variant) and how its problem is
# built (sweep_problem; the JAX package's tests build the same one):
# geometry "box" (a 4 m x 4 m box, Dirichlet on three sides, a Neumann top
# with a 0.25 m step down: 12 static rows) or "table" (the box with its
# Dirichlet sides in 32 segments each: 105 rows), the conductivity (None:
# no delta tracking; "bumps": a 10x anomaly under the step; "terms": a
# TERMS spec), the Dirichlet data ("zero", "poly": x + y as a TERMS spec,
# "grid": a bilinear field the grid holds exactly), 1 or 5 dipole sources,
# MIS toward the first dipole, a local majorant, the Robin mode, the split
# (its freeze threshold) and the screened sampler. Axis-aligned walls with
# exact corners keep walks in step across math libraries.
_F, _T = False, True
SWEEP = (
    ("reflectance+mis", (2, _F, _T, _F, _F, _T, _F, _F, _F),
     dict(mis=True, robin="reflectance")),
    ("table+majorant", (0, _T, _F, _F, _T, _T, _F, _F, _F),
     dict(geometry="table", majorant=True)),
    ("table+mis", (0, _F, _T, _F, _T, _T, _F, _F, _F),
     dict(geometry="table", mis=True)),
    ("table+wide", (0, _F, _F, _F, _T, _T, _F, _T, _F),
     dict(geometry="table", n_src=5)),
    ("chain+freeze+terms", (1, _F, _F, _T, _F, _T, _F, _F, _F, _T),
     dict(alpha="terms", robin="chain", split=1.2)),
    ("chain+majorant+terms", (1, _T, _F, _F, _F, _T, _F, _F, _F, _T),
     dict(alpha="terms", robin="chain", majorant=True)),
    ("grid_no_delta", (0, _F, _F, _F, _F, _F, _F, _F, _T),
     dict(alpha=None, bc="grid")),
    ("survey+grid", (0, _F, _F, _F, _F, _T, _F, _F, _T), dict(bc="grid")),
    ("flagship_wide", (1, _T, _T, _T, _F, _T, _F, _T, _F),
     dict(robin="chain", majorant=True, mis=True, split=1.2, n_src=5)),
    ("transport+mis", (0, _F, _T, _F, _F, _T, _T, _F, _F),
     dict(mis=True, sampler="transport")),
    ("reflectance_table_all", (2, _T, _F, _T, _T, _T, _T, _T, _T, _T),
     dict(geometry="table", alpha="terms", bc="grid", n_src=5,
          majorant=True, robin="reflectance", split=1.2,
          sampler="transport")),
    ("no_delta_wide+terms", (0, _F, _F, _F, _F, _F, _F, _T, _F),
     dict(alpha=None, bc="poly", n_src=5)),
)
# every variant the script launches: the paths', phases 40-41's, the sweep
SCRIPT_VARIANTS = PATH_VARIANTS + (
    (0, False, False, True, False, True, False, False, False),
    (0, True, True, True, True, True, False, False, False)) + tuple(
        c[1] for c in SWEEP)
SWEEP_DEFAULTS = dict(geometry="box", alpha="bumps", bc="zero", n_src=1,
                      mis=False, majorant=False, robin=False, split=None,
                      sampler="exact")
SWEEP_BOX = [[-2.0, 0.0], [-2.0, -4.0], [2.0, -4.0], [2.0, 0.0]]
SWEEP_WALL = [[-2.0, 0.0], [-0.5, 0.0], [-0.5, -0.25], [0.5, -0.25],
              [0.5, 0.0], [2.0, 0.0]]
SWEEP_DIPOLES = (((-1.0, -0.6), (1.0, -0.6)), ((-1.5, -1.0), (0.5, -1.0)),
                 ((-0.5, -2.0), (1.5, -2.0)), ((-1.0, -3.0), (1.0, -1.5)),
                 ((0.0, -0.6), (0.0, -2.5)))
SWEEP_WIDTH = 0.3
# (center, radius, value) over a background of 1, sharpness 8
SWEEP_ANOMALIES = (((0.8, -0.6), 0.4, 10.0), ((-1.0, -2.5), 0.5, 0.2))
SWEEP_MAJORANT_BOX = (0.2, 1.4, -1.2, 0.0)
SWEEP_GRID = (np.linspace(-2.5, 2.5, 11), np.linspace(-4.5, 0.5, 11))
SWEEP_POINTS = np.array([[0.0, -1.0], [0.5, -0.5], [-1.5, -0.004],
                         [1.2, -3.5], [0.0, -0.252], [-1.9, -2.0]],
                        np.float32)
SWEEP_EPS, SWEEP_MAX_STEPS = 1e-2, 500


def sweep_spec(case):
    """A sweep case's build, its defaults filled in."""
    return dict(SWEEP_DEFAULTS, **case[2])


def sweep_boundary(geometry):
    """The Dirichlet points (three sides, in 32 segments each for the
    table form) and the Neumann top of a sweep case."""
    if geometry == "box":
        return SWEEP_BOX, SWEEP_WALL
    pts = []
    for (ax, ay), (bx, by) in zip(SWEEP_BOX[:-1], SWEEP_BOX[1:]):
        for k in range(32):
            pts.append([ax + (bx - ax) * k / 32, ay + (by - ay) * k / 32])
    return pts + [SWEEP_BOX[-1]], SWEEP_WALL


def sweep_grid_values(xs, ys):
    """The sweep's gridded Dirichlet data: 0.5 + 0.3 x - 0.2 y + 0.1 x y,
    bilinear, so the grid's interpolant is the field up to rounding."""
    x, y = np.meshgrid(xs, ys, indexing="ij")
    return 0.5 + 0.3 * x - 0.2 * y + 0.1 * x * y


def sweep_problem(spec):
    """The port's problem of a sweep case (``sweep_spec``)."""
    from dcrmontecarlo_tpu_torch.diagnostics import grid_continuation
    from dcrmontecarlo_tpu_torch.geometry import Polyline
    from dcrmontecarlo_tpu_torch.models.dcr_scenarios import \
        _anomalous_conductivity
    from dcrmontecarlo_tpu_torch.problems import LocalMajorant, Problem, \
        fields

    dirichlet, neumann = sweep_boundary(spec["geometry"])
    alpha = {None: None, "terms": fields.terms(
        2.0, fields.term({(0, 1): 0.2}), fields.term(0.3, sx=("sin", 0.5))),
        "bumps": _anomalous_conductivity(1.0, SWEEP_ANOMALIES, 8.0)}[
            spec["alpha"]]
    bc = {"zero": fields.constant(0.0),
          "poly": fields.polynomial({(1, 0): 1.0, (0, 1): 1.0}),
          "grid": grid_continuation(*SWEEP_GRID,
                                    sweep_grid_values(*SWEEP_GRID))}[
                                        spec["bc"]]
    sources = [fields.gaussian_dipole(a, b, 1.0, SWEEP_WIDTH)
               for a, b in SWEEP_DIPOLES[:spec["n_src"]]]
    a, b = SWEEP_DIPOLES[0]
    return Problem(
        dirichlet=Polyline.from_points(dirichlet),
        neumann=Polyline.from_points(neumann), bc_dirichlet=bc,
        source=sources[0] if len(sources) == 1 else sources, alpha=alpha,
        source_importance=(fields.GaussianMixture.from_components(
            [(a, SWEEP_WIDTH, 0.5), (b, SWEEP_WIDTH, 0.5)])
            if spec["mis"] else None),
        local_majorant=(LocalMajorant(boxes=(SWEEP_MAJORANT_BOX,),
                                      sigma_bar_bg=0.01)
                        if spec["majorant"] else None))


def sweep_options(spec, **kw):
    """The solver options of a sweep case (survey-like: CRN, roulette at
    delta tracking's 0.05, boundary snap)."""
    from dcrmontecarlo_tpu_torch.solver import SolverOptions

    return SolverOptions(common_random_numbers=True, roulette_threshold=0.05,
                         robin_correction=spec["robin"],
                         split_threshold=spec["split"],
                         screened_sampler=spec["sampler"], **kw)


# ---- phases 40-41: the survey with the split, the terrain with the --------
# ---- flagship's estimator ---------------------------------------------------
P1_WALKS, P1_MAX_STEPS, P1_EPS, P1_SPLIT = 1 << 19, 500, 0.9, 4.0
P2_WALKS, P2_MAX_STEPS, P2_EPS, P2_SPLIT = 1 << 17, 600, 0.5, 4.0
P1_LANES, P2_LANES = 147456, 294912
TOPO_XS = np.arange(-40.0, 41.0, 10.0)


def survey_split_options(**kw):
    """Phase 6's options with the high-weight split at ``P1_SPLIT``: the
    survey's freeze build through the host launch loop."""
    from dcrmontecarlo_tpu_torch.solver import SolverOptions

    base = dict(target_slots=1 << 21, min_quota=32, rejection_rounds=1,
                split_threshold=P1_SPLIT)
    return SolverOptions(**dict(base, **kw))


def terrain_flagship_problem(**size):
    """``topographic_survey_problem()`` (at ``size``, its defaults
    without) with the flagship's estimator: MIS toward the survey's
    two-component mixture at the two buried current electrodes
    (``survey/dcr.py::DCRSurvey.build_problem``) and
    ``local_majorant="auto"``. Returns ``(problem, height_fn)``."""
    from dcrmontecarlo_tpu_torch.models import topographic_survey_problem
    from dcrmontecarlo_tpu_torch.problems import Problem, fields

    prob, h = topographic_survey_problem(**size)
    # the electrodes as topographic_survey_problem buries them
    a, b = ((x, float(h(np.asarray(x))) - 1.5) for x in (-20.0, 20.0))
    return Problem(
        dirichlet=prob.dirichlet, neumann=prob.neumann,
        bc_dirichlet=prob.bc_dirichlet, source=prob.source, alpha=prob.alpha,
        source_importance=fields.GaussianMixture.from_components(
            [(a, 0.5, 0.5), (b, 0.5, 0.5)]),
        local_majorant="auto"), h


def validation_phases(wk, dev, card, regs, records, tolerance, schedules,
                      resident):
    """Phases 32-35: the validation and diagnostics path (``schedules``
    and ``resident``: the freeze builds' launch schedules and their blocks
    on the card at once, by kernel name)."""
    from dcrmontecarlo_tpu_torch.diagnostics import grid_continuation, \
        martingale_audit, profile_occupancy, trace_walks
    from dcrmontecarlo_tpu_torch.models import geophysical_scenario, \
        notebook_survey
    from dcrmontecarlo_tpu_torch.problems import fields
    from dcrmontecarlo_tpu_torch.solver import SolverOptions, WoStSolver
    from dcrmontecarlo_tpu_torch.solver.state import state_planes
    from dcrmontecarlo_tpu_torch.survey import survey_default_options
    from dcrmontecarlo_tpu_torch.validation import fdm_solve

    cyl_prob, pins = cylinder_problem()
    el = np.stack([np.arange(-400.0, 401.0, 40.0),
                   np.full(21, -0.1)], 1).astype(np.float32)
    check(np.allclose(pins["electrodes"], el, atol=1e-6),
          "the cylinder pins' electrodes moved")
    ref = pins["ref_conductor"] + pins["delta_smooth_conductor"]

    # ---- 32. the grid instantiation vs plain; one-step launches --------
    solver = WoStSolver(cyl_prob, survey_default_options(
        target_slots=8192, split_threshold=4.0), device=dev)
    state, p32, _, _ = solver._setup(el, 8192, 6000, 1.0, 3)
    check(state["px"].numel() == 8192, "phase 32 state is not 8192 lanes")
    check(p32.variant == (wk.ROBIN_CHAIN, True, True, True, False, True,
                          False, False, True),
          f"phase 32 runs {p32.kernel_name}")
    t32 = steps_256(wk, state, p32, "phase 32", thr=4.0)
    zero = fields.constant(0.0)
    p_zero = dataclasses.replace(p32, bc=zero, specs=(zero,) + p32.specs[1:])
    z32 = clone_state(state)
    wk.run_walk(z32, p_zero, 256, freeze_thr=4.0)
    acts = lanes_differ(t32["end"], z32, ("asum0",))
    same_path = all(torch.equal(t32["end"][k], z32[k])
                    for k in ("px", "py", "steps", "ndone", "quota"))
    check(acts >= 0.01 and same_path,
          f"phase 32: the grid changed {acts:.4f} of lanes' banks, paths "
          f"equal: {same_path}")
    log(f"[32] the grid instantiation ({p32.kernel_name}, "
        f"{regs.get(p32.kernel_name)} registers), 256 steps x 8192 lanes "
        f"from fresh starts, freeze 4.0: kernel {t32['ms']:.3f} ms, plain "
        f"{t32['plain_ms']:.3f} ms; worst plane agreement {t32['worst']:.5f}"
        f", max |err| on agreeing lanes {t32['max_err']:.3g}; with zero "
        f"Dirichlet data the same paths and {acts:.4f} of lanes bank "
        f"otherwise ({card})")
    nb64, _ = notebook_survey()
    nb64.source_mis = True
    sv64, el64 = geophysical_scenario(sharpness=0.5)
    # (the grid instantiation is a freeze build: without a threshold no
    # lane freezes)
    cases = (("chain + MIS", nb64.build_problem(), el, 6000, 1.0, {}),
             ("survey", sv64.build_problem(), survey_points(el64, -0.1),
              500, 0.9, {}),
             ("grid flagship", cyl_prob, el, 6000, 1.0,
              dict(split_threshold=4.0)))
    for what, prob, pts, ms, eps, extra in cases:
        opts = survey_default_options(target_slots=8192, **extra)
        st, p, _, _ = WoStSolver(prob, opts, device=dev)._setup(
            pts, 8192, ms, eps, 7)
        one, many = clone_state(st), clone_state(st)
        wk.run_walk(one, p, 64)
        for _ in range(64):
            wk.run_walk(many, p, 1)
        names = [k for k in state_planes(p.n_src)]
        equal = [k for k in names if torch.equal(one[k], many[k])]
        check(len(equal) == len(names),
              f"phase 32 ({what}): 64 one-step launches differ from one "
              f"64-step launch on {sorted(set(names) - set(equal))}")
        log(f"[32] {what} ({p.kernel_name}): 64 one-step launches equal "
            f"one 64-step launch on every plane, bit for bit; "
            f"{life_steps(st, one)} walker-steps")

    # the kernel vs the plain host loop at a cut size (the plain version
    # takes ~27 ms a step on the card whatever the lanes: a short walk)
    solver = WoStSolver(cyl_prob, survey_default_options(
        target_slots=1 << 17, split_threshold=4.0), device=dev)
    t0 = time.perf_counter()
    rk = solver._solve_raw(el, 128, 100, 1.0, 11)
    stats_k = solver.last_solve_stats
    t_k = time.perf_counter() - t0
    rp = solver._solve_raw(el, 128, 100, 1.0, 11, walk=wk.walk_plain)
    stats_p = solver.last_solve_stats
    t_p = time.perf_counter() - t0 - t_k
    dm = np.abs(rk.mean - rp.mean)
    scale = np.abs(rp.mean) + np.sqrt(rk.stderr ** 2 + rp.stderr ** 2)
    check(np.isfinite(rk.mean).all() and (dm <= 1e-3 * scale).all()
          and rk.total_steps == rp.total_steps
          and stats_k["clones"] == stats_p["clones"] > 0,
          f"phase 32 host loop: kernel {rk.total_steps} steps {stats_k}, "
          f"plain {rp.total_steps} steps {stats_p}, |dmean|/scale "
          f"{dm / scale}")
    log(f"[32] host-loop solve 21x128, max_steps 100 (cylinder): max "
        f"|dmean|/(|mean|+se) {float((dm / scale).max()):.3g} (bound 1e-3), "
        f"steps kernel {rk.total_steps:.0f} plain {rp.total_steps:.0f}, "
        f"kernel {stats_k}, plain {stats_p}; {t_k:.2f} s kernel, "
        f"{t_p:.2f} s plain")

    # ---- 33. the cylinder oracle's Monte Carlo tier ---------------------
    solver = WoStSolver(cyl_prob, survey_default_options(
        target_slots=16384, split_threshold=4.0), device=dev)
    check(solver._robin_enabled() == "chain", "cylinder Robin is not chain")
    x = el[:, 0]
    for seed in (0, 1, 2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = solver.solve(el, n_walks=2500, max_steps=6000, eps=1.0,
                         seed=seed)
        t33 = time.perf_counter() - t0
        check(np.isfinite(r.mean).all() and np.isfinite(r.stderr).all(),
              f"phase 33 seed {seed} not finite")
        n_ok, cm, signed = cylinder_checks(r, ref, x)
        log(f"[33] cylinder MC tier seed {seed}: {n_ok}/21 within 4 sigma "
            f"+ 3.0, median error {cm:.3f}, stderr-weighted means at the "
            f"+ and - current electrodes (sign-corrected, must be > 0): "
            f"{signed[0]:.4g}, {signed[1]:.4g}; means "
            f"{np.round(r.mean, 2).tolist()} stderr "
            f"{np.round(r.stderr, 2).tolist()}; "
            f"{solver.last_solve_stats}, steps {r.total_steps:.0f}, max "
            f"banked {r.max_banked:.4g}, {t33:.3f} s ({card})")
        check(n_ok >= 18, f"phase 33 seed {seed}: {n_ok}/21 within bound")
        check(-30.0 < cm < 6.0, f"phase 33 seed {seed}: median error {cm}")
        check(min(signed) > 0.0,
              f"phase 33 seed {seed}: sign pattern {signed}")

    # ---- 34. full size: the cylinder -------------------------------------
    full = survey_default_options(target_slots=1 << 21, min_quota=32,
                                  split_threshold=4.0)
    solver = WoStSolver(cyl_prob, full, device=dev)
    n_walks = 1 << 20
    f34 = full_size_solves(wk, solver, el, n_walks, 6000, 1.0, 688128,
                           "phase 34", reps=2)
    log(f"[34] full size 21x{n_walks} walks, 688128 lanes, the cylinder: "
        f"walker_steps_per_sec {f34['rate']:.6g} s/solve {f34['times']} "
        f"steps/solve {f34['steps']:.6g} longest lane {f34['longest']} "
        f"steps, lane occupancy {f34['occupancy']:.4f}, launches and clones "
        f"per solve {f34['stats']}, kernel share of wall time "
        f"{[round(v, 4) for v in f34['share']]}, warm-up launches "
        f"{f34['counts']} ({card})")
    state, p34, _, _ = solver._setup(el, n_walks, 6000, 1.0, 5)
    check(state["px"].numel() == 688128 and p34.variant == p32.variant
          and f34["counts"] == {p34.kernel_name:
                                f34["stats"][0]["launches"]},
          f"phase 34 runs {p34.kernel_name}, launched {f34['counts']}")
    n_ok, cm, signed = cylinder_checks(f34["warm"], ref, x)
    log(f"[34] the full-size solve against the series: {n_ok}/21 within 4 "
        f"sigma + 3.0, median error {cm:.3f}, signed means {signed}")
    _, a34 = launch_anatomy(wk, solver, el, n_walks, 6000, 1.0, 0,
                            schedules[p34.kernel_name],
                            resident[p34.kernel_name], 8)
    log(f"[34] the solve's {a34['launches']} launches one by one (seed 0): "
        f"kernel ms per launch median {a34['ms_median']:.4f} max "
        f"{a34['ms_max']:.3f}, {a34['kernel_ms']:.1f} ms in all, "
        f"{a34['inf_launches']} at thr = +inf; warp efficiency, "
        f"modelled on the host, "
        f"{a34['eff_sched']:.4f} (the kernel's schedule, every 8th "
        f"launch), "
        f"{a34['eff_life']:.4f} (lane-steps, one thread a lane) ({card})")
    t34 = steps_256(wk, state, p34, "phase 34", thr=4.0, subset=True)
    b34 = bound(p34, t34["lanes"], t34["steps"], 1)
    log(f"[34] 256 steps x {t34['lanes']} lanes, freeze 4.0: kernel "
        f"{t34['ms']:.3f} ms, plain {t34['plain_ms']:.3f} ms; bound "
        f"{b34[0]:.4f} ms ({b34[1]}); worst plane agreement "
        f"{t34['worst']:.5f}, {t34['steps']} walker-steps ({card})")
    records.append(kernel_record(
        p34, "robin_chain+local_majorant+mis+freeze+grid",
        f34["counts"][p34.kernel_name], t34, regs, tolerance))

    # ---- 35. the diagnostics on the card ---------------------------------
    # the notebook audit (tests/test_martingale_audit.py::
    # test_notebook_step_operator_normalized_residuals)
    nb_survey, _ = notebook_survey()
    nb_survey.source_mis = True
    nb_prob = nb_survey.build_problem()

    def np_field(f):
        return lambda X, Y: f(torch.as_tensor(X, dtype=torch.float32),
                              torch.as_tensor(Y, dtype=torch.float32)
                              ).numpy()

    t0 = time.perf_counter()
    fdm = fdm_solve(bounds=((-500.0, 500.0), (-1000.0, 1.0)),
                    alpha=np_field(nb_prob.alpha),
                    source=np_field(nb_prob.source), neumann_top=True,
                    nx=201, ny=201)
    t_fdm = time.perf_counter() - t0
    cont = grid_continuation(fdm.xs, fdm.ys, fdm.u)
    wk.run_walk.launches = 0
    wk.run_walk.variant_launches.clear()
    t0 = time.perf_counter()
    rep = martingale_audit(
        nb_prob, SolverOptions(target_slots=1 << 15,
                               robin_correction="chain",
                               rejection_rounds=2),
        (0.0, -0.1), continuation=cont, eps=1.0, max_steps=6000, n_steps=24,
        n_walkers=1 << 15, n_seeds=4, normalize_by_atten=True, device=dev)
    t_aud = time.perf_counter() - t0
    counts35 = dict(wk.run_walk.variant_launches)
    log(f"[35] notebook audit (2^15 walkers x 24 steps x 4 seeds, "
        f"normalized, launches {counts35}) in {t_aud:.2f} s (the 201^2 "
        f"oracle {t_fdm:.2f} s on the host):\n{rep}")
    check(abs(rep.mean[0]) < 5 * rep.sem[0] + 0.03,
          f"phase 35: far-interior {rep.mean[0]} +- {rep.sem[0]}")
    for b in (1, 2):
        check(rep.n[b] == 0 or abs(rep.mean[b]) < 5 * rep.sem[b] + 0.1,
              f"phase 35: {rep.bucket_names[b]} {rep.mean[b]} +- "
              f"{rep.sem[b]}")
    check(set(counts35) == {wk.kernel_name((wk.ROBIN_CHAIN, False, True,
                                            False, False, True, False,
                                            False, False))}
          and sum(counts35.values()) == 24 * 4,
          f"phase 35: the audit launched {counts35}")
    # walk histories and the occupancy profile on the survey, against a
    # solve of the same walks: quota 1 per slot, no CRN and no snap
    sv, _ = geophysical_scenario(sharpness=0.5)
    point = np.array([[0.0, -2.0]], np.float32)
    n_tr = 256
    solver = WoStSolver(sv.build_problem(), SolverOptions(
        target_slots=n_tr, min_quota=1), device=dev)
    wk.run_walk.launches = 0
    wk.run_walk.variant_launches.clear()
    hist = trace_walks(solver, point[0], n_walks=n_tr, max_steps=500,
                       eps=0.9, seed=4)
    n_trace = wk.run_walk.launches
    r, h = solver.solve(point, n_walks=n_tr, max_steps=500, eps=0.9,
                        seed=4, return_history=True, history_walks=8)
    tot = float(hist.total.astype(np.float64).sum())
    check(hist.positions.shape == (n_tr, 502, 2)
          and (hist.walk_length >= 1).all()
          and abs(tot - float(r.walk_sum[0])) <= 1e-5 * (
              abs(tot) + float(np.abs(hist.total).sum()))
          and int(hist.active.sum() - n_tr) == int(r.total_steps),
          f"phase 35: the trace's totals {tot} vs the solve's "
          f"{float(r.walk_sum[0])}, steps {int(hist.active.sum() - n_tr)} "
          f"vs {r.total_steps}")
    check(len(h) == 1 and len(h[0]) == 8 and all(
        {"walk_id", "path", "contributions", "total_contribution"}
        <= set(w) for w in h[0]), "phase 35: return_history's schema")
    occ = profile_occupancy(solver, point, n_walks=4 * n_tr, max_steps=500,
                            eps=0.9, seed=4, max_iters=4096)
    r4 = solver.solve(point, n_walks=4 * n_tr, max_steps=500, eps=0.9,
                      seed=4)
    check(int(occ.walks_done_per_iter.sum()) == 4 * n_tr
          and int(occ.active_per_iter.sum()) == int(r4.total_steps),
          f"phase 35: the profile counted "
          f"{int(occ.walks_done_per_iter.sum())} walks and "
          f"{int(occ.active_per_iter.sum())} steps, the solve "
          f"{r4.total_steps}")
    log(f"[35] trace_walks {n_tr} walks from (0, -2) in {n_trace} one-step "
        f"launches: totals sum {tot:.6g} = the solve's "
        f"{float(r.walk_sum[0]):.6g}, steps {int(r.total_steps)} on both; "
        f"return_history 8 walks; "
        f"occupancy profile of {4 * n_tr} walks: {occ.iterations} "
        f"iterations, mean occupancy {occ.mean_occupancy:.4f}, "
        f"{int(occ.active_per_iter.sum())} steps = the solve's")


# phase 39's worker: one process of a 2-process job on this card, each
# holding 2 of the mesh's 4 shards (gloo: NCCL refuses two ranks on one
# card); prints its solve of the survey
WORKER_39 = r"""
import json, sys
import numpy as np
import torch.distributed as dist
from dcrmontecarlo_tpu_torch.models import geophysical_scenario
from dcrmontecarlo_tpu_torch.ops import walk_kernel as wk
from dcrmontecarlo_tpu_torch.parallel import ShardedWoStSolver, \
    initialize_distributed, make_mesh
from dcrmontecarlo_tpu_torch.solver import SolverOptions

coord, pid = sys.argv[1], int(sys.argv[2])
n = initialize_distributed(coord, 2, pid, local_device_count=2)
survey, electrodes = geophysical_scenario(sharpness=0.5)
pts = np.asarray(electrodes, np.float32).copy()
pts[:, 1] = -0.1
solver = ShardedWoStSolver(survey.build_problem(), make_mesh(), SolverOptions(
    target_slots=1 << 16, rejection_rounds=1))
r = solver.solve(pts, n_walks=1 << 15, max_steps=500, eps=0.9, seed=3)
out = {"shards": n, "backend": dist.get_backend(),
       "local": solver.mesh.local_shards, "launches": wk.run_walk.launches,
       "result": [r.mean.tolist(), r.stderr.tolist(), r.walk_sum.tolist(),
                  r.walk_sumsq.tolist(), r.total_steps, r.iterations,
                  solver.last_solve_stats]}
dist.destroy_process_group()
print("RESULT", json.dumps(out), flush=True)
"""


def fused_equal(wk, fused, shards, starts, steps, what):
    """A fused launch's end planes ``fused`` against each shard launched
    alone from ``starts`` (its planes before) with its own seed for
    ``steps`` steps: equal on every lane and plane."""
    n = starts[0]["px"].numel()
    for i, (s, st) in enumerate(zip(shards, starts)):
        wk.run_walk(st, s.params, steps)
        for k, v in st.items():
            check(torch.equal(fused[k].reshape(-1)[i * n:(i + 1) * n],
                              v.reshape(-1)),
                  f"{what}: the fused launch differs from shard {i} alone "
                  f"in {k}")


def sharded_phases(wk, dev, card, regs, records, tolerance, survey,
                   electrodes, fdm, f6, flag_prob, nb_pts):
    """Phases 36-39: the sharded solve (K9) on virtual shards of one card.
    ``fdm``: phase 5's finite-volume oracle of ``survey``; ``f6``: phase
    6's full-size solves."""
    from dcrmontecarlo_tpu_torch.parallel import ShardedWoStSolver, \
        make_mesh
    from dcrmontecarlo_tpu_torch.problems import fields
    from dcrmontecarlo_tpu_torch.solver import SolverOptions, WoStSolver
    from dcrmontecarlo_tpu_torch.solver.state import state_planes
    from dcrmontecarlo_tpu_torch.survey import survey_default_options

    prob = survey.build_problem()
    pts = survey_points(electrodes, -0.1)
    sharded_flagship = (wk.ROBIN_CHAIN, True, True, False, False, True,
                        False, False, False)

    def kernel_vs_plain(solver, pts, n_walks, max_steps, eps, seed, what):
        """A sharded solve with the kernel and with the plain version on
        the same shards: equal steps, launches and clones per shard, means
        within phase 4's rule. Returns the two results, the kernel's stats
        and both times."""
        t0 = time.perf_counter()
        rk = solver._solve_raw(pts, n_walks, max_steps, eps, seed)
        stats_k, t_k = solver.last_solve_stats, time.perf_counter() - t0
        rp = solver._solve_raw(pts, n_walks, max_steps, eps, seed,
                               walk=wk.walk_plain)
        stats_p, t_p = solver.last_solve_stats, time.perf_counter() - t0
        dm = np.abs(rk.mean - rp.mean)
        scale = np.abs(rp.mean) + np.sqrt(rk.stderr ** 2 + rp.stderr ** 2)
        check(np.isfinite(rk.mean).all() and np.isfinite(rk.stderr).all()
              and (dm <= 1e-3 * scale).all()
              and rk.total_steps == rp.total_steps and stats_k == stats_p,
              f"{what}: kernel {rk.total_steps} steps {stats_k}, plain "
              f"{rp.total_steps} steps {stats_p}, |dmean|/scale "
              f"{dm / scale}")
        return rk, rp, stats_k, t_k, t_p - t_k, float((dm / scale).max())

    # ---- 36. K9: the sharded launch loop, kernel vs plain ---------------
    mesh4 = make_mesh(4)
    check(mesh4.devices.size == 4 and mesh4.local_shards == [0, 1, 2, 3],
          f"phase 36: make_mesh(4) gave {mesh4.devices}")
    solver = ShardedWoStSolver(prob, mesh4, survey_default_options())
    rk, rp, stats, t_k, t_p, q = kernel_vs_plain(
        solver, pts, 128, 500, 0.9, 11, "phase 36 (survey, 4 shards)")
    log(f"[36] sharded survey 9x128, 4 shards on "
        f"{sorted({str(d) for d in mesh4.devices})}: max |dmean|/(|mean|"
        f"+se) {q:.3g} (bound 1e-3), steps kernel {rk.total_steps:.0f} "
        f"plain {rp.total_steps:.0f}, launches per shard "
        f"{stats['shard_launches']}; {t_k:.2f} s kernel, {t_p:.2f} s plain")
    # the fused launch: the four shards advanced together, one launch over
    # their buffer a loop step, equal the four solved one by one, bit for
    # bit
    plan = solver._plan(pts, 128, 500, 0.9, 11)
    together = solver._combine(plan, solver._run_shards(plan, range(4)))
    alone = solver._combine(plan, torch.cat(
        [solver._run_shards(plan, [d]) for d in range(4)]))
    same = [k for k in together._fields
            if np.array_equal(np.asarray(getattr(together, k)),
                              np.asarray(getattr(alone, k)))]
    check(len(same) == len(together._fields)
          and together.total_steps == rk.total_steps,
          f"phase 36: the shards together and one by one differ outside "
          f"{same}")
    log(f"[36] 4 shards advanced together = the 4 solved one by one, bit "
        f"for bit on every output ({together.total_steps:.0f} steps)")

    # the new instantiation: the flagship without the freeze, one launch
    solver = ShardedWoStSolver(flag_prob, make_mesh(1), survey_default_options(
        target_slots=8192, split_threshold=4.0))
    shard = solver._shard(solver._plan(nb_pts, 8192, 6000, 1.0, 3), 0)
    state, params = shard.state, shard.params
    check(state["px"].numel() == 8192 and params.variant == sharded_flagship,
          f"phase 36: the sharded flagship state runs {params.kernel_name} "
          f"on {state['px'].numel()} lanes")
    wk.walk_plain(state, params, 200)
    start, ref = clone_state(state), clone_state(state)
    before = wk.run_walk.launches
    wk.run_walk(state, params, 32)
    torch.cuda.synchronize()
    check(wk.run_walk.launches == before + 1, "launch count did not grow")
    wk.walk_plain(ref, params, 32)
    worst, err = check_planes(wk, state, ref, state_planes(params.n_src),
                              "phase 36 (sharded flagship)")
    no_mix = clone_state(start)
    wk.walk_plain(no_mix, dataclasses.replace(params, mis_table=None), 32)
    mis_share = lanes_differ(state, no_mix, ("acc0", "asum0"))
    check(mis_share >= 0.01, f"phase 36: without the mixture only "
                             f"{mis_share:.4f} of lanes bank otherwise")
    heavy = int(((state["quota"] > 0) & (state["atten"].abs() > 4.0)).sum())
    log(f"[36] one 32-step launch, 8192 lanes, the flagship on a mesh "
        f"({params.kernel_name}, {regs.get(params.kernel_name)} registers): "
        f"worst plane agreement {worst:.5f}, max |err| on agreeing lanes "
        f"{err:.3g}; without the mixture {mis_share:.4f} of lanes bank "
        f"otherwise; {heavy} active lanes above the split threshold walk "
        f"on (no freeze)")

    # a whole sharded flagship solve with the split: 2 shards, so shard 1
    # hands out clone ids from 0xA0000000, negative as an int32
    solver = ShardedWoStSolver(flag_prob, make_mesh(2), survey_default_options(
        target_slots=1 << 17, split_threshold=4.0))
    rk, rp, stats, t_k, t_p, q = kernel_vs_plain(
        solver, nb_pts, 64, 100, 1.0, 11, "phase 36 (sharded flagship)")
    check(min(stats["shard_clones"]) > 0,
          f"phase 36: a shard of the flagship made no clone: {stats}")
    log(f"[36] sharded flagship solve 21x64, max_steps 100, 2 shards: max "
        f"|dmean|/(|mean|+se) {q:.3g} (bound 1e-3), steps kernel "
        f"{rk.total_steps:.0f} plain {rp.total_steps:.0f}, {stats}; "
        f"{t_k:.2f} s kernel, {t_p:.2f} s plain")

    # ---- 37. the dryrun's configurations on a 4-shard mesh ---------------
    res = survey.run(electrodes, n_walks=1500, max_steps=800, eps=0.5,
                     seed=0, solver=ShardedWoStSolver(
                         prob, mesh4, SolverOptions(target_slots=16384)))
    ref = fdm(res.electrodes)
    n_ok = int((np.abs(res.potentials - ref)
                < 4.0 * res.potentials_stderr + 2e-4).sum())
    check(n_ok >= 8, f"phase 37: only {n_ok}/9 electrodes match the oracle: "
                     f"{res.potentials} vs {ref}")
    two = survey.build_problem()
    two.set_source_term(two.source_fields + [fields.constant(1e-3)])
    r2 = ShardedWoStSolver(two, mesh4, SolverOptions(
        target_slots=16384, common_random_numbers=True)).solve(
        pts, n_walks=2048, max_steps=500, eps=0.9, seed=1)
    check(r2.mean.shape == (2, 9) and np.isfinite(r2.mean).all(),
          f"phase 37: the two-source CRN solve gave {r2.mean}")
    chain = SolverOptions(target_slots=16384, robin_correction="chain")
    s3 = ShardedWoStSolver(prob, mesh4, dataclasses.replace(
        chain, split_threshold=1.5))
    wk.run_walk.variant_launches.clear()
    r3 = s3.solve(pts, n_walks=2048, max_steps=500, eps=0.9, seed=2)
    counts3 = dict(wk.run_walk.variant_launches)
    r1 = WoStSolver(prob, chain, device=dev).solve(
        pts, n_walks=2048, max_steps=500, eps=0.9, seed=2)
    dev3 = np.abs(r3.mean - r1.mean) / np.sqrt(r3.stderr ** 2
                                               + r1.stderr ** 2)
    check(set(counts3) == {wk.kernel_name((wk.ROBIN_CHAIN,) + (False,) * 4
                                          + (True,) + (False,) * 3)}
          and (dev3 < 4.0).all(),
          f"phase 37: split 1.5 + chain launched {counts3}, |dmean| / "
          f"sigma {dev3} against the single-device solve")
    packed = {}
    for comp in (False, "pack"):
        packed[comp] = ShardedWoStSolver(prob, mesh4, SolverOptions(
            target_slots=16384, compaction=comp)).solve(
            pts, n_walks=1024, max_steps=500, eps=0.9, seed=4)
    a, b = packed[False], packed["pack"]
    check(a.total_steps == b.total_steps
          and np.allclose(a.walk_sum, b.walk_sum, rtol=1e-5)
          and np.allclose(a.walk_sumsq, b.walk_sumsq, rtol=1e-5),
          f"phase 37: pack {b.total_steps} steps, unpacked {a.total_steps}")
    log(f"[37] 4 shards: oracle gate {n_ok}/9 within 4 sigma + 2e-4; CRN "
        f"with two sources {r2.mean.shape}, finite; split 1.5 + chain "
        f"({s3.last_solve_stats['clones']} clones) within "
        f"{float(dev3.max()):.3f} sigma of the single-device chain solve; "
        f"pack = unpacked, {b.total_steps:.0f} steps")

    # ---- 38. full size on a 4-shard mesh ---------------------------------
    solver = ShardedWoStSolver(prob, mesh4, SolverOptions(
        target_slots=1 << 21, min_quota=32, rejection_rounds=1))
    pts6 = survey_points(electrodes, -0.5)
    n_walks, max_steps, eps = 1 << 19, 500, 0.9
    f38 = full_size_solves(wk, solver, pts6, n_walks, max_steps, eps,
                           147456, "phase 38 (survey)")
    plan = solver._plan(pts6, n_walks, max_steps, eps, 5)
    shards = [solver._shard(plan, d) for d in range(4)]
    alone = [clone_state(s.state) for s in shards]
    groups = solver._groups(plan, shards)
    group = groups[0]
    name = group.params.kernel_name
    # one launch a loop step for the card's four shards: the warm-up's
    # launches are its longest shard's
    check(set(f38["counts"]) == {name} and f38["counts"][name] == max(
        f38["stats"][0]["shard_launches"]) and len(groups) == 1
        and group.state["px"].numel() == 4 * 40960,
        f"phase 38: the sharded survey launched {f38['counts']}, "
        f"{f38['stats'][0]}, {len(groups)} launch groups")
    for a, b in zip(f38["raws"], f6["raws"]):
        dev6 = np.abs(a.mean - b.mean) / np.sqrt(a.stderr ** 2
                                                 + b.stderr ** 2)
        check((dev6 < 4.0).all(), f"phase 38: the sharded survey is "
                                  f"{dev6} sigma from phase 6's")
    log(f"[38] full size 9x{n_walks} walks, 4 shards x 36864 working "
        f"lanes (5 blocks of 8192), {group.state['px'].numel()} lanes a "
        f"launch, 1 launch a loop step on the card, "
        f"{f38['counts'][name]} launches in the warm-up: "
        f"walker_steps_per_sec {f38['rate']:.6g} (phase 6, one launch: "
        f"{f6['rate']:.6g}) s/solve {f38['times']} steps/solve "
        f"{f38['steps']:.6g} longest lane {f38['longest']}, lane occupancy "
        f"{f38['occupancy']:.4f}, kernel share "
        f"{[round(v, 4) for v in f38['share']]}, launches per shard "
        f"{[s['shard_launches'] for s in f38['stats']]}; means within 4 "
        f"sigma of phase 6's ({card})")
    t38 = steps_256(wk, group.state, group.params,
                    "phase 38 (survey, 4 shards fused)")
    fused_equal(wk, t38["end"], shards, alone, 256, "phase 38 (survey)")
    log(f"[38] 256 steps x {t38['lanes']} lanes (4 survey shards, one "
        f"fused launch, {t38['steps']} walker-steps): kernel "
        f"{t38['ms']:.3f} ms, plain {t38['plain_ms']:.3f} ms; worst plane "
        f"agreement {t38['worst']:.5f}; = 4 one-shard launches bit for bit "
        f"({card})")
    records.append(kernel_record(
        group.params, "survey_sharded", f38["counts"][name], t38, regs,
        tolerance, replaces="dcrmontecarlo_tpu/parallel/mesh.py:583"))

    solver = ShardedWoStSolver(flag_prob, mesh4, survey_default_options(
        target_slots=1 << 21, min_quota=32, split_threshold=4.0))
    n_walks, max_steps, eps = 1 << 20, 6000, 1.0
    f38f = full_size_solves(wk, solver, nb_pts, n_walks, max_steps, eps,
                            688128, "phase 38 (flagship)", reps=2)
    plan = solver._plan(nb_pts, n_walks, max_steps, eps, 5)
    shards = [solver._shard(plan, d) for d in range(4)]
    shard, alone = shards[0], [clone_state(s.state) for s in shards]
    site_start = clone_state(shard.state)
    group = solver._groups(plan, shards)[0]
    name = group.params.kernel_name
    check(group.params.variant == sharded_flagship
          and set(f38f["counts"]) == {name}
          and f38f["counts"][name] == max(f38f["stats"][0]["shard_launches"])
          and group.state["px"].numel() == 4 * 172032,
          f"phase 38: the sharded flagship launched {f38f['counts']}")
    log(f"[38] full size flagship 21x{n_walks} walks, 4 shards x 172032 "
        f"lanes, split 4.0 without the freeze: walker_steps_per_sec "
        f"{f38f['rate']:.6g} s/solve {f38f['times']} steps/solve "
        f"{f38f['steps']:.6g} longest lane {f38f['longest']}, occupancy "
        f"{f38f['occupancy']:.4f}, kernel share "
        f"{[round(v, 4) for v in f38f['share']]}, launches and clones "
        f"{[(s['launches'], s['clones']) for s in f38f['stats']]}, "
        f"max_weight {[r.max_weight for r in f38f['raws']]}, max_banked "
        f"{[r.max_banked for r in f38f['raws']]} ({card})")
    fused = clone_state(group.state)
    ms_fused = cuda_ms(lambda: wk.run_walk(fused, group.params, 256))
    fused_equal(wk, fused, shards, alone, 256, "phase 38 (flagship)")
    t38f = steps_256(wk, group.state, group.params,
                     "phase 38 (flagship, 4 shards fused)", subset=True)
    log(f"[38] 256 steps x {group.state['px'].numel()} lanes (4 flagship "
        f"shards, one fused launch, {name}, {regs.get(name)} registers): "
        f"kernel {ms_fused:.3f} ms, = 4 one-shard launches bit for bit; "
        f"kernel vs plain on {t38f['lanes']} of them: kernel "
        f"{t38f['ms']:.3f} ms, plain {t38f['plain_ms']:.3f} ms; worst plane "
        f"agreement {t38f['worst']:.5f}, max |err| {t38f['max_err']:.3g}, "
        f"{t38f['steps']} walker-steps ({card})")
    log(f"[38] a shard's step's sites' shares of the one-thread loop's "
        f"warp-cycles (256 steps, site clocks): "
        f"{site_shares(wk, site_start, shard.params)} ({card})")
    records.append(kernel_record(
        group.params, "robin_chain+local_majorant+mis (sharded)",
        f38f["counts"][name], t38f, regs, tolerance))

    # ---- 39. two processes on the card ----------------------------------
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER_39, f"127.0.0.1:{port}", str(pid)],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for pid in (0, 1)]
    try:
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, out in zip(procs, outs):
        check(p.returncode == 0, f"phase 39: a worker failed "
                                 f"({p.returncode}):\n{out[-3000:]}")
    got = [json.loads([ln for ln in out.splitlines()
                       if ln.startswith("RESULT")][0].split(" ", 1)[1])
           for out in outs]
    t39 = time.perf_counter() - t0
    solver = ShardedWoStSolver(prob, make_mesh(4), SolverOptions(
        target_slots=1 << 16, rejection_rounds=1))
    r = solver.solve(pts, n_walks=1 << 15, max_steps=500, eps=0.9, seed=3)
    one = json.loads(json.dumps(
        [r.mean.tolist(), r.stderr.tolist(), r.walk_sum.tolist(),
         r.walk_sumsq.tolist(), r.total_steps, r.iterations,
         solver.last_solve_stats]))
    check(got[0]["result"] == got[1]["result"] == one
          and [g["local"] for g in got] == [[0, 1], [2, 3]]
          and all(g["shards"] == 4 and g["launches"] > 0 for g in got),
          f"phase 39: the processes' results differ from each other or "
          f"from one process's: {got} vs {one}")
    log(f"[39] 2 processes x 2 shards ({got[0]['backend']}), survey 9x"
        f"{1 << 15}: both = the 1-process 4-shard mesh bit for bit "
        f"({r.total_steps:.0f} steps, kernel launches per process "
        f"{[g['launches'] for g in got]}), {t39:.1f} s with start-up")


def new_path_phases(wk, dev, card, regs, records, tolerance, survey,
                    electrodes, f6, f20, topo_pts):
    """Phases 40-42: the survey with the split, the terrain with the
    flagship's estimator, and the variant sweep."""
    from dcrmontecarlo_tpu_torch.solver import WoStSolver
    from dcrmontecarlo_tpu_torch.survey import survey_default_options

    # ---- 40. the survey with the split ----------------------------------
    p1 = (wk.ROBIN_OFF, False, False, True, False, True, False, False,
          False)
    solver = WoStSolver(survey.build_problem(), survey_split_options(),
                        device=dev)
    pts = survey_points(electrodes, -0.5)
    f40 = full_size_solves(wk, solver, pts, P1_WALKS, P1_MAX_STEPS, P1_EPS,
                           P1_LANES, "phase 40")
    state, params, _, _ = solver._setup(pts, P1_WALKS, P1_MAX_STEPS, P1_EPS,
                                        5)
    check(params.variant == p1 and set(f40["counts"]) == {
        params.kernel_name} and state["px"].numel() == P1_LANES,
          f"phase 40 launched {f40['counts']} on {state['px'].numel()} "
          f"lanes")
    # split on against split off (phase 6's solves of the same seeds)
    z = [float(np.max(np.abs(a.mean - b.mean)
                      / np.hypot(a.stderr, b.stderr)))
         for a, b in zip(f40["raws"], f6["raws"])]
    check(max(z) < 4.0, f"phase 40: split on and off differ by {z} sigma")
    log(f"[40] the survey with the split at {P1_SPLIT}, 9x{P1_WALKS} walks, "
        f"{P1_LANES} lanes ({params.kernel_name}, "
        f"{regs.get(params.kernel_name)} registers): walker_steps_per_sec "
        f"{f40['rate']:.6g} s/solve {f40['times']} steps/solve "
        f"{f40['steps']:.6g}, launches and clones per solve "
        f"{f40['stats']}, lane occupancy {f40['occupancy']:.4f}, kernel "
        f"share {[round(v, 4) for v in f40['share']]}; largest |split on - "
        f"off| per solve {[round(v, 3) for v in z]} sigma (bound 4); "
        f"phase 6 in this run {f6['rate']:.6g} ({card})")
    # kernel vs plain through the host loop, cut size
    cut = WoStSolver(survey.build_problem(), survey_split_options(
        target_slots=4096, min_quota=1), device=dev)
    t0 = time.perf_counter()
    rk = cut._solve_raw(pts, 256, P1_MAX_STEPS, P1_EPS, 11)
    stats_k, t_k = cut.last_solve_stats, time.perf_counter() - t0
    rp = cut._solve_raw(pts, 256, P1_MAX_STEPS, P1_EPS, 11,
                        walk=wk.walk_plain)
    stats_p, t_p = cut.last_solve_stats, time.perf_counter() - t0 - t_k
    dm = np.abs(rk.mean - rp.mean)
    scale = np.abs(rp.mean) + np.hypot(rk.stderr, rp.stderr)
    check(np.isfinite(rk.mean).all() and (dm <= 1e-3 * scale).all()
          and rk.total_steps == rp.total_steps and stats_k == stats_p
          and stats_k["clones"] > 0,
          f"phase 40 host loop: kernel {rk.total_steps} steps {stats_k}, "
          f"plain {rp.total_steps} steps {stats_p}, |dmean|/scale "
          f"{dm / scale}")
    log(f"[40] host-loop solve 9x256 (one walk a slot): max |dmean|/(|mean|"
        f"+se) {float((dm / scale).max()):.3g} (bound 1e-3), steps kernel "
        f"{rk.total_steps:.0f} plain {rp.total_steps:.0f}, kernel "
        f"{stats_k}, plain {stats_p}; {t_k:.2f} s kernel, {t_p:.2f} s plain")
    t40 = steps_256(wk, state, params, "phase 40", thr=P1_SPLIT,
                    subset=True)
    log(f"[40] 256 steps x {t40['lanes']} lanes, freeze {P1_SPLIT}: kernel "
        f"{t40['ms']:.3f} ms, plain {t40['plain_ms']:.3f} ms; worst plane "
        f"agreement {t40['worst']:.5f}, max |err| {t40['max_err']:.3g}, "
        f"{t40['steps']} walker-steps ({card})")
    records.append(kernel_record(params, "survey+split",
                                 f40["counts"][params.kernel_name], t40,
                                 regs, tolerance))

    # ---- 41. the terrain with the flagship's estimator -------------------
    p2 = (wk.ROBIN_OFF, True, True, True, True, True, False, False, False)
    prob, _ = terrain_flagship_problem()
    boxes = prob.local_majorant.boxes if prob.local_majorant else ()
    solver = WoStSolver(prob, survey_default_options(
        target_slots=1 << 21, split_threshold=P2_SPLIT), device=dev)
    check(solver._robin_enabled() is False, "phase 41: Robin resolved on")
    f41 = full_size_solves(wk, solver, topo_pts, P2_WALKS, P2_MAX_STEPS,
                           P2_EPS, P2_LANES, "phase 41", reps=2)
    state, params, _, _ = solver._setup(topo_pts, P2_WALKS, P2_MAX_STEPS,
                                        P2_EPS, 5)
    check(params.variant == p2 and set(f41["counts"]) == {
        params.kernel_name} and state["px"].numel() == P2_LANES,
          f"phase 41 launched {f41['counts']} on {state['px'].numel()} "
          f"lanes")
    mean41, se41 = f41["warm"].mean, f41["warm"].stderr
    i_pos = int(np.argmin(np.abs(TOPO_XS + 20)))
    i_neg = int(np.argmin(np.abs(TOPO_XS - 20)))
    check(mean41[i_pos] > 0 and mean41[i_neg] < 0
          and np.abs(mean41).max() < 1.0,
          f"phase 41 potentials break the survey's physics: {mean41}")
    z41 = float(np.max(np.abs(mean41 - f20["warm"].mean)
                       / np.hypot(se41, f20["warm"].stderr)))
    check(z41 < 4.0, f"phase 41 differs from phase 20 by {z41:.2f} sigma")
    log(f"[41] the terrain with the flagship's estimator (MIS, "
        f"local_majorant='auto': {len(boxes)} boxes {boxes}, split "
        f"{P2_SPLIT}), 9x{P2_WALKS} walks, {P2_LANES} lanes "
        f"({params.kernel_name}, {regs.get(params.kernel_name)} registers): "
        f"walker_steps_per_sec {f41['rate']:.6g} s/solve {f41['times']} "
        f"steps/solve {f41['steps']:.6g}, launches and clones per solve "
        f"{f41['stats']}, lane occupancy {f41['occupancy']:.4f}, truncated "
        f"share {[round(v, 4) for v in f41['trunc']]}, kernel share "
        f"{[round(v, 4) for v in f41['share']]}; potentials "
        f"{np.round(mean41, 5).tolist()}, stderr "
        f"{np.round(se41, 5).tolist()}; largest |phase 41 - phase 20| "
        f"{z41:.3f} sigma (bound 4); phase 20's stderr "
        f"{np.round(f20['warm'].stderr, 5).tolist()} ({card})")
    t41 = steps_256(wk, state, params, "phase 41", thr=P2_SPLIT,
                    subset=True)
    rows41 = cull_rows(wk, params, t41["end"])
    log(f"[41] 256 steps x {t41['lanes']} lanes, freeze {P2_SPLIT}: kernel "
        f"{t41['ms']:.3f} ms, plain {t41['plain_ms']:.3f} ms; worst plane "
        f"agreement {t41['worst']:.5f}, max |err| {t41['max_err']:.3g}, "
        f"{t41['steps']} walker-steps; rows a step visits after them: "
        f"{cull_text(rows41)} ({card})")
    records.append(kernel_record(params, "terrain_flagship",
                                 f41["counts"][params.kernel_name], t41,
                                 regs, tolerance, rows=rows41))

    # ---- 42. the variant sweep ---------------------------------------------
    from dcrmontecarlo_tpu_torch.solver.state import state_planes

    worst_all = 1.0
    for case in SWEEP:
        name, variant, _ = case
        spec = sweep_spec(case)
        solver = WoStSolver(sweep_problem(spec),
                            sweep_options(spec, target_slots=8192),
                            device=dev)
        state, params, _, _ = solver._setup(SWEEP_POINTS, 1 << 13,
                                            SWEEP_MAX_STEPS, SWEEP_EPS, 3)
        check(params.variant == variant and state["px"].numel() == 8192,
              f"phase 42 {name}: {params.kernel_name} on "
              f"{state['px'].numel()} lanes")
        thr = spec["split"] if params.freeze else None
        # the library and its module loaded before the timed launch
        wk.run_walk(clone_state(state), params, 16, freeze_thr=thr)
        ks, ps = clone_state(state), clone_state(state)
        wk.run_walk.launches = 0
        wk.run_walk.variant_launches.clear()
        ms = cuda_ms(lambda: wk.run_walk(ks, params, 64, freeze_thr=thr))
        launches = wk.run_walk.variant_launches[params.kernel_name]
        check(launches == wk.run_walk.launches == 1,
              f"phase 42 {name}: {wk.run_walk.launches} launches")
        plain_ms = cuda_ms(lambda: wk.walk_plain(ps, params, 64,
                                                 freeze_thr=thr))
        worst, max_err = check_planes(wk, ks, ps, state_planes(params.n_src),
                                      f"phase 42 {name}")
        worst_all = min(worst_all, worst)
        steps = life_steps(state, ks)
        check(steps > 0 and int(ks["ndone"].sum()) > 0,
              f"phase 42 {name}: no walk stepped or ended")
        timed = dict(lanes=8192, ms=ms, plain_ms=plain_ms, worst=worst,
                     max_err=max_err, steps=steps)
        rows = cull_rows(wk, params, ks)
        records.append(kernel_record(params, f"sweep:{name}", launches,
                                     timed, regs, tolerance, rows=rows))
        log(f"[42] {name}: {params.kernel_name} ({regs.get(params.kernel_name)}"
            f" registers), 64 steps x 8192 lanes: kernel {ms:.3f} ms, plain "
            f"{plain_ms:.1f} ms; worst plane agreement {worst:.5f}, max "
            f"|err| {max_err:.3g}, {steps} walker-steps"
            + ("" if rows is None else f"; rows a step visits: "
               f"{cull_text(rows)}"))
    log(f"[42] {len(SWEEP)} sweep variants, kernel vs plain: worst plane "
        f"agreement {worst_all:.5f} ({card})")


def survey_build_phase(wk, dev, card, report, electrodes, f6):
    """Phase 43: phase 6's configuration (``bench.py``'s full preset) with
    the transport sampler and with the survey's MIS mixture
    (``survey_config``), a warm-up and 3 timed solves each, every solve's
    single launch dealt; each solve within 4 sigma of phase 6's of the same
    seed; the dealt loop's registers and spills from phase 2's ``ptxas``
    ``report``. Returns ``{build: full_size_solves result}``."""
    from dcrmontecarlo_tpu_torch.solver import WoStSolver

    out = {}
    pts = survey_points(electrodes, -0.5)
    for build in ("transport", "mis"):
        survey, _, options = survey_config(build)
        solver = WoStSolver(survey.build_problem(), options, device=dev)
        what = f"phase 43 ({build})"
        f = full_size_solves(wk, solver, pts, *SURVEY_RUN, 147456, what)
        name = wk.kernel_name((wk.ROBIN_OFF, False, build == "mis", False,
                               False, True, build == "transport", False,
                               False))
        check(f["loops"] == {"dealt": 1} and set(f["counts"]) == {name},
              f"{what}: the warm-up solve launched {f['counts']}, by loop "
              f"{f['loops']}")
        z = [float(np.max(np.abs(a.mean - b.mean)
                          / np.hypot(a.stderr, b.stderr)))
             for a, b in zip(f["raws"], f6["raws"])]
        check(max(z) < 4.0, f"{what}: the solves differ from phase 6's by "
                            f"{z} sigma")
        log(f"[43] full size 9x{SURVEY_RUN[0]} walks, 147456 lanes, "
            f"{build} ({name}; its dealt loop {report.get(name + ' (dealt)')}"
            f"): walker_steps_per_sec {f['rate']:.6g} s/solve "
            f"{f['times']} steps/solve {f['steps']:.6g} longest lane "
            f"{f['longest']} steps, lane occupancy {f['occupancy']:.4f}, "
            f"kernel share {[round(v, 4) for v in f['share']]}, launches of "
            f"the warm-up solve {f['counts']}, by loop {f['loops']}; largest "
            f"|{build} - phase 6| per solve {[round(v, 3) for v in z]} sigma "
            f"(bound 4); phase 6 in this run {f6['rate']:.6g} ({card})")
        out[build] = f
    return out


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU only",
              file=sys.stderr)
        sys.exit(2)

    from scipy.special import i0 as sp_i0

    from dcrmontecarlo_tpu_torch.geometry import Polyline, circle_loop, \
        square_loop
    from dcrmontecarlo_tpu_torch.models import drape_electrodes, \
        geophysical_scenario, interior_grid, notebook_survey, \
        poisson_solve_points, poisson_square, polynomial_manufactured, \
        topographic_survey_problem, trig_manufactured, \
        varcoeff_solve_points, variable_coefficient_problem
    from dcrmontecarlo_tpu_torch.ops import walk_kernel as wk
    from dcrmontecarlo_tpu_torch.problems import Problem, fields
    from dcrmontecarlo_tpu_torch.solver import SolverOptions, WoStSolver, \
        solve_to_tolerance
    from dcrmontecarlo_tpu_torch.solver.state import state_planes
    from dcrmontecarlo_tpu_torch.survey import DCRSurvey, \
        dipole_dipole_pairs, estimate_field, linearized_update, \
        run_pseudosection, sensitivity_map, surface_electrode_line, \
        survey_default_options, survey_jacobian
    from dcrmontecarlo_tpu_torch.validation import fdm_solve

    check("jax" not in sys.modules, "jax was imported")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    name = torch.cuda.get_device_name(0)
    nvsmi = subprocess.run(NVSMI_QUERY, capture_output=True, text=True,
                           timeout=60).stdout.strip().splitlines()
    check(bool(nvsmi), "nvidia-smi gave no card line")
    card = nvsmi[0].strip()
    survey, electrodes = geophysical_scenario(sharpness=0.5)
    t_start = time.perf_counter()

    # ---- 1. environment ------------------------------------------------
    nvcc = subprocess.run([wk._nvcc(), "--version"], capture_output=True,
                          text=True, timeout=60)
    log(f"[1] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {name} x{torch.cuda.device_count()} | card: {card} | "
        f"nvcc: {nvcc.stdout.strip().splitlines()[-1]}")

    # ---- 2. build -------------------------------------------------------
    from concurrent.futures import ThreadPoolExecutor

    site_pool = ThreadPoolExecutor(max_workers=len(SITE_VARIANTS))
    start_site_builds(wk, site_pool)
    libs, build_s, build_log = wk.build_library(SCRIPT_VARIANTS)
    regs = ptxas_registers(build_log)
    built = set(wk.build_logs)  # the codes built now, not found in _build
    # a build without the freeze holds a second kernel, for launches of
    # several shards
    check(set(regs) == {k for v in SCRIPT_VARIANTS
                        if wk.variant_code(v) in built
                        for k in built_kernels(wk, v)},
          f"built {sorted(built)}, ptxas reported {regs}")
    log(f"[2] {len(libs)} libraries, one per variant the script launches, "
        f"in "
        f"{os.path.relpath(os.path.dirname(next(iter(libs.values()))), ROOT)}"
        f": {len(built)} built in {build_s:.1f} s ({os.cpu_count()} nvcc "
        f"processes at a time), {len(libs) - len(built)} found there; "
        f"ptxas registers per variant: {regs}")
    # the freeze builds and the chain builds without the freeze run the
    # repack loop; the flagship's and the grid flagship's must not
    # spill (ptxas picks the others' registers, and several of those spill
    # a few words, as some one-thread builds do)
    report = ptxas_report(build_log)
    freeze = {wk.kernel_name(v): library_resources(wk, v)
              for v in SCRIPT_VARIANTS if wk.repacked(v)}
    schedules = {wk.kernel_name(v): repack_schedule(
        wk._library(wk._canonical(v))) for v in SCRIPT_VARIANTS
        if wk.repacked(v)}
    schedule = next(iter(schedules.values()))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    flagships = {wk.kernel_name(v) for v in PATH_VARIANTS if v[3]}
    spills = {k: (r["spill_stores"], r["spill_loads"])
              for k, r in report.items()
              if k in freeze and (r["spill_stores"] or r["spill_loads"])}
    check(len(flagships) == 2 and not set(spills) & flagships,
          f"the flagships' repack loop spills: {spills}")
    check(len(set(schedules.values())) == 1 and schedule[1] is not None,
          f"the repack builds' schedules: {schedules}")
    resident = {k: resident_blocks(schedules[k][0], *r, sms)
                for k, r in freeze.items()}
    resources = {k: (*r, resident[k]) for k, r in sorted(freeze.items())}
    log(f"[2] the {len(freeze)} freeze and chain builds run the "
        f"repack loop (as their libraries export it; the chain builds "
        f"without the freeze with the chain's wall work queued): "
        f"{schedule[0]} threads a "
        f"block, rounds of {schedule[1]} "
        f"iterations, a block refills from the launch's pool when "
        f"{schedule[2]} threads are free (the others one thread a lane, "
        f"128 a block); registers, shared memory bytes a block and blocks "
        f"on the card's {sms} SMs at once: {resources}; spills (store, load bytes): "
        f"{spills or 'none'}")

    # ---- 3. kernel vs plain, one launch, survey defaults --------------
    solver = WoStSolver(survey.build_problem(),
                        survey_default_options(target_slots=8192),
                        device=dev)
    state, params, _, _ = solver._setup(survey_points(electrodes, -0.1),
                                        8192, 500, 0.9, 3)
    check(state["px"].numel() == 8192, "phase 3 state is not 8192 lanes")
    wk.walk_plain(state, params, 200)      # reach mid-walk states
    ref = clone_state(state)
    before = wk.run_walk.launches
    wk.run_walk(state, params, 32)
    torch.cuda.synchronize()
    check(wk.run_walk.launches == before + 1, "launch count did not grow")
    wk.walk_plain(ref, params, 32)
    worst, max_err = check_planes(wk, state, ref, state_planes(params.n_src),
                                  "phase 3")
    log(f"[3] one 32-step launch, 8192 lanes, survey defaults: worst plane "
        f"agreement {worst:.5f}, max |err| on agreeing lanes {max_err:.3g}")

    # ---- 4. kernel vs plain, whole solve ------------------------------
    solver = WoStSolver(survey.build_problem(), survey_default_options(),
                        device=dev)
    pts = survey_points(electrodes, -0.1)
    rk = solver._solve_raw(pts, 512, 500, 0.9, 11)
    rp = solver._solve_raw(pts, 512, 500, 0.9, 11, walk=wk.walk_plain)
    check(np.isfinite(rk.mean).all() and np.isfinite(rk.stderr).all(),
          "kernel solve not finite")
    # the same counter-hash streams on both sides: the means differ by the
    # rounding of the sums alone, the step counts not at all
    dm = np.abs(rk.mean - rp.mean)
    scale = np.abs(rp.mean) + np.sqrt(rk.stderr ** 2 + rp.stderr ** 2)
    check((dm <= 1e-3 * scale).all(),
          f"solve means differ: {dm} > 1e-3 x {scale}")
    check(rk.total_steps == rp.total_steps,
          f"total steps differ: {rk.total_steps} vs {rp.total_steps}")
    log(f"[4] solve 9x512: max |dmean| {float(dm.max()):.3g}, max "
        f"|dmean|/(|mean|+se) {float((dm / scale).max()):.3g} (bound 1e-3), "
        f"max se {float(rp.stderr.max()):.3g}, steps kernel "
        f"{rk.total_steps:.0f} plain {rp.total_steps:.0f}")

    # ---- 5. physics: finite-volume oracle ------------------------------
    res = survey.run(electrodes, n_walks=1500, max_steps=800, eps=0.5,
                     seed=0, options=SolverOptions(target_slots=16384),
                     device=dev)
    prob = survey.build_problem()

    def np_field(f):
        return lambda X, Y: f(torch.as_tensor(X, dtype=torch.float32),
                              torch.as_tensor(Y, dtype=torch.float32)
                              ).numpy()

    fdm = fdm_solve(bounds=((-100.0, 100.0), (-200.0, 0.0)),
                            alpha=np_field(prob.alpha),
                            source=np_field(prob.source),
                            neumann_top=True, nx=321, ny=321)
    ref = fdm(res.electrodes)
    err = np.abs(res.potentials - ref)
    tol = 4.0 * res.potentials_stderr + 2e-4
    n_ok = int((err < tol).sum())
    check(n_ok >= 8, f"only {n_ok}/9 electrodes match the oracle: "
                     f"{res.potentials} vs {ref}")
    log(f"[5] oracle gate: {n_ok}/9 electrodes within 4 sigma + 2e-4")

    # ---- 6. full size: the main path ----------------------------------
    _, _, full = survey_config()
    solver = WoStSolver(survey.build_problem(), full, device=dev)
    pts = survey_points(electrodes, -0.5)
    n_walks, max_steps, eps = SURVEY_RUN
    f6 = full_size_solves(wk, solver, pts, n_walks, max_steps, eps, 147456,
                          "phase 6")
    check(f6["loops"] == {"dealt": 1},
          f"phase 6: the warm-up solve's launch ran the loops {f6['loops']}")
    log(f"[6] full size 9x{n_walks} walks, 147456 lanes: "
        f"dcr_survey_walker_steps_per_sec_per_chip {f6['rate']:.6g} "
        f"s/solve {f6['times']} steps/solve {f6['steps']:.6g} longest lane "
        f"{f6['longest']} steps, lane occupancy {f6['occupancy']:.4f}, "
        f"truncated walks {[round(v, 6) for v in f6['trunc']]}, "
        f"kernel share {[round(v, 4) for v in f6['share']]}, launches of "
        f"the warm-up solve {f6['counts']}, by loop {f6['loops']} ({card})")

    # ---- 7. kernel vs plain at the full-size state ---------------------
    state, params, _, step_bound = solver._setup(pts, n_walks, max_steps,
                                                 eps, 5)
    check(state["px"].numel() == 147456, "full state is not 147456 lanes")
    check(set(f6["counts"]) == {params.kernel_name},
          f"the survey path launched {f6['counts']}, expected "
          f"{params.kernel_name} only")
    wk.run_walk.loop_launches.clear()
    t7 = steps_256(wk, state, params, "phase 7")
    check(set(wk.run_walk.loop_launches) == {"lanes"},
          f"phase 7: the 256-step launches ran {wk.run_walk.loop_launches}")
    log(f"[7] 256 steps x 147456 lanes (one thread a lane): kernel "
        f"{t7['ms']:.3f} ms, plain "
        f"{t7['plain_ms']:.3f} ms ({t7['plain_ms'] / t7['ms']:.1f}x); worst "
        f"plane agreement {t7['worst']:.5f}, max |err| on agreeing lanes "
        f"{t7['max_err']:.3g} ({card})")
    # the whole solve's single launch: its walks dealt to the threads
    d7 = dealt_launch(wk, state, params, step_bound, "phase 7")
    log(f"[7] {dealt_text(d7, params, card)}")
    tolerance = (f">={wk.PLANE_MIN_FRAC:.0%} of lanes per plane within "
                 f"rel {wk.PLANE_RTOL:g} + {wk.PLANE_FLOOR:g} x plane max")
    records = [dict(kernel_record(params, "survey",
                                  f6["counts"][params.kernel_name], t7,
                                  regs, tolerance),
                    whole_launch_ms=d7["ms"], whole_launch_steps=d7["steps"],
                    loops=f6["loops"])]
    survey_full = (solver, pts, params)   # phase 12 reuses the full state

    # ---- the accuracy path: the notebook survey ------------------------
    nb_survey, nb_electrodes = notebook_survey()
    nb_survey.local_majorant = "auto"
    nb_prob = nb_survey.build_problem()
    mj = nb_prob.local_majorant
    check(mj is not None and len(mj.boxes) == 2 and not mj.bands,
          f"notebook majorant is {mj}, expected 2 boxes and no band")
    nb_pts = np.asarray(nb_electrodes, np.float32)

    # ---- 8. kernel vs plain, one launch, chain and reflectance ---------
    for mode in ("auto", "reflectance"):
        solver = WoStSolver(nb_prob, survey_default_options(
            target_slots=8192, robin_correction=mode), device=dev)
        check(solver._robin_enabled() == ("chain" if mode == "auto"
                                          else mode),
              f"robin_correction={mode!r} resolved to "
              f"{solver._robin_enabled()!r}")
        state, params, _, _ = solver._setup(nb_pts, 8192, 6000, 1.0, 3)
        check(state["px"].numel() == 8192, "phase 8 state is not 8192 lanes")
        wk.walk_plain(state, params, 200)
        start = clone_state(state)
        ref = clone_state(state)
        before = wk.run_walk.launches
        wk.run_walk(state, params, 32)
        torch.cuda.synchronize()
        check(wk.run_walk.launches == before + 1, "launch count did not grow")
        wk.walk_plain(ref, params, 32)
        worst8, err8 = check_planes(wk, state, ref,
                                    state_planes(params.n_src),
                                    f"phase 8 ({mode})")
        shares = {}
        for off, p_off in (("robin", dataclasses.replace(
                params, robin=wk.ROBIN_OFF)), ("majorant",
                dataclasses.replace(params, majorant=None))):
            other = clone_state(start)
            wk.run_walk(other, p_off, 32)
            shares[off] = lanes_differ(state, other)
            check(shares[off] >= 0.01,
                  f"phase 8 ({mode}): switching the {off} off changed only "
                  f"{shares[off]:.4f} of lanes")
        log(f"[8] one 32-step launch, 8192 lanes, notebook {params.robin=} "
            f"(1 chain, 2 reflectance) + majorant: worst plane agreement "
            f"{worst8:.5f}, max |err| on agreeing lanes {err8:.3g}; lanes "
            f"changed with the mechanism off: {shares}")

    # ---- 9. kernel vs plain, whole solve, accuracy configuration ------
    solver = WoStSolver(nb_prob, survey_default_options(target_slots=1 << 17),
                        device=dev)
    rk = solver._solve_raw(nb_pts, 512, 6000, 1.0, 11)
    rp = solver._solve_raw(nb_pts, 512, 6000, 1.0, 11, walk=wk.walk_plain)
    check(np.isfinite(rk.mean).all() and np.isfinite(rk.stderr).all(),
          "phase 9 kernel solve not finite")
    dm = np.abs(rk.mean - rp.mean)
    scale = np.abs(rp.mean) + np.sqrt(rk.stderr ** 2 + rp.stderr ** 2)
    check((dm <= 1e-3 * scale).all(),
          f"phase 9 solve means differ: {dm} > 1e-3 x {scale}")
    check(rk.total_steps == rp.total_steps,
          f"phase 9 total steps differ: {rk.total_steps} vs {rp.total_steps}")
    log(f"[9] solve 21x512 (chain + majorant): max |dmean| "
        f"{float(dm.max()):.3g}, max |dmean|/(|mean|+se) "
        f"{float((dm / scale).max()):.3g} (bound 1e-3), steps kernel "
        f"{rk.total_steps:.0f} plain {rp.total_steps:.0f}")

    # ---- 10. physics: the accuracy preset against the pinned oracle ----
    with np.load(os.path.join(ROOT, "dcrmontecarlo_tpu", "validation",
                              "pins", "notebook_oracle.npz")) as z:
        pins = {k: z[k] for k in z.files}
    check(np.allclose(pins["electrodes"], nb_electrodes, atol=1e-5),
          "pinned electrodes differ from the survey's")
    solver = nb_survey.make_solver(survey_default_options(
        target_slots=1 << 17), device=dev)
    nb_survey.run(nb_electrodes, n_walks=4096, max_steps=6000, eps=1.0,
                  seed=999, solver=solver)                    # warm-up
    dv_errs, times, steps10 = [], [], 0.0
    for seed in range(8):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = nb_survey.run(nb_electrodes, n_walks=4096, max_steps=6000,
                            eps=1.0, seed=seed, solver=solver)
        times.append(time.perf_counter() - t0)
        steps10 += res.solve.total_steps
        err = res.potentials - pins["fdm_401"]
        n_pot = int((np.abs(err) < 4.0 * res.potentials_stderr + 3.5).sum())
        cm = float(np.median(err))
        dv_dev = np.abs(res.voltages - pins["dv_401"]) / (
            4.0 * res.voltages_stderr + 0.25)
        check(np.isfinite(res.potentials).all(), f"seed {seed} not finite")
        check((dv_dev < 1.0).all(),
              f"seed {seed}: dipole voltages off the oracle, worst "
              f"|err|/(4 sigma + 0.25) {float(dv_dev.max()):.3f}")
        check(-25.0 < cm < 3.0,
              f"seed {seed}: median signed potential error {cm:.3f}")
        check(n_pot >= 19,
              f"seed {seed}: only {n_pot}/21 potentials within 4 sigma + 3.5")
        dv_errs.append(np.abs(res.voltages - pins["dv_401"]))
        log(f"[10] seed {seed}: dV worst |err|/(4 sigma + 0.25) "
            f"{float(dv_dev.max()):.3f}, median signed potential error "
            f"{cm:.3f}, potentials within 4 sigma + 3.5: {n_pot}/21, "
            f"steps {res.solve.total_steps:.0f}, {times[-1]:.4f} s")
    med_err = float(np.median(np.stack(dv_errs)))
    t_solve = sum(times) / len(times)
    log(f"[10] accuracy preset, 8 seeds x 4096 walks: med|dV err| "
        f"{med_err:.4g}, s/solve {t_solve:.4f}, err*sqrt(t) "
        f"{med_err * np.sqrt(t_solve):.4g}, steps/solve {steps10 / 8:.6g} "
        f"({card})")

    # ---- 11. full size: the accuracy path ------------------------------
    full = survey_default_options(target_slots=1 << 21, min_quota=32)
    solver = nb_survey.make_solver(full, device=dev)
    n_walks, max_steps, eps = 1 << 20, 6000, 1.0
    f11 = full_size_solves(wk, solver, nb_pts, n_walks, max_steps, eps,
                           688128, "phase 11")
    log(f"[11] full size 21x{n_walks} walks, 688128 lanes, chain + "
        f"majorant: walker_steps_per_sec {f11['rate']:.6g} s/solve "
        f"{f11['times']} steps/solve {f11['steps']:.6g} longest lane "
        f"{f11['longest']} steps, lane occupancy {f11['occupancy']:.4f}, "
        f"kernel share {[round(v, 4) for v in f11['share']]}, launches of "
        f"the warm-up solve {f11['counts']} ({card})")
    state, params, _, _ = solver._setup(nb_pts, n_walks, max_steps, eps, 5)
    check(state["px"].numel() == 688128, "phase 11 state is not 688128 lanes")
    check(params.robin == wk.ROBIN_CHAIN and params.majorant is not None,
          "phase 11 does not run the chain + majorant variant")
    check(set(f11["counts"]) == {params.kernel_name},
          f"the accuracy path launched {f11['counts']}")
    t11 = steps_256(wk, state, params, "phase 11", subset=True)
    log(f"[11] 256 steps x {t11['lanes']} lanes"
        f"{' (plain 16 steps took %.0f ms)' % t11['t16'] if t11['t16'] else ''}"
        f": kernel {t11['ms']:.3f} ms, plain {t11['plain_ms']:.3f} ms "
        f"({t11['plain_ms'] / t11['ms']:.1f}x); worst plane agreement "
        f"{t11['worst']:.5f}, max |err| on agreeing lanes "
        f"{t11['max_err']:.3g} ({card})")
    log(f"[11] {params.kernel_name}: {regs.get(params.kernel_name)} "
        f"registers; sites' shares of the one-thread loop's warp-cycles "
        f"(256 steps, site clocks): {site_shares(wk, state, params)} "
        f"({card})")
    records.append(kernel_record(
        params, "robin_chain+local_majorant",
        f11["counts"][params.kernel_name], t11, regs, tolerance))
    # the two instantiations no main path launches, timed at that state
    # for their bounds (they take no record: no path counts their launches)
    for what, robin in (("reflectance+majorant", wk.ROBIN_REFLECTANCE),
                        ("majorant alone", wk.ROBIN_OFF)):
        p11 = dataclasses.replace(params, robin=robin)
        t = steps_256(wk, state, p11, f"phase 11 ({what})", subset=True)
        b_ms, b_by = bound(p11, t["lanes"], t["steps"], 1)
        log(f"[11] {what} ({p11.kernel_name}), 256 steps x {t['lanes']} "
            f"lanes: kernel {t['ms']:.3f} ms, plain {t['plain_ms']:.3f} ms; "
            f"worst plane agreement {t['worst']:.5f}; {t['steps']} "
            f"walker-steps, bound {b_ms:.4f} ms ({b_by}), "
            f"{regs.get(p11.kernel_name)} registers ({card})")

    # ---- the flagship notebook gate's path -------------------------------
    flag_survey, _ = notebook_survey()
    flag_survey.local_majorant = "auto"
    flag_survey.source_mis = True
    flag_prob = flag_survey.build_problem()
    check(flag_prob.source_importance is not None
          and flag_prob.local_majorant is not None,
          "the flagship problem has no mixture or no majorant")

    # ---- 12. kernel vs plain, one launch with MIS (and the freeze) ------
    mis_survey, _ = geophysical_scenario(sharpness=0.5)
    mis_survey.source_mis = True
    cases12 = (("flagship", flag_prob, nb_pts, dict(split_threshold=4.0),
                6000, 1.0),
               ("survey+mis", mis_survey.build_problem(),
                survey_points(electrodes, -0.1), {}, 500, 0.9))
    for what, prob12, pts12, extra, ms12, eps12 in cases12:
        solver = WoStSolver(prob12, survey_default_options(
            target_slots=8192, **extra), device=dev)
        state, params, _, _ = solver._setup(pts12, 8192, ms12, eps12, 3)
        check(state["px"].numel() == 8192, "phase 12 state is not 8192 lanes")
        check(params.mis_table is not None
              and params.freeze == ("split_threshold" in extra),
              f"phase 12 ({what}) runs {params.kernel_name}")
        thr = 4.0 if params.freeze else None
        wk.walk_plain(state, params, 200)      # mid-walk states, no freeze
        start = clone_state(state)
        ref = clone_state(state)
        before = wk.run_walk.launches
        wk.run_walk(state, params, 32, freeze_thr=thr)
        torch.cuda.synchronize()
        check(wk.run_walk.launches == before + 1, "launch count did not grow")
        wk.walk_plain(ref, params, 32, freeze_thr=thr)
        worst12, err12 = check_planes(wk, state, ref,
                                      state_planes(params.n_src),
                                      f"phase 12 ({what})")
        no_mix = clone_state(start)
        wk.walk_plain(no_mix, dataclasses.replace(params, mis_table=None),
                      32, freeze_thr=thr)
        shares = {"mis": lanes_differ(state, no_mix, ("acc0", "asum0"))}
        check(shares["mis"] >= 0.01,
              f"phase 12 ({what}): without the mixture only "
              f"{shares['mis']:.4f} of lanes bank otherwise")
        if params.freeze:
            frozen = int(((state["quota"] > 0)
                          & (state["atten"].abs() > thr)).sum())
            check(frozen >= 1, f"phase 12 ({what}): no lane ended frozen")
            open_ = clone_state(start)
            wk.run_walk(open_, params, 32, freeze_thr=float("inf"))
            shares["freeze"] = lanes_differ(state, open_)
            shares["frozen_lanes"] = frozen
            check(shares["freeze"] > 0.0,
                  f"phase 12 ({what}): thr = +inf changed nothing")
        log(f"[12] one 32-step launch, 8192 lanes, {what} "
            f"({params.kernel_name}): worst plane agreement {worst12:.5f}, "
            f"max |err| on agreeing lanes {err12:.3g}; mechanisms: {shares}")

    # MIS on the survey path: launches from a solve through the entry
    # point, times at phase 7's full-size state with the mixture
    wk.run_walk.launches = 0
    wk.run_walk.variant_launches.clear()
    res = mis_survey.run(electrodes, n_walks=2048, max_steps=500, eps=0.9,
                         seed=0, device=dev)
    check(np.isfinite(res.potentials).all(), "survey+mis solve not finite")
    counts12 = dict(wk.run_walk.variant_launches)
    solver7, pts7, params7 = survey_full
    solver = WoStSolver(mis_survey.build_problem(), solver7.options,
                        device=dev)
    state, params, _, bound12 = solver._setup(pts7, 1 << 19, 500, 0.9, 5)
    check(params.variant == dataclasses.replace(
        params7, mis_table=params.mis_table).variant,
          "the survey+mis state is not phase 7's configuration with MIS")
    mis_name = params.kernel_name
    check(set(counts12) == {mis_name},
          f"the survey with source_mis launched {counts12}")
    t12 = steps_256(wk, state, params, "phase 12 (survey+mis, full size)")
    log(f"[12] survey+mis 256 steps x 147456 lanes: kernel {t12['ms']:.3f} "
        f"ms, plain {t12['plain_ms']:.3f} ms "
        f"({t12['plain_ms'] / t12['ms']:.1f}x); worst plane agreement "
        f"{t12['worst']:.5f}, max |err| {t12['max_err']:.3g}; the survey "
        f"solve with source_mis launched {counts12} ({card})")
    # the solve's single launch with MIS: its walks dealt to the threads
    d12 = dealt_launch(wk, state, params, bound12, "phase 12 (survey+mis)")
    log(f"[12] survey+mis, {dealt_text(d12, params, card)}")
    records.append(dict(kernel_record(params, "survey+mis",
                                      counts12[mis_name], t12, regs,
                                      tolerance),
                        whole_launch_ms=d12["ms"],
                        whole_launch_steps=d12["steps"], loops=d12["loops"]))

    # ---- 13. kernel vs plain, whole host-loop solve, flagship ----------
    solver = WoStSolver(flag_prob, survey_default_options(
        target_slots=1 << 17, split_threshold=4.0), device=dev)
    t0 = time.perf_counter()
    rk = solver._solve_raw(nb_pts, 256, 150, 1.0, 11)
    stats_k = solver.last_solve_stats
    t_k = time.perf_counter() - t0
    rp = solver._solve_raw(nb_pts, 256, 150, 1.0, 11, walk=wk.walk_plain)
    stats_p = solver.last_solve_stats
    t_p = time.perf_counter() - t0 - t_k
    check(np.isfinite(rk.mean).all() and np.isfinite(rk.stderr).all(),
          "phase 13 kernel solve not finite")
    dm = np.abs(rk.mean - rp.mean)
    scale = np.abs(rp.mean) + np.sqrt(rk.stderr ** 2 + rp.stderr ** 2)
    check((dm <= 1e-3 * scale).all(),
          f"phase 13 solve means differ: {dm} > 1e-3 x {scale}")
    check(rk.total_steps == rp.total_steps,
          f"phase 13 total steps differ: {rk.total_steps} vs "
          f"{rp.total_steps}")
    check(stats_k == stats_p and stats_k["clones"] > 0,
          f"phase 13 launches or clones differ, or none: {stats_k} vs "
          f"{stats_p}")
    log(f"[13] host-loop solve 21x256, max_steps 150 (flagship): max "
        f"|dmean|/(|mean|+se) "
        f"{float((dm / scale).max()):.3g} (bound 1e-3), steps kernel "
        f"{rk.total_steps:.0f} plain {rp.total_steps:.0f}, kernel "
        f"{stats_k}, plain {stats_p}; {t_k:.2f} s kernel, {t_p:.2f} s plain")

    # ---- 14. physics: the flagship gate against the pinned oracle -------
    solver = flag_survey.make_solver(survey_default_options(
        target_slots=65536, split_threshold=4.0), device=dev)
    check(solver._robin_enabled() == "chain", "flagship Robin is not chain")
    x = nb_electrodes[:, 0]
    for seed in (0, 1, 2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = flag_survey.run(nb_electrodes, n_walks=2500, max_steps=6000,
                              eps=1.0, seed=seed, solver=solver)
        t14 = time.perf_counter() - t0
        check(np.isfinite(res.potentials).all(), f"seed {seed} not finite")
        # the gate's three bounds (test_dcr_survey.py:233-243); the
        # potentials at the current electrodes are printed, not held to
        # a sign: the host loop's heavy tail can flip one (PERF.md)
        at_src = (float(res.potentials[np.abs(x + 200) <= 40].mean()),
                  float(res.potentials[np.abs(x - 200) <= 40].mean()))
        err = res.potentials - pins["fdm_401"]
        n_pot = int((np.abs(err) < 4.0 * res.potentials_stderr + 3.5).sum())
        cm = float(np.median(err))
        dv_dev = np.abs(res.voltages - pins["dv_401"]) / (
            4.0 * res.voltages_stderr + 0.25)
        check(n_pot >= 19,
              f"seed {seed}: only {n_pot}/21 potentials within 4 sigma + 3.5")
        check(-25.0 < cm < 3.0,
              f"seed {seed}: median signed potential error {cm:.3f}")
        check((dv_dev < 1.0).all(),
              f"seed {seed}: dipole voltages off the oracle, worst "
              f"|err|/(4 sigma + 0.25) {float(dv_dev.max()):.3f}")
        log(f"[14] flagship gate seed {seed}: potentials within 4 sigma + "
            f"3.5: {n_pot}/21, median signed error {cm:.3f}, dV worst "
            f"|err|/(4 sigma + 0.25) {float(dv_dev.max()):.3f}, med|dV err| "
            f"{float(np.median(np.abs(res.voltages - pins['dv_401']))):.4g}, "
            f"potentials at the electrodes x = -200, +200: "
            f"{at_src[0]:.4g}, {at_src[1]:.4g}, max banked "
            f"{res.solve.max_banked:.3g}, steps {res.solve.total_steps:.0f}, "
            f"{solver.last_solve_stats}, {t14:.3f} s ({card})")

    # ---- 15. full size: the flagship path -------------------------------
    full = survey_default_options(target_slots=1 << 21, min_quota=32,
                                  split_threshold=4.0)
    solver = flag_survey.make_solver(full, device=dev)
    n_walks, max_steps, eps = 1 << 20, 6000, 1.0
    f15 = full_size_solves(wk, solver, nb_pts, n_walks, max_steps, eps,
                           688128, "phase 15")
    log(f"[15] full size 21x{n_walks} walks, 688128 lanes, flagship: "
        f"walker_steps_per_sec {f15['rate']:.6g} s/solve {f15['times']} "
        f"steps/solve {f15['steps']:.6g} longest lane {f15['longest']} "
        f"steps, lane occupancy {f15['occupancy']:.4f}, launches and clones "
        f"per solve {f15['stats']}, kernel share of wall time "
        f"{[round(v, 4) for v in f15['share']]} ({card})")
    state, params, _, _ = solver._setup(nb_pts, n_walks, max_steps, eps, 5)
    check(state["px"].numel() == 688128, "phase 15 state is not 688128 lanes")
    check(params.variant == (wk.ROBIN_CHAIN, True, True, True, False, True,
                             False, False, False),
          f"phase 15 runs {params.kernel_name}")
    check(f15["counts"] == {params.kernel_name: f15["stats"][0]["launches"]}
          and f15["stats"][0]["launches"] > 1,
          f"the flagship solve launched {f15['counts']}, {f15['stats'][0]}")
    _, a15 = launch_anatomy(wk, solver, nb_pts, n_walks, max_steps, eps, 0,
                            schedules[params.kernel_name],
                            resident[params.kernel_name], 8)
    log(f"[15] the solve's {a15['launches']} launches one by one (seed 0): "
        f"kernel ms per launch median {a15['ms_median']:.4f} max "
        f"{a15['ms_max']:.3f}, {a15['kernel_ms']:.1f} ms in all, "
        f"{a15['inf_launches']} at thr = +inf; warp efficiency, "
        f"modelled on the host, "
        f"{a15['eff_sched']:.4f} (iterations over the thread-slots of the "
        f"kernel's schedule, replayed on {resident[params.kernel_name]} "
        f"blocks, every 8th launch), {a15['eff_life']:.4f} (lane-steps, "
        f"one thread a lane) ({card})")
    t15 = steps_256(wk, state, params, "phase 15", thr=4.0, subset=True)
    log(f"[15] 256 steps x {t15['lanes']} lanes, freeze 4.0"
        f"{' (plain 16 steps took %.0f ms)' % t15['t16'] if t15['t16'] else ''}"
        f": kernel {t15['ms']:.3f} ms, plain {t15['plain_ms']:.3f} ms "
        f"({t15['plain_ms'] / t15['ms']:.1f}x); worst plane agreement "
        f"{t15['worst']:.5f}, max |err| on agreeing lanes "
        f"{t15['max_err']:.3g}, {t15['steps']} walker-steps ({card})")
    records.append(kernel_record(
        params, "robin_chain+local_majorant+mis+freeze",
        f15["counts"][params.kernel_name], t15, regs, tolerance))
    # ---- the topographic survey: silhouettes, the two geometry forms ----
    xs_topo = np.arange(-40.0, 41.0, 10.0)
    topo_small = dict(half_width=100.0, depth=150.0)

    def launch_256(prob, pts, opts, what, n_walks, max_steps, eps,
                   off_params=None, acts_on=("atten", "px")):
        """Phases 16-18 and 21-23: 256 steps of kernel and plain version
        from a fresh 8,192-lane state, timed and held to phase 3's rule;
        with ``off_params``, the same launch with ``off_params(params)``
        must change >= 1% of lanes in a plane of ``acts_on`` (the share is
        ``t["acts"]``). Returns ``(solver, state, params, t)``."""
        solver = WoStSolver(prob, dataclasses.replace(opts, target_slots=8192),
                            device=dev)
        state, params, _, _ = solver._setup(pts, n_walks, max_steps, eps, 3)
        check(state["px"].numel() == 8192, f"{what}: not 8192 lanes")
        t = steps_256(wk, state, params, what)
        if off_params is not None:
            other = clone_state(state)
            wk.run_walk(other, off_params(params), 256)
            t["acts"] = lanes_differ(t["end"], other, acts_on)
            check(t["acts"] >= 0.01, f"{what}: switching the mechanism off "
                                     f"changed only {t['acts']:.4f} of lanes")
        return solver, state, params, t

    def solve_launches(solver, pts, what, name=None, **kw):
        """A solve through ``WoStSolver.solve`` with the launch counts set
        to 0 just before it and read just after: ``(result, counts)``;
        with ``name``, the solve must have launched that instantiation
        only."""
        wk.run_walk.launches = 0
        wk.run_walk.variant_launches.clear()
        res = solver.solve(pts, **kw)
        counts = dict(wk.run_walk.variant_launches)
        check(sum(counts.values()) == wk.run_walk.launches > 0,
              f"{what}: the solve launched {counts}")
        check(np.isfinite(res.mean).all(), f"{what}: solve not finite")
        check(name is None or set(counts) == {name},
              f"{what}: the solve launched {counts}, expected {name}")
        return res, counts

    no_vertices = lambda p: dataclasses.replace(p, vert_table=p.vert_table[:0])

    # ---- 16. the table form, one launch, the defaults -------------------
    topo_prob, topo_h = topographic_survey_problem()
    topo_pts = drape_electrodes(topo_h, xs_topo, nudge=0.5)
    check(wk.geometry_size(topo_prob) == 402, "the terrain is not 402 rows")
    _, _, p16, t16 = launch_256(topo_prob, topo_pts, SolverOptions(),
                                "phase 16", 8192, 600, 0.5, no_vertices)
    check(p16.table and p16.variant == (wk.ROBIN_OFF, False, False, False,
                                        True, True, False, False, False),
          f"phase 16 runs {p16}")
    # the JAX regression test_pallas_smem_sees_trailing_segments: a square
    # whose right edge is its table's last three rows
    sq = []
    for (a, b, n, first) in (((1, 1), (-1, 1), 32, True),
                             ((-1, 1), (-1, -1), 32, False),
                             ((-1, -1), (1, -1), 33, False),
                             ((1, -1), (1, 1), 3, False)):
        for k in range(0 if first else 1, n + 1):
            sq.append([a[0] + k / n * (b[0] - a[0]),
                       a[1] + k / n * (b[1] - a[1])])
    sq_prob = Problem(dirichlet=Polyline.from_points(sq),
                      bc_dirichlet=fields.constant(1.0),
                      alpha=fields.constant(1.0))
    sq_solver = WoStSolver(sq_prob, SolverOptions(target_slots=8192),
                           device=dev)
    state, p_sq, _, _ = sq_solver._setup(np.zeros((1, 2), np.float32), 8192,
                                         60, 1e-3, 0)
    check(p_sq.table and len(p_sq.dir_table) == 100, "square not tabled")
    ref = clone_state(state)
    wk.run_walk(state, p_sq, 60)
    wk.walk_plain(ref, p_sq, 60)
    worst_sq, _ = check_planes(wk, state, ref, state_planes(1), "phase 16 "
                               "(trailing rows)")
    reach = float(torch.maximum(state["px"].abs(), state["py"].abs()).max())
    check(reach <= 1.0 + 1e-5, f"a walker left the square: |x| {reach}")
    log(f"[16] table form, defaults (402 rows), 256 steps x 8192 lanes "
        f"({p16.kernel_name}, {regs.get(p16.kernel_name)} registers): "
        f"kernel {t16['ms']:.3f} ms, plain {t16['plain_ms']:.3f} ms; worst "
        f"plane agreement {t16['worst']:.5f}, max |err| {t16['max_err']:.3g}"
        f"; rows a step visits: {cull_text(cull_rows(wk, p16, t16['end']))}"
        f"; without the vertices {t16['acts']:.4f} of lanes change; "
        f"trailing rows: agreement {worst_sq:.5f}, farthest walker at "
        f"{reach:.6f} of the half-width ({card})")

    # ---- 17. the static form with silhouettes ----------------------------
    prob17, h17 = topographic_survey_problem(resolution=8.0, **topo_small)
    pts17 = drape_electrodes(h17, xs_topo, nudge=0.5)
    check(wk.geometry_size(prob17) == 52, "resolution 8 is not 52 rows")
    solver17, _, p17, t17 = launch_256(prob17, pts17, SolverOptions(),
                                       "phase 17", 8192, 600, 0.5,
                                       no_vertices)
    check(not p17.table and len(p17.vert_table) == 24,
          f"phase 17 runs {p17.kernel_name}")
    n17 = solve_launches(solver17, pts17, "phase 17", p17.kernel_name,
                         n_walks=512, max_steps=600, eps=0.5,
                         seed=0)[1][p17.kernel_name]
    log(f"[17] static form with silhouettes (52 rows), 256 steps x 8192 "
        f"lanes: kernel {t17['ms']:.3f} ms, plain {t17['plain_ms']:.3f} ms; "
        f"worst plane agreement {t17['worst']:.5f}, max |err| "
        f"{t17['max_err']:.3g}; without the vertices {t17['acts']:.4f} of "
        f"lanes change; a 9x512 solve launched {n17} ({card})")

    # ---- 18. the chord chain on a table geometry -------------------------
    prob18, h18 = topographic_survey_problem(resolution=4.0, **topo_small)
    pts18 = drape_electrodes(h18, xs_topo, nudge=0.5)
    solver18, _, p18, t18 = launch_256(
        prob18, pts18, SolverOptions(robin_correction="chain"), "phase 18",
        8192, 600, 0.5, lambda p: dataclasses.replace(p, robin=wk.ROBIN_OFF))
    check(p18.variant == (wk.ROBIN_CHAIN, False, False, False, True, True,
                          False, False, False),
          f"phase 18 runs {p18.kernel_name}")
    n18 = solve_launches(solver18, pts18, "phase 18", p18.kernel_name,
                         n_walks=512, max_steps=600, eps=0.5,
                         seed=0)[1][p18.kernel_name]
    rows18 = cull_rows(wk, p18, t18["end"])
    log(f"[18] chain on the table form (102 rows), 256 steps x 8192 lanes "
        f"({regs.get(p18.kernel_name)} registers): "
        f"kernel {t18['ms']:.3f} ms, plain {t18['plain_ms']:.3f} ms; worst "
        f"plane agreement {t18['worst']:.5f}, max |err| {t18['max_err']:.3g}"
        f"; rows a step visits: {cull_text(rows18)}"
        f"; Robin off changes {t18['acts']:.4f} of lanes; a 9x512 solve "
        f"launched {n18} ({card})")

    # ---- 19. kernel vs plain, whole solve, test size ---------------------
    solver = WoStSolver(prob18, SolverOptions(), device=dev)
    rk = solver._solve_raw(pts18, 512, 600, 0.5, 11)
    rp = solver._solve_raw(pts18, 512, 600, 0.5, 11, walk=wk.walk_plain)
    check(np.isfinite(rk.mean).all() and np.isfinite(rk.stderr).all(),
          "phase 19 kernel solve not finite")
    dm = np.abs(rk.mean - rp.mean)
    scale = np.abs(rp.mean) + np.sqrt(rk.stderr ** 2 + rp.stderr ** 2)
    check((dm <= 1e-3 * scale).all(),
          f"phase 19 solve means differ: {dm} > 1e-3 x {scale}")
    check(rk.total_steps == rp.total_steps,
          f"phase 19 total steps differ: {rk.total_steps} vs "
          f"{rp.total_steps}")
    log(f"[19] solve 9x512 on the terrain (table form): max |dmean|/"
        f"(|mean|+se) {float((dm / scale).max()):.3g} (bound 1e-3), steps "
        f"kernel {rk.total_steps:.0f} plain {rp.total_steps:.0f}")

    # ---- 20. full size: the topographic path -----------------------------
    solver = WoStSolver(topo_prob, SolverOptions(target_slots=1 << 21),
                        device=dev)
    n_walks, max_steps, eps = 1 << 17, 600, 0.5
    f20 = full_size_solves(wk, solver, topo_pts, n_walks, max_steps, eps,
                           294912, "phase 20")
    mean20 = f20["warm"].mean
    i_pos = int(np.argmin(np.abs(xs_topo + 20)))
    i_neg = int(np.argmin(np.abs(xs_topo - 20)))
    check(mean20[i_pos] > 0 and mean20[i_neg] < 0
          and np.abs(mean20).max() < 1.0,
          f"phase 20 potentials break the survey's physics: {mean20}")
    state, params, _, _ = solver._setup(topo_pts, n_walks, max_steps, eps, 5)
    check(state["px"].numel() == 294912, "phase 20 state is not 294912 lanes")
    check(set(f20["counts"]) == {params.kernel_name} and params.table,
          f"the topographic path launched {f20['counts']}")
    log(f"[20] full size 9x{n_walks} walks, 294912 lanes, table form: "
        f"walker_steps_per_sec {f20['rate']:.6g} s/solve {f20['times']} "
        f"steps/solve {f20['steps']:.6g} longest lane {f20['longest']} "
        f"steps, lane occupancy {f20['occupancy']:.4f}, truncated share "
        f"{[round(v, 4) for v in f20['trunc']]}, kernel share "
        f"{[round(v, 4) for v in f20['share']]}, launches of the warm-up "
        f"solve {f20['counts']}; potentials {np.round(mean20, 5).tolist()} "
        f"({card})")
    t20 = steps_256(wk, state, params, "phase 20", subset=True)
    rows20 = cull_rows(wk, params, t20["end"])
    log(f"[20] 256 steps x {t20['lanes']} lanes"
        f"{' (plain 16 steps took %.0f ms)' % t20['t16'] if t20['t16'] else ''}"
        f" ({params.kernel_name}, {regs.get(params.kernel_name)} registers)"
        f": kernel {t20['ms']:.3f} ms, plain {t20['plain_ms']:.3f} ms "
        f"({t20['plain_ms'] / t20['ms']:.1f}x); worst plane agreement "
        f"{t20['worst']:.5f}, max |err| {t20['max_err']:.3g}, "
        f"{t20['steps']} walker-steps; rows a step visits after them: "
        f"{cull_text(rows20)} ({card})")
    records.append(kernel_record(params, "topography_table",
                                 f20["counts"][params.kernel_name], t20,
                                 regs, tolerance, rows=rows20))
    records.append(kernel_record(p18, "topography_table+robin_chain", n18,
                                 t18, regs, tolerance, rows=rows18))
    records.append(kernel_record(p17, "topography_static_silhouettes", n17,
                                 t17, regs, tolerance))
    # ---- the analytic-check problems: no delta tracking, the transport --
    # ---- sampler, TERMS field specs (phases 21-26) -----------------------
    P4 = np.array([[0.0, 0.0], [1.0, 0.5], [-1.2, -0.7], [0.3, 1.5]],
                  np.float32)
    BOX = [[-2.0, 0.0], [-2.0, -4.0], [2.0, -4.0], [2.0, 0.0]]
    WALL = [[-2.0, 0.0], [2.0, 0.0]]
    xy2 = fields.polynomial({(2, 0): 1.0, (0, 2): 1.0})

    def table_square(per_side=25):
        """The Poisson square with ``per_side`` segments per side (100
        rows: the table form, rows far past the static form's 96)."""
        c = [(2.0, 2.0), (-2.0, 2.0), (-2.0, -2.0), (2.0, -2.0)]
        sq_pts = [[a[0] + k / per_side * (b[0] - a[0]),
                   a[1] + k / per_side * (b[1] - a[1])]
                  for a, b in zip(c, c[1:] + c[:1]) for k in range(per_side)]
        return Problem(dirichlet=Polyline.from_points(sq_pts + [list(c[0])]),
                       bc_dirichlet=xy2, source=fields.constant(-4.0))

    # ---- 21. no delta tracking, one launch ------------------------------
    harmonic = Problem(dirichlet=square_loop(1.0),
                       bc_dirichlet=fields.polynomial({(1, 0): 1.0,
                                                       (0, 1): 2.0}))
    # the Green's-radius NEE acts: the same launch without the source
    # banks otherwise on >= 1% of lanes
    no_source = lambda p: dataclasses.replace(p, sources=(),
                                              specs=p.specs[:3])
    cases21 = (
        ("harmonic square", harmonic,
         [[0.0, 0.0], [0.5, 0.3], [-0.7, -0.2], [0.2, -0.8]], 1e-3, 200,
         None),
        ("Poisson square", poisson_square()[0], P4, 1e-3, 300, no_source),
        ("Neumann box", Problem(
            dirichlet=Polyline.from_points(BOX),
            neumann=Polyline.from_points(WALL),
            bc_dirichlet=fields.polynomial({(1, 0): 1.0, (0, 1): 1.0})),
         [[0.0, -1.0], [0.5, -0.5], [-1.5, -0.02]], 1e-2, 500, None),
        ("Poisson square + circle obstacle", poisson_square(True)[0],
         [[1.0, 1.0], [0.7, 0.0], [0.0, -1.5], [-0.55, 0.1]], 1e-3, 500,
         None),
        ("table-form square", table_square(), P4, 1e-3, 300, None))
    t21 = {}
    for what, prob, pts, eps, ms, off in cases21:
        _, _, params, t = launch_256(
            prob, np.asarray(pts, np.float32), SolverOptions(),
            f"phase 21 ({what})", 1 << 16, ms, eps, off, ("acc0", "asum0"))
        check(not params.delta and params.variant in wk.KERNEL_VARIANTS,
              f"phase 21 ({what}) runs {params.kernel_name}")
        t21[what] = (params, t)
        if what == "Poisson square + circle obstacle":
            check(not params.table and len(params.vert_table) == 31,
                  f"phase 21 ({what}): {len(params.vert_table)} vertices, "
                  f"table form {params.table}")
        if what == "table-form square":
            check(params.table and len(params.dir_table) == 100,
                  f"phase 21 ({what}) is not the 100-row table form")
        extra = (f"; without the source {t['acts']:.4f} of lanes bank "
                 f"otherwise" if off else "")
        log(f"[21] no delta tracking, {what} ({params.kernel_name}), 256 "
            f"steps x 8192 lanes: kernel {t['ms']:.3f} ms, plain "
            f"{t['plain_ms']:.3f} ms; worst plane agreement {t['worst']:.5f}, "
            f"max |err| {t['max_err']:.3g}{extra} ({card})")

    # ---- 22. the transport sampler, one launch --------------------------
    # tests/test_pallas_walk.py:120-139 with its alpha as a TERMS spec; the
    # sampler acts: the exact sampler in its place changes >= 1% of lanes
    tr_prob = Problem(
        dirichlet=Polyline.from_points(BOX),
        neumann=Polyline.from_points(WALL),
        bc_dirichlet=fields.polynomial({(1, 0): 1.0, (0, 1): 1.0}),
        alpha=fields.terms(2.0, fields.term({(0, 1): 0.2}),
                           fields.term(0.3, sx=("sin", 0.5))))
    tr_pts = np.array([[0.0, -1.0], [0.5, -0.5]], np.float32)
    tr_opts = SolverOptions(screened_sampler="transport")
    _, _, p22, t22 = launch_256(
        tr_prob, tr_pts, tr_opts, "phase 22", 1 << 16, 500, 1e-2,
        lambda p: dataclasses.replace(p, transport=False),
        ("atten", "px", "asum0"))
    check(p22.transport and p22.robin == wk.ROBIN_CHAIN,
          f"phase 22 runs {p22.kernel_name}")
    _, counts22 = solve_launches(
        WoStSolver(tr_prob, dataclasses.replace(tr_opts, target_slots=256,
                                                pallas_block_rows=8),
                   device=dev), tr_pts, "phase 22", p22.kernel_name,
        n_walks=64, max_steps=60, eps=1e-2, seed=5)
    log(f"[22] transport sampler + chain ({p22.kernel_name}), 256 steps x "
        f"8192 lanes: kernel {t22['ms']:.3f} ms, plain {t22['plain_ms']:.3f} "
        f"ms; worst plane agreement {t22['worst']:.5f}, max |err| "
        f"{t22['max_err']:.3g}; the exact sampler in its place changes "
        f"{t22['acts']:.4f} of lanes; a 2x64-walk solve launched {counts22} "
        f"({card})")
    # transport against the rejection at phase 7's full-size survey state
    solver7, pts7, params7 = survey_full
    times22 = {}
    for label, sampler, rounds in (("exact r1", "exact", 1),
                                   ("exact r2", "exact", 2),
                                   ("transport", "transport", 1)):
        solver = WoStSolver(solver7.problem, dataclasses.replace(
            solver7.options, screened_sampler=sampler,
            rejection_rounds=rounds), device=dev)
        state, params, _, bound22 = solver._setup(pts7, 1 << 19, 500, 0.9,
                                                  5)
        check(state["px"].numel() == 147456, "phase 22 full state")
        wk.run_walk(clone_state(state), params, 16)
        ms = []
        for _ in range(3):
            ks = clone_state(state)
            ms.append(cuda_ms(lambda: wk.run_walk(ks, params, 256)))
        times22[label] = (min(ms), life_steps(state, ks), params)
    tr_full = steps_256(wk, state, params, "phase 22 (survey + transport)",
                        subset=True)
    log(f"[22] 256 steps x 147456 lanes of the survey, best of 3: "
        + ", ".join(f"{k} {v[0]:.3f} ms ({v[1]} walker-steps)"
                    for k, v in times22.items())
        + f"; transport kernel vs plain on {tr_full['lanes']} lanes: "
        f"{tr_full['ms']:.3f} / {tr_full['plain_ms']:.3f} ms, worst plane "
        f"agreement {tr_full['worst']:.5f} ({card})")
    # the solve's single launch with the transport map: walks dealt
    d22 = dealt_launch(wk, state, params, bound22,
                       "phase 22 (survey + transport)")
    log(f"[22] survey + transport, {dealt_text(d22, params, card)}")

    # ---- 23. TERMS field specs on the card: variable coefficients -------
    vc_prob = variable_coefficient_problem()
    vc_pts = varcoeff_solve_points()
    check(vc_prob.alpha.kind == fields.TERMS, "varcoeff alpha is no TERMS")
    _, _, p23, t23 = launch_256(
        vc_prob, vc_pts[:8], SolverOptions(max_attenuation=50.0), "phase 23",
        1 << 16, 500, 1e-3)
    check(p23.robin == wk.ROBIN_CHAIN and not p23.table
          and len(p23.vert_table) == 31, f"phase 23 runs {p23.kernel_name}")
    log(f"[23] variable coefficients, chain with a TERMS alpha "
        f"({p23.kernel_name}), 256 steps x 8192 lanes: kernel "
        f"{t23['ms']:.3f} ms, plain {t23['plain_ms']:.3f} ms; worst plane "
        f"agreement {t23['worst']:.5f}, max |err| {t23['max_err']:.3g} "
        f"({card})")

    # ---- 24. the reference's analytic checks on the card ----------------
    F = fields
    sin_sinh = F.terms(0.0, F.term(0.5, ay=1.0, sx=("sin", 1.0)),
                       F.term(-0.5, ay=-1.0, sx=("sin", 1.0)))
    sin_cosh = F.terms(0.0, F.term(0.5, ay=1.0, sx=("sin", 1.0)),
                       F.term(0.5, ay=-1.0, sx=("sin", 1.0)))
    poly_prob, poly_u = polynomial_manufactured(2.0)

    def within(res, exact, k, slack):
        return bool((np.abs(res.mean - exact) < k * res.stderr + slack).all())

    def strip():
        d = Polyline.concat([Polyline.from_points([[-1.0, 0.0], [1.0, 0.0]]),
                             Polyline.from_points([[-1.0, 2.0], [1.0, 2.0]])])
        n = Polyline.concat([Polyline.from_points([[-1.0, 0.0], [-1.0, 2.0]]),
                             Polyline.from_points([[1.0, 0.0], [1.0, 2.0]])])
        return Problem(dirichlet=d, neumann=n,
                       bc_dirichlet=F.polynomial({(0, 1): 1.0}))

    g4 = np.linspace(-0.7, 0.7, 4)
    grid16 = np.stack([a.ravel() for a in np.meshgrid(g4, g4, indexing="ij")],
                      1)
    # (name, problem, options, points, solve kwargs, gate(result, points))
    checks24 = [
        ("harmonic_linear_dirichlet", harmonic, dict(target_slots=4096),
         [[0.0, 0.0], [0.5, 0.3], [-0.7, -0.2], [0.2, -0.8]],
         dict(n_walks=2000, max_steps=200, eps=1e-3, seed=0),
         lambda r, p: within(r, p[:, 0] + 2 * p[:, 1], 4.0, 5e-3)),
        ("harmonic_saddle", Problem(
            dirichlet=square_loop(1.0),
            bc_dirichlet=F.polynomial({(2, 0): 1.0, (0, 2): -1.0})),
         dict(target_slots=4096), [[0.0, 0.0], [0.4, 0.4], [-0.5, 0.1]],
         dict(n_walks=3000, max_steps=200, eps=1e-3, seed=1),
         lambda r, p: within(r, p[:, 0] ** 2 - p[:, 1] ** 2, 4.0, 5e-3)),
        ("constant_bc_zero_variance", Problem(
            dirichlet=square_loop(1.0), bc_dirichlet=F.constant(3.5)),
         dict(target_slots=512), [[0.1, 0.2]],
         dict(n_walks=64, max_steps=100, eps=1e-3),
         lambda r, p: bool(abs(r.mean[0] - 3.5) <= 3.5e-6
                           and r.stderr[0] <= 1e-5)),
        ("all_walks_complete", Problem(dirichlet=square_loop(1.0)),
         dict(target_slots=256), [[0.0, 0.0], [0.5, 0.5]],
         dict(n_walks=123, max_steps=100, eps=1e-3),
         lambda r, p: bool(r.n_walks == 123 and r.total_steps > 0
                           and (np.abs(r.mean) <= 1e-7).all())),
        ("harmonic_sin_sinh", Problem(dirichlet=square_loop(1.0),
                                      bc_dirichlet=sin_sinh),
         dict(target_slots=8192), [[0.0, 0.5], [0.5, -0.5], [-0.3, 0.0]],
         dict(n_walks=4000, max_steps=200, eps=1e-3, seed=3),
         lambda r, p: within(r, np.sin(p[:, 0]) * np.sinh(p[:, 1]), 4.0,
                             5e-3)),
        ("poisson_quadratic_source", poisson_square()[0],
         dict(target_slots=8192), P4,
         dict(n_walks=4000, max_steps=300, eps=1e-3, seed=0),
         lambda r, p: within(r, p[:, 0] ** 2 + p[:, 1] ** 2, 4.0, 0.02)),
        ("poisson_bubble_zero_bc", Problem(
            dirichlet=circle_loop(1.0, n=256), bc_dirichlet=F.constant(0.0),
            source=F.constant(1.0)), dict(target_slots=8192),
         [[0.0, 0.0], [0.5, 0.0], [0.0, -0.8]],
         dict(n_walks=6000, max_steps=300, eps=1e-3, seed=1),
         lambda r, p: within(r, (1 - p[:, 0] ** 2 - p[:, 1] ** 2) / 4, 4.0,
                             5e-3)),
        ("mixed_neumann_strip", strip(), dict(target_slots=8192),
         [[0.0, 1.0], [0.5, 0.5], [-0.8, 1.5]],
         dict(n_walks=4000, max_steps=500, eps=1e-3, seed=2),
         lambda r, p: within(r, p[:, 1], 4.0, 0.02)),
        ("neumann_circle_obstacle_runs", Problem(
            dirichlet=square_loop(2.0), neumann=circle_loop(0.5, n=32),
            bc_dirichlet=xy2), dict(target_slots=4096),
         [[1.0, 1.0], [0.7, 0.0], [0.0, -1.5]],
         dict(n_walks=1000, max_steps=500, eps=1e-3, seed=3),
         lambda r, p: bool(np.isfinite(r.mean).all()
                           and ((r.mean > 0) & (r.mean < 8)).all())),
        ("screened_constant_sigma_disk", Problem(
            dirichlet=circle_loop(1.0, n=256), bc_dirichlet=F.constant(1.0),
            sigma=F.constant(4.0)), dict(target_slots=16384),
         [[0.0, 0.0], [0.5, 0.0], [0.0, 0.8]],
         dict(n_walks=8000, max_steps=1000, eps=1e-3, seed=0),
         lambda r, p: within(r, sp_i0(np.hypot(p[:, 0], p[:, 1]) * 2.0)
                             / sp_i0(2.0), 4.0, 0.01)),
        ("constant_alpha_reduces_to_wos", Problem(
            dirichlet=square_loop(1.0), bc_dirichlet=harmonic.bc_dirichlet,
            alpha=F.constant(5.0)), dict(target_slots=8192),
         [[0.0, 0.0], [0.4, -0.2]],
         dict(n_walks=6000, max_steps=1000, eps=1e-3, seed=1),
         lambda r, p: within(r, p[:, 0] + 2 * p[:, 1], 4.0, 0.01)),
        ("manufactured_polynomial_solution", poly_prob,
         dict(target_slots=16384), grid16,
         dict(n_walks=3000, max_steps=800, eps=1e-3, seed=2),
         lambda r, p: manufactured_ok(r, poly_u(p))),
        ("transport_sampler_solution_unbiased", poly_prob,
         dict(target_slots=16384, screened_sampler="transport"), grid16,
         dict(n_walks=3000, max_steps=800, eps=1e-3, seed=2),
         lambda r, p: manufactured_ok(r, poly_u(p))),
        # tests/test_models.py:17-73
        ("polynomial_model", poly_prob, dict(target_slots=8192),
         interior_grid(n_points=3),
         dict(n_walks=2000, max_steps=800, eps=1e-3, seed=0),
         lambda r, p: rmse(r, poly_u(p)) < 0.08),
        ("trig_model", trig_manufactured()[0], dict(target_slots=8192),
         interior_grid(n_points=3),
         dict(n_walks=2500, max_steps=800, eps=1e-3, seed=1),
         lambda r, p: rmse(r, trig_manufactured()[1](p)) < 0.15),
        ("poisson_model", poisson_square()[0], dict(target_slots=8192),
         poisson_solve_points(n=5),
         dict(n_walks=1500, max_steps=300, eps=1e-3, seed=2),
         lambda r, p: (np.abs(r.mean - poisson_square()[1](p))
                       < 4 * r.stderr + 0.03).mean() > 0.9),
        ("varcoeff_model_runs", vc_prob,
         dict(target_slots=4096, max_attenuation=50.0),
         varcoeff_solve_points(n=5),
         dict(n_walks=300, max_steps=500, eps=1e-3, seed=3),
         lambda r, p: bool(np.isfinite(r.mean).all()
                           and np.abs(r.mean).max() < 5.0)),
        ("varcoeff_uncapped_is_finite", vc_prob, dict(target_slots=2048),
         varcoeff_solve_points(n=3),
         dict(n_walks=200, max_steps=400, eps=1e-3, seed=3),
         lambda r, p: bool(np.isfinite(r.mean).all()
                           and np.isfinite(r.stderr).all())),
    ]

    def rmse(res, exact):
        return float(np.sqrt(np.mean((res.mean - exact) ** 2)))

    def manufactured_ok(res, exact):
        err = np.abs(res.mean - exact)
        return rmse(res, exact) < 0.08 and (
            err < 5.0 * res.stderr + 0.03).mean() > 0.85

    counts24 = {}
    for name24, prob, opts, pts, kw, gate in checks24:
        pts = np.asarray(pts, np.float32)
        solver = WoStSolver(prob, SolverOptions(**opts))   # on the card
        check(solver.device.type == "cuda", f"phase 24 {name24} off the card")
        t0 = time.perf_counter()
        res, counts = solve_launches(solver, pts, f"phase 24 {name24}", **kw)
        t = time.perf_counter() - t0
        check(gate(res, pts), f"phase 24 {name24}: {res.mean} "
                              f"(stderr {res.stderr})")
        for k, v in counts.items():
            counts24.setdefault(k, {})[name24] = v
        log(f"[24] {name24}: held, means {np.round(res.mean, 5).tolist()}, "
            f"max stderr {float(np.max(res.stderr)):.3g}, steps "
            f"{res.total_steps:.0f}, launches {counts}, {t:.3f} s")
    # test_reproducible_given_seed
    solver = WoStSolver(Problem(dirichlet=square_loop(1.0),
                                bc_dirichlet=sin_cosh),
                        SolverOptions(target_slots=512))
    rr = [solver.solve([[0.2, -0.3]], n_walks=500, max_steps=100, eps=1e-3,
                       seed=sd).mean[0] for sd in (7, 7, 8)]
    check(rr[0] == rr[1] != rr[2], f"phase 24 reproducible_given_seed: {rr}")
    # one whole solve, kernel vs plain: the Poisson square
    solver = WoStSolver(poisson_square()[0], SolverOptions(target_slots=8192),
                        device=dev)
    rk = solver._solve_raw(P4, 4000, 300, 1e-3, 11)
    rp = solver._solve_raw(P4, 4000, 300, 1e-3, 11, walk=wk.walk_plain)
    dm = np.abs(rk.mean - rp.mean)
    scale = np.abs(rp.mean) + np.sqrt(rk.stderr ** 2 + rp.stderr ** 2)
    check((dm <= 1e-3 * scale).all() and rk.total_steps == rp.total_steps,
          f"phase 24 Poisson solve: |dmean| {dm}, steps {rk.total_steps} vs "
          f"{rp.total_steps}")
    # solve_to_tolerance on poisson_square() reaching its target
    seen = []
    res = solve_to_tolerance(
        WoStSolver(poisson_square()[0], SolverOptions(target_slots=8192)),
        poisson_solve_points(n=5), target_stderr=0.02, batch_walks=4096,
        max_walks=1 << 17, max_steps=300, eps=1e-3, seed=5,
        callback=lambda i, r: seen.append(float(r.stderr.max())))
    check(res.stderr.max() <= 0.02 and res.iterations > 1 and seen[0] > 0.02
          and res.n_walks < 1 << 17,
          f"phase 24 solve_to_tolerance: stderr {res.stderr.max()}, "
          f"{res.iterations} batches")
    log(f"[24] {len(checks24) + 1} analytic checks held on the card; Poisson "
        f"solve kernel vs plain: max |dmean|/(|mean|+se) "
        f"{float((dm / scale).max()):.3g}, steps {rk.total_steps:.0f} both; "
        f"solve_to_tolerance: max stderr {float(res.stderr.max()):.4g} <= "
        f"0.02 after {res.iterations} batches ({res.n_walks} walks)")

    # ---- 25. the short-walk harmonic preset at full size ----------------
    sw_pts = np.array([[0.0, 0.0], [0.5, 0.3], [-0.4, 0.6]], np.float32)
    solver = WoStSolver(harmonic, SolverOptions(target_slots=1 << 19,
                                                min_quota=32), device=dev)
    n_walks = 1 << 21
    f25 = full_size_solves(wk, solver, sw_pts, n_walks, 200, 1e-3, 196608,
                           "phase 25", reps=10)
    exact25 = sw_pts[:, 0] + 2 * sw_pts[:, 1]
    for res in [f25["warm"]] + f25["raws"]:
        check(within(res, exact25, 4.0, 5e-3),
              f"phase 25: means {res.mean} off x + 2y {exact25} (stderr "
              f"{res.stderr})")
    state, p25, _, _ = solver._setup(sw_pts, n_walks, 200, 1e-3, 5)
    check(state["px"].numel() == 196608 and not p25.delta
          and set(f25["counts"]) == {p25.kernel_name},
          f"phase 25: {state['px'].numel()} lanes, {f25['counts']}")
    log(f"[25] short-walk harmonic 3x{n_walks} walks, 196608 lanes: "
        f"walker_steps_per_sec {f25['rate']:.6g} s/solve "
        f"{[round(v, 5) for v in f25['times']]} steps/solve "
        f"{f25['steps']:.6g} mean walk length "
        f"{f25['steps'] / (3 * n_walks):.3f} steps, longest lane "
        f"{f25['longest']}, lane occupancy {f25['occupancy']:.4f}, kernel "
        f"share {[round(v, 4) for v in f25['share']]}, launches of the "
        f"warm-up solve {f25['counts']}; means "
        f"{np.round(f25['warm'].mean, 5).tolist()} ({card})")
    t25 = steps_256(wk, state, p25, "phase 25", subset=True)
    log(f"[25] 256 steps x {t25['lanes']} lanes: kernel {t25['ms']:.3f} ms, "
        f"plain {t25['plain_ms']:.3f} ms; worst plane agreement "
        f"{t25['worst']:.5f}, {t25['steps']} walker-steps ({card})")

    # ---- 26. variable coefficients at full size -------------------------
    solver = WoStSolver(vc_prob, SolverOptions(target_slots=1 << 21,
                                               max_attenuation=50.0),
                        device=dev)
    mode26 = solver._robin_enabled()
    n_walks = 4096
    lanes26 = len(vc_pts) * 1024
    f26 = full_size_solves(wk, solver, vc_pts, n_walks, 500, 1e-3, lanes26,
                           "phase 26")
    for res in [f26["warm"]] + f26["raws"]:
        check(np.isfinite(res.mean).all() and np.abs(res.mean).max() < 5.0,
              f"phase 26: max |mean| {np.abs(res.mean).max()}")
    state, p26, _, _ = solver._setup(vc_pts, n_walks, 500, 1e-3, 5)
    working26 = int((state["quota"] > 0).sum())
    check(len(vc_pts) == 652 and working26 == lanes26 == 667648
          and mode26 == "chain" and set(f26["counts"]) == {p26.kernel_name},
          f"phase 26: {len(vc_pts)} points, {working26} working lanes, "
          f"Robin {mode26!r}, {f26['counts']}")
    log(f"[26] variable coefficients 652x{n_walks} walks, 667648 lanes, "
        f"Robin 'auto' -> {mode26!r} (sigma_bar {vc_prob.sigma_bar:.4g}, "
        f"max gamma {vc_prob.max_boundary_gamma():.4g}): "
        f"walker_steps_per_sec {f26['rate']:.6g} s/solve "
        f"{[round(v, 4) for v in f26['times']]} steps/solve "
        f"{f26['steps']:.6g} longest lane {f26['longest']}, lane occupancy "
        f"{f26['occupancy']:.4f}, truncated share "
        f"{[round(v, 5) for v in f26['trunc']]}, kernel share "
        f"{[round(v, 4) for v in f26['share']]}, launches of the warm-up "
        f"solve {f26['counts']}, max |mean| "
        f"{float(np.abs(f26['warm'].mean).max()):.4g} ({card})")
    t26 = steps_256(wk, state, p26, "phase 26", subset=True)
    log(f"[26] 256 steps x {t26['lanes']} lanes"
        f"{' (plain 16 steps took %.0f ms)' % t26['t16'] if t26['t16'] else ''}"
        f": kernel {t26['ms']:.3f} ms, plain {t26['plain_ms']:.3f} ms; "
        f"worst plane agreement {t26['worst']:.5f}; {p26.kernel_name}: "
        f"{regs.get(p26.kernel_name)} registers; sites' shares of the "
        f"one-thread loop's warp-cycles (256 steps, site clocks): "
        f"{site_shares(wk, state, p26)} ({card})")
    records.append(kernel_record(
        p26, "robin_chain+terms_fields", f26["counts"][p26.kernel_name], t26,
        regs, tolerance))

    # ---- the survey products: the pseudosection, the E-field, the -------
    # ---- sensitivity maps and the Jacobian (phases 27-31) ----------------
    from dcrmontecarlo_tpu_torch.survey import dcr as sdcr

    drop_mix = lambda p: dataclasses.replace(p, mis_table=None)
    # MIS without delta tracking: the narrow Gaussian of
    # tests/test_pseudosection.py:150-175 (unit mass, width 0.05)
    w_n = 0.05
    amp_n = 1.0 / (2 * np.pi * w_n * w_n)

    def narrow_source(c, mis=True):
        mix = fields.GaussianMixture.from_components([(c, w_n, 1.0)])
        return dict(source=fields.gaussian_bump(c, amp_n, w_n),
                    source_importance=mix if mis else None,
                    bc_dirichlet=fields.constant(0.0))

    nd_square = Problem(dirichlet=square_loop(2.0),
                        **narrow_source((0.0, 0.0)))
    nd_box = Problem(dirichlet=Polyline.from_points(BOX),
                     neumann=Polyline.from_points(WALL),
                     **narrow_source((0.0, -0.3)))
    # the lines: the scenario's (6 sources; phase 7's conductivity), the
    # Born demo's Jacobian (examples/inversion_demo.py: 9 electrodes, 8
    # unit dipoles, 9 components) and the notebook's
    # (examples/pseudosection_figure.py: 18 sources, 19 components)
    sc_prob, sc_pts, _, _ = sdcr._line_problem(survey, electrodes, 3)
    born_survey, born_elec, born_prob, born_grid = born_line()
    gx31, gy31 = np.unique(born_grid[:, 0]), np.unique(born_grid[:, 1])
    nbl_survey, nbl_elec = notebook_survey()
    nbl_survey.source_mis = True
    nbl_prob, nbl_pts, nbl_src, _ = sdcr._line_problem(nbl_survey, nbl_elec,
                                                       8)
    check(len(nbl_prob.source_fields) == 18
          and len(nbl_prob.source_importance.cx) == 19,
          "the notebook line is not 18 sources and 19 components")
    figure_opts = SolverOptions(target_slots=65536,
                                common_random_numbers=True)

    # ---- 27. kernel vs plain, one launch of each new instantiation ------
    cases27 = (
        ("MIS without delta, square", nd_square, [[0.5, 0.0], [1.0, 1.0]],
         SolverOptions(), 1e-3, 300, False),
        ("MIS without delta, Neumann box", nd_box,
         [[0.5, -0.2], [-1.0, -0.01], [0.0, -1.5]], SolverOptions(), 1e-2,
         300, False),
        ("chain + MIS, notebook survey", nbl_survey.build_problem(), nb_pts,
         figure_opts, 1.0, 6000, False),
        ("wide survey, scenario line", sc_prob, sc_pts,
         survey_default_options(), 0.9, 500, True),
        ("wide survey + MIS, Born demo", born_prob, born_grid[:21],
         SolverOptions(common_random_numbers=True), 0.3, 500, True),
        ("wide chain + MIS, notebook line", nbl_prob, nbl_pts, figure_opts,
         1.0, 6000, True))
    t27 = {}
    for what, prob, pts, opts, eps, ms, wide in cases27:
        mis = prob.source_importance is not None
        _, start, params, t = launch_256(
            prob, np.asarray(pts, np.float32), opts, f"phase 27 ({what})",
            1 << 16, ms, eps)
        check(params.wide == wide and (params.mis_table is not None) == mis,
              f"phase 27 ({what}) runs {params.kernel_name}")
        if mis:  # the plain walk: the wide chain has no MIS-free form
            other = clone_state(start)
            wk.walk_plain(other, drop_mix(params), 256)
            t["acts"] = lanes_differ(t["end"], other, ("acc0", "asum0"))
            check(t["acts"] >= 0.01, f"phase 27 ({what}): without the "
                                     f"mixture only {t['acts']:.4f} of "
                                     f"lanes bank otherwise")
        nonzero = [i for i in range(wk.MAX_SRC, params.n_src)
                   if bool((t["end"][f"asum{i}"] != 0).any()
                           | (t["end"][f"acc{i}"] != 0).any())]
        check(nonzero == list(range(wk.MAX_SRC, params.n_src)),
              f"phase 27 ({what}): only sources {nonzero} of "
              f"{wk.MAX_SRC}..{params.n_src - 1} accumulated")
        t27[what] = (params, t)
        b_ms, b_by = bound(params, t["lanes"], t["steps"], 1)
        extra = (f"; without the mixture {t['acts']:.4f} of lanes bank "
                 f"otherwise" if mis else "")
        log(f"[27] {what} ({params.kernel_name}, {params.n_src} sources, "
            f"{0 if params.mis_table is None else len(params.mis_table)} "
            f"components), 256 steps x 8192 lanes: kernel {t['ms']:.3f} ms, "
            f"plain {t['plain_ms']:.3f} ms; worst plane agreement "
            f"{t['worst']:.5f}, max |err| {t['max_err']:.3g}; bound "
            f"{b_ms:.4f} ms ({b_by}), {regs.get(params.kernel_name)} "
            f"registers{extra} ({card})")

    # ---- 28. kernel vs plain, whole solve, the scenario pseudosection ---
    solver = WoStSolver(sc_prob, survey_default_options(), device=dev)
    rk = solver._solve_raw(sc_pts, 512, 500, 0.9, 11)
    rp = solver._solve_raw(sc_pts, 512, 500, 0.9, 11, walk=wk.walk_plain)
    check(rk.mean.shape == (6, 9) and np.isfinite(rk.mean).all()
          and np.isfinite(rk.stderr).all(), "phase 28 kernel solve")
    dm = np.abs(rk.mean - rp.mean)
    scale = np.abs(rp.mean) + np.sqrt(rk.stderr ** 2 + rp.stderr ** 2)
    check((dm <= 1e-3 * scale).all() and rk.total_steps == rp.total_steps,
          f"phase 28 solve: |dmean| {dm.max()}, steps {rk.total_steps} vs "
          f"{rp.total_steps}")
    wk.run_walk.launches = 0
    wk.run_walk.variant_launches.clear()
    ps28 = run_pseudosection(survey, electrodes, num_rx_per_src=3,
                             n_walks=512, max_steps=500, eps=0.9, seed=11,
                             device=dev)
    counts28 = dict(wk.run_walk.variant_launches)
    p_wide = t27["wide survey, scenario line"][0]
    check(set(counts28) == {p_wide.kernel_name}
          and np.array_equal(ps28.potentials, rk.mean),
          f"phase 28: run_pseudosection launched {counts28}, potentials "
          f"equal to the kernel solve's: "
          f"{np.array_equal(ps28.potentials, rk.mean)}")
    log(f"[28] scenario pseudosection 9x512, 6 sources: max "
        f"|dmean|/(|mean|+se) {float((dm / scale).max()):.3g} (bound 1e-3), "
        f"steps kernel {rk.total_steps:.0f} plain {rp.total_steps:.0f}; "
        f"run_pseudosection launched {counts28}, {len(ps28.voltage)} "
        f"measurements")

    # ---- 29. the reference's survey-product checks on the card ----------
    def quad(a, b):
        return np.sqrt(np.asarray(a) ** 2 + np.asarray(b) ** 2)

    held29, counts29 = [], {}

    def check29(name, cond, detail, t0):
        check(bool(cond), f"phase 29 {name}: {detail}")
        held29.append(name)
        log(f"[29] {name}: held, {detail}, {time.perf_counter() - t0:.2f} s")

    def count29(name, fn):
        wk.run_walk.launches = 0
        wk.run_walk.variant_launches.clear()
        out = fn()
        counts29[name] = dict(wk.run_walk.variant_launches)
        check(sum(counts29[name].values()) == wk.run_walk.launches > 0,
              f"phase 29 {name}: launched {counts29[name]}")
        return out

    t0 = time.perf_counter()
    srcs, rxs = dipole_dipole_pairs(6, num_rx_per_src=10)
    check29("dipole_dipole_pairs", srcs == [(0, 1), (1, 2), (2, 3)]
            and rxs[0] == [(2, 3), (3, 4), (4, 5)] and rxs[2] == [(4, 5)],
            f"{srcs}", t0)
    # test_multi_source_matches_single_solves / _exact_for_u_x2y2
    t0 = time.perf_counter()
    f1, f2 = fields.constant(-4.0), fields.polynomial({(1, 0): 6.0})
    pts = np.array([[0.0, 0.0], [1.0, 0.5]], np.float32)
    o8k = SolverOptions(target_slots=8192)
    rm = count29("multi_source_matches_single_solves", lambda: WoStSolver(
        Problem(dirichlet=square_loop(2.0), bc_dirichlet=xy2,
                source=[f1, f2]), o8k).solve(pts, n_walks=4000,
                                               max_steps=300, eps=1e-3,
                                               seed=0))
    ok = rm.mean.shape == (2, 2)
    for i, f in enumerate((f1, f2)):
        rs = WoStSolver(Problem(dirichlet=square_loop(2.0), bc_dirichlet=xy2,
                                source=f), o8k).solve(
            pts, n_walks=4000, max_steps=300, eps=1e-3, seed=1)
        ok &= bool((np.abs(rm.mean[i] - rs.mean)
                    < 4 * quad(rm.stderr[i], rs.stderr) + 1e-3).all())
    check29("multi_source_matches_single_solves", ok,
            f"multi {np.round(rm.mean, 4).tolist()}", t0)
    t0 = time.perf_counter()
    pts = np.array([[0.0, 0.0], [1.0, 1.0]], np.float32)
    res = WoStSolver(Problem(dirichlet=square_loop(2.0), bc_dirichlet=xy2,
                             source=[f1, fields.constant(0.0)]), o8k).solve(
        pts, n_walks=4000, max_steps=300, eps=1e-3, seed=2)
    exact = pts[:, 0] ** 2 + pts[:, 1] ** 2
    check29("multi_source_exact_for_u_x2y2",
            (np.abs(res.mean[0] - exact) < 4 * res.stderr[0] + 0.02).all()
            and np.isfinite(res.mean[1]).all(),
            f"{np.round(res.mean[0], 4).tolist()} vs {exact.tolist()}", t0)
    # test_pseudosection_matches_fdm_oracle
    t0 = time.perf_counter()
    ps = count29("pseudosection_matches_fdm_oracle", lambda: run_pseudosection(
        survey, electrodes, num_rx_per_src=3, n_walks=2500, max_steps=800,
        eps=0.5, seed=0, options=survey_default_options(target_slots=32768),
        device=dev))
    ok = (ps.potentials.shape == (6, 9) and (ps.pseudo_z < 0).all()
          and (np.abs(ps.pseudo_x) <= 40.0).all())
    prob29 = survey.build_problem()
    sources, receivers = dipole_dipole_pairs(9, 3)
    depth = max(survey.electrode_nudge, 2.0 * survey.source_width)
    src_pos = np.asarray(electrodes, np.float32).copy()
    src_pos[:, 1] = -depth
    pts = np.asarray(electrodes, np.float32).copy()
    pts[:, 1] = -survey.electrode_nudge
    n_checked = n_ok = 0
    for s_i, (a, b) in enumerate(sources):
        f = fields.gaussian_dipole(src_pos[a], src_pos[b], survey.current,
                                   survey.source_width)
        ref = fdm_solve(bounds=((-100.0, 100.0), (-200.0, 0.0)),
                        alpha=np_field(prob29.alpha), source=np_field(f),
                        neumann_top=True, nx=241, ny=241)(pts)
        sel = ps.src_index == s_i
        dv_ref = ref[ps.m_index[sel]] - ref[ps.n_index[sel]]
        n_ok += int((np.abs(ps.voltage[sel] - dv_ref)
                     < 4.0 * ps.voltage_stderr[sel] + 3e-4).sum())
        n_checked += int(sel.sum())
    ok &= n_checked == sum(len(r) for r in receivers)
    check29("pseudosection_matches_fdm_oracle",
            ok and n_ok / n_checked >= 0.85,
            f"{n_ok}/{n_checked} voltages within 4 sigma + 3e-4 of the "
            f"oracle (need 0.85), launches "
            f"{counts29['pseudosection_matches_fdm_oracle']}", t0)
    # test_mis_nee_unbiased_and_lower_variance
    t0 = time.perf_counter()
    pts = np.array([[0.5, 0.0], [1.0, 1.0]], np.float32)
    r_plain = WoStSolver(Problem(dirichlet=square_loop(2.0),
                                 **narrow_source((0.0, 0.0), mis=False)),
                         o8k).solve(pts, n_walks=6000, max_steps=300,
                                    eps=1e-3, seed=0)
    r_mis = count29("mis_nee_unbiased_and_lower_variance",
                    lambda: WoStSolver(nd_square, o8k).solve(
                        pts, n_walks=6000, max_steps=300, eps=1e-3, seed=0))
    dev29 = np.abs(r_plain.mean - r_mis.mean) / quad(r_plain.stderr,
                                                     r_mis.stderr)
    check29("mis_nee_unbiased_and_lower_variance",
            (dev29 < 4).all() and (r_mis.stderr < r_plain.stderr / 3).all(),
            f"plain {np.round(r_plain.mean, 4).tolist()} +- "
            f"{np.round(r_plain.stderr, 4).tolist()}, MIS "
            f"{np.round(r_mis.mean, 4).tolist()} +- "
            f"{np.round(r_mis.stderr, 4).tolist()}, stderr ratio "
            f"{np.round(r_plain.stderr / r_mis.stderr, 2).tolist()}, "
            f"launches {counts29['mis_nee_unbiased_and_lower_variance']}",
            t0)
    # test_homogeneous_pseudosection_with_mis_crn
    t0 = time.perf_counter()
    hs = DCRSurvey(half_width=300.0, depth=600.0, current_a=(0.0, 0.0),
                   current_b=(1.0, 0.0), conductivity=fields.constant(10.0),
                   source_width=0.25, source_mis=True)
    ps = count29("homogeneous_pseudosection_with_mis_crn",
                 lambda: run_pseudosection(
                     hs, surface_electrode_line((-20.0, 20.0), 5.0),
                     num_rx_per_src=4, n_walks=6000, max_steps=1500,
                     eps=0.25, seed=0, options=SolverOptions(
                         target_slots=32768, common_random_numbers=True),
                     device=dev))
    rho_a = ps.apparent_resistivity
    med = float(np.median(rho_a))
    check29("homogeneous_pseudosection_with_mis_crn",
            abs(med - 0.1) / 0.1 < 0.2
            and np.mean(np.abs(rho_a - 0.1) / 0.1 < 0.3) >= 0.4,
            f"median rho_a {med:.4g} (true 0.1), within 30%: "
            f"{float(np.mean(np.abs(rho_a - 0.1) / 0.1 < 0.3)):.3f}, "
            f"launches {counts29['homogeneous_pseudosection_with_mis_crn']}",
            t0)
    # test_crn_keeps_per_point_estimates_unbiased
    t0 = time.perf_counter()
    pts = np.array([[0.0, 0.0], [0.3, 0.2], [0.31, 0.2]], np.float32)
    res = WoStSolver(Problem(dirichlet=square_loop(1.0),
                             bc_dirichlet=harmonic.bc_dirichlet),
                     SolverOptions(target_slots=4096,
                                   common_random_numbers=True)).solve(
        pts, n_walks=4000, max_steps=200, eps=1e-3, seed=0)
    exact = pts[:, 0] + 2 * pts[:, 1]
    d_est, d_exact = res.mean[2] - res.mean[1], exact[2] - exact[1]
    q12 = float(quad(res.stderr[1], res.stderr[2]))
    check29("crn_keeps_per_point_estimates_unbiased",
            (np.abs(res.mean - exact) < 4 * res.stderr + 5e-3).all()
            and abs(d_est - d_exact) < max(0.7 * q12, 1e-3),
            f"difference {d_est:.5f} vs {d_exact:.5f} (quadrature {q12:.4f})",
            t0)
    # test_pseudosection_on_scenario_runs / _single_source_line
    t0 = time.perf_counter()
    s_def, e_def = geophysical_scenario()
    ps = run_pseudosection(s_def, e_def, num_rx_per_src=3, n_walks=300,
                           max_steps=400, eps=0.9, seed=1,
                           options=SolverOptions(target_slots=4096),
                           device=dev)
    check29("pseudosection_on_scenario_runs",
            ps.potentials.shape == (6, 9) and np.isfinite(ps.voltage).all()
            and len(ps.voltage) == sum(len(r) for r in
                                       dipole_dipole_pairs(9, 3)[1]),
            f"{len(ps.voltage)} finite voltages", t0)
    t0 = time.perf_counter()
    ps = run_pseudosection(s_def, np.stack([np.linspace(-15.0, 15.0, 4),
                                            np.zeros(4)], axis=1),
                           num_rx_per_src=2, n_walks=50, max_steps=200,
                           eps=0.9, seed=0,
                           options=SolverOptions(target_slots=1024),
                           device=dev)
    check29("pseudosection_single_source_line",
            len(ps.voltage) == 1 and np.isfinite(ps.voltage).all(),
            f"voltage {ps.voltage.tolist()}", t0)
    # tests/test_efield.py
    for name29, bc29, side, pts, n29, ms29, seed29, gate in (
            ("efield_linear_potential", harmonic.bc_dirichlet, 1.0,
             [[0.0, 0.0], [0.3, -0.2]], 4000, 200, 0,
             lambda f, p: (np.abs(f.ex + 1.0) < 0.45).all()
             and (np.abs(f.ey + 2.0) < 0.45).all()),
            ("efield_saddle", fields.polynomial({(2, 0): 1.0, (0, 2): -1.0}),
             1.0, [[0.4, 0.1]], 6000, 200, 1,
             lambda f, p: abs(f.ex[0] + 0.8) < 0.45
             and abs(f.ey[0] - 0.2) < 0.45),
            ("efield_multi_source", xy2, 2.0, [[0.5, 0.0], [0.0, 0.5]], 4000,
             300, 0,
             lambda f, p: f.ex.shape == (2, 2) and f.potential.shape == (2, 2)
             and abs(f.ex[0, 0] + 1.0) < 0.5 and abs(f.ey[0, 1] + 1.0) < 0.5
             and np.isfinite(f.ex).all() and np.isfinite(f.ey).all())):
        t0 = time.perf_counter()
        src29 = ([fields.constant(-4.0), fields.constant(0.0)]
                 if name29 == "efield_multi_source" else None)
        f = count29(name29, lambda: estimate_field(
            Problem(dirichlet=square_loop(side), bc_dirichlet=bc29,
                    source=src29), np.asarray(pts, np.float32), h=0.02,
            n_walks=n29, max_steps=ms29, eps=1e-3, seed=seed29, options=o8k,
            device=dev))
        check29(name29, gate(f, pts),
                f"ex {np.round(f.ex, 4).tolist()}, ey "
                f"{np.round(f.ey, 4).tolist()}, launches {counts29[name29]}",
                t0)
    # tests/test_sensitivity.py
    t0 = time.perf_counter()
    bump = fields.gaussian_bump((0.0, -18.0), 1.0, 9.0)
    bump_np = np_field(bump)
    s_sens = DCRSurvey(half_width=100.0, depth=100.0, current_a=(-30.0, -4.0),
                       current_b=(30.0, -4.0),
                       conductivity=fields.constant(1.0), source_width=2.0,
                       source_mis=True)
    rx_m, rx_n = (5.0, -4.0), (15.0, -4.0)
    src_np = np_field(s_sens.build_problem().source_fields[0])
    q_adj = np_field(fields.gaussian_dipole(rx_m, rx_n, 1.0, 2.0))

    def solve_v(alpha_np):
        sol = fdm_solve(bounds=((-100.0, 100.0), (-100.0, 0.0)),
                        alpha=alpha_np, source=src_np, neumann_top=True,
                        nx=257, ny=257)
        X, Y = np.meshgrid(sol.xs, sol.ys, indexing="ij")
        q = q_adj(X.ravel(), Y.ravel()).reshape(X.shape)
        return (np.sum(q * sol.u) * (sol.xs[1] - sol.xs[0])
                * (sol.ys[1] - sol.ys[0]))

    dv_fdm = (solve_v(lambda X, Y: 1.0 + 0.3 * bump_np(X, Y))
              - solve_v(lambda X, Y: 1.0 + 0.0 * X))
    gx = np.linspace(-22.0, 22.0, 10)
    gy = np.linspace(-40.0, -2.0, 9)
    grid = np.stack([a.ravel() for a in np.meshgrid(gx, gy, indexing="ij")],
                    1)
    res = count29("sensitivity_matches_fdm_perturbation",
                  lambda: sensitivity_map(
                      s_sens, rx_m, rx_n, grid, h=3.0, n_walks=3500,
                      max_steps=800, eps=0.5, seed=7,
                      options=SolverOptions(target_slots=1 << 16),
                      device=dev))
    dv_pred = (np.sum(res.sensitivity * 0.3 * bump_np(grid[:, 0], grid[:, 1]))
               * (gx[1] - gx[0]) * (gy[1] - gy[0]))
    check29("sensitivity_matches_fdm_perturbation",
            dv_fdm < 0 and np.isfinite(res.sensitivity).all()
            and abs(dv_pred - dv_fdm) < 0.30 * abs(dv_fdm)
            and np.allclose(res.sensitivity_log, res.sensitivity, rtol=1e-6),
            f"dV predicted {dv_pred:.5g} vs finite-volume {dv_fdm:.5g} (rel "
            f"err {abs(dv_pred - dv_fdm) / abs(dv_fdm):.4f}, bound 0.30), "
            f"launches {counts29['sensitivity_matches_fdm_perturbation']}",
            t0)
    t0 = time.perf_counter()
    elec5 = surface_electrode_line((-20.0, 20.0), 10.0)
    s5 = DCRSurvey(half_width=80.0, depth=80.0, current_a=tuple(elec5[0]),
                   current_b=tuple(elec5[1]),
                   conductivity=fields.constant(1.0), source_width=2.0,
                   source_mis=True)
    grid3 = np.array([[0.0, -8.0], [5.0, -15.0], [-8.0, -10.0]], np.float32)
    o15 = SolverOptions(target_slots=1 << 15)
    jac = count29("survey_jacobian_row_matches_sensitivity_map",
                  lambda: survey_jacobian(
                      s5, elec5, grid3, num_rx_per_src=2, h=3.0,
                      n_walks=2500, max_steps=400, eps=0.5, seed=3,
                      options=o15, device=dev))
    single = sensitivity_map(s5, tuple(elec5[2]), tuple(elec5[3]), grid3,
                             h=3.0, n_walks=2500, max_steps=400, eps=0.5,
                             seed=4, options=o15, device=dev)
    dev29 = np.abs(jac.rows[0] - single.sensitivity) / np.maximum(
        quad(jac.stderr[0], single.stderr), 1e-12)
    check29("survey_jacobian_row_matches_sensitivity_map",
            np.isfinite(jac.rows).all() and jac.src_pairs[0] == (0, 1)
            and jac.rx_pairs[0] == (2, 3)
            and jac.rows.shape == (len(jac.src_pairs), 3)
            and (dev29 < 4.0).all(),
            f"row deviations {np.round(dev29, 3).tolist()} sigma (bound 4)",
            t0)
    t0 = time.perf_counter()
    true_c = (6.0, -10.0)
    bump_b = np_field(fields.gaussian_bump(true_c, 1.0, 5.0))
    buried = [born_survey._bury_source(p) for p in born_elec]
    src_list, rx_lists = dipole_dipole_pairs(len(born_elec), 4)

    def fdm_data(alpha_np):
        out = []
        for (a, b), rx_l in zip(src_list, rx_lists):
            sol = fdm_solve(bounds=((-60.0, 60.0), (-60.0, 0.0)),
                            alpha=alpha_np, source=np_field(
                                fields.gaussian_dipole(buried[a], buried[b],
                                                       1.0, 1.5)),
                            neumann_top=True, nx=201, ny=201)
            X, Y = np.meshgrid(sol.xs, sol.ys, indexing="ij")
            d_area = (sol.xs[1] - sol.xs[0]) * (sol.ys[1] - sol.ys[0])
            for (m, n) in rx_l:
                q = np_field(fields.gaussian_dipole(buried[m], buried[n], 1.0,
                                                    1.5))(X.ravel(), Y.ravel())
                out.append(np.sum(q.reshape(X.shape) * sol.u) * d_area)
        return np.array(out)

    d_resid = (fdm_data(lambda X, Y: 1.0 + bump_b(X, Y))
               - fdm_data(lambda X, Y: 1.0 + 0.0 * X))
    jac = count29("born_inversion_localizes_anomaly", lambda: survey_jacobian(
        born_survey, born_elec, born_grid, num_rx_per_src=4, h=1.5,
        n_walks=5000, max_steps=500, eps=0.3, seed=5,
        options=SolverOptions(target_slots=1 << 16), n_batches=1,
        device=dev))
    cell = (gx31[1] - gx31[0]) * (gy31[1] - gy31[0])
    m_img = linearized_update(jac, d_resid, cell, lam_rel=0.05)
    pk = np.unravel_index(np.argmax(m_img.reshape(12, 7)), (12, 7))
    corr = float(np.corrcoef(m_img, bump_b(born_grid[:, 0],
                                           born_grid[:, 1]))[0, 1])
    check29("born_inversion_localizes_anomaly",
            abs(gx31[pk[0]] - true_c[0]) <= 4.1
            and abs(gy31[pk[1]] - true_c[1]) <= 5.7 and corr > 0.4,
            f"peak ({gx31[pk[0]]:.3g}, {gy31[pk[1]]:.3g}) vs {true_c}, corr "
            f"{corr:.3f} (bound 0.4), launches "
            f"{counts29['born_inversion_localizes_anomaly']}", t0)
    t0 = time.perf_counter()
    grid2 = grid3[:2]
    one = sensitivity_map(s5, tuple(elec5[2]), tuple(elec5[3]), grid2,
                          h=3.0, n_walks=2400, max_steps=400, eps=0.5,
                          seed=4, options=o15, device=dev)
    bat = sensitivity_map(s5, tuple(elec5[2]), tuple(elec5[3]), grid2,
                          h=3.0, n_walks=2400, max_steps=400, eps=0.5,
                          seed=4, n_batches=6, options=o15, device=dev)
    dev29 = np.abs(one.sensitivity - bat.sensitivity) / np.maximum(
        quad(one.stderr, bat.stderr), 1e-12)
    jac = survey_jacobian(s5, elec5, grid2, num_rx_per_src=2, h=3.0,
                          n_walks=2400, max_steps=400, eps=0.5, seed=4,
                          n_batches=6, options=o15, device=dev)
    check29("batch_error_bars_consistent",
            np.isfinite(bat.stderr).all() and (bat.stderr > 0).all()
            and (dev29 < 4.0).all() and np.isfinite(jac.rows).all()
            and np.isfinite(jac.stderr).all() and (jac.stderr > 0).all()
            and jac.stderr.shape == jac.rows.shape,
            f"deviations {np.round(dev29, 3).tolist()} sigma (bound 4)", t0)
    log(f"[29] {len(held29)} survey-product checks held on the card; "
        f"launches by check {counts29} ({card})")

    # ---- 30. full size: the notebook pseudosection ----------------------
    full30 = SolverOptions(target_slots=1 << 21, min_quota=32,
                           common_random_numbers=True)
    solver = WoStSolver(nbl_prob, full30, device=dev)
    n_walks = 1 << 20
    f30 = full_size_solves(
        wk, solver, nbl_pts, n_walks, 6000, 1.0, 688128, "phase 30", reps=2,
        warm_up=lambda: run_pseudosection(
            nbl_survey, nbl_elec, num_rx_per_src=8, n_walks=n_walks,
            max_steps=6000, eps=1.0, seed=0, options=full30, device=dev))
    state, p30, _, _ = solver._setup(nbl_pts, n_walks, 6000, 1.0, 5)
    check(state["px"].numel() == 688128 and p30.wide
          and p30.robin == wk.ROBIN_CHAIN and p30.mis_table is not None
          and set(f30["counts"]) == {p30.kernel_name},
          f"phase 30: {state['px'].numel()} lanes, {p30.kernel_name}, "
          f"launched {f30['counts']}")
    log(f"[30] notebook pseudosection 21x{n_walks} walks, 18 sources, 19 "
        f"components, 688128 lanes ({p30.kernel_name}, "
        f"{regs.get(p30.kernel_name)} registers): walker_steps_per_sec "
        f"{f30['rate']:.6g} s/solve {[round(v, 4) for v in f30['times']]} "
        f"steps/solve {f30['steps']:.6g} longest lane {f30['longest']} "
        f"steps, lane occupancy {f30['occupancy']:.4f}, kernel share "
        f"{[round(v, 4) for v in f30['share']]}, launches of the "
        f"run_pseudosection warm-up {f30['counts']} ({card})")
    t30 = steps_256(wk, state, p30, "phase 30", subset=True)
    log(f"[30] 256 steps x {t30['lanes']} lanes"
        f"{' (plain 16 steps took %.0f ms)' % t30['t16'] if t30['t16'] else ''}"
        f": kernel {t30['ms']:.3f} ms, plain {t30['plain_ms']:.3f} ms; worst "
        f"plane agreement {t30['worst']:.5f}, max |err| {t30['max_err']:.3g}, "
        f"{t30['steps']} walker-steps ({card})")
    log(f"[30] {p30.kernel_name}: {regs.get(p30.kernel_name)} registers; "
        f"its step's sites' shares of the one-thread loop's warp-cycles "
        f"(256 steps, site clocks): {site_shares(wk, state, p30)} ({card})")
    # the figure's own 2000 walks: three source rows against single-source
    # solves of the same dipoles (another mixture and seed: independent)
    t0 = time.perf_counter()
    ps30 = run_pseudosection(nbl_survey, nbl_elec, num_rx_per_src=8,
                             n_walks=2000, max_steps=6000, eps=1.0, seed=0,
                             options=figure_opts, device=dev)
    counts30 = {}  # launches of each single-source solve, by source
    for s_i in (0, 8, 17):
        a, b = nbl_src[s_i]
        one_src = dataclasses.replace(nbl_survey,
                                      current_a=tuple(nbl_elec[a]),
                                      current_b=tuple(nbl_elec[b]))
        wk.run_walk.launches = 0
        wk.run_walk.variant_launches.clear()
        r = one_src.run(nbl_elec, n_walks=2000, max_steps=6000, eps=1.0,
                        seed=1 + s_i, options=figure_opts, device=dev)
        counts30[s_i] = dict(wk.run_walk.variant_launches)
        lim = 4.0 * quad(ps30.potentials_stderr[s_i],
                         r.potentials_stderr) + 0.25
        diff = np.abs(ps30.potentials[s_i] - r.potentials)
        n_in = int((diff < lim).sum())
        check(n_in >= 20, f"phase 30 source {s_i} ({a}, {b}): only "
                          f"{n_in}/21 electrodes within 4 sigma + 0.25 of "
                          f"the single-source solve")
        log(f"[30] source {s_i} ({a}, {b}) at 2000 walks: {n_in}/21 "
            f"electrodes within 4 sigma + 0.25 of DCRSurvey.run, worst "
            f"|diff|/limit {float((diff / lim).max()):.3f}, potentials "
            f"{float(np.abs(r.potentials).max()):.4g} at most")
    p_nb1 = t27["chain + MIS, notebook survey"][0]
    check(all(set(c) == {p_nb1.kernel_name} for c in counts30.values()),
          f"phase 30: the single-source solves launched {counts30}")
    log(f"[30] checks at 2000 walks in {time.perf_counter() - t0:.2f} s; "
        f"the single-source solves launched {counts30}")

    # ---- 31. full size: the survey Jacobian -----------------------------
    kw31 = dict(num_rx_per_src=4, h=1.5, n_walks=6000, max_steps=500,
                eps=0.3, options=SolverOptions(target_slots=1 << 16),
                n_batches=4, device=dev)
    wk.run_walk.launches = 0
    wk.run_walk.variant_launches.clear()
    wk.run_walk.loop_launches.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    survey_jacobian(born_survey, born_elec, born_grid, seed=5, **kw31)
    warm31 = time.perf_counter() - t0
    counts31 = dict(wk.run_walk.variant_launches)
    loops31 = dict(wk.run_walk.loop_launches)
    check(loops31 == {"dealt": 4},
          f"phase 31: the Jacobian's launches ran the loops {loops31}")
    t0 = time.perf_counter()
    jac = survey_jacobian(born_survey, born_elec, born_grid, seed=6, **kw31)
    torch.cuda.synchronize()
    time31 = time.perf_counter() - t0
    n_meas = sum(len(r) for r in dipole_dipole_pairs(9, 4)[1])
    check(jac.rows.shape == (n_meas, 84) and np.isfinite(jac.rows).all()
          and np.isfinite(jac.stderr).all() and (jac.stderr > 0).all(),
          f"phase 31 Jacobian {jac.rows.shape}")
    solver = WoStSolver(born_prob, SolverOptions(
        target_slots=1 << 16, common_random_numbers=True), device=dev)
    _, stencil = born_stencil()
    state, p31, _, bound31 = solver._setup(stencil, *JACOBIAN_RUN, 5)
    check(p31.wide and p31.mis_table is not None and p31.n_src == 8
          and set(counts31) == {p31.kernel_name},
          f"phase 31 runs {p31.kernel_name}, launched {counts31}")
    t31 = steps_256(wk, state, p31, "phase 31", subset=True)
    log(f"[31] survey Jacobian, 9 electrodes, 8 unit dipoles, 84 grid "
        f"points x 6000 walks in 4 batches ({p31.kernel_name}, "
        f"{regs.get(p31.kernel_name)} registers): warm-up {warm31:.3f} s, "
        f"timed call {time31:.3f} s, launches of the warm-up {counts31}, "
        f"by loop {loops31}; 256 "
        f"steps x {t31['lanes']} lanes: kernel {t31['ms']:.3f} ms, plain "
        f"{t31['plain_ms']:.3f} ms, worst plane agreement "
        f"{t31['worst']:.5f} ({card})")
    d31 = dealt_launch(wk, state, p31, bound31, "phase 31", plain_quota=1)
    log(f"[31] a batch of {JACOBIAN_RUN[0]} walks x {len(stencil)} points, "
        f"{dealt_text(d31, p31, card)}")
    # the wide survey at phase 7's full-size state, the line's 6 sources
    solver7, pts7, params7 = survey_full
    state, p_ws, _, _ = WoStSolver(sc_prob, solver7.options,
                                   device=dev)._setup(pts7, 1 << 19, 500,
                                                      0.9, 5)
    check(p_ws.variant == params7.variant[:7] + (True, False),
          "the wide survey state is not phase 7's configuration")
    t_ws = steps_256(wk, state, p_ws, "wide survey at phase 7's state")
    log(f"[31] the wide survey, 6 sources, at phase 7's state: 256 steps x "
        f"{t_ws['lanes']} lanes: kernel {t_ws['ms']:.3f} ms (1 source: "
        f"{t7['ms']:.3f} ms), plain {t_ws['plain_ms']:.3f} ms ({card})")
    p_nd, t_nd = t27["MIS without delta, Neumann box"]
    records.append(kernel_record(
        p_nd, "mis_no_delta",
        counts29["mis_nee_unbiased_and_lower_variance"][p_nd.kernel_name],
        t_nd, regs, tolerance))
    records.append(kernel_record(p_nb1, "robin_chain+mis",
                                 counts30[0][p_nb1.kernel_name],
                                 t27["chain + MIS, notebook survey"][1],
                                 regs, tolerance))
    records.append(kernel_record(p_ws, "survey_wide",
                                 counts28[p_ws.kernel_name], t_ws, regs,
                                 tolerance))
    records.append(dict(kernel_record(p31, "survey+mis_wide",
                                      counts31[p31.kernel_name], t31, regs,
                                      tolerance),
                        whole_launch_ms=d31["ms"],
                        whole_launch_steps=d31["steps"], loops=loops31))
    records.append(kernel_record(p30, "robin_chain+mis_wide",
                                 f30["counts"][p30.kernel_name], t30, regs,
                                 tolerance))

    # ---- the validation and diagnostics path (phases 32-35) -------------
    validation_phases(wk, dev, card, regs, records, tolerance, schedules,
                      resident)

    # ---- the sharded solve (phases 36-39) -------------------------------
    sharded_phases(wk, dev, card, regs, records, tolerance, survey,
                   electrodes, fdm, f6, flag_prob, nb_pts)

    # ---- the survey with the split, the terrain with the flagship's ------
    # ---- estimator, the variant sweep (phases 40-42) ---------------------
    new_path_phases(wk, dev, card, regs, records, tolerance, survey,
                    electrodes, f6, f20, topo_pts)

    # ---- 43. full size: the survey with the transport sampler, with MIS --
    survey_build_phase(wk, dev, card, report, electrodes, f6)
    # what phase 2 built is what the phases launched: no library was built
    # after it, and as many were loaded
    check(set(wk.build_logs) == built,
          f"built after phase 2: {sorted(set(wk.build_logs) - built)}")
    check(wk._library.cache_info().currsize == len(SCRIPT_VARIANTS),
          f"{wk._library.cache_info().currsize} libraries loaded, "
          f"{len(SCRIPT_VARIANTS)} built")

    p21s, t21s = t21["Poisson square + circle obstacle"]
    p21t, t21t = t21["table-form square"]
    name_s, name_t = p21s.kernel_name, p21t.kernel_name
    check(name_s == p25.kernel_name, "phases 21 and 25 run other variants")
    records.append(kernel_record(p25, "no_delta_static",
                                 f25["counts"][name_s], t25, regs, tolerance))
    records.append(kernel_record(
        p21t, "no_delta_table",
        counts24.get(name_t, {}).get("poisson_bubble_zero_bc", 0), t21t, regs,
        tolerance))
    p_tr = times22["transport"][2]
    records.append(dict(kernel_record(
        p_tr, "transport",
        counts24.get(p_tr.kernel_name, {}).get(
            "transport_sampler_solution_unbiased", 0), tr_full, regs,
        tolerance), whole_launch_ms=d22["ms"],
        whole_launch_steps=d22["steps"], loops=d22["loops"]))
    records.append(kernel_record(p22, "transport+robin_chain",
                                 counts22[p22.kernel_name], t22, regs,
                                 tolerance))
    for what, (ms_, steps_, p_) in times22.items():
        b_ms, b_by = bound(p_, 147456, steps_, 1)
        log(f"[bound] survey with {what} ({p_.kernel_name}): {ms_:.3f} ms "
            f"against a bound of {b_ms:.4f} ms ({b_by}) for {steps_} "
            f"walker-steps")
    log(f"[guard] phase 6 {f6['rate']:.6g} (earlier runs: 6.51e9-6.64e9), "
        f"phase 11 {f11['rate']:.6g} (earlier runs: 3.17e9-3.25e9) "
        f"walker-steps/s; survey "
        f"registers {regs.get(wk.kernel_name(survey_full[2].variant))}")

    for r in records:
        log(f"[bound] {r['name']} ({r['variant']}): {r['ms']:.3f} ms against "
            f"a bound of {r['bound_ms']:.4f} ms ({r['bound_by']}), "
            f"{r['registers']} registers")

    log(f"total {time.perf_counter() - t_start:.1f} s")
    check("jax" not in sys.modules, "jax was imported")
    print(json.dumps({"kernels": records}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
