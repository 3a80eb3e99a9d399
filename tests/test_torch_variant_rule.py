"""Every switch combination of the walk kernel: the rule, the paths, the build.

The JAX kernel (``ops/pallas_walk.py::make_pallas_walk``) traces any
combination of its switches; the port's CUDA kernel builds each valid
one as a library of its own the first time a launch needs it. Here, on
the CPU: ``walk_kernel.valid_variant`` accepts exactly the 400
combinations of the Robin mode and eight switches that the reference
traces, and rejects each other class with the reference's reason; the
paths that used to raise on the card take their variants and pack; and a
variant's build command names its switches as macros under a cache key of
its own. The C++ side of the rule is held to this one in
``test_torch_hygiene.py``; the plain walk of each new interaction to the
reference in ``test_torch_variant_sweep*.py``.
"""

import dataclasses
import itertools

import numpy as np
import pytest
import torch

import chip_smoke as cs
from dcrmontecarlo_tpu_torch.geometry import square_loop
from dcrmontecarlo_tpu_torch.models import drape_electrodes, \
    geophysical_scenario, notebook_survey, variable_coefficient_problem
from dcrmontecarlo_tpu_torch.ops import walk_kernel as wk
from dcrmontecarlo_tpu_torch.problems import Problem, fields
from dcrmontecarlo_tpu_torch.solver import SolverOptions, WoStSolver
from dcrmontecarlo_tpu_torch.survey import survey_default_options

torch.set_num_threads(1)

ROBINS = (wk.ROBIN_OFF, wk.ROBIN_CHAIN, wk.ROBIN_REFLECTANCE)
ALL = [v for v in itertools.product(ROBINS, *[(False, True)] * 8)]


def test_valid_variant_accepts_exactly_the_reference_combinations():
    valid = [v for v in ALL if wk.valid_variant(v)]
    assert len(ALL) == 768 and len(valid) == 400
    # with delta tracking every combination; without it Robin off, no
    # majorant, freeze or transport sampler: MIS, the table form, the wide
    # form and the grid free
    assert sum(v[5] for v in valid) == 3 * 2 ** 7
    assert {v for v in valid if not v[5]} == {
        (wk.ROBIN_OFF, False, m, False, t, False, False, w, g)
        for m, t, w, g in itertools.product((False, True), repeat=4)}
    # a TERMS form exactly where the variant lacks the kind
    forms = [v + (True,) for v in valid if not wk.terms_fields(v)]
    assert len(forms) == 368 and all(wk.valid_variant(f) for f in forms)
    assert not any(wk.valid_variant(v + (True,)) for v in valid
                   if wk.terms_fields(v))
    assert wk.KERNEL_VARIANTS == frozenset(valid) | frozenset(forms)
    # the paths' 21 and the script's others are all valid
    assert set(cs.SCRIPT_VARIANTS) <= wk.KERNEL_VARIANTS
    assert len(set(cs.SCRIPT_VARIANTS)) == len(cs.SCRIPT_VARIANTS) == 35


NO_DELTA = (wk.ROBIN_OFF, False, False, False, False, False, False, False,
            False)


@pytest.mark.parametrize("variant,reason", [
    (NO_DELTA[:0] + (wk.ROBIN_CHAIN,) + NO_DELTA[1:],
     r"Robin correction needs delta tracking .*pallas_walk.py:611"),
    (NO_DELTA[:0] + (wk.ROBIN_REFLECTANCE,) + NO_DELTA[1:],
     r"Robin correction needs delta tracking"),
    (NO_DELTA[:1] + (True,) + NO_DELTA[2:],
     r"local majorant needs delta tracking .*pallas_walk.py:559"),
    (NO_DELTA[:3] + (True,) + NO_DELTA[4:],
     r"freeze needs delta tracking .*solver/wost.py:1780.*inert"),
    (NO_DELTA[:6] + (True,) + NO_DELTA[7:],
     r"transport sampler needs delta tracking .*pallas_walk.py:884-900"),
    (NO_DELTA + (True,), r"TERMS form exists only for a variant that lacks"),
    ((3,) + NO_DELTA[1:], r"unknown Robin mode 3"),
])
def test_invalid_classes_carry_the_reference_reason(variant, reason):
    assert not wk.valid_variant(variant)
    assert variant not in wk.KERNEL_VARIANTS
    import re
    assert re.search(reason, wk.variant_fault(variant)), \
        wk.variant_fault(variant)
    with pytest.raises(ValueError, match="variant has 9 or 10"):
        wk.valid_variant(variant[:8])


def _params(solver, pts, n_walks=64, max_steps=100, eps=0.5):
    return solver._setup(np.asarray(pts, np.float32), n_walks, max_steps,
                         eps, 0)[1]


def _survey_split():
    survey, el = geophysical_scenario(sharpness=0.5)
    return WoStSolver(survey.build_problem(), cs.survey_split_options(
        target_slots=1024), device="cpu"), cs.survey_points(el, -0.5)


def _terrain_flagship():
    prob, h = cs.terrain_flagship_problem(half_width=100.0, depth=150.0,
                                          resolution=4.0)
    return WoStSolver(prob, survey_default_options(
        target_slots=1024, split_threshold=4.0), device="cpu"), \
        drape_electrodes(h, cs.TOPO_XS, nudge=0.5)


def _notebook_reflectance():
    survey, el = notebook_survey()
    survey.source_mis = True
    return survey.make_solver(survey_default_options(
        target_slots=1024, robin_correction="reflectance"),
        device="cpu"), el


def _varcoeff(**opts):
    return WoStSolver(variable_coefficient_problem(), SolverOptions(
        target_slots=1024, **opts), device="cpu"), [[0.7, 0.7], [-1.0, 0.2]]


def _varcoeff_majorant():
    prob = variable_coefficient_problem()
    prob.local_majorant = wk.LocalMajorant(boxes=((-0.5, 0.5, -0.5, 0.5),),
                                           sigma_bar_bg=1.0)
    return WoStSolver(prob, SolverOptions(target_slots=1024),
                      device="cpu"), [[0.7, 0.7], [-1.0, 0.2]]


def _grid_chain():
    from dcrmontecarlo_tpu_torch.diagnostics import grid_continuation

    survey, el = notebook_survey()
    prob = survey.build_problem()
    xs, ys = np.linspace(-600, 600, 13), np.linspace(-1100, 100, 13)
    prob.set_boundary_conditions(grid_continuation(
        xs, ys, np.add.outer(xs, ys)))
    return WoStSolver(prob, SolverOptions(target_slots=1024),
                      device="cpu"), el


# paths of the JAX package on switch combinations beyond the paths of
# chip_smoke.py phases 3-39: (solver and points, variant, name, code)
PATHS = {
    "survey with the split": (
        _survey_split, (0, False, False, True, False, True, False, False,
                        False),
        "walk_kernel<0,false,false,true,false,true,false>", 10),
    "terrain with the flagship's estimator": (
        _terrain_flagship, (0, True, True, True, True, True, False, False,
                            False),
        "walk_kernel<0,true,true,true,true,true,false>", 62),
    "notebook gate with reflectance": (
        _notebook_reflectance, (2, False, True, False, False, True, False,
                                False, False),
        "walk_kernel<2,false,true,false,false,true,false>", 146),
    "variable coefficients with the split": (
        lambda: _varcoeff(split_threshold=4.0),
        (1, False, False, True, False, True, False, False, False, True),
        "walk_kernel<1,false,false,true,false,true,false,false,false,true>",
        1024 + 74),
    "variable coefficients with a local majorant": (
        _varcoeff_majorant,
        (1, True, False, False, False, True, False, False, False, True),
        "walk_kernel<1,true,false,false,false,true,false,false,false,true>",
        1024 + 98),
    "a grid on the accuracy path's chain": (
        _grid_chain, (1, False, False, False, False, True, False, False,
                      True),
        "walk_kernel<1,false,false,false,false,true,false,false,true>",
        512 + 66),
}


@pytest.mark.parametrize("path", sorted(PATHS))
def test_new_paths_take_their_variant_and_pack(path):
    make, variant, name, code = PATHS[path]
    solver, pts = make()
    params = _params(solver, pts)
    assert params.variant == variant and params.variant in wk.KERNEL_VARIANTS
    assert params.kernel_name == name and wk.variant_code(variant) == code
    assert params.terms_form == (len(variant) == 10)
    fp, ip = params.pack()
    assert ip[10] == variant[0] and ip[11] == int(variant[1])
    assert (ip[15] > 0) == variant[2] and ip[16] == int(variant[3])
    assert ip[18] == int(variant[4]) and ip[19] == int(variant[5])


def test_packs_refuse_invalid_switches_and_capacities():
    solver, pts = _survey_split()
    params = _params(solver, pts)
    # an invalid combination: the transport sampler without delta tracking
    bad = dataclasses.replace(params, delta=False, freeze=False,
                              transport=True)
    with pytest.raises(ValueError, match="transport sampler needs delta"):
        bad.pack()
    # capacities stay: sources, mixture components
    many = Problem(dirichlet=square_loop(1.0), source=[
        fields.gaussian_dipole((-0.5, 0.01 * i), (0.5, 0.01 * i))
        for i in range(wk.MAX_WIDE_SRC + 1)])
    p = _params(WoStSolver(many, SolverOptions(target_slots=256),
                           device="cpu"), [[0.0, 0.0]], eps=1e-2)
    with pytest.raises(NotImplementedError, match="up to 32 sources"):
        p.pack()


def test_the_freeze_needs_delta_tracking():
    # the reference builds the freeze only with delta tracking
    # (solver/wost.py:1780): the split is inert without it
    prob = Problem(dirichlet=square_loop(1.0),
                   bc_dirichlet=fields.constant(1.0))
    params = wk.make_walk_params(
        prob, eps=1e-2, max_steps=10, t_min=1e-5, rmin=5e-3, project=True,
        rejection_rounds=2, roulette_threshold=None, snap=False, seed=1,
        freeze_split=True)
    assert not params.freeze and wk.valid_variant(params.variant)


# the loop rules of csrc/walk_variant.h for each kernel variant on stdin
# (robin, the nine switches), one line each: chain_phases, repacked
_LOOP_RULES_MAIN = r"""
#include <cstdio>
#include "walk_variant.h"
int main() {
  int r, s[9];
  while (std::scanf("%d %d %d %d %d %d %d %d %d %d", &r, &s[0], &s[1],
                    &s[2], &s[3], &s[4], &s[5], &s[6], &s[7], &s[8]) == 10)
    std::printf("%d %d\n",
                walk_rules::chain_phases(r, s[1], s[2], s[3], s[8]),
                walk_rules::repacked(r, s[1], s[2], s[3], s[8]));
}
"""


def test_loop_rules_of_header_and_python_agree_on_every_variant(tmp_path):
    # the header's loop rules, compiled by the host compiler, and
    # ops/walk_kernel.py's give the same loop to each of the 768 kernel
    # variants: the Robin chain without the freeze queues its wall work in
    # the repack loop with MIS in every form, without MIS except in the table
    # form and the TERMS forms (80 variants, 16 of them without MIS), the
    # freeze builds take the repack loop too (384), the others one thread
    # a lane
    import shutil
    import subprocess

    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    main = tmp_path / "loop_rules.cpp"
    main.write_text(_LOOP_RULES_MAIN)
    exe = tmp_path / "loop_rules"
    subprocess.run([cxx, "-std=c++17", "-I", str(wk._SRC.parent), "-o",
                    str(exe), str(main)], check=True, timeout=120)
    variants = sorted(wk._switches(v) for v in wk.KERNEL_VARIANTS)
    assert len(variants) == 768
    stdin = "".join(" ".join(str(int(x)) for x in v) + "\n"
                    for v in variants)
    out = subprocess.run([str(exe)], input=stdin, check=True,
                         capture_output=True, text=True,
                         timeout=60).stdout.split("\n")
    got = [tuple(int(x) for x in line.split()) for line in out if line]
    assert len(got) == 768
    chain = [v for v in variants if wk.chain_phases(v)]
    for v, (c, rep) in zip(variants, got):
        assert c == wk.chain_phases(v), v
        assert rep == wk.repacked(v), v
        assert c == (v[0] == wk.ROBIN_CHAIN and not v[3]
                     and (v[2] or not (v[4] or v[9]))), v
        assert rep == (v[3] or c), v
    assert len(chain) == 80 and sum(not v[2] for v in chain) == 16
    assert sum(v[3] for v in variants) == 384
    # the paths' chain builds without MIS: the accuracy path's, the
    # variable coefficients' and the transport chain's take the queued
    # step; the table chain (phase 18) and the sweep's chain + majorant
    # TERMS form (phase 42) keep one thread a lane
    for v in ((1, True, False, False, False, True, False, False, False),
              (1, False, False, False, False, True, False, False, False),
              (1, False, False, False, False, True, True, False, False)):
        assert wk.chain_phases(v) and wk.repacked(v), v
    for v in ((1, False, False, False, True, True, False, False, False),
              (1, True, False, False, False, True, False, False, False,
               True)):
        assert not wk.chain_phases(v) and not wk.repacked(v), v


# csrc/walk_variant.h::dealt for each kernel variant on stdin (robin, the
# nine switches), one line each
_DEALT_RULE_MAIN = r"""
#include <cstdio>
#include "walk_variant.h"
int main() {
  int r, s[9];
  while (std::scanf("%d %d %d %d %d %d %d %d %d %d", &r, &s[0], &s[1],
                    &s[2], &s[3], &s[4], &s[5], &s[6], &s[7], &s[8]) == 10)
    std::printf("%d\n", (int)walk_rules::dealt(r, s[0], s[1], s[2], s[3],
                                                s[4], s[5], s[6], s[7],
                                                s[8]));
}
"""


def test_dealt_rule_of_header_and_python_agree_on_every_variant(tmp_path):
    # the header's dealt rule, compiled by the host compiler, and
    # ops/walk_kernel.py's pick the same four of the 768 kernel variants:
    # the survey's build (the main path), the survey's build with MIS and
    # with the transport sampler, and the wide survey with MIS (the
    # Jacobian); none runs the repack loop
    import shutil
    import subprocess

    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    main = tmp_path / "dealt_rule.cpp"
    main.write_text(_DEALT_RULE_MAIN)
    exe = tmp_path / "dealt_rule"
    subprocess.run([cxx, "-std=c++17", "-I", str(wk._SRC.parent), "-o",
                    str(exe), str(main)], check=True, timeout=120)
    variants = sorted(wk._switches(v) for v in wk.KERNEL_VARIANTS)
    stdin = "".join(" ".join(str(int(x)) for x in v) + "\n"
                    for v in variants)
    out = subprocess.run([str(exe)], input=stdin, check=True,
                         capture_output=True, text=True,
                         timeout=60).stdout.split()
    got = [bool(int(x)) for x in out]
    assert got == [wk.dealt(v) for v in variants]
    assert [v for v, d in zip(variants, got) if d] == [
        (wk.ROBIN_OFF, False, False, False, False, True, False, False, False,
         False),
        (wk.ROBIN_OFF, False, False, False, False, True, True, False, False,
         False),
        (wk.ROBIN_OFF, False, True, False, False, True, False, False, False,
         False),
        (wk.ROBIN_OFF, False, True, False, False, True, False, True, False,
         False)]
    assert not any(wk.repacked(v) for v, d in zip(variants, got) if d)


def test_build_command_names_the_switches():
    v = (wk.ROBIN_CHAIN, True, True, True, False, True, False, False, True)
    cmd = wk.nvcc_command(v, "/tmp/out.so")
    assert cmd[1:1 + len(wk.NVCC_FLAGS)] == list(wk.NVCC_FLAGS)
    macros = [c for c in cmd if c.startswith("-DWALK_")]
    assert macros == ["-DWALK_ROBIN=1", "-DWALK_MAJORANT=1", "-DWALK_MIS=1",
                      "-DWALK_FREEZE=1", "-DWALK_TABLE=0", "-DWALK_DELTA=1",
                      "-DWALK_TRANSPORT=0", "-DWALK_WIDE=0", "-DWALK_GRID=1",
                      "-DWALK_TERMS=0"]
    assert cmd[-3:] == ["-o", "/tmp/out.so", str(wk._SRC)]
    assert "-fmad=false" in cmd and not any("fast" in c for c in cmd)
    # a cache key of its own per variant, one source hash for all
    paths = {wk._library_path(u) for u in wk.KERNEL_VARIANTS}
    assert len(paths) == len(wk.KERNEL_VARIANTS) == 768
    assert len({p.name.split("-")[1] for p in paths}) == 1
    assert wk._library_path(v).name.endswith(f"-{122 + 512}.so")


def test_build_refuses_invalid_variants_and_reports_nvcc_failures(
        monkeypatch, tmp_path):
    with pytest.raises(ValueError, match="freeze needs delta tracking"):
        wk.build_library([(0, False, False, True, False, False, False,
                           False, False)])
    # no fallback: a failed compile raises with the compiler's log
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: no card toolchain here'\n"
                    "exit 3\n")
    fake.chmod(0o755)
    monkeypatch.setattr(wk, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(wk, "_BUILD_DIR", tmp_path / "build")
    v = (0, False, True, True, True, True, False, True, False)
    with pytest.raises(RuntimeError, match=r"(?s)nvcc failed \(3\).*no card"):
        wk.build_library([v])
    assert not list((tmp_path / "build").glob("*.so"))


def _host_library(tmp_path, variant):
    """The host part of ``csrc/walk_kernel.cu`` built by the host
    compiler for ``variant`` (``tests/host_cuda/cuda_runtime.h`` in place
    of CUDA's header, the launch cut out, so the kernel is not
    instantiated: the library checks a header and copies its constant
    block)."""
    import ctypes
    import shutil
    import subprocess

    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    src = wk._SRC.read_text()
    launch = src[src.index("  walk_kernel<WALK_ROBIN"):
                 src.index("(n_lanes, budget, thr);") + 23]
    unit = tmp_path / "walk_kernel_host.cpp"
    unit.write_text(src.replace(launch, "  (void)grid; (void)st;"))
    so = tmp_path / f"walk-{wk.variant_code(variant)}.so"
    here = wk._SRC.parents[2] / "tests" / "host_cuda"
    subprocess.run([cxx, "-std=c++17", "-O0", "-shared", "-fPIC", "-I",
                    str(here), "-I", str(wk._SRC.parent),
                    *wk.variant_macros(variant), "-o", str(so), str(unit)],
                   check=True, timeout=300)
    return ctypes.CDLL(str(so))


def test_library_refuses_a_header_of_other_switches(tmp_path):
    # one library per variant: walk_launch takes only a header whose
    # switches are its own, and walk_switches reads them back
    import ctypes
    import math

    solver, pts = _survey_split()
    state, params, _, _ = solver._setup(np.asarray(pts, np.float32), 64,
                                        100, 0.5, 0)
    lib = _host_library(tmp_path, params.variant)
    got = (ctypes.c_int * 10)()
    assert lib.walk_switches(got, 10) == 0
    assert tuple(got) == (0, 0, 0, 1, 0, 1, 0, 0, 0, 0)

    lib.walk_launch.argtypes = wk.LAUNCH_ARGTYPES

    def launch(p):
        fp, ip, arr, garr, seeds, per, chunks = wk.launch_args(state, p)
        return lib.walk_launch(
            fp.ctypes.data, len(fp), ip.ctypes.data, len(ip), arr, len(arr),
            0, 0, math.inf, garr, len(garr), None, seeds.ctypes.data,
            len(seeds), per, chunks, None, None, 0)

    assert launch(params) == 0
    for other in (dataclasses.replace(params, freeze=False),
                  dataclasses.replace(params, transport=True),
                  dataclasses.replace(params, robin=wk.ROBIN_CHAIN)):
        assert launch(other) == 1, other.kernel_name  # cudaErrorInvalidValue
