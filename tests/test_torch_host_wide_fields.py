"""The wide form's sources of any kind, run on the CPU.

Sources past the fourth that are not all Gaussian dipoles launch a wide
variant's general rows build (``WalkParams.rows``, the eleventh switch):
its sources from ``MAX_SRC`` on are ``WideRow`` records of any kind the
header's fields take but the grid (``csrc/walk_kernel.cu``,
``row_value``). Here the host compiler builds (``tests/host_cuda/``) the
wide survey's general rows build without MIS
``<0,false,false,false,false,true,false,true,false,false,true>``
(``chip_smoke.py`` phase 46's) and with MIS (phase 31's build; no
``TERMS`` row, whose TERMS form deals no walk). On ``chip_smoke.py``'s
sweep box (axis-aligned walls keep walks in step across math libraries),
with a source of another kind at index 4 of 5, 5 of 6 and 31 of 32
(``chip_smoke.sweep_sources``: constants, bump sums, Gaussian bumps and
polynomials among dipoles), with common random numbers and boundary-snap
starts on and off, the dealt launch equals the one-thread loop run in
256-step launches until drained, bit for bit on every plane, and
``walk_plain`` by ``compare_planes``. A ``TERMS`` row on the wide survey
with MIS takes the TERMS form of its general rows build, which runs one
thread a lane, equal to ``walk_plain``. A library takes only a header of
its own build, and ``WalkParams.pack`` refuses what no row holds. The
comparisons with the JAX package are in
``test_torch_host_wide_fields_jax.py``.
"""

import ctypes
import dataclasses
import math

import numpy as np
import pytest
import torch

import chip_smoke as cs
from dcrmontecarlo_tpu_torch.diagnostics import grid_continuation
from dcrmontecarlo_tpu_torch.ops import walk_kernel as wk
from dcrmontecarlo_tpu_torch.problems import fields
from dcrmontecarlo_tpu_torch.solver.state import state_planes
from test_torch_host_dealt_walks import WIDE, WIDE_MIS, _box_state, \
    _budget, _clone, _drained, host_builds

torch.set_num_threads(1)

ROWS = WIDE + (False, True)           # phase 46's build
ROWS_MIS = WIDE_MIS + (False, True)   # phase 31's build, general rows
ROWS_MIS_TERMS = WIDE_MIS + (True, True)  # its TERMS form
HERE = (ROWS, ROWS_MIS, ROWS_MIS_TERMS, WIDE)
# the sources past the fourth of another kind than the dipole, by source
# count: (index, chip_smoke.SWEEP_ROWS kind)
KINDS = {
    ROWS: {5: ((4, "bump"),), 6: ((5, "bumps"),),
           32: ((4, "const"), (13, "poly"), (22, "bumps"), (31, "bump"))},
    ROWS_MIS: {5: ((4, "bumps"),), 6: ((5, "const"),),
               32: ((4, "const"), (22, "bumps"), (31, "bumps"))}}
NAMES = {ROWS: "wide", ROWS_MIS: "wide_mis"}


@pytest.fixture(scope="module")
def host_walks(tmp_path_factory):
    return host_builds(tmp_path_factory, HERE)


def rows_state(variant, n_src, rows, snap="auto", crn=True):
    """512 lanes of ``variant`` on the sweep box
    (``test_torch_host_dealt_walks._box_state``) with ``n_src`` sources,
    those at ``rows`` of their kinds (``chip_smoke.sweep_sources``)."""
    mis = variant[2]
    state, params = _box_state(
        variant, snap, crn=crn, case=dict(mis=mis, n_src=n_src),
        sources=cs.sweep_sources(dict(n_src=n_src, rows=rows)))
    assert params.n_src == n_src and params.rows and params.wide
    assert [i for i, f in enumerate(params.specs[3:])
            if f.kind != fields.DIPOLE] == [i for i, _ in rows]
    return state, params


def rows_case(walk, variant, n_src, snap, crn):
    """The dealt launch of ``variant``'s host build ``walk``: every plane
    equal to the drained one-thread loop's, bit for bit; then on the first
    128 lanes at quotas of at most 7 a dealt launch equal to
    ``walk_plain``'s by ``compare_planes``."""
    state, params = rows_state(variant, n_src, KINDS[variant][n_src], snap,
                               crn)
    assert wk.dealt(params.variant)
    dealt, one = _clone(state), _clone(state)
    assert walk.loop(dealt, params, _budget(state, params), None) == "dealt"
    assert _drained(walk, one, params) > 1
    names = state_planes(n_src)
    for k in names:
        assert torch.equal(dealt[k], one[k]), k
    assert int(dealt["quota"].max()) == 0
    for i, _ in KINDS[variant][n_src]:  # every row banked
        assert int((dealt[f"asum{i}"] != 0).sum()) > 0, i
    small = {k: v.reshape(-1)[:128].clone() for k, v in state.items()}
    small["quota"].clamp_(max=7)
    got, plain = _clone(small), _clone(small)
    assert walk.loop(got, params, _budget(small, params), None) == "dealt"
    wk.walk_plain(plain, params, _budget(small, params))
    frac, _, finite = wk.compare_planes(got, plain, names)
    assert finite and min(frac.values()) >= wk.PLANE_MIN_FRAC, frac


@pytest.mark.parametrize("crn", [True, False], ids=["crn", "no_crn"])
@pytest.mark.parametrize("snap", ["auto", None], ids=["snap", "no_snap"])
@pytest.mark.parametrize("variant", [ROWS, ROWS_MIS],
                         ids=[NAMES[ROWS], NAMES[ROWS_MIS]])
def test_row_at_index_5_dealt_equals_one_thread_and_plain(
        host_walks, variant, snap, crn):
    rows_case(host_walks[variant], variant, 6, snap, crn)


@pytest.mark.parametrize("n_src", [5, 32])
@pytest.mark.parametrize("variant", [ROWS, ROWS_MIS],
                         ids=[NAMES[ROWS], NAMES[ROWS_MIS]])
def test_rows_at_index_4_and_31_dealt_equal_one_thread_and_plain(
        host_walks, variant, n_src):
    rows_case(host_walks[variant], variant, n_src, "auto", True)


def test_terms_row_with_mis_takes_the_terms_form(host_walks):
    # a TERMS row on the wide survey with MIS: the TERMS form of its
    # general rows build, which deals no walk; its launch that drains
    # every quota runs one thread a lane, equal to walk_plain
    walk = host_walks[ROWS_MIS_TERMS]
    state, params = rows_state(ROWS_MIS_TERMS, 6, ((4, "poly"),
                                                   (5, "bumps")))
    assert params.terms_form and not wk.dealt(params.variant)
    small = {k: v.reshape(-1)[:128].clone() for k, v in state.items()}
    small["quota"].clamp_(max=7)
    got, plain = _clone(small), _clone(small)
    assert walk.loop(got, params, _budget(small, params), None) == "lanes"
    wk.walk_plain(plain, params, _budget(small, params))
    names = state_planes(params.n_src)
    frac, _, finite = wk.compare_planes(got, plain, names)
    assert finite and min(frac.values()) >= wk.PLANE_MIN_FRAC, frac
    assert int(got["quota"].max()) == 0 and int((got["asum4"] != 0).sum())


def _launch(lib, state, params):
    fp, ip, arr, garr, seeds, per, chunks = wk.launch_args(state, params)
    return lib.walk_launch(
        fp.ctypes.data, len(fp), ip.ctypes.data, len(ip), arr, len(arr),
        state["px"].numel(), 1, math.inf, garr, len(garr), None,
        seeds.ctypes.data, len(seeds), per, chunks, None, None, 0)


def test_library_takes_only_a_header_of_its_own_build(host_walks):
    # the general rows build refuses a dipole-only wide header and the
    # dipole rows build a header with another kind past the fourth source
    # (cudaErrorInvalidValue); each reads its switches back
    rows, dipoles = host_walks[ROWS].lib, host_walks[WIDE].lib
    for lib, want in ((rows, ROWS), (dipoles, WIDE + (False, False))):
        got = (ctypes.c_int * 11)()
        assert lib.walk_switches(got, 11) == 0
        assert tuple(got) == tuple(int(v) for v in want)
    state, mixed = rows_state(ROWS, 6, ((5, "bumps"),))
    only_dipoles = dataclasses.replace(
        mixed, sources=mixed.sources[:5] + (mixed.sources[0],),
        specs=mixed.specs[:8] + (mixed.specs[3],))
    assert only_dipoles.variant == WIDE and not only_dipoles.rows
    for lib, params, err in ((rows, mixed, 0), (rows, only_dipoles, 1),
                             (dipoles, only_dipoles, 0),
                             (dipoles, mixed, 1)):
        assert _launch(lib, _clone(state), params) == err, (params.variant,
                                                            err)


def _refuse_grid(params):
    xs = np.linspace(-3.0, 3.0, 7)
    grid = grid_continuation(xs, xs, np.zeros((7, 7)))
    return dataclasses.replace(params, sources=params.sources[:5] + (grid,),
                               specs=params.specs[:8] + (grid,))


def _refuse_terms(params):
    f = fields.terms(0.0, *(fields.term(1.0, sx=("sin", float(k)))
                            for k in range(fields.MAX_TERMS + 1)))
    return dataclasses.replace(params, sources=params.sources[:5] + (f,),
                               specs=params.specs[:8] + (f,))


def _refuse_bumps(params):
    f = fields.bump_sum(0.0, [(1.0, fields.smooth_circle((0.0, -1.0), 0.5))])
    f.bumps = f.bumps * (fields.MAX_BUMPS + 1)  # past the constructor's cap
    f.params = (f.background,) + sum(f.bumps, ())
    return dataclasses.replace(params, sources=params.sources[:5] + (f,),
                               specs=params.specs[:8] + (f,))


def _refuse_33(params):
    extra = (params.specs[3],) * (wk.MAX_WIDE_SRC + 1 - params.n_src)
    return dataclasses.replace(params, sources=params.sources + extra,
                               specs=params.specs + extra)


@pytest.mark.parametrize("make,match", [
    (_refuse_grid, "Dirichlet data only"),
    (_refuse_terms, f"up to {fields.MAX_TERMS} terms"),
    (_refuse_bumps, f"up to {fields.MAX_BUMPS} bumps"),
    (_refuse_33, f"up to {wk.MAX_WIDE_SRC} sources"),
], ids=["grid", "terms", "bumps", "33_sources"])
def test_pack_refuses_what_no_row_holds(make, match):
    _, params = rows_state(ROWS, 6, ((5, "bumps"),))
    fp, ip = params.pack()
    assert ip[-2] == fields.BUMPS  # the sixth source's kind
    with pytest.raises(NotImplementedError, match=match):
        make(params).pack()
