"""The general rows build's Gaussian pole sources, run on the CPU.

In a wide variant's general rows build (``WalkParams.rows``;
``chip_smoke.py`` phase 46's wide survey
``<0,false,false,false,false,true,false,true,false,false,true>``) a source
that is exactly one Gaussian pole (``walk_kernel.pole_record``: a
``fields.gaussian_bump``) is marked by the host (``WalkParams.poles``, the
kind word ``POLE_KIND``), in the header or past it, and the kernel
evaluates it from a record (``csrc/walk_kernel.cu``: ``pole_value``) in
place of the general ``TERMS`` text. Here the host compiler builds it
(``tests/host_cuda/``). On ``chip_smoke.py``'s sweep box (axis-aligned
walls keep walks in step across math libraries), with nine poles and with
poles mixed among dipoles, polynomials and bump sums, the dealt launch
equals, bit for bit on every plane, the one-thread loop run in 256-step
launches until drained and the same launch with no source marked (every
pole by the ``TERMS`` text), and ``walk_plain`` by ``compare_planes``. A
near-pole (a non-zero background, a non-zero ax, a sin factor, a second
term, a linear coefficient) is not marked and still agrees. The kernel
refuses a mark on a field that is not one pole, on a field outside the
sources, and in a build without the general rows.
"""

import dataclasses
import math

import pytest
import torch

from dcrmontecarlo_tpu_torch.ops import walk_kernel as wk
from dcrmontecarlo_tpu_torch.problems import fields
from dcrmontecarlo_tpu_torch.solver.state import state_planes
from test_torch_host_dealt_walks import WIDE, _box_state, _budget, \
    _clone, _drained, host_builds

torch.set_num_threads(1)

ROWS = WIDE + (False, True)  # phase 46's build


@pytest.fixture(scope="module")
def host_walks(tmp_path_factory):
    return host_builds(tmp_path_factory, (ROWS, WIDE))


def pole(i, amp=1.0):
    """The ``i``-th test pole inside the sweep box."""
    return fields.gaussian_bump((-1.6 + 0.4 * i, -0.5 - 0.35 * (i % 4)),
                                amp * (1.0 + 0.15 * i), 0.3 + 0.02 * i)


def dipole(i):
    return fields.gaussian_dipole((-1.0 + 0.2 * i, -0.6),
                                  (1.0, -1.0 - 0.1 * i), 1.0, 0.3)


# a term like pole(i)'s but for one change, which takes it off the rule
NEAR = {
    "background": lambda i: fields.terms(0.25, *pole(i).terms),
    "ax": lambda i: fields.terms(0.0, pole(i).terms[0]._replace(ax=0.5)),
    "sin": lambda i: fields.terms(0.0, fields.term(
        1.3, g=4.0, center=(0.1 * i, -1.0), sx=("sin", 2.0, 0.3))),
    "two_terms": lambda i: fields.terms(0.0, *pole(i).terms,
                                        *pole(i + 1).terms),
    "linear": lambda i: fields.terms(0.0, fields.term(
        {(0, 0): 1.2, (1, 0): 0.4}, g=3.0, center=(-0.2 * i, -1.2))),
}
# the sources of each case, and the ones the host marks
CASES = {
    "nine_poles": ([pole(i) for i in range(9)], tuple(range(9))),
    "mixed": ([pole(0), dipole(1),
               fields.polynomial({(1, 0): 0.3, (0, 1): 0.2}), pole(3, -1.0),
               fields.bump_sum(0.1, [(1.5, fields.smooth_circle(
                   (-0.8, -2.0), 0.5, 8.0))]),
               pole(5), dipole(6), fields.polynomial({(0, 0): 0.5}), pole(8)],
              (0, 3, 5, 8)),
}


def test_pole_record_takes_exactly_one_gaussian_pole():
    p = pole(2)
    t = p.terms[0]
    assert wk.pole_record(p) == (t.cx, t.cy, t.poly[0][0], t.g)
    for name, make in NEAR.items():
        assert wk.pole_record(make(2)) is None, name
    assert wk.pole_record(fields.terms(-0.0, *p.terms)) is None  # its bits
    for other in (dipole(0), fields.constant(1.0), fields.polynomial(
            {(0, 0): 1.0}), CASES["mixed"][0][4]):
        assert wk.pole_record(other) is None


def _unmarked(params):
    """``params`` with no source marked as a pole (every pole by the
    ``TERMS`` text)."""
    class Unmarked(type(params)):
        poles = ()

    return Unmarked(**{f.name: getattr(params, f.name)
                       for f in dataclasses.fields(params) if f.init})


def pole_case(walk, sources, marked):
    """The dealt launch of the host build ``walk`` from the box state with
    ``sources`` (those at ``marked`` poles): every plane equal to the
    drained one-thread loop's and to the same launch without marks, bit for
    bit; then at quotas of at most 7 on the first 128 lanes equal to
    ``walk_plain``'s by ``compare_planes``."""
    state, params = _box_state(ROWS, "auto", case=dict(n_src=len(sources)),
                               sources=sources)
    assert params.variant == ROWS and params.poles == marked
    _, ip = params.pack()
    kinds = ip[_kind(params, 3)::2]  # the sources' kind words
    assert [i for i, k in enumerate(kinds) if k == wk.POLE_KIND] == list(
        marked)
    names = state_planes(params.n_src)
    budget = _budget(state, params)
    dealt, one, general = _clone(state), _clone(state), _clone(state)
    assert walk.loop(dealt, params, budget, None) == "dealt"
    assert _drained(walk, one, params) > 1
    unmarked = _unmarked(params)
    assert unmarked.pack()[1].tolist() != ip.tolist()
    assert walk.loop(general, unmarked, budget, None) == "dealt"
    for k in names:
        assert torch.equal(dealt[k], one[k]), k
        assert torch.equal(dealt[k], general[k]), k
    assert int(dealt["quota"].max()) == 0
    for i in marked:
        assert int((dealt[f"asum{i}"] != 0).sum()) > 0, i
    small = {k: v.reshape(-1)[:128].clone() for k, v in state.items()}
    small["quota"].clamp_(max=7)
    got, plain = _clone(small), _clone(small)
    assert walk.loop(got, params, _budget(small, params), None) == "dealt"
    wk.walk_plain(plain, params, _budget(small, params))
    frac, _, finite = wk.compare_planes(got, plain, names)
    assert finite and min(frac.values()) >= wk.PLANE_MIN_FRAC, frac


@pytest.mark.parametrize("case", sorted(CASES))
def test_poles_dealt_equal_one_thread_general_text_and_plain(host_walks,
                                                             case):
    sources, marked = CASES[case]
    pole_case(host_walks[ROWS], sources, marked)


@pytest.mark.parametrize("near", sorted(NEAR))
def test_near_pole_takes_the_general_text(host_walks, near):
    # near-poles in the header (source 1) and past it (source 6), among
    # poles: not marked, and the launch still agrees
    sources = [pole(i) for i in range(9)]
    sources[1], sources[6] = NEAR[near](1), NEAR[near](6)
    pole_case(host_walks[ROWS], sources, (0, 2, 3, 4, 5, 7, 8))


def _kind(params, f):
    """The index of field ``f``'s kind word in ``params.pack()``'s ints
    (the fields' kinds and lengths end them)."""
    return len(params.pack()[1]) - 2 * len(params.specs) + 2 * f


def _launch(lib, state, params, ip):
    fp, _, arr, garr, seeds, per, chunks = wk.launch_args(state, params)
    return lib.walk_launch(
        fp.ctypes.data, len(fp), ip.ctypes.data, len(ip), arr, len(arr),
        state["px"].numel(), 1, math.inf, garr, len(garr), None,
        seeds.ctypes.data, len(seeds), per, chunks, None, None, 0)


def test_a_mark_off_a_pole_or_the_rows_build_is_refused(host_walks):
    # cudaErrorInvalidValue (1): a mark on a near-pole (in the header and
    # past it), on the Dirichlet field, or in the dipole rows build
    rows, dipoles = host_walks[ROWS].lib, host_walks[WIDE].lib
    sources = [pole(i) for i in range(9)]
    sources[1], sources[6] = NEAR["linear"](1), NEAR["background"](6)
    state, params = _box_state(ROWS, "auto", case=dict(n_src=9),
                               sources=sources)
    _, ip = params.pack()
    assert _launch(rows, _clone(state), params, ip) == 0
    for f in (3 + 1, 3 + 6, 0):
        bad = ip.copy()
        bad[_kind(params, f)] = wk.POLE_KIND
        assert _launch(rows, _clone(state), params, bad) == 1, f
    wide_state, wide = _box_state(WIDE, "auto", case=dict(n_src=5))
    assert wide.variant == WIDE and wide.poles == ()
    _, ip = wide.pack()
    assert _launch(dipoles, _clone(wide_state), wide, ip) == 0
    bad = ip.copy()
    bad[_kind(wide, 3)] = wk.POLE_KIND  # source 0, a dipole
    assert _launch(dipoles, _clone(wide_state), wide, bad) == 1
