"""The walk kernel built by the host compiler, for the CPU tests.

``csrc/walk_kernel.cu`` is built with ``cuda_runtime.h`` beside this file
in place of the CUDA runtime: one host thread per CUDA thread, the
block's barriers, ``__syncthreads_count`` and the shared-memory atomics
emulated, a block at a time. Its ``<<<...>>>`` launch becomes
``host_launch``. With ``one_thread`` every build runs the
one-thread-per-lane loop, as the builds outside ``walk_variant.h::
repacked`` do, in place of the repack loop; with ``full_scans`` the table
form's culled scans skip no chunk or group (``FULL_SCANS``): every row in
row order, the scans as they were before the chunks; with ``large`` the
culled variant's large-table build (``walk_kernel.large_scans``); with
``plain_loop`` the one-thread loop without its builds' hooks
(``PLAIN_LOOP``: the full closest point of ``walk_kernel.culled_closest``'s
build, ``cosf`` and ``sinf`` in ``walk_kernel.one_sincos``'s, the full
chord frame in ``walk_kernel.culled_chord``'s), the loop those builds ran
before them.
"""

import ctypes
import re
import shutil
import subprocess

import pytest

import chip_smoke as cs
from dcrmontecarlo_tpu_torch.ops import walk_kernel as wk

# the kernel's loop fork, and the one-thread loop in its place
ONE_THREAD = (
    ("  if constexpr (repacked(ROBIN, MIS, FREEZE, TABLE, TERMS_FORM)) {\n"
     "    walk_repacked", "  if constexpr (false) {\n    walk_repacked"),
    ("constexpr bool REPACKED = repacked(WALK_ROBIN, WALK_MIS != 0,\n"
     "                                   WALK_FREEZE != 0, WALK_TABLE != 0,\n"
     "                                   WALK_TERMS != 0);",
     "constexpr bool REPACKED = false;"))
# the culled scans' skip test, and false in its place
FULL_SCANS = (("constexpr bool CHUNK_SKIP = true;",
               "constexpr bool CHUNK_SKIP = false;"),)
# the one-thread loop's hooks of the culled_closest, one_sincos and
# culled_chord builds, and none in their place
PLAIN_LOOP = (("#if WALK_CULLED_CLOSEST\n#define WALK_CLOSEST",
               "#if 0\n#define WALK_CLOSEST"),
              ("#if WALK_ONE_SINCOS\n#define WALK_SINCOS",
               "#if 0\n#define WALK_SINCOS"),
              ("#if WALK_CULLED_CHORD\n#define WALK_CHORD",
               "#if 0\n#define WALK_CHORD"))


def host_source(one_thread=False, full_scans=False, extra="",
                plain_loop=False):
    """The kernel's source with its launch run by ``host_launch``, and
    ``extra`` appended (a test's probe of the unit's functions)."""
    src = wk._SRC.read_text()
    for on, edits in ((one_thread, ONE_THREAD), (full_scans, FULL_SCANS),
                      (plain_loop, PLAIN_LOOP)):
        for old, new in edits if on else ():
            assert src.count(old) == 1, old
            src = src.replace(old, new)
    start = src.index("  walk_kernel<WALK_ROBIN")
    end = src.index("(n_lanes, budget, thr);") + len("(n_lanes, budget, thr);")
    launch = src[start:end]
    m = re.search(r"<<<\s*(\w+)\s*,\s*(\w+)\s*,[^>]*>>>", launch)
    call = " ".join(launch.replace(m.group(0), "").split())
    return src.replace(launch, f"  host_launch({m.group(1)}, {m.group(2)}, "
                               f"[&] {{ {call} }});") + extra


def start_build(tmp, variant, one_thread, full_scans=False, extra="",
                large=False, plain_loop=False):
    """Start the host compiler on ``variant``'s library (its large-table
    build with ``large``) under ``tmp``; returns ``(process, library
    path)`` (:func:`load` waits for it)."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    name = (f"{wk.build_code(variant, large)}_"
            f"{'one' if one_thread else 'own'}"
            f"{'_full' if full_scans else ''}"
            f"{'_plain' if plain_loop else ''}")
    unit = tmp / f"walk_kernel_{name}.cpp"
    unit.write_text(host_source(one_thread, full_scans, extra, plain_loop))
    so = tmp / f"walk_kernel_{name}.so"
    here = wk._SRC.parents[2] / "tests" / "host_cuda"
    proc = subprocess.Popen(
        [cxx, "-std=c++17", "-O1", "-ffp-contract=off", "-shared", "-fPIC",
         "-pthread", "-I", str(here), "-I", str(wk._SRC.parent),
         *wk.variant_macros(variant, large), "-o", str(so), str(unit)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, so


def load(build, variant):
    """``walk(state, params, budget, thr)``: one launch of a started
    build's library on CPU planes, in place, in the build's own loop (one
    thread a lane or the repack loop, never the dealt loop);
    ``walk.loop(state, params, budget, thr)`` launches as the card's
    wrapper does (``walk_kernel.launch_loop``: the dealt loop where the
    launch allows it) and returns the loop it ran; ``walk.schedule`` is the
    launch's schedule as the library exports it, ``walk.lib`` the
    library."""
    proc, so = build
    out, _ = proc.communicate(timeout=300)
    assert proc.returncode == 0, out
    lib = ctypes.CDLL(str(so))

    lib.walk_launch.argtypes = wk.LAUNCH_ARGTYPES
    assert lib.walk_chunk_rows() == wk.CHUNK_ROWS

    def walk(state, params, budget, thr):
        assert params.variant == variant
        fp, ip, arr, garr, seeds, per, chunks = wk.launch_args(state,
                                                              params)
        err = lib.walk_launch(
            fp.ctypes.data, len(fp), ip.ctypes.data, len(ip), arr, len(arr),
            state["px"].numel(), budget, thr, garr, len(garr), None,
            seeds.ctypes.data, len(seeds), per, chunks, None, None, 0)
        assert err == 0
        return state

    def loop(state, params, budget, thr):
        assert params.variant == variant
        return wk.launch_loop(lib, state, params, budget, thr)

    if hasattr(lib, "walk_plan"):
        lib.walk_plan.argtypes = wk.PLAN_ARGTYPES
    walk.loop = loop
    walk.schedule = cs.repack_schedule(lib)
    walk.lib = lib
    return walk
