"""The walk kernel built by the host compiler, for the CPU tests.

``csrc/walk_kernel.cu`` is built with ``cuda_runtime.h`` beside this file
in place of the CUDA runtime: one host thread per CUDA thread, the
block's barriers, ``__syncthreads_count`` and the shared-memory atomics
emulated, a block at a time. Its ``<<<...>>>`` launch becomes
``host_launch``. With ``one_thread`` every build runs the
one-thread-per-lane loop, as the builds outside ``walk_variant.h::
repacked`` do, in place of the repack loop.
"""

import ctypes
import re
import shutil
import subprocess

import pytest

import chip_smoke as cs
from dcrmontecarlo_tpu_torch.ops import walk_kernel as wk
from dcrmontecarlo_tpu_torch.solver.state import CONST_PLANES, \
    SNAP_PLANES, state_planes

# the kernel's loop fork, and the one-thread loop in its place
ONE_THREAD = (
    ("  if constexpr (repacked(ROBIN, MIS, FREEZE)) {\n    walk_repacked",
     "  if constexpr (false) {\n    walk_repacked"),
    ("constexpr bool REPACKED = repacked(WALK_ROBIN, WALK_MIS != 0, "
     "WALK_FREEZE != 0);", "constexpr bool REPACKED = false;"))


def host_source(one_thread=False):
    """The kernel's source with its launch run by ``host_launch``."""
    src = wk._SRC.read_text()
    if one_thread:
        for old, new in ONE_THREAD:
            assert src.count(old) == 1, old
            src = src.replace(old, new)
    start = src.index("  walk_kernel<WALK_ROBIN")
    end = src.index("(n_lanes, budget, thr);") + len("(n_lanes, budget, thr);")
    launch = src[start:end]
    m = re.search(r"<<<\s*(\w+)\s*,\s*(\w+)\s*,[^>]*>>>", launch)
    call = " ".join(launch.replace(m.group(0), "").split())
    return src.replace(launch, f"  host_launch({m.group(1)}, {m.group(2)}, "
                               f"[&] {{ {call} }});")


def start_build(tmp, variant, one_thread):
    """Start the host compiler on ``variant``'s library under ``tmp``;
    returns ``(process, library path)`` (:func:`load` waits for it)."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    name = f"{wk.variant_code(variant)}_{'one' if one_thread else 'own'}"
    unit = tmp / f"walk_kernel_{name}.cpp"
    unit.write_text(host_source(one_thread))
    so = tmp / f"walk_kernel_{name}.so"
    here = wk._SRC.parents[2] / "tests" / "host_cuda"
    proc = subprocess.Popen(
        [cxx, "-std=c++17", "-O1", "-ffp-contract=off", "-shared", "-fPIC",
         "-pthread", "-I", str(here), "-I", str(wk._SRC.parent),
         *wk.variant_macros(variant), "-o", str(so), str(unit)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, so


def load(build, variant):
    """``walk(state, params, budget, thr)``: one launch of a started
    build's library on CPU planes, in place; ``walk.schedule`` is the
    launch's schedule as the library exports it."""
    proc, so = build
    out, _ = proc.communicate(timeout=300)
    assert proc.returncode == 0, out
    lib = ctypes.CDLL(str(so))

    def walk(state, params, budget, thr):
        assert params.variant == variant
        fp, ip = params.pack()
        ptrs = [None] * len(wk._PLANE_ORDER)
        names = set(CONST_PLANES) | set(state_planes(params.n_src))
        names |= set(SNAP_PLANES) if params.snap else set()
        for n in names:
            assert state[n].is_contiguous()
            ptrs[wk._PLANE_INDEX[n]] = state[n].data_ptr()
        geom = [t.data_ptr() if t.numel() else None
                for t in params.device_tables("cpu")] or [None] * 3
        geom.append(None)  # no grid
        err = lib.walk_launch(
            ctypes.c_void_p(fp.ctypes.data), len(fp),
            ctypes.c_void_p(ip.ctypes.data), len(ip),
            (ctypes.c_void_p * len(ptrs))(*ptrs), len(ptrs),
            state["px"].numel(), budget, ctypes.c_float(thr),
            (ctypes.c_void_p * 4)(*geom), 4, None)
        assert err == 0
        return state
    walk.schedule = cs.repack_schedule(lib)
    return walk
