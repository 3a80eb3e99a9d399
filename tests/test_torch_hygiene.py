"""Import hygiene and defaults of the PyTorch port.

The machine with the card has no JAX, so ``dcrmontecarlo_tpu_torch`` must
import neither ``jax`` nor the JAX package ``dcrmontecarlo_tpu`` (whose
``__init__`` imports jax), and ``chip_smoke.py`` executes no file of it
(the port keeps its own copy of the finite-volume oracle). The two names
share a prefix, so the patterns below match ``dcrmontecarlo_tpu`` only as
a whole module name. The port's entry points run on the card unless the
caller asks for the CPU.
"""

import ast
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "dcrmontecarlo_tpu_torch"
_FORBIDDEN = re.compile(
    r"^\s*(?:import|from)\s+(?:jax|jaxlib|dcrmontecarlo_tpu)(?:\.|\s|,|$)")


def test_no_jax_import_in_port_sources():
    offenders = []
    for f in sorted(PORT.rglob("*.py")):
        for i, line in enumerate(f.read_text().splitlines(), 1):
            if _FORBIDDEN.match(line) or "import_module(\"jax" in line:
                offenders.append(f"{f.relative_to(ROOT)}:{i}: {line}")
    assert not offenders, "\n".join(offenders)


def test_pattern_tells_the_packages_apart():
    assert _FORBIDDEN.match("from dcrmontecarlo_tpu.ops import bessel")
    assert _FORBIDDEN.match("import dcrmontecarlo_tpu")
    assert _FORBIDDEN.match("    import jax.numpy as jnp")
    assert not _FORBIDDEN.match("from dcrmontecarlo_tpu_torch.ops import x")
    assert not _FORBIDDEN.match("import dcrmontecarlo_tpu_torch")


def test_importing_every_port_module_loads_no_jax():
    code = r"""
import importlib, json, pkgutil, sys
import dcrmontecarlo_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "dcrmontecarlo_tpu"))
import torch.distributed as dist
print(json.dumps({"modules": names, "bad": bad,
                  "group": dist.is_available() and dist.is_initialized()}))
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    for mod in ("ops.walk_kernel", "ops.greens", "problems.majorant",
                "interop", "validation.fdm", "solver.split",
                "models.topography", "geometry.queries", "solver.stream",
                "sampling.mis", "sampling._transport_coeffs",
                "models.manufactured", "models.poisson", "models.varcoeff",
                "validation.cylinder", "validation.fem", "validation.pins",
                "diagnostics.history", "diagnostics.counters",
                "diagnostics.martingale", "diagnostics._steps",
                "utils.plotting", "parallel", "parallel.mesh"):
        assert f"dcrmontecarlo_tpu_torch.{mod}" in res["modules"], mod
    assert res["bad"] == []
    # importing the port makes no process group (parallel/ neither)
    assert res["group"] is False


def _imported_tops(src):
    """Top-level modules ``src`` imports; a relative import is ``"."``
    plus its module (a sibling of the port)."""
    tops = set()
    for node in ast.walk(ast.parse(src.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            tops.add("." * node.level + node.module.split(".")[0])
    return tops


def _files_chip_smoke_loads_by_path():
    """The JAX package's files that chip_smoke.py opens by path:
    ``os.path.join(ROOT, "dcrmontecarlo_tpu", ...)``."""
    text = (ROOT / "chip_smoke.py").read_text()
    found = set()
    for m in re.finditer(r'os\.path\.join\(ROOT,\s*("dcrmontecarlo_tpu"'
                         r'(?:,\s*"[^"]+")+)\)', text):
        parts = re.findall(r'"([^"]+)"', m.group(1))
        found.add("/".join(parts))
    return found


def _files_port_loads_by_path():
    """The JAX package's files the port opens by path: the pins, by name
    under ``validation/pins.py``'s ``PIN_DIR``."""
    found = set()
    for f in sorted(PORT.rglob("*.py")):
        text = f.read_text()
        if '"dcrmontecarlo_tpu"' not in text:
            continue
        assert f == PORT / "validation" / "pins.py", f
        assert re.search(r'"dcrmontecarlo_tpu", "validation", "pins"\)',
                         text)
        for name in re.findall(r'_load\("([^"]+)"\)', text):
            found.add(f"dcrmontecarlo_tpu/validation/pins/{name}")
    return found


def test_oracle_loaded_by_path_imports_only_numpy_and_scipy():
    # chip_smoke.py's oracle is the port's own copy of the finite-volume
    # solver, imported from the port; it imports only numpy and scipy
    tops = _imported_tops(PORT / "validation" / "fdm.py")
    assert tops <= {"numpy", "scipy", "typing", "math", "__future__"}, tops
    text = (ROOT / "chip_smoke.py").read_text()
    assert "dcrmontecarlo_tpu_torch.validation" in text
    assert "spec_from_file_location" not in text


@pytest.mark.parametrize("module", ["fem", "cylinder", "pins"])
def test_port_oracle_copies_import_only_numpy_and_scipy(module):
    # the other oracles are the port's own copies of the JAX package's
    # numpy and scipy files too (fem builds on the port's fdm)
    tops = _imported_tops(PORT / "validation" / f"{module}.py")
    assert tops <= {"numpy", "scipy", "typing", "math", "__future__",
                    "os", ".fdm"}, tops


def test_every_file_chip_smoke_loads_by_path_is_jax_free():
    # the files of the JAX package chip_smoke.py and the port read by path
    # are the two pinned oracles' data: plain .npz files that load without
    # pickle (no code)
    import numpy as np

    files = _files_chip_smoke_loads_by_path()
    assert files == {"dcrmontecarlo_tpu/validation/pins/notebook_oracle.npz"}
    files |= _files_port_loads_by_path()
    assert files == {"dcrmontecarlo_tpu/validation/pins/notebook_oracle.npz",
                     "dcrmontecarlo_tpu/validation/pins/cylinder_oracle.npz"}
    for rel in files:
        with np.load(ROOT / rel, allow_pickle=False) as z:
            assert "electrodes" in z.files
            assert {"fdm_401", "dv_401"} <= set(z.files) or \
                {"gx", "gy", "bc_grid_conductor"} <= set(z.files)


def test_kernel_source_names_the_tpu_kernel_it_replaces():
    src = (PORT / "csrc" / "walk_kernel.cu").read_text()
    assert "dcrmontecarlo_tpu/ops/pallas_walk.py" in src
    assert "make_pallas_walk" in src


def test_kernel_constant_tables_match_python():
    # every polynomial table of the kernel equals the plain version's,
    # rounded to float32 (the kernel writes double literals cast to float)
    import numpy as np

    from dcrmontecarlo_tpu_torch.ops import bessel

    src = (PORT / "csrc" / "walk_kernel.cu").read_text()
    tables = {m.group(1): m.group(3) for m in re.finditer(
        r"__constant__ float (\w+)\[(\d+)\] = \{(.*?)\};", src, re.S)}
    assert len(tables) == 13, sorted(tables)
    for name, body in tables.items():
        got = np.array([float(v) for v in re.findall(
            r"F\(([-+0-9.eE]+)\)", body)], np.float32)
        want = np.array(getattr(bessel, "_" + name), np.float32)
        np.testing.assert_array_equal(got, want, err_msg=name)


# every switch tuple, the C++ rules' verdicts printed one line each
_RULES_MAIN = r"""
#include <cstdio>
#include "walk_variant.h"
int main() {
  for (int c = 0; c < 3 * 512; ++c) {
    const int r = c / 512, b = c % 512;
    auto bit = [&](int k) { return ((b >> k) & 1) != 0; };
    std::printf("%d %d %d %d %d\n", c,
                walk_rules::valid_variant(r, bit(0), bit(1), bit(2), bit(3),
                                          bit(4), bit(5), bit(8)),
                walk_rules::terms_fields(r, bit(0), bit(1), bit(2), bit(3),
                                         bit(4)),
                walk_rules::chain_phases(r, bit(1), bit(2), bit(3), bit(8)),
                walk_rules::repacked(r, bit(1), bit(2), bit(3), bit(8)));
  }
}
"""


def test_kernel_instantiations_match_python(tmp_path):
    # csrc/walk_variant.h's rules, compiled by the host compiler, agree
    # with ops/walk_kernel.py's on all 3 x 2^8 switch tuples (and their
    # TERMS forms), the loop rules (chain_phases, repacked) too: 400 valid
    # variants, 368 TERMS forms, and the general rows builds of the 384
    # wide ones; every valid one is in KERNEL_VARIANTS under its own code,
    # and the unit builds only with its switches given
    import shutil

    from dcrmontecarlo_tpu_torch.ops import walk_kernel as wk

    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    main = tmp_path / "rules.cpp"
    main.write_text(_RULES_MAIN)
    exe = tmp_path / "rules"
    subprocess.run([cxx, "-std=c++17", "-I", str(PORT / "csrc"), "-o",
                    str(exe), str(main)], check=True, timeout=120)
    out = subprocess.run([str(exe)], check=True, capture_output=True,
                         text=True, timeout=60).stdout.split("\n")
    n_valid, n_terms, n_rows, codes = 0, 0, 0, set()
    for line in filter(None, out):
        c, valid, terms, chain, repack = (int(v) for v in line.split())
        r, b = divmod(c, 512)  # robin, the eight switches, the TERMS form
        variant = (r,) + tuple(bool((b >> k) & 1) for k in range(9))
        assert valid == wk.valid_variant(variant), variant
        assert terms == wk.terms_fields(variant), variant
        assert chain == wk.chain_phases(variant), variant
        assert repack == wk.repacked(variant), variant
        if valid:
            canon = wk._canonical(variant)
            assert canon in wk.KERNEL_VARIANTS
            codes.add(wk.variant_code(canon))
            n_valid += not variant[9]
            n_terms += variant[9]
            if variant[7]:  # its general rows build, wide ones only
                rows = wk._canonical(variant + (True,))
                assert rows in wk.KERNEL_VARIANTS
                codes.add(wk.variant_code(rows))
                n_rows += 1
            else:
                assert not wk.valid_variant(variant + (True,))
    assert (n_valid, n_terms, n_rows) == (400, 368, 384)
    assert len(wk.KERNEL_VARIANTS) == len(codes) == 1152
    src = (PORT / "csrc" / "walk_kernel.cu").read_text()
    assert "walk_pick" not in src and "WALK_CASE" not in src
    for name in wk.SWITCHES:
        assert f"defined(WALK_{name.upper()})" in src, name


def test_kernel_transport_table_matches_python():
    # the kernel's transport table is the port's copy of the generated
    # coefficients rounded to float32, and the port's copy equals the JAX
    # package's file (read as text: the port imports nothing of it); no
    # entry is zero, so the kernel skips none, as the reference would
    import numpy as np

    from dcrmontecarlo_tpu_torch.sampling import _transport_coeffs as tc

    src = (PORT / "csrc" / "walk_kernel.cu").read_text()
    body = re.search(r"__constant__ float TRANSPORT_COEFFS\[T_ROWS\]"
                     r"\[T_COLS\] = \{(.*?)\n\};", src, re.S).group(1)
    rows = [np.array([float(v) for v in re.findall(r"F\(([-+0-9.eE]+)\)",
                                                   row)], np.float32)
            for row in re.findall(r"\{([^{}]*)\}", body)]
    got = np.stack(rows)
    want = np.asarray(tc.COEFFS, np.float32)
    assert got.shape == want.shape == (29, 13)
    np.testing.assert_array_equal(got, want)
    assert (want != 0).all()
    for name in ("Z_LO", "Z_SW", "A_RAT", "OMEGA_R0", "OMEGA_R1"):
        m = re.search(rf"\b{name} = ([-+0-9.eE]+)", src)
        assert float(m.group(1)) == getattr(tc, name), name
    ref = {}
    exec((ROOT / "dcrmontecarlo_tpu" / "sampling" / "_transport_coeffs.py")
         .read_text(), ref)
    for name in ("COEFFS", "Z_LO", "Z_SW", "A_RAT", "OMEGA_R0", "OMEGA_R1"):
        assert getattr(tc, name) == ref[name], name


def test_entry_points_default_to_the_card():
    # the defaults are "cuda"; here, without a GPU, a solve that does not
    # ask for the CPU raises before it runs anything
    import inspect

    import numpy as np
    import torch

    from dcrmontecarlo_tpu_torch.models import geophysical_scenario
    from dcrmontecarlo_tpu_torch.solver import WoStSolver
    from dcrmontecarlo_tpu_torch.survey import DCRSurvey

    from dcrmontecarlo_tpu_torch.parallel import initialize_distributed, \
        make_mesh

    for fn in (WoStSolver.__init__, DCRSurvey.make_solver, DCRSurvey.run,
               make_mesh, initialize_distributed):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    assert not torch.cuda.is_available()
    survey, electrodes = geophysical_scenario()
    calls = []
    for attempt in (lambda: survey.run(electrodes, n_walks=8, max_steps=5),
                    lambda: survey.make_solver(),
                    lambda: WoStSolver(survey.build_problem())):
        with pytest.raises(RuntimeError, match='device="cpu"') as info:
            calls.append(attempt())
        assert "\n" not in str(info.value)
    assert calls == []
    solver = survey.make_solver(device="cpu")
    assert solver.device.type == "cpu"
    res = survey.run(electrodes[:2], n_walks=8, max_steps=5, solver=solver)
    assert np.isfinite(res.potentials).all()


def test_chip_smoke_refuses_without_a_gpu():
    # this test runs where torch has no CUDA device: the script must exit
    # non-zero and print no result line
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
