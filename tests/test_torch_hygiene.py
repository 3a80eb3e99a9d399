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
print(json.dumps({"modules": names, "bad": bad}))
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
                "models.manufactured", "models.poisson", "models.varcoeff"):
        assert f"dcrmontecarlo_tpu_torch.{mod}" in res["modules"], mod
    assert res["bad"] == []


def _imported_tops(src):
    tops = set()
    for node in ast.walk(ast.parse(src.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            assert node.level == 0, f"relative import at line {node.lineno}"
            tops.add(node.module.split(".")[0])
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


def test_oracle_loaded_by_path_imports_only_numpy_and_scipy():
    # chip_smoke.py's oracle is the port's own copy of the finite-volume
    # solver, imported from the port; it imports only numpy and scipy
    tops = _imported_tops(PORT / "validation" / "fdm.py")
    assert tops <= {"numpy", "scipy", "typing", "math", "__future__"}, tops
    text = (ROOT / "chip_smoke.py").read_text()
    assert "dcrmontecarlo_tpu_torch.validation" in text
    assert "spec_from_file_location" not in text


def test_every_file_chip_smoke_loads_by_path_is_jax_free():
    # the one file of the JAX package chip_smoke.py reads by path is the
    # pinned oracle's data: a plain .npz that loads without pickle (no code)
    import numpy as np

    files = _files_chip_smoke_loads_by_path()
    assert files == {"dcrmontecarlo_tpu/validation/pins/notebook_oracle.npz"}
    for rel in files:
        with np.load(ROOT / rel, allow_pickle=False) as z:
            assert {"electrodes", "fdm_401", "dv_401"} <= set(z.files)


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


def test_kernel_instantiations_match_python():
    # the variants walk_pick compiles are KERNEL_VARIANTS, no more, no less
    from dcrmontecarlo_tpu_torch.ops import walk_kernel as wk

    src = (PORT / "csrc" / "walk_kernel.cu").read_text()
    body = src[src.index("LaunchFn walk_pick("):]
    body = body[:body.index("default:")]
    robin = {"OFF": wk.ROBIN_OFF, "CHAIN": wk.ROBIN_CHAIN,
             "REFLECT": wk.ROBIN_REFLECTANCE}
    found = set()
    for m in re.finditer(r"WALK_CASE\((\d+), ROBIN_(\w+)((?:, \w+){6})\);",
                         body):
        code, r, flags = m.groups()
        b = [f.strip() == "true" for f in flags.split(",")[1:]]
        variant = (robin[r], *b)
        want = variant[0]
        for f in b:
            want = 2 * want + f
        assert int(code) == want == wk.variant_code(variant)
        found.add(variant)
    assert found == set(wk.KERNEL_VARIANTS) and len(found) == 14
    # the table form runs the topographic survey, the chain on it and a
    # walk without delta tracking
    assert {v for v in found if v[4]} == {
        (wk.ROBIN_OFF, False, False, False, True, True, False),
        (wk.ROBIN_CHAIN, False, False, False, True, True, False),
        (wk.ROBIN_OFF, False, False, False, True, False, False)}
    # no delta tracking: Robin off, no majorant, MIS or freeze, both
    # forms; the transport sampler with delta tracking, static form
    assert {v for v in found if not v[5]} == {
        (wk.ROBIN_OFF, False, False, False, t, False, False)
        for t in (False, True)}
    assert {v for v in found if v[6]} == {
        (r, False, False, False, False, True, True)
        for r in (wk.ROBIN_OFF, wk.ROBIN_CHAIN)}


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

    for fn in (WoStSolver.__init__, DCRSurvey.make_solver, DCRSurvey.run):
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
