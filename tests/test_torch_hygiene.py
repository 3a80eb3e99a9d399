"""Import hygiene of the PyTorch port.

The machine with the card has no JAX, so ``dcrmontecarlo_tpu_torch`` must
import neither ``jax`` nor the JAX package ``dcrmontecarlo_tpu`` (whose
``__init__`` imports jax). The two names share a prefix, so the patterns
below match ``dcrmontecarlo_tpu`` only as a whole module name.
"""

import ast
import json
import os
import re
import subprocess
import sys
from pathlib import Path

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
    assert "dcrmontecarlo_tpu_torch.ops.walk_kernel" in res["modules"]
    assert res["bad"] == []


def test_oracle_loaded_by_path_imports_only_numpy_and_scipy():
    # chip_smoke.py loads the JAX package's finite-volume oracle by file
    # path, bypassing that package's __init__ (which imports jax); the file
    # must therefore import neither jax nor a sibling module
    src = ROOT / "dcrmontecarlo_tpu" / "validation" / "fdm.py"
    tops = set()
    for node in ast.walk(ast.parse(src.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            assert node.level == 0, f"relative import at line {node.lineno}"
            tops.add(node.module.split(".")[0])
    assert tops <= {"numpy", "scipy", "typing", "math", "__future__"}, tops
    assert "fdm.py" in (ROOT / "chip_smoke.py").read_text()


def test_kernel_source_names_the_tpu_kernel_it_replaces():
    src = (PORT / "csrc" / "walk_kernel.cu").read_text()
    assert "dcrmontecarlo_tpu/ops/pallas_walk.py" in src
    assert "make_pallas_walk" in src


def test_chip_smoke_refuses_without_a_gpu():
    # this test runs where torch has no CUDA device: the script must exit
    # non-zero and print no result line
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
