"""Pinned oracle artifacts: committed reference numbers for the gates
(port of ``validation/pins.py``).

The pins are data, not code: the JAX package's committed ``.npz`` files
under ``dcrmontecarlo_tpu/validation/pins/``, generated by its
``tools/gen_oracle_pins.py`` and ``tools/gen_cylinder_pins.py``. The port
reads the two files by path from the checkout (plain arrays, no pickle)
and imports nothing of the JAX package.
"""

import os

import numpy as np

__all__ = ["notebook_oracle_pins", "cylinder_oracle_pins"]

PIN_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "dcrmontecarlo_tpu", "validation", "pins")
_cache = {}


def _load(name: str) -> dict:
    if name not in _cache:
        path = os.path.join(PIN_DIR, name)
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"{path}: the oracle pins are read from the repository's "
                "checkout (dcrmontecarlo_tpu/validation/pins/)")
        with np.load(path, allow_pickle=False) as z:
            _cache[name] = {k: z[k] for k in z.files}
    return _cache[name]


def cylinder_oracle_pins() -> dict:
    """Load the author-independent cylinder-series oracle pins.

    Keys per contrast (``conductor`` = 1e-1, ``resistor`` = 1e-3):
    ``ref_<c>`` (21,) regularized series at the electrode line,
    ``bc_grid_<c>`` (257, 257) domain grid for the MC Dirichlet BC,
    ``delta_smooth_<c>`` (21,) FDM smoothing delta,
    ``fdm_sharp_401_<c>`` (21,); plus ``electrodes``, ``gx``, ``gy``.
    """
    return _load("cylinder_oracle.npz")


def notebook_oracle_pins() -> dict:
    """Load the flagship notebook-model oracle pins.

    Returns a dict with ``electrodes`` (21, 2) and electrode potentials
    ``fdm_201 / fdm_401 / fdm_801 / fem_201 / fem_401 / richardson``
    plus adjacent dipole voltages ``dv_401 / dv_richardson``.
    """
    return _load("notebook_oracle.npz")
