"""dcrmontecarlo_tpu_torch — the Walk-on-Stars DCR solver in PyTorch + CUDA.

A port of ``dcrmontecarlo_tpu`` (JAX/Pallas) for NVIDIA Hopper: the same
public names and subpackage layout, with the fused walk as a hand-written
CUDA kernel (``csrc/walk_kernel.cu``) and its plain PyTorch version for
CPU tensors. Imports ``torch``, ``numpy`` and ``scipy`` only.
"""

from .geometry import Polyline, square_loop, circle_loop, func_to_polyline
from .problems import Problem
from .solver import WoStSolver, SolveResult, SolverOptions

__all__ = [
    "Polyline",
    "square_loop",
    "circle_loop",
    "func_to_polyline",
    "Problem",
    "WoStSolver",
    "SolveResult",
    "SolverOptions",
]
__version__ = "0.1.0"
