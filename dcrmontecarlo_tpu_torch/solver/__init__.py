from .wost import WoStSolver, SolveResult, SolverOptions, RawSolveOut
from .stream import StreamState, solve_stream, solve_to_tolerance

__all__ = ["WoStSolver", "SolveResult", "SolverOptions", "RawSolveOut",
           "StreamState", "solve_stream", "solve_to_tolerance"]
