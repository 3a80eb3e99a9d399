from .state import WalkerState, init_state
from .wost import WoStSolver, SolveResult, SolverOptions, RawSolveOut
from .stream import StreamState, solve_stream, solve_to_tolerance

__all__ = ["WalkerState", "init_state", "WoStSolver", "SolveResult",
           "SolverOptions", "RawSolveOut", "StreamState", "solve_stream",
           "solve_to_tolerance"]
