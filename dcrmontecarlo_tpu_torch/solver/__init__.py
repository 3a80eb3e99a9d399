from .wost import WoStSolver, SolveResult, SolverOptions, RawSolveOut

__all__ = ["WoStSolver", "SolveResult", "SolverOptions", "RawSolveOut"]
