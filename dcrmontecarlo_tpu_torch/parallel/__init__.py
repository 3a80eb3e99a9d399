from .mesh import ShardedWoStSolver, initialize_distributed, make_mesh

__all__ = ["ShardedWoStSolver", "make_mesh", "initialize_distributed"]
