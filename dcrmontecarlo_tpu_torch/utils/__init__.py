from .autodiff import gradient, laplacian, value_grad_laplacian
from .gridscan import grid_min_max

__all__ = ["gradient", "laplacian", "value_grad_laplacian", "grid_min_max"]
