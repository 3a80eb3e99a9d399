"""Differential operators on scalar fields via ``torch.func``.

Port of ``dcrmontecarlo_tpu/utils/autodiff.py``. A field is an
elementwise function ``f(x, y)`` of float32 tensors; the operators return
functions of the same kind, built from ``torch.func.grad`` on the scalar
field and ``torch.func.vmap`` over the batch. They serve arbitrary
callables on the eager path and check the hand-derived derivatives of
the kernel field specs (``problems/fields.py``).
"""

from typing import Callable

from torch.func import grad, vmap

__all__ = ["gradient", "laplacian", "value_grad_laplacian"]


def gradient(f: Callable) -> Callable:
    """``grad f`` of a scalar field ``f(x, y)`` -> ``(fx, fy)``."""
    fx = vmap(grad(f, argnums=0))
    fy = vmap(grad(f, argnums=1))

    def grad_f(x, y):
        return fx(x, y), fy(x, y)

    return grad_f


def laplacian(f: Callable) -> Callable:
    """``lap f`` of a scalar field ``f(x, y)`` (trace of the Hessian)."""
    fxx = vmap(grad(grad(f, argnums=0), argnums=0))
    fyy = vmap(grad(grad(f, argnums=1), argnums=1))

    def lap_f(x, y):
        return fxx(x, y) + fyy(x, y)

    return lap_f


def value_grad_laplacian(f: Callable) -> Callable:
    """Fused ``(f, grad f, lap f)`` evaluation of a scalar field."""
    g = gradient(f)
    lap = laplacian(f)

    def eval_f(x, y):
        gx, gy = g(x, y)
        return f(x, y), (gx, gy), lap(x, y)

    return eval_f
