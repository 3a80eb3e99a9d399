"""Multiple importance sampling combinator (port of ``sampling/mis.py``).

The reference's MIS scaffold over radial distributions, which no solver
path calls (the walk's source-directed MIS is ``ops/walk_kernel.py``'s):
a distribution is a ``(sample, pdf)`` pair over the ball radius, and
:func:`mis_sample` draws from one per lane with the balance-heuristic
weight ``w_i = c_i p_i / sum_j c_j p_j``. On tensors, branchless.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Sequence, Tuple

import torch

__all__ = ["RadialDistribution", "uniform_radial", "mis_sample"]


class RadialDistribution(NamedTuple):
    """A radial distribution on the ball of radius R.

    sample: ``(R, u1, u2) -> r``; pdf: ``(r, R) -> density``.
    """

    sample: Callable
    pdf: Callable


def uniform_radial() -> RadialDistribution:
    """Uniform radius on ``[0, R]``."""
    return RadialDistribution(
        sample=lambda R, u1, u2: u1 * R,
        pdf=lambda r, R: torch.where((r >= 0) & (r <= R), 1.0 / R, 0.0),
    )


def mis_sample(dists: Sequence[RadialDistribution],
               weights: Sequence[float], R, u_select, u1, u2
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One radius per lane by MIS over ``dists`` (balance heuristic).

    Every distribution is sampled, ``u_select`` picks one per lane against
    the float32 cumulative weights, and the weight ``w_i p_i(r) / sum_j
    w_j p_j(r)`` is taken at the chosen sample. Returns ``(r,
    chosen_index, mis_weight)``.
    """
    dev = u_select.device
    w = torch.as_tensor(weights, dtype=torch.float32, device=dev)
    w = w / torch.sum(w)
    cum = torch.cumsum(w, 0)
    idx = (u_select[..., None] > cum).sum(-1)
    # a float32 cumsum can end below 1.0: clip one past the end
    idx = torch.clamp(idx, 0, len(dists) - 1)
    samples = torch.stack([d.sample(R, u1, u2) for d in dists], dim=-1)
    r = torch.gather(samples, -1, idx[..., None])[..., 0]
    pdfs = torch.stack([d.pdf(r, R) for d in dists], dim=-1)
    weighted = w * pdfs
    denom = torch.sum(weighted, dim=-1)
    chosen = torch.gather(weighted, -1, idx[..., None])[..., 0]
    mis_w = torch.where(denom > 0,
                        chosen / torch.clamp(denom, min=1e-30), 0.0)
    return r, idx, mis_w
