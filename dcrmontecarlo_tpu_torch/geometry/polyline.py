"""SoA polyline boundary representation on torch tensors.

Port of ``dcrmontecarlo_tpu/geometry/polyline.py``: the same padded
structure-of-arrays fields (``seg_a``, ``seg_b``, ``seg_valid``,
``vert_abc``, ``vert_valid``, ``points``), padding to a multiple of 8 with
degenerate far-away segments, the query facade (``distance``,
``is_silhouette``, ``silhouette_distance``, ``ray_intersection``,
``intersect``) and the heightmap polyline :func:`func_to_polyline`. Tensors
live on the CPU; the walk moves what it needs to its device.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

__all__ = ["Polyline", "square_loop", "circle_loop", "func_to_polyline"]

_PAD = 8  # pad segment/vertex counts to a multiple of this


def _pad_to(n: int, m: int) -> int:
    return max(m, ((n + m - 1) // m) * m)


class Polyline(NamedTuple):
    """Flat SoA polyline set of float32/bool tensors."""

    seg_a: torch.Tensor      # (S, 2) float32 segment starts
    seg_b: torch.Tensor      # (S, 2) float32 segment ends
    seg_valid: torch.Tensor  # (S,)   bool
    vert_abc: torch.Tensor   # (V, 3, 2) float32 interior-vertex triples
    vert_valid: torch.Tensor  # (V,)  bool
    points: torch.Tensor     # (N, 2) float32 original vertex chain(s)

    @staticmethod
    def from_points(points) -> "Polyline":
        """Build from a single ``(N, 2)`` vertex chain (not closed)."""
        pts = np.asarray(points, dtype=np.float32)
        if pts.ndim != 2 or pts.shape[1] != 2 or pts.shape[0] < 2:
            raise ValueError(f"points must be (N>=2, 2), got {pts.shape}")
        if pts.shape[0] >= 3:
            abc = np.stack([pts[:-2], pts[1:-1], pts[2:]], axis=1)
        else:
            abc = np.zeros((0, 3, 2), dtype=np.float32)
        return Polyline._assemble(pts[:-1], pts[1:], abc, pts)

    @staticmethod
    def concat(polys: Sequence["Polyline"]) -> "Polyline":
        """Fuse several chains into one segment soup."""
        seg_a = np.concatenate([p.seg_a.numpy()[p.seg_valid.numpy()]
                                for p in polys])
        seg_b = np.concatenate([p.seg_b.numpy()[p.seg_valid.numpy()]
                                for p in polys])
        abc = np.concatenate([p.vert_abc.numpy()[p.vert_valid.numpy()]
                              for p in polys])
        pts = np.concatenate([p.points.numpy() for p in polys])
        return Polyline._assemble(seg_a, seg_b, abc, pts)

    @staticmethod
    def _assemble(seg_a, seg_b, abc, pts) -> "Polyline":
        S = _pad_to(len(seg_a), _PAD)
        V = _pad_to(len(abc), _PAD)
        sa = np.full((S, 2), 1e30, np.float32)
        sb = np.full((S, 2), 1e30, np.float32)
        sv = np.zeros((S,), bool)
        sa[: len(seg_a)] = seg_a
        sb[: len(seg_b)] = seg_b
        sv[: len(seg_a)] = True
        va = np.full((V, 3, 2), 1e30, np.float32)
        vv = np.zeros((V,), bool)
        va[: len(abc)] = abc
        vv[: len(abc)] = True
        return Polyline(
            seg_a=torch.from_numpy(sa),
            seg_b=torch.from_numpy(sb),
            seg_valid=torch.from_numpy(sv),
            vert_abc=torch.from_numpy(va),
            vert_valid=torch.from_numpy(vv),
            points=torch.from_numpy(np.asarray(pts, np.float32).copy()),
        )

    @property
    def num_segments(self) -> int:
        return int(self.seg_valid.sum())

    @property
    def num_vertices(self) -> int:
        return int(self.vert_valid.sum())

    def valid_segments(self) -> np.ndarray:
        """``(S_valid, 4)`` float32 ``[ax, ay, bx, by]`` of the real segments."""
        v = self.seg_valid.numpy()
        return np.concatenate(
            [self.seg_a.numpy()[v], self.seg_b.numpy()[v]], axis=1)

    # ------------------------------------------------------------------ #
    # query facade (ops on (2,) points or (W, 2) batches), delegating to  #
    # .queries as the JAX package's facade does (polyline.py:119-184)     #
    # ------------------------------------------------------------------ #

    @staticmethod
    def _split(point):
        p = torch.as_tensor(np.asarray(point, np.float32))
        scalar = p.dim() == 1
        p = p.reshape(-1, 2)
        return p[:, 0], p[:, 1], scalar

    def distance(self, point):
        """Min distance to the polyline."""
        from . import queries

        px, py, scalar = self._split(point)
        d = queries.distance(self, px, py)
        return d[0] if scalar else d

    def is_silhouette(self, point):
        """Silhouette mask over the interior vertices (at least one column)."""
        from . import queries

        px, py, scalar = self._split(point)
        m = queries.is_silhouette(self, px, py)[:, : max(1, self.num_vertices)]
        return m[0] if scalar else m

    def silhouette_distance(self, point):
        """Distance to the closest silhouette vertex (``+inf`` for none)."""
        from . import queries

        px, py, scalar = self._split(point)
        d = queries.silhouette_distance(self, px, py)
        return d[0] if scalar else d

    def ray_intersection(self, point, direction):
        """Per-segment ray-hit parameters in units of ``|direction|``."""
        from . import queries

        px, py, scalar = self._split(point)
        dx, dy, _ = self._split(direction)
        n = torch.sqrt(dx * dx + dy * dy)
        t = queries.ray_intersection(self, px, py, dx / n, dy / n)
        t = t[:, : self.num_segments] / n[:, None]
        return t[0] if scalar else t

    def intersect(self, point, direction, r):
        """First ray hit within ``r``: ``(hit_point, inward_normal, hit)``."""
        from . import queries

        px, py, scalar = self._split(point)
        dx, dy, _ = self._split(direction)
        n = torch.sqrt(dx * dx + dy * dy)
        dx, dy = dx / n, dy / n
        rr = torch.full_like(px, float(np.float32(r)))
        hx, hy, nx, ny, _, hit = queries.first_hit(self, px, py, dx, dy, rr)
        hp = torch.stack([hx, hy], dim=-1)
        nv = torch.stack([nx, ny], dim=-1)
        if scalar:
            return hp[0], nv[0], bool(hit[0])
        return hp, nv, hit

    def bounds(self):
        """Domain bounds from the vertex chain."""
        pts = self.points.numpy()
        return (
            (float(pts[:, 0].min()), float(pts[:, 0].max())),
            (float(pts[:, 1].min()), float(pts[:, 1].max())),
        )


def square_loop(half_size: float, center=(0.0, 0.0)) -> Polyline:
    """Closed axis-aligned square (CCW), first vertex repeated at the end."""
    cx, cy = center
    h = half_size
    pts = np.array(
        [
            [cx - h, cy - h],
            [cx + h, cy - h],
            [cx + h, cy + h],
            [cx - h, cy + h],
            [cx - h, cy - h],
        ],
        dtype=np.float32,
    )
    return Polyline.from_points(pts)


def circle_loop(radius: float, center=(0.0, 0.0), n: int = 32) -> Polyline:
    """Closed polygonal circle."""
    theta = np.linspace(0.0, 2.0 * np.pi, n + 1)
    pts = np.stack(
        [center[0] + radius * np.cos(theta), center[1] + radius * np.sin(theta)],
        axis=1,
    ).astype(np.float32)
    return Polyline.from_points(pts)


def func_to_polyline(func, x_min: float, x_max: float,
                     resolution: float) -> Polyline:
    """1D heightmap -> open polyline over ``[x_min, x_max]``, the vertices
    a float32 ``linspace`` that includes ``x_max`` (a float ``arange``
    stops short and leaves a gap at a side wall)."""
    n = max(2, int(round((x_max - x_min) / resolution)) + 1)
    x = np.linspace(x_min, x_max, n, dtype=np.float32)
    y = np.asarray(func(x), dtype=np.float32)
    return Polyline.from_points(np.stack([x, y], axis=1))
