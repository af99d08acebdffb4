"""Plain k-nearest-neighbor search over one batch of formations.

A frozen copy of the contract the program's search keeps: squared
distances in the direct form ``(x_i-x_j)^2 + (y_i-y_j)^2``, self excluded,
ascending distance with ties to the lower index (a stable sort), and
``(idx, offsets, dists)`` per neighbor.
"""

from __future__ import annotations

from typing import Tuple

import torch

Tensor = torch.Tensor
SELF_DIST = 1e12


def knn(points: Tensor, k: int) -> Tuple[Tensor, Tensor, Tensor]:
    """``points (M, N, 2)`` -> ``idx (M, N, k)`` int64, ``offsets (M, N,
    k, 2)`` (neighbor minus self) and ``dists (M, N, k)``."""
    m, n, _ = points.shape
    dx = points[..., 0][:, :, None] - points[..., 0][:, None, :]
    dy = points[..., 1][:, :, None] - points[..., 1][:, None, :]
    d2 = dx * dx + dy * dy
    eye = torch.eye(n, dtype=torch.bool, device=points.device)
    d2 = d2.masked_fill(eye, SELF_DIST)
    best, idx = torch.sort(d2, dim=-1, stable=True)
    best, idx = best[..., :k], idx[..., :k]
    nbr = torch.gather(points, 1, idx.reshape(m, n * k, 1).expand(-1, -1, 2))
    offsets = nbr.reshape(m, n, k, 2) - points[:, :, None, :]
    return idx, offsets, torch.sqrt(best)
