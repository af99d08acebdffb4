"""k-nearest-neighbor search over agent positions: the plain version and the
dispatch to the CUDA kernels.

Counterpart of the JAX package's ``ops/knn.py``. The contract, shared by the
plain version here and both kernels in ``csrc/knn.cu``:

- ``idx (M, N, k)`` int32, ``offsets (M, N, k, 2)`` and ``dists (M, N, k)``
  float32, sorted by ascending distance;
- the squared distance is the direct form ``(x_i-x_j)^2 + (y_i-y_j)^2``,
  never the ``|a|^2+|b|^2-2ab`` expansion that ``torch.cdist`` uses (the JAX
  package measured 33.5% wrong indices with it);
- self and invalid columns get the finite distance ``_SELF_MASK`` and are
  never chosen while a real neighbor is left; a row with fewer than k real
  neighbors fills the rest with self-loops (``idx = i``, offset 0, dist 0);
- ties go to the lower index, as ``lax.top_k`` does. ``torch.topk``
  promises no tie order, so the plain version sorts with ``stable=True``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

# Finite self-distance mask, as in the JAX package (ops/knn.py:40).
_SELF_MASK = 1e12

# The fused kernel holds one formation in shared memory; the JAX package's
# boundary (knn_pallas.py:53, N padded to 128 lanes must fit its VMEM
# budget) is kept so that both kernels stay on the main paths.
FUSED_MAX_N = 640

KnnResult = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def knn_batch_torch(
    points: torch.Tensor, k: int, valid: Optional[torch.Tensor] = None
) -> KnnResult:
    """Batched k-NN in plain PyTorch on ``points (M, N, 2)``.

    ``valid (M, N)`` bool marks live points; invalid points are never
    chosen as neighbors (they still get neighbors of their own). Materialises
    the ``(M, N, N)`` distance matrix; the kernels do not.
    """
    m, n, d = points.shape
    if d != 2:
        raise ValueError(f"points must be (M, N, 2), got {tuple(points.shape)}")
    if not 1 <= k < n:
        raise ValueError(f"knn needs 1 <= k < N (k={k}, N={n})")
    x = points[..., 0]
    y = points[..., 1]
    dx = x[:, :, None] - x[:, None, :]
    dy = y[:, :, None] - y[:, None, :]
    d2 = dx * dx + dy * dy  # (M, N, N), separate multiply and add
    rows = torch.arange(n, device=points.device)
    blocked = (rows[:, None] == rows[None, :]).expand(m, n, n)
    if valid is not None:
        blocked = blocked | ~valid[:, None, :]
    d2 = d2.masked_fill(blocked, _SELF_MASK)
    best, idx = torch.sort(d2, dim=-1, stable=True)
    best, idx = best[..., :k], idx[..., :k]
    real = best < 0.5 * _SELF_MASK
    idx = torch.where(real, idx, rows[None, :, None])
    nbr = torch.gather(
        points, 1, idx.reshape(m, n * k, 1).expand(m, n * k, 2)
    ).reshape(m, n, k, 2)
    offsets = nbr - points[:, :, None, :]
    dists = torch.where(real, torch.sqrt(best), torch.zeros_like(best))
    return idx.to(torch.int32), offsets, dists


def pairwise_sq_dists(points: torch.Tensor) -> torch.Tensor:
    """Squared distances ``(N, N)`` of ``points (N, d)`` in the direct form,
    the diagonal masked to ``_SELF_MASK`` (the JAX package's
    ``ops/knn.py:43``)."""
    diff = points[:, None, :] - points[None, :, :]
    d2 = (diff * diff).sum(-1)
    return d2 + _SELF_MASK * torch.eye(
        points.shape[0], dtype=points.dtype, device=points.device
    )


def knn(
    points: torch.Tensor, k: int, valid: Optional[torch.Tensor] = None
) -> KnnResult:
    """The k nearest neighbors of each point of one formation, ``points
    (N, d)``, self excluded: ``idx (N, k)`` int32, ``offsets (N, k, d)``,
    ``dists (N, k)``, by ascending distance (the JAX package's
    ``ops/knn.py:53``).

    ``valid (N,)`` marks live points; an invalid point is never chosen,
    and a row with fewer than k valid neighbors fills the rest with
    self-loops (``idx = i``, offset 0, dist 0): the formation's row of
    ``knn_batch_torch``. Unmasked, the search is ``knn_local`` with every
    point a query, so the rows equal the agent-sharded search's bitwise.
    """
    n = points.shape[0]
    if not 1 <= k < n:
        raise ValueError(f"knn needs 1 <= k < N (k={k}, N={n})")
    if valid is None:
        return knn_local(points, points, k, 0)
    idx, offsets, dists = knn_batch_torch(points[None], k, valid[None])
    return idx[0], offsets[0], dists[0]


def knn_local(
    queries: torch.Tensor,
    points: torch.Tensor,
    k: int,
    query_offset: int,
) -> KnnResult:
    """The k nearest neighbors of a block of query agents against the whole
    formation (the JAX package's ``ops/knn.py:95``, the agent-sharded
    search): ``queries (..., nq, d)`` are global rows ``query_offset ..
    query_offset + nq`` of ``points (..., N, d)``; leading axes are
    formations. Returns ``idx (..., nq, k)`` int32 global indices,
    ``offsets`` and ``dists``, by ascending distance; self is masked by
    its global row, in the same direct form and column order as ``knn``,
    so each row equals the whole search's row bitwise."""
    nq, n, d = queries.shape[-2], points.shape[-2], points.shape[-1]
    if not 1 <= k < n:
        raise ValueError(f"knn_local needs 1 <= k < N (k={k}, N={n})")
    diff = queries[..., :, None, :] - points[..., None, :, :]
    d2 = (diff * diff).sum(-1)  # (..., nq, N)
    gids = query_offset + torch.arange(nq, device=points.device)
    cols = torch.arange(n, device=points.device)
    d2 = d2.masked_fill(cols[None, :] == gids[:, None], _SELF_MASK)
    best, idx = torch.sort(d2, dim=-1, stable=True)
    best, idx = best[..., :k], idx[..., :k]
    lead = points.shape[:-2]
    flat = points.reshape(-1, n, d)
    nbr = torch.gather(
        flat, 1, idx.reshape(flat.shape[0], nq * k, 1).expand(-1, -1, d)
    ).reshape(*lead, nq, k, d)
    offsets = nbr - queries[..., :, None, :]
    dists = torch.sqrt(torch.clamp_min(best, 0.0))
    return idx.to(torch.int32), offsets, dists


def resolve_impl(points: torch.Tensor, impl: str) -> str:
    """What ``impl="auto"`` runs for ``points``: the plain version on a CPU
    tensor; on a CUDA tensor the fused kernel for N <= 640 and the tiled
    kernel above."""
    if impl != "auto":
        return impl
    if not points.is_cuda:
        return "torch"
    return "cuda" if points.shape[1] <= FUSED_MAX_N else "cuda_big"


def knn_batch(
    points: torch.Tensor,
    k: int,
    valid: Optional[torch.Tensor] = None,
    impl: str = "auto",
) -> KnnResult:
    """Batched k-NN over ``points (M, N, 2)`` with implementation dispatch.

    ``impl``: ``"auto"`` (see ``resolve_impl``), ``"torch"`` (the plain
    version, any device), ``"cuda"`` (fused kernel) or ``"cuda_big"``
    (tiled kernel). The kernels take CUDA tensors only and raise on
    anything else; nothing falls back to the plain version.
    """
    impl = resolve_impl(points, impl)
    if impl == "torch":
        return knn_batch_torch(points, k, valid)
    from marl_distributedformation_tpu_torch.ops import knn_cuda

    if impl == "cuda":
        return knn_cuda.knn_fused(points, k, valid)
    if impl == "cuda_big":
        return knn_cuda.knn_tiled(points, k, valid)
    raise ValueError(f"unknown knn impl {impl!r}")
