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
