"""k-nearest-neighbor search: the plain PyTorch versions (``knn.py``: the
batched ``knn_batch_torch``, the single-formation ``knn`` and
``knn_local``) and the CUDA kernels that replace the JAX package's Pallas
kernels (``knn_cuda.py``, ``csrc/knn.cu``). Importing this package builds
nothing."""

from marl_distributedformation_tpu_torch.ops.knn import (  # noqa: F401
    knn,
    knn_batch,
    knn_batch_torch,
    knn_local,
    pairwise_sq_dists,
)
