"""k-nearest-neighbor search: the plain PyTorch version (``knn.py``) and the
CUDA kernels that replace the JAX package's Pallas kernels (``knn_cuda.py``,
``csrc/knn.cu``). Importing this package builds nothing."""

from marl_distributedformation_tpu_torch.ops.knn import (  # noqa: F401
    knn_batch,
    knn_batch_torch,
)
