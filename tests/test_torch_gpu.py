"""The CUDA k-NN kernels against the plain PyTorch version, on the card.

Marked ``gpu``: each test skips when no CUDA device is found. This file
imports neither JAX nor the JAX package, so that it runs on a machine with
PyTorch alone:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

(``--noconftest`` because ``tests/conftest.py`` configures JAX.) Tolerance:
``idx`` and offsets bitwise, distances within 1 ulp.
"""

import math

import pytest
import torch

from marl_distributedformation_tpu_torch.ops import knn_cuda
from marl_distributedformation_tpu_torch.ops.knn import (
    FUSED_MAX_N,
    knn_batch,
    knn_batch_torch,
    resolve_impl,
)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _assert_same(got, want):
    gi, go, gd = got
    wi, wo, wd = want
    assert gi.dtype == torch.int32
    assert torch.equal(gi, wi)
    assert torch.equal(go, wo)
    ulp = (gd.view(torch.int32).long() - wd.view(torch.int32).long()).abs()
    assert int(ulp.max()) <= 1


def _points(m, n, device, seed=0, kind="random"):
    gen = torch.Generator(device=device).manual_seed(seed)
    if kind == "random":
        pts = torch.rand((m, n, 2), generator=gen, device=device)
        return (pts * torch.tensor([400.0, 600.0], device=device)).contiguous()
    side = math.isqrt(n - 1) + 1
    g = torch.arange(n, device=device)
    lattice = torch.stack([(g % side) * 7.0, (g // side) * 7.0], -1).float()
    if kind == "duplicates":
        lattice[n // 2:] = lattice[: n - n // 2].clone()
    return lattice.expand(m, n, 2).contiguous()


KERNELS = {"knn_fused": knn_cuda.knn_fused, "knn_tiled": knn_cuda.knn_tiled}


@pytest.mark.parametrize("name", sorted(KERNELS))
@pytest.mark.parametrize("kind", ["random", "lattice", "duplicates"])
@pytest.mark.parametrize("n,k", [(20, 4), (130, 1), (700, 8), (1030, 5)])
def test_kernel_matches_plain(cuda, name, kind, n, k):
    pts = _points(3, n, cuda, seed=n, kind=kind)
    _assert_same(KERNELS[name](pts, k), knn_batch_torch(pts, k))


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_kernel_with_short_masks(cuda, name):
    k, n = 4, 600
    pts = _points(8, n, cuda, seed=3)
    gen = torch.Generator(device=cuda).manual_seed(4)
    valid = torch.rand((8, n), generator=gen, device=cuda) < 0.3
    valid[0] = False
    valid[0, :2] = True  # two valid points: every row has self-loops
    got = KERNELS[name](pts, k, valid)
    _assert_same(got, knn_batch_torch(pts, k, valid))
    assert torch.equal(
        got[0][0, :, -1], torch.arange(n, device=cuda, dtype=torch.int32)
    )


def test_auto_dispatch_and_launch_counts(cuda):
    knn_cuda.reset_launches()
    small = _points(2, FUSED_MAX_N, cuda)
    big = _points(2, FUSED_MAX_N + 1, cuda)
    assert resolve_impl(small, "auto") == "cuda"
    assert resolve_impl(big, "auto") == "cuda_big"
    _assert_same(knn_batch(small, 4), knn_batch_torch(small, 4))
    _assert_same(knn_batch(big, 4), knn_batch_torch(big, 4))
    assert knn_cuda.LAUNCHES == {"knn_fused": 1, "knn_tiled": 1}
    knn_batch(small, 4, impl="torch")
    assert knn_cuda.LAUNCHES == {"knn_fused": 1, "knn_tiled": 1}


def test_kernels_refuse_bad_inputs(cuda):
    pts = _points(2, 20, cuda)
    with pytest.raises(ValueError, match="k <= 8"):
        knn_cuda.knn_fused(pts, 9)
    with pytest.raises(TypeError, match="float32"):
        knn_cuda.knn_tiled(pts.double(), 4)
    with pytest.raises(ValueError, match="contiguous"):
        knn_cuda.knn_fused(pts.transpose(0, 1), 4)
    with pytest.raises(TypeError, match="bool"):
        knn_cuda.knn_tiled(pts, 4, torch.ones(2, 20, device=cuda))
