"""The port's plain k-NN (``knn_batch_torch``) against the JAX package's
three implementations on the CPU: ``xla`` and its two Pallas kernels in
interpret mode.

Tolerance: ``idx`` and offsets bitwise; distances within 1 ulp (JAX's own
``xla`` and interpret paths differ from each other by 1 ulp here: the square
roots are not all rounded the same way).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marl_distributedformation_tpu.ops import knn_batch as jax_knn_batch
from marl_distributedformation_tpu_torch.ops.knn import (
    knn_batch,
    knn_batch_torch,
    resolve_impl,
)

JAX_IMPLS = ("xla", "pallas_interpret", "pallas_big_interpret")


def _lattice(m, side, spacing=10.0):
    g = np.arange(side * side)
    pts = np.stack([(g % side) * spacing, (g // side) * spacing], -1)
    return np.broadcast_to(pts, (m, side * side, 2)).astype(np.float32)


def _case(name):
    """``(points (M, N, 2) f32, k, valid (M, N) bool or None)``."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if name.startswith("random20"):
        pts = rng.uniform(0, 400, (4, 20, 2)).astype(np.float32)
        k = 4
    elif name.startswith("random130"):  # N not a multiple of 128
        pts = (rng.uniform(0, 1, (3, 130, 2)) * [400, 600]).astype(np.float32)
        k = 4
    elif name == "lattice":  # exact ties everywhere
        pts = _lattice(2, 5)
        k = 4
    elif name == "duplicates":  # coincident agents: zero distances
        base = rng.uniform(0, 400, (2, 10, 2)).astype(np.float32)
        pts = np.concatenate([base, base[:, ::-1]], axis=1)
        k = 3
    elif name.startswith("edge"):  # agents clipped onto the world's edges
        raw = rng.uniform(-50, 450, (3, 30, 2))
        pts = np.clip(np.round(raw), 0, 400).astype(np.float32)
        k = 4
    else:
        raise KeyError(name)
    valid = None
    if name.endswith("+mask"):
        valid = rng.uniform(size=pts.shape[:2]) < 0.6
        valid[0] = False
        valid[0, : k - 1] = True  # fewer than k valid points
    return np.ascontiguousarray(pts), k, valid


CASES = (
    "random20", "random20+mask", "random130", "random130+mask",
    "lattice", "duplicates", "edge+mask",
)


def _assert_same(port, ref):
    pi, po, pd = (np.asarray(a) for a in port)
    ri, ro, rd = (np.asarray(a) for a in ref)
    assert pi.dtype == np.int32 and ri.dtype == np.int32
    np.testing.assert_array_equal(pi, ri)
    np.testing.assert_array_equal(po, ro)
    np.testing.assert_array_max_ulp(pd, rd, maxulp=1)


@pytest.mark.parametrize("impl", JAX_IMPLS)
@pytest.mark.parametrize("case", CASES)
def test_plain_knn_matches_jax(case, impl):
    pts, k, valid = _case(case)
    jvalid = None if valid is None else jnp.asarray(valid)
    ref = jax_knn_batch(jnp.asarray(pts), k, jvalid, impl=impl)
    tvalid = None if valid is None else torch.from_numpy(valid)
    port = knn_batch_torch(torch.from_numpy(pts), k, tvalid)
    _assert_same(port, ref)


def test_short_rows_are_self_loops():
    pts, k, valid = _case("random20+mask")
    idx, off, dist = knn_batch_torch(
        torch.from_numpy(pts), k, torch.from_numpy(valid)
    )
    # Formation 0 has k-1 valid points: the last slot of every row is a
    # self-loop with zero offset and distance.
    rows = torch.arange(pts.shape[1], dtype=torch.int32)
    assert torch.equal(idx[0, :, -1], rows)
    assert not off[0, :, -1].any() and not dist[0, :, -1].any()
    chosen = idx[0][idx[0] != rows[:, None]]
    assert bool(torch.from_numpy(valid[0])[chosen.long()].all())


def test_auto_on_cpu_runs_the_plain_version():
    pts, k, valid = _case("random130+mask")
    t = torch.from_numpy(pts)
    assert resolve_impl(t, "auto") == "torch"
    want = knn_batch_torch(t, k, torch.from_numpy(valid))
    for impl in ("auto", "torch"):
        got = knn_batch(t, k, torch.from_numpy(valid), impl=impl)
        for a, b in zip(got, want):
            assert torch.equal(a, b)


@pytest.mark.parametrize("impl", ["cuda", "cuda_big"])
def test_kernels_refuse_cpu_tensors(impl):
    pts, k, _ = _case("random20")
    with pytest.raises(ValueError, match="CUDA tensor"):
        knn_batch(torch.from_numpy(pts), k, impl=impl)


def test_unknown_impl_and_bad_k_raise():
    t = torch.from_numpy(_case("random20")[0])
    with pytest.raises(ValueError, match="unknown knn impl"):
        knn_batch(t, 4, impl="xla")
    with pytest.raises(ValueError, match="k < N"):
        knn_batch_torch(t, 20)
