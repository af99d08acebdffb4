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
from marl_distributedformation_tpu_torch.ops import knn_cuda
from marl_distributedformation_tpu_torch.ops.knn import (
    _SELF_MASK,
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


def _kernel_scan_model(pts, k, valid):
    """The scan both CUDA kernels run (``csrc/knn.cu::scan_group``), in
    numpy float32: columns staged with invalid ones and the padding up to
    whole groups as NaN, scanned in ascending order a group at a time; a
    group is tested against the K-th distance as it stood before it, and
    its hits are inserted in column order with a strict-less insertion
    that re-tests each one; the self column is dropped at insertion."""
    m, n, _ = pts.shape
    stride = -(-n // knn_cuda.FUSED_GROUP) * knn_cuda.FUSED_GROUP
    idx = np.empty((m, n, k), np.int32)
    off = np.empty((m, n, k, 2), np.float32)
    dist = np.empty((m, n, k), np.float32)
    for f in range(m):
        cols = np.full((stride, 2), np.nan, np.float32)
        ok = np.ones(n, bool) if valid is None else valid[f]
        cols[:n][ok] = pts[f][ok]
        for i in range(n):
            me = pts[f, i]
            dx, dy = me[0] - cols[:, 0], me[1] - cols[:, 1]
            d2 = dx * dx + dy * dy
            bd = [np.float32(np.inf)] * k
            bi = [np.iinfo(np.int32).max] * k
            for j0 in range(0, stride, knn_cuda.FUSED_GROUP):
                thr = bd[-1]
                hits = [j0 + g for g in range(knn_cuda.FUSED_GROUP)
                        if d2[j0 + g] < thr]
                for j in hits:
                    if j == i or not d2[j] < bd[-1]:
                        continue
                    p = k - 1
                    while p > 0 and d2[j] < bd[p - 1]:
                        bd[p], bi[p] = bd[p - 1], bi[p - 1]
                        p -= 1
                    bd[p], bi[p] = d2[j], j
            for p in range(k):
                real = bd[p] < 0.5 * _SELF_MASK
                j = bi[p] if real else i
                idx[f, i, p] = j
                off[f, i, p] = (pts[f, j] - me) if real else 0.0
                dist[f, i, p] = np.sqrt(bd[p]) if real else 0.0
    return idx, off, dist


@pytest.mark.parametrize(
    "case", ["lattice", "duplicates", "edge+mask", "random20+mask"]
)
def test_kernel_scan_order_matches_plain(case):
    """The kernels compare a candidate with the K-th entry by distance
    alone: exact because columns arrive in ascending order, so equal
    distances keep the lower column ahead. Held against the plain stable
    sort on exact ties and on rows with fewer than k valid points."""
    pts, k, valid = _case(case)
    with np.errstate(invalid="ignore"):
        got = _kernel_scan_model(pts, k, valid)
    tvalid = None if valid is None else torch.from_numpy(valid)
    _assert_same(got, knn_batch_torch(torch.from_numpy(pts), k, tvalid))


def test_fused_geometry_fits_shared_memory():
    """Every N that knn_fused takes fits one block's shared memory, and the
    span covers the formations any CTA's rows touch."""
    big_m = 1 << 20
    for n in range(2, knn_cuda.FUSED_SMEM_MAX_N + 1):
        threads, stride, span, smem = knn_cuda.fused_geometry(big_m, n)
        assert smem <= knn_cuda.SMEM_MAX_BYTES, n
        assert stride >= n and stride % knn_cuda.FUSED_GROUP == 0
    n = knn_cuda.FUSED_SMEM_MAX_N + 1
    assert knn_cuda.fused_geometry(big_m, n)[3] > knn_cuda.SMEM_MAX_BYTES
    for m, n in [(1, 2), (1, 500), (3, 7), (5, 100), (7, 127), (9, 128),
                 (4, 129), (2, 640), (3, 1000)]:
        threads, _, span, _ = knn_cuda.fused_geometry(m, n)
        rows = m * n
        for r0 in range(0, rows, threads):
            touched = (min(r0 + threads, rows) - 1) // n - r0 // n + 1
            assert touched <= span, (m, n, r0)

