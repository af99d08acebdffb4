"""Wrappers of the two k-NN kernels in ``csrc/knn.cu``.

``knn_fused`` replaces the JAX package's ``ops/knn_pallas.py::_knn_kernel``
(wrapper ``knn_batch_pallas``) and ``knn_tiled`` its ``_knn_kernel_chunked``
(wrapper ``knn_batch_pallas_big``). Both compute ``ops.knn.knn_batch_torch``
exactly; see ``csrc/knn.cu`` for the design and what bounds each kernel.

Each wrapper takes CUDA tensors only: it checks device, type, shape and
contiguity, allocates the outputs, launches on the current stream, raises
if the launch fails, and adds one to its entry of ``LAUNCHES``. There is no
fallback.
"""

from __future__ import annotations

import contextlib
import ctypes
import threading
from typing import Dict, Iterator, Optional, Tuple

import torch

from marl_distributedformation_tpu_torch.ops import _build
from marl_distributedformation_tpu_torch.ops.knn import KnnResult

SOURCE = "knn"
MAX_K = 8  # csrc/knn.cu instantiates K = 1..8
SMEM_MAX_BYTES = 227 * 1024  # shared memory Hopper gives one block
FUSED_GROUP = 16  # columns knn_fused tests a group (csrc/knn.cu)
FUSED_THREADS = 128  # query rows a knn_fused CTA owns, one a thread
POINT_BYTES = 8  # a staged point, float2
# From N = FUSED_THREADS on, a CTA's rows touch at most two formations, so
# knn_fused takes N up to where two strides fill a block's shared memory.
FUSED_SMEM_MAX_N = (
    SMEM_MAX_BYTES // (2 * POINT_BYTES) // FUSED_GROUP * FUSED_GROUP
)

# Launch counts, one plain integer per kernel; callers reset them to 0.
# Several threads launch at once in one process (a trainer, the gate and
# the serving replicas), so every addition takes the lock.
LAUNCHES: Dict[str, int] = {"knn_fused": 0, "knn_tiled": 0}
_COUNT_LOCK = threading.Lock()
# A capture launches nothing: what a thread's capture records goes to that
# thread's tally (``train/capture.py``), never to ``LAUNCHES``.
_CAPTURE = threading.local()
# The owners' counts a thread's launches also go to (``counted_for``).
_OWNERS = threading.local()


def _add(name: str, count: int) -> None:
    with _COUNT_LOCK:
        LAUNCHES[name] += count
        for tally in getattr(_OWNERS, "tallies", ()):
            tally[name] += count


@contextlib.contextmanager
def counted_for(tally: Dict[str, int]) -> Iterator[Dict[str, int]]:
    """Within the block, each launch the calling thread makes, eagerly or
    by a replay (``count_replay``), is also added to ``tally``: one
    owner's own count where several owners launch in one process (a
    trainer and the gate). Blocks nest; each tally gets its launches."""
    for name in LAUNCHES:
        tally.setdefault(name, 0)
    outer = getattr(_OWNERS, "tallies", ())
    _OWNERS.tallies = (*outer, tally)
    try:
        yield tally
    finally:
        _OWNERS.tallies = outer


def reset_launches() -> None:
    with _COUNT_LOCK:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def count_replay(launches: Dict[str, int]) -> None:
    """A replay of a captured CUDA graph launches each kernel the graph
    holds again: add the graph's ``launches`` (``train/capture.py``)."""
    for name, count in launches.items():
        _add(name, count)


def begin_capture_tally() -> None:
    """From here the calling thread's launches on a capturing stream are
    recorded into its tally (``end_capture_tally``)."""
    _CAPTURE.tally = dict.fromkeys(LAUNCHES, 0)


def end_capture_tally() -> Dict[str, int]:
    """The kernels the calling thread's capture recorded, by name."""
    tally, _CAPTURE.tally = getattr(_CAPTURE, "tally", None), None
    return tally or dict.fromkeys(LAUNCHES, 0)


_typed_lib: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    """The built library with its C signatures declared: every pointer and
    the stream as ``c_void_p``, so that ctypes does not cut them to 32
    bits."""
    global _typed_lib
    if _typed_lib is None:
        lib = _build.load(SOURCE)
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        # (points, valid, m, n, k[, threads, stride, span], idx, off, dist,
        # stream)
        lib.knn_fused_launch.argtypes = [ptr, ptr] + [i32] * 6 + [ptr] * 4
        lib.knn_tiled_launch.argtypes = [ptr, ptr] + [i32] * 3 + [ptr] * 4
        for fn in (lib.knn_fused_launch, lib.knn_tiled_launch):
            fn.restype = ctypes.c_int
        _typed_lib = lib
    return _typed_lib


def fused_geometry(m: int, n: int) -> Tuple[int, int, int, int]:
    """Launch geometry of ``knn_fused`` for ``M`` formations of ``N`` points:
    ``(threads, stride, span, smem_bytes)``. A CTA owns ``threads``
    consecutive rows of the flattened ``M*N`` rows, one a thread, and stages
    each formation they touch (at most ``span``) in shared memory,
    ``stride`` points a formation: N rounded up to whole groups."""
    stride = -(-n // FUSED_GROUP) * FUSED_GROUP
    span = min(m, (FUSED_THREADS + n - 2) // n + 1)
    return FUSED_THREADS, stride, span, span * stride * POINT_BYTES


def _check(
    name: str, points: torch.Tensor, k: int, valid: Optional[torch.Tensor]
) -> None:
    if not points.is_cuda:
        raise ValueError(f"{name} takes a CUDA tensor, got {points.device}")
    if points.dtype != torch.float32:
        raise TypeError(f"{name} takes float32 points, got {points.dtype}")
    if points.dim() != 3 or points.shape[2] != 2:
        raise ValueError(
            f"{name} takes points (M, N, 2), got {tuple(points.shape)}"
        )
    if not points.is_contiguous() or points.data_ptr() % 8:
        raise ValueError(f"{name} takes contiguous, 8-byte aligned points")
    m, n, _ = points.shape
    if not 1 <= k < n or k > MAX_K:
        raise ValueError(
            f"{name} needs 1 <= k < N and k <= {MAX_K} (k={k}, N={n})"
        )
    if n >= 2**31 // max(m, 1):
        raise ValueError(f"{name}: M*N={m * n} overflows the kernel's int")
    if valid is not None:
        if valid.device != points.device or valid.dtype != torch.bool:
            raise TypeError(f"{name} takes valid as bool on {points.device}")
        if tuple(valid.shape) != (m, n) or not valid.is_contiguous():
            raise ValueError(
                f"{name} takes a contiguous valid (M, N) = {(m, n)}, got "
                f"{tuple(valid.shape)}"
            )


def _launch(
    name: str, fn_name: str, points: torch.Tensor, k: int,
    valid: Optional[torch.Tensor], geometry: Tuple[int, ...] = (),
) -> KnnResult:
    m, n, _ = points.shape
    dev = points.device
    idx = torch.empty((m, n, k), dtype=torch.int32, device=dev)
    off = torch.empty((m, n, k, 2), dtype=torch.float32, device=dev)
    dist = torch.empty((m, n, k), dtype=torch.float32, device=dev)
    if m == 0:
        return idx, off, dist
    fn = getattr(_lib(), fn_name)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            points.data_ptr(),
            None if valid is None else valid.data_ptr(),
            m, n, k, *geometry,
            idx.data_ptr(), off.data_ptr(), dist.data_ptr(),
            stream,
        )
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError_t {err}")
    tally = getattr(_CAPTURE, "tally", None)
    if tally is not None and torch.cuda.is_current_stream_capturing():
        tally[name] += 1
    else:
        _add(name, 1)
    return idx, off, dist


def knn_fused(
    points: torch.Tensor, k: int, valid: Optional[torch.Tensor] = None
) -> KnnResult:
    """k-NN with a CTA per run of ``FUSED_THREADS`` query rows, each
    formation they touch held in shared memory (``fused_geometry``). For
    swarms of up to ``FUSED_SMEM_MAX_N`` points; ``knn_batch`` picks it for
    N <= 640."""
    _check("knn_fused", points, k, valid)
    m, n, _ = points.shape
    if n > FUSED_SMEM_MAX_N:
        raise ValueError(
            f"knn_fused holds formations in shared memory: N={n} > "
            f"{FUSED_SMEM_MAX_N}; use knn_tiled"
        )
    threads, stride, span, _ = fused_geometry(m, n)
    return _launch("knn_fused", "knn_fused_launch", points, k, valid,
                   (threads, stride, span))


def knn_tiled(
    points: torch.Tensor, k: int, valid: Optional[torch.Tensor] = None
) -> KnnResult:
    """k-NN with a CTA per (formation, 256 query rows), two rows a thread,
    the columns streamed through shared memory in double-buffered
    1024-column tiles. Any N."""
    _check("knn_tiled", points, k, valid)
    return _launch("knn_tiled", "knn_tiled_launch", points, k, valid)
