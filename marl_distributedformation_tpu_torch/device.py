"""Device choice, float32 matmul precision and random draws, in one place.

Every entry point of the port resolves its device here. The default is the
GPU; the CPU is used only when the caller asks for it by name. A missing GPU
raises rather than falling back, so a run never reports CPU numbers as if
they came from the card.

A run draws from one ``torch.Generator``; a population of K runs from K,
one a member (``draw``).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple, Union

import torch

DeviceLike = Union[str, torch.device, None]
# One run's generator, or a population's, member i's at index i.
Streams = Union[None, torch.Generator, Sequence[torch.Generator]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The ``torch.device`` an entry point runs on.

    ``None`` means ``"cuda"``. A CUDA device raises ``RuntimeError`` when
    ``torch.cuda.is_available()`` is false. Also turns TF32 off for matmuls
    and cuDNN: the port's float32 results are compared with the JAX
    reference, and TF32 keeps only about three decimal digits. And turns
    off cuBLAS's reduced-precision reductions in bf16 GEMMs (the serving
    engine's bf16 rungs), so their products accumulate in float32, as the
    bf16 action budget assumes (``tests/bf16_budget.py``, fact 2).
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "CPU explicitly"
        )
    return dev


def draw(
    fn: Callable[..., torch.Tensor],
    streams: Streams,
    shape: Tuple[int, ...],
    device: torch.device,
    dtype: Optional[torch.dtype] = torch.float32,
) -> torch.Tensor:
    """``fn(shape, generator=...)`` (``torch.rand`` or ``torch.randn``) from
    one generator; from a population's K generators, member i's
    ``shape[0] // K`` leading rows from ``streams[i]``, each drawn as the
    member's own run draws them (the same call at the member's shape)."""
    if streams is None or isinstance(streams, torch.Generator):
        return fn(shape, generator=streams, device=device, dtype=dtype)
    k = len(streams)
    if shape[0] % k:
        raise ValueError(f"{shape[0]} rows do not split into {k} members")
    rows = (shape[0] // k, *shape[1:])
    return torch.cat([
        fn(rows, generator=g, device=device, dtype=dtype) for g in streams
    ])
