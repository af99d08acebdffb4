"""Device choice and float32 matmul precision, in one place.

Every entry point of the port resolves its device here. The default is the
GPU; the CPU is used only when the caller asks for it by name. A missing GPU
raises rather than falling back, so a run never reports CPU numbers as if
they came from the card.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The ``torch.device`` an entry point runs on.

    ``None`` means ``"cuda"``. A CUDA device raises ``RuntimeError`` when
    ``torch.cuda.is_available()`` is false. Also turns TF32 off for matmuls
    and cuDNN: the port's float32 results are compared with the JAX
    reference, and TF32 keeps only about three decimal digits.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "CPU explicitly"
        )
    return dev
