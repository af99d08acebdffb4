"""Reading ``rl_model_{steps}_steps.msgpack`` checkpoints.

Counterpart of the read half of the JAX package's ``utils/checkpoint.py``:
flax's msgpack format decoded with ``msgpack`` alone (ext code 1 is an
ndarray packed as ``(shape, dtype name, bytes)``, code 3 a numpy scalar), the
crc32/length/``MARLCKPT`` footer validated and stripped when present, and
discovery by the largest step number. Writing checkpoints comes with the
training slice.
"""

from __future__ import annotations

import re
import struct
import zlib
from pathlib import Path
from typing import Any, Optional

import msgpack
import numpy as np

_STEP_RE = re.compile(r"rl_model_(\d+)_steps")
_CKPT_MAGIC = b"MARLCKPT"
_FOOTER = struct.Struct("<Iq8s")  # crc32, payload length, magic
_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3


class CorruptCheckpointError(ValueError):
    """Checkpoint bytes that fail validation: checksum mismatch, a footer
    whose length disagrees, or undecodable msgpack."""


def strip_footer(data: bytes, origin: str) -> bytes:
    """The payload of ``data`` with its footer validated and removed;
    footer-less (legacy) bytes pass through whole."""
    if len(data) < _FOOTER.size or data[-8:] != _CKPT_MAGIC:
        return data
    crc, length, _ = _FOOTER.unpack(data[-_FOOTER.size:])
    payload = data[: -_FOOTER.size]
    if length != len(payload):
        raise CorruptCheckpointError(
            f"checkpoint {origin}: footer says {length} payload bytes but "
            f"{len(payload)} are present (truncated write?)"
        )
    if zlib.crc32(payload) & 0xFFFFFFFF != crc:
        raise CorruptCheckpointError(
            f"checkpoint {origin}: payload checksum mismatch"
        )
    return payload


def _ndarray(data: bytes) -> np.ndarray:
    shape, dtype_name, buffer = msgpack.unpackb(data, raw=True)
    return np.frombuffer(buffer, dtype=np.dtype(dtype_name)).reshape(shape)


def _ext_hook(code: int, data: bytes) -> Any:
    if code == _EXT_NDARRAY:
        return _ndarray(data)
    if code == _EXT_NPSCALAR:
        return _ndarray(data)[()]
    raise CorruptCheckpointError(f"unknown msgpack ext code {code}")


def msgpack_restore_file(path: str | Path) -> Any:
    """The checkpoint at ``path`` as nested dicts of numpy arrays (read-only
    views of the file's bytes) and Python scalars."""
    path = Path(path)
    payload = strip_footer(path.read_bytes(), origin=str(path))
    try:
        tree = msgpack.unpackb(payload, ext_hook=_ext_hook, raw=False)
    except (ValueError, msgpack.UnpackException) as e:
        raise CorruptCheckpointError(
            f"checkpoint {path}: undecodable msgpack payload: {e!r}"
        ) from e
    return tree


def latest_checkpoint(log_dir: str | Path) -> Optional[Path]:
    """The ``rl_model_*_steps.msgpack`` in ``log_dir`` with the largest step
    number (reference visualize_policy.py:29-32), or None."""
    log_dir = Path(log_dir)
    if not log_dir.is_dir():
        return None
    candidates = [
        p for p in log_dir.iterdir()
        if p.suffix == ".msgpack" and _STEP_RE.search(p.name)
    ]
    if not candidates:
        return None
    return max(candidates, key=checkpoint_step)


def checkpoint_step(path: str | Path) -> int:
    m = _STEP_RE.search(Path(path).name)
    if not m:
        raise ValueError(f"not a checkpoint path: {path}")
    return int(m.group(1))
