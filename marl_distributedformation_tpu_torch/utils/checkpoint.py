"""``rl_model_{steps}_steps.msgpack`` checkpoints: writing and reading.

Counterpart of the JAX package's ``utils/checkpoint.py``, with ``msgpack``
alone in flax's format: ext code 1 is an ndarray packed as ``(shape, dtype
name, bytes)``, code 3 a numpy scalar. Every file carries a 20-byte footer,
``crc32(payload)``, the payload length and ``MARLCKPT``, checked on every
read (footer-less legacy files pass whole). A write goes to a dot-prefixed
temp file and is renamed into place, so a torn write is never discovered,
and a tree holding a non-finite float is refused. Discovery picks the
largest step number; resume walks back past corrupt files, moving each aside
as ``{name}.quarantined``.
"""

from __future__ import annotations

import re
import struct
import sys
import zlib
from pathlib import Path
from typing import Any, Iterable, Mapping, Optional, Tuple

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


class NonFiniteCheckpointError(ValueError):
    """A checkpoint tree with a NaN or Inf float leaf; never written."""


def checkpoint_path(log_dir: str | Path, num_timesteps: int) -> Path:
    return Path(log_dir) / f"rl_model_{num_timesteps}_steps.msgpack"


def with_footer(payload: bytes) -> bytes:
    return payload + _FOOTER.pack(
        zlib.crc32(payload) & 0xFFFFFFFF, len(payload), _CKPT_MAGIC
    )


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


def _ndarray_bytes(arr: np.ndarray) -> bytes:
    return msgpack.packb(
        (arr.shape, arr.dtype.name, arr.tobytes("C")), use_bin_type=True
    )


def _ext_default(obj: Any) -> Any:
    if isinstance(obj, np.ndarray):
        return msgpack.ExtType(_EXT_NDARRAY, _ndarray_bytes(obj))
    if isinstance(obj, np.generic):
        return msgpack.ExtType(_EXT_NPSCALAR, _ndarray_bytes(np.asarray(obj)))
    raise TypeError(f"cannot serialize {type(obj).__name__} into a checkpoint")


def _sorted_keys(tree: Any) -> Any:
    if isinstance(tree, Mapping):
        return {k: _sorted_keys(tree[k]) for k in sorted(tree)}
    return tree


def msgpack_serialize(tree: Any) -> bytes:
    """flax's ``msgpack_serialize`` of a tree of dicts, numpy arrays and
    scalars, Python numbers and strings: the same bytes, dict keys
    sorted as flax's tree walk sorts them."""
    return msgpack.packb(
        _sorted_keys(tree), default=_ext_default, strict_types=True,
        use_bin_type=True,
    )


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


def nonfinite_leaf(tree: Any, prefix: str = "") -> Optional[str]:
    """Path of the first float leaf holding NaN or Inf, or None."""
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            found = nonfinite_leaf(v, f"{prefix}/{k}")
            if found is not None:
                return found
        return None
    if isinstance(tree, (str, bytes)) or tree is None:
        return None
    arr = np.asarray(tree)
    if np.issubdtype(arr.dtype, np.floating) and not np.isfinite(arr).all():
        return prefix or "/"
    return None


def write_atomic(path: Path, tree: Any) -> None:
    """Serialize ``tree`` with its footer into ``path`` through a
    dot-prefixed temp file and an atomic rename. Raises
    ``NonFiniteCheckpointError`` for a tree with a non-finite float."""
    bad = nonfinite_leaf(tree)
    if bad is not None:
        raise NonFiniteCheckpointError(
            f"checkpoint {path.name}: leaf {bad} holds non-finite values; "
            "refusing to publish a diverged state"
        )
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.parent / f".{path.name}.tmp"
    tmp.write_bytes(with_footer(msgpack_serialize(tree)))
    tmp.replace(path)


def save_checkpoint(
    log_dir: str | Path, num_timesteps: int, tree: Any
) -> Optional[Path]:
    """Write ``rl_model_{num_timesteps}_steps.msgpack``; returns its path,
    or None (with a notice on stderr) when the non-finite gate refused the
    tree."""
    path = checkpoint_path(log_dir, num_timesteps)
    try:
        write_atomic(path, tree)
    except NonFiniteCheckpointError as e:
        print(f"[checkpoint] skipped: {e}", file=sys.stderr)
        return None
    return path


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


def restore_latest_partial(
    log_dir: str | Path, keys: Iterable[str]
) -> Optional[Tuple[Path, dict]]:
    """Resume from the newest valid checkpoint in ``log_dir``: ``(path,
    {key: value})`` for each of ``keys`` the file holds (extra keys are
    ignored), or None when there is none. A corrupt file is renamed to
    ``{name}.quarantined`` and the walk steps down to the next; if the
    rename fails, the error is raised."""
    keys = list(keys)
    while True:
        path = latest_checkpoint(log_dir)
        if path is None:
            return None
        try:
            raw = msgpack_restore_file(path)
        except CorruptCheckpointError as e:
            print(f"[checkpoint] quarantined {path.name}: {e}", file=sys.stderr)
            try:
                path.replace(path.with_name(path.name + ".quarantined"))
            except OSError:
                raise e
            continue
        if not isinstance(raw, dict):
            raise ValueError(f"checkpoint {path} is not a dict")
        return path, {k: raw[k] for k in keys if k in raw}
