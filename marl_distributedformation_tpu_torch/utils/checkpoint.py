"""``rl_model_{steps}_steps.msgpack`` checkpoints, and a population's
``sweep_state_{steps}_steps.msgpack`` anchors: writing and reading.

Counterpart of the JAX package's ``utils/checkpoint.py``, with ``msgpack``
alone in flax's format: ext code 1 is an ndarray packed as ``(shape, dtype
name, bytes)``, code 3 a numpy scalar. Every file carries a 20-byte footer,
``crc32(payload)``, the payload length and ``MARLCKPT``, checked on every
read (footer-less legacy files pass whole). A write goes to a dot-prefixed
temp file and is renamed into place, so a torn write is never discovered,
and a tree holding a non-finite float is refused. Discovery picks the
largest step number; resume walks back past corrupt files, moving each aside
as ``{name}.quarantined`` with a line in ``quarantine.jsonl``.

Writes can leave the training loop: ``device_snapshot`` copies the state on
the device behind the work that produced it, and ``AsyncCheckpointWriter``
brings the copy to the host and writes it on a background thread, one write
at a time, in order. ``prune_checkpoints`` keeps the newest N files.
``CheckpointDiscovery`` is the incremental discovery a long-running watcher
polls (the fleet's reload coordinator).

The chaos plane's checkpoint seams (``chaos/plane.py``) sit in the atomic
write (``checkpoint.write``, ``checkpoint.pre_rename``,
``checkpoint.post_rename``) and at the writer's submit
(``ckpt_writer.submit``).

The writer, the non-finite gate, quarantine and pruning record into the
metrics registry under the JAX package's names (``checkpoint_writes_total``,
``checkpoint_write_seconds``, ``checkpoint_queue_depth``,
``checkpoint_writes_skipped_total``, ``checkpoint_nonfinite_skipped_total``,
``checkpoint_quarantined_total``, ``checkpoint_pruned_total``).
"""

from __future__ import annotations

import dataclasses
import json
import os
import random
import re
import struct
import sys
import threading
import time
import zlib
from pathlib import Path
from typing import (
    Any,
    Callable,
    Dict,
    Iterable,
    List,
    Mapping,
    Optional,
    Tuple,
)

import msgpack
import numpy as np
import torch

from marl_distributedformation_tpu_torch.chaos.plane import (
    SimulatedCrash,
    fault_point,
)
from marl_distributedformation_tpu_torch.obs.metrics import get_registry

_STEP_RE = re.compile(r"rl_model_(\d+)_steps")
# A population's resume anchor lives beside its seed{i}/ member directories;
# its own prefix keeps it out of the rl_model_* discovery.
_SWEEP_STEP_RE = re.compile(r"sweep_state_(\d+)_steps")
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


def sweep_state_path(log_dir: str | Path, num_timesteps: int) -> Path:
    return Path(log_dir) / f"sweep_state_{num_timesteps}_steps.msgpack"


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
    payload = with_footer(msgpack_serialize(tree))
    fault_point("checkpoint.write", path=tmp)
    tmp.write_bytes(payload)
    fault_point("checkpoint.pre_rename", path=tmp)
    tmp.replace(path)
    fault_point("checkpoint.post_rename", path=path)


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
        get_registry().counter("checkpoint_nonfinite_skipped_total").inc()
        print(f"[checkpoint] skipped: {e}", file=sys.stderr)
        return None
    return path


def save_sweep_state(
    log_dir: str | Path, num_timesteps: int, tree: Any
) -> Optional[Path]:
    """Write a population's resume anchor,
    ``sweep_state_{num_timesteps}_steps.msgpack``; returns its path, or
    None (with a notice on stderr) when the non-finite gate refused it."""
    path = sweep_state_path(log_dir, num_timesteps)
    try:
        write_atomic(path, tree)
    except NonFiniteCheckpointError as e:
        get_registry().counter("checkpoint_nonfinite_skipped_total").inc()
        print(f"[checkpoint] skipped: {e}", file=sys.stderr)
        return None
    return path


def _latest(log_dir: str | Path, step_re: re.Pattern) -> Optional[Path]:
    log_dir = Path(log_dir)
    if not log_dir.is_dir():
        return None
    steps = {}
    for p in log_dir.iterdir():
        m = step_re.search(p.name)
        if p.suffix == ".msgpack" and m:
            steps[p] = int(m.group(1))
    if not steps:
        return None
    return max(steps, key=steps.get)


def latest_checkpoint(log_dir: str | Path) -> Optional[Path]:
    """The ``rl_model_*_steps.msgpack`` in ``log_dir`` with the largest step
    number (reference visualize_policy.py:29-32), or None."""
    return _latest(log_dir, _STEP_RE)


def latest_sweep_state(log_dir: str | Path) -> Optional[Path]:
    """The newest ``sweep_state_*_steps.msgpack`` in ``log_dir``, or
    None."""
    return _latest(log_dir, _SWEEP_STEP_RE)


def checkpoint_step(path: str | Path) -> int:
    m = _STEP_RE.search(Path(path).name)
    if not m:
        raise ValueError(f"not a checkpoint path: {path}")
    return int(m.group(1))


def quarantine_checkpoint(path: str | Path, reason: str) -> Optional[Path]:
    """Move a bad checkpoint aside as ``{name}.quarantined`` (no longer a
    ``.msgpack``, so discovery never serves it) and append a line to
    ``quarantine.jsonl`` beside it. Returns the new path, or None when the
    rename failed; never raises."""
    path = Path(path)
    target: Optional[Path] = path.with_name(path.name + ".quarantined")
    try:
        path.replace(target)
    except OSError:
        target = None
    try:
        with open(path.parent / "quarantine.jsonl", "a") as f:
            f.write(json.dumps({
                "time": round(time.time(), 3),
                "file": path.name,
                "quarantined_as": target.name if target else None,
                "reason": str(reason)[:300],
            }) + "\n")
    except OSError:
        pass
    get_registry().counter("checkpoint_quarantined_total").inc()
    return target


def restore_latest_partial(
    log_dir: str | Path, keys: Iterable[str]
) -> Optional[Tuple[Path, dict]]:
    """Resume from the newest valid checkpoint in ``log_dir``: ``(path,
    {key: value})`` for each of ``keys`` the file holds (extra keys are
    ignored), or None when there is none. A corrupt file is quarantined
    (``quarantine_checkpoint``) and the walk steps down to the next; if the
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
            if quarantine_checkpoint(path, str(e)) is None:
                raise e
            continue
        if not isinstance(raw, dict):
            raise ValueError(f"checkpoint {path} is not a dict")
        return path, {k: raw[k] for k in keys if k in raw}


def restore_state_dict_partial(
    raw: Mapping[str, Any], template: Mapping[str, Any],
    origin: str = "<state dict>",
) -> dict:
    """Each key of ``template`` that ``raw`` (a parsed checkpoint) holds,
    validated against the template's tree: the JAX package's
    ``utils/checkpoint.py::restore_state_dict_partial``, whose flax restore
    takes the template's keys at every level and ignores extra keys of the
    file. A missing or renamed subtree, a dict where an array belongs (or
    the reverse), another leaf shape, or another dtype where both leaves are
    arrays raises ``ValueError`` naming ``origin``, the key and the leaf: a
    checkpoint of another architecture, or the same shapes at a drifted
    dtype, is refused here rather than served. Scalar template leaves
    (``num_timesteps: 0``) restore at whatever integer width was written."""
    restored = {}
    for key, tmpl in template.items():
        if key in raw:
            restored[key] = _restore_subtree(tmpl, raw[key], origin, key, "")
    return restored


def _restore_subtree(tmpl: Any, value: Any, origin: str, key: str,
                     path: str) -> Any:
    where = path or "the root"
    if isinstance(tmpl, Mapping):
        missing = ([k for k in tmpl if k not in value]
                   if isinstance(value, Mapping) else None)
        if missing is None or missing:
            found = (f"lacks {missing}" if missing
                     else f"holds a {type(value).__name__}, not a dict")
            raise ValueError(
                f"checkpoint {origin}: key {key!r} does not match the "
                f"restore template (architecture mismatch?): {where} {found}"
            )
        return {k: _restore_subtree(t, value[k], origin, key, f"{path}[{k!r}]")
                for k, t in tmpl.items()}
    if isinstance(value, Mapping):
        raise ValueError(
            f"checkpoint {origin}: key {key!r} tree structure does not match "
            f"the restore template — architecture mismatch (a dict at leaf "
            f"{where})"
        )
    t_shape, r_shape = np.shape(tmpl), np.shape(value)
    t_dtype = getattr(tmpl, "dtype", None)
    r_dtype = getattr(value, "dtype", None)
    problem = None
    if t_shape != r_shape:
        problem = f"shape {r_shape}, but the template expects {t_shape}"
    elif t_dtype is not None and r_dtype is not None and t_dtype != r_dtype:
        problem = f"dtype {r_dtype}, but the template expects {t_dtype}"
    if problem:
        raise ValueError(
            f"checkpoint {origin}: key {key!r} leaf {where} has {problem} — "
            "architecture mismatch (refusing to restore an incompatible tree)"
        )
    return value


def prune_checkpoints(
    log_dir: str | Path, keep_last_n: int, protect: Iterable[Any] = ()
) -> List[Path]:
    """The retention ring: delete all but the newest ``keep_last_n``
    discoverable ``rl_model_*`` checkpoints in ``log_dir`` (0 keeps all).
    Quarantined, temporary and other files are never touched, nor any path
    in ``protect`` (the recovery ladder's last good file). Best effort;
    returns the paths removed."""
    keep_last_n = int(keep_last_n)
    log_dir = Path(log_dir)
    if keep_last_n <= 0 or not log_dir.is_dir():
        return []
    protected = {Path(p).resolve() for p in (protect or ()) if p is not None}
    candidates = sorted(
        (
            p for p in log_dir.iterdir()
            if p.suffix == ".msgpack" and not p.name.startswith(".")
            and _STEP_RE.search(p.name)
        ),
        key=checkpoint_step,
        reverse=True,
    )
    pruned: List[Path] = []
    for path in candidates[keep_last_n:]:
        if path.resolve() in protected:
            continue
        try:
            path.unlink()
        except OSError:
            continue
        pruned.append(path)
    if pruned:
        get_registry().counter("checkpoint_pruned_total").inc(len(pruned))
    return pruned


# ---------------------------------------------------------------------------
# Writing off the training loop
# ---------------------------------------------------------------------------


def _map_tree(fn: Callable[[Any], Any], tree: Any) -> Any:
    if isinstance(tree, Mapping):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_to_host(tree: Any, ready: Optional[Any] = None) -> Any:
    """``tree`` with every tensor as a numpy array, in one pass. With a
    CUDA event ``ready``, the copies run on a side stream that first waits
    for it, so they wait for the work the event closes and for nothing the
    caller queued after it."""
    def leaf(x: Any) -> Any:
        # A copy: a CPU tensor's numpy() would alias the live tensor, and a
        # host tree (a rollback anchor) must not move with training.
        return (x.detach().to("cpu", copy=True).numpy()
                if isinstance(x, torch.Tensor) else x)

    if ready is None:
        return _map_tree(leaf, tree)
    stream = torch.cuda.Stream()
    stream.wait_event(ready)
    with torch.cuda.stream(stream):
        return _map_tree(leaf, tree)


@dataclasses.dataclass
class DeviceSnapshot:
    """Device copies of a state tree and the event that closes them;
    ``result()`` brings them to the host and applies ``finish``."""

    tree: Any
    ready: Optional[Any]
    finish: Optional[Callable[[Any], Any]] = None

    def result(self) -> Any:
        host = tree_to_host(self.tree, self.ready)
        return host if self.finish is None else self.finish(host)


def device_snapshot(
    tree: Any, finish: Optional[Callable[[Any], Any]] = None
) -> DeviceSnapshot:
    """A copy of every tensor of ``tree`` on its device, queued behind the
    work that produced it, with an event recorded after the copies on the
    current stream (CUDA). The live tensors can then be overwritten by the
    next dispatch while a writer thread reads the snapshot. Host leaves
    pass as they are; ``finish(host_tree)`` runs when the snapshot is read
    (on the writer's thread, so it must read nothing else that changes)."""
    copy = _map_tree(
        lambda x: x.detach().clone() if isinstance(x, torch.Tensor) else x,
        tree,
    )
    ready = None
    if any(
        isinstance(x, torch.Tensor) and x.is_cuda
        for x in _leaves(copy)
    ):
        ready = torch.cuda.Event()
        ready.record()
    return DeviceSnapshot(copy, ready, finish)


def _leaves(tree: Any) -> List[Any]:
    if isinstance(tree, Mapping):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


class AsyncCheckpointWriter:
    """Checkpoint writes on a background thread.

    At most one write is in flight: ``submit`` joins the previous write
    first, so writes land in the order submitted and one snapshot is held
    at a time. A write is ``write_atomic``'s, so a crash at any point
    leaves at most a dot-prefixed temporary file that discovery never
    picks up. An ``OSError`` is retried ``io_retries`` times with jittered
    backoff and then skipped (``writes_skipped``), as is a state the
    non-finite gate refuses and a write the chaos plane kills
    (``SimulatedCrash``: the checkpoint is lost, as a real crash loses
    it): training goes on and the next save tries again. Any other
    failure is raised as ``RuntimeError`` on the next ``submit``,
    ``wait`` or ``close``.
    """

    IO_RETRIES = 3
    IO_BACKOFF_S = 0.05

    def __init__(
        self,
        keep_last_n: int = 0,
        protect: Optional[Callable[[], Iterable[Any]]] = None,
    ) -> None:
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self.writes_skipped = 0
        self.keep_last_n = max(0, int(keep_last_n))
        self._protect = protect
        self.io_retries = self.IO_RETRIES
        self.io_backoff_s = self.IO_BACKOFF_S

    def submit(
        self,
        path: str | Path,
        target: Any,
        on_done: Optional[Callable[[Path], None]] = None,
    ) -> Path:
        """Queue one atomic write of ``target`` (a host tree, or a
        ``DeviceSnapshot``) to ``path``. ``on_done(path)`` runs on the
        writer's thread once the file is in place; then the retention ring
        is pruned."""
        path = Path(path)

        def write() -> None:
            tree = (
                target.result() if isinstance(target, DeviceSnapshot)
                else target
            )
            write_atomic(path, tree)
            if on_done is not None:
                on_done(path)
            if self.keep_last_n > 0:
                prune_checkpoints(
                    path.parent, self.keep_last_n,
                    protect=self._protect() if self._protect else (),
                )

        self.submit_write(write)
        return path

    def submit_write(self, write_fn: Callable[[], None]) -> None:
        """Queue any checkpoint-writing callable on the writer's thread,
        under the same contract as ``submit``. The ``ckpt_writer.submit``
        chaos seam runs on the caller's (the training) thread."""
        fault_point("ckpt_writer.submit")
        self.wait()
        # One write in flight: a depth stuck at 1 means training outruns
        # the disk.
        get_registry().gauge("checkpoint_queue_depth").set(1.0)
        thread = threading.Thread(
            target=self._run, args=(write_fn,), daemon=True,
            name="ckpt-writer",
        )
        self._thread = thread
        thread.start()

    def _run(self, write_fn: Callable[[], None]) -> None:
        t0 = time.perf_counter()
        registry = get_registry()
        try:
            attempt = 0
            while True:
                try:
                    write_fn()
                    registry.histogram("checkpoint_write_seconds").observe(
                        time.perf_counter() - t0)
                    registry.counter("checkpoint_writes_total").inc()
                    return
                except OSError as e:
                    attempt += 1
                    if attempt > self.io_retries:
                        self._skip(e)
                        return
                    time.sleep(
                        self.io_backoff_s * 2.0 ** (attempt - 1)
                        * random.uniform(0.5, 1.5)
                    )
                except SimulatedCrash as e:
                    self._skip(e)
                    return
                except NonFiniteCheckpointError as e:
                    self.writes_skipped += 1
                    registry.counter(
                        "checkpoint_nonfinite_skipped_total").inc()
                    print(f"[checkpoint] write skipped: {e}",
                          file=sys.stderr)
                    return
        except BaseException as e:  # noqa: BLE001 - raised on the next wait
            self._error = e
        finally:
            registry.gauge("checkpoint_queue_depth").set(0.0)

    def _skip(self, error: BaseException) -> None:
        from marl_distributedformation_tpu_torch.obs import get_tracer

        self.writes_skipped += 1
        get_registry().counter("checkpoint_writes_skipped_total").inc()
        get_tracer().incident(
            "checkpoint_write_skipped", error=repr(error)[:300],
            retries=self.io_retries, writes_skipped=self.writes_skipped,
        )
        print(f"[checkpoint] write skipped: {error}", file=sys.stderr)

    def wait(self) -> None:
        """Join the write in flight, if any; raise its failure."""
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join()
        err, self._error = self._error, None
        if err is not None:
            raise RuntimeError(
                f"async checkpoint write failed: {err!r}"
            ) from err

    def close(self) -> None:
        """Drain the writer; raises if the last write failed."""
        self.wait()

    def close_quietly(self) -> None:
        """Join without raising, on a path that is already failing."""
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join()
        self._error = None


class CheckpointDiscovery:
    """Incremental ``rl_model_*`` discovery for long-running watchers.

    ``latest_checkpoint`` lists and parses the whole directory on every
    call; a watcher polling a training run for hours would pay for every
    checkpoint ever written on every poll. This keeps
    ``latest_checkpoint``'s contract (the same name filter and step
    parse; dot-prefixed temp files never seen) at a bounded cost:

    - each file name is parsed once (a name-to-step cache);
    - an idle poll is one ``stat``: the directory's mtime changes when an
      entry is added or renamed in, so an unchanged mtime means an
      unchanged listing. The skip is trusted only when the last listing
      ran ``_MTIME_SLACK_S`` after the mtime it recorded, so a file that
      lands within the same mtime tick is found one listing later, never
      missed.

    ``latest()`` is the non-consuming view (the fleet coordinator's);
    ``poll_new()`` the consuming stream, ascending, each checkpoint once,
    ignoring steps at or below the consumed high-water mark.
    """

    _MTIME_SLACK_S = 2.0

    def __init__(
        self, log_dir: str | Path, start_after_step: int = -1
    ) -> None:
        self.log_dir = Path(log_dir)
        self._known: Dict[str, int] = {}  # file name -> parsed step
        self._high_water = int(start_after_step)
        self._dir_mtime_ns: Optional[int] = None
        self._listing_stable = False  # the last listing postdated the mtime

    def _refresh(self) -> None:
        try:
            st = os.stat(self.log_dir)
        except OSError:  # the directory is not there yet
            self._dir_mtime_ns = None
            self._listing_stable = False
            return
        if self._listing_stable and st.st_mtime_ns == self._dir_mtime_ns:
            return  # an idle poll: one stat
        now = time.time()
        with os.scandir(self.log_dir) as entries:
            for entry in entries:
                name = entry.name
                if name in self._known or not name.endswith(".msgpack"):
                    continue
                m = _STEP_RE.search(name)
                if m is not None:
                    self._known[name] = int(m.group(1))
        self._dir_mtime_ns = st.st_mtime_ns
        self._listing_stable = (now - st.st_mtime) > self._MTIME_SLACK_S

    def latest(self) -> Optional[Path]:
        """The newest checkpoint (``latest_checkpoint``'s answer); a
        deleted entry leaves the cache, so the answer can step back down
        to an older file."""
        self._refresh()
        while self._known:
            name = max(self._known, key=self._known.__getitem__)
            path = self.log_dir / name
            if path.exists():
                return path
            del self._known[name]
        return None

    def poll_new(self) -> List[Path]:
        """Checkpoints above the consumed high-water mark, ascending; the
        mark moves past everything returned."""
        self._refresh()
        fresh = sorted(
            (step, name) for name, step in self._known.items()
            if step > self._high_water
        )
        if fresh:
            self._high_water = fresh[-1][0]
        return [self.log_dir / name for _, name in fresh]
