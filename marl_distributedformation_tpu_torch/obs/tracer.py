"""Tracer: the low-overhead tracing spine every subsystem shares.

Counterpart of the JAX package's ``obs/tracer.py``, the same code: spans
and events recorded at host-side seams only (scheduler dispatch, reload
commit), never inside a captured CUDA graph, where a host call would run
once at capture and never again.

Design constraints, in order:

1. **Never in the captured path.** The recorder performs no device work
   and imports nothing but the standard library.
2. **Lock-cheap.** Each recording thread owns its own bounded ring
   buffer (``collections.deque(maxlen=...)`` — appends are GIL-atomic);
   the only lock is taken once per thread, at ring registration. A
   serving worker recording one span per micro-batch contends with
   nobody.
3. **Bounded memory.** Rings cap at ``ring_size`` records per thread;
   old spans fall off the back. The :class:`~.flightrec.FlightRecorder`
   exists precisely because the ring is a window, not an archive —
   incidents snapshot it before it scrolls away.

Identity: a **trace ID** is an opaque hex string minted once per logical
operation (one request, one checkpoint's promotion journey) and carried
explicitly through every layer — the ``X-Trace-Id`` header on the wire, a
``trace_id=`` kwarg in process. Spans record the ID they were given.

Timestamps are monotonic (``time.perf_counter``) so intervals are
immune to wall-clock steps; the tracer keeps an epoch<->monotonic
anchor pair so exporters can place spans on the wall clock (and so a
span can be back-dated to a file mtime).

The **process-global registry** is the default tracer: ``get_tracer()``
returns it, ``configure(...)`` re-shapes it in place (enabled flag, ring
size, flight-recorder attachment), and every instrumented subsystem
resolves it at call time — tests can swap in a private
:class:`Tracer` via ``set_tracer`` and restore the old one.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import threading
import time
import uuid
from collections import deque
from pathlib import Path
from typing import Any, Dict, Iterator, List, Optional, Tuple

# The wire spelling of the trace identity (the JAX package's fleet
# frontend accepts and echoes it; clients may send their own).
TRACE_HEADER = "X-Trace-Id"

# Trace IDs are sanitized at trust boundaries: hex-ish, bounded length.
_MAX_TRACE_ID_LEN = 64
# Explicit ASCII set — str.isalnum() would admit non-ASCII Unicode
# alphanumerics, which are not URL/log/filename-safe.
_TRACE_ID_SAFE = frozenset(
    "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789-_."
)


def new_trace_id() -> str:
    """Mint an opaque 16-hex-char trace ID (collision-safe at the rates
    a single process mints them)."""
    return uuid.uuid4().hex[:16]


def sanitize_trace_id(raw: Optional[str]) -> Optional[str]:
    """A caller-supplied trace ID, defanged: stripped, length-bounded,
    restricted to URL/log-safe characters. Anything unusable -> None
    (the caller mints a fresh one)."""
    if not raw:
        return None
    raw = raw.strip()[:_MAX_TRACE_ID_LEN]
    if not raw or not all(c in _TRACE_ID_SAFE for c in raw):
        return None
    return raw


@dataclasses.dataclass
class Span:
    """One closed interval on one thread. ``t0``/``t1`` are monotonic
    (``perf_counter``); exporters convert via the tracer's anchor."""

    name: str
    t0: float
    t1: float
    trace_id: Optional[str] = None
    attrs: Optional[Dict[str, Any]] = None

    kind = "span"


@dataclasses.dataclass
class Event:
    """One instant on one thread (same clock as :class:`Span`)."""

    name: str
    t: float
    trace_id: Optional[str] = None
    attrs: Optional[Dict[str, Any]] = None

    kind = "event"


class Tracer:
    """Per-thread ring buffers of spans/events plus the epoch anchor.

    Args:
      enabled: master switch. Disabled, every record call is one
        attribute read and a return — the tracer can stay wired into hot
        host paths unconditionally.
      ring_size: per-thread bound on retained records (spans + events).
      flightrec: optional :class:`~.flightrec.FlightRecorder`;
        :meth:`incident` dumps through it.
    """

    def __init__(
        self,
        enabled: bool = True,
        ring_size: int = 4096,
        flightrec: Optional[Any] = None,
    ) -> None:
        self.enabled = bool(enabled)
        self.ring_size = max(1, int(ring_size))
        self.flightrec = flightrec
        self.incidents_total = 0
        self._local = threading.local()
        self._rings_lock = threading.Lock()
        # thread ident -> (thread name, ring). Read by snapshot().
        self._rings: Dict[int, Tuple[str, deque]] = {}  # graftlock: guarded-by=_rings_lock
        # Rings displaced by ident recycling: CPython reuses a dead
        # thread's ident, and a later thread registering under it must
        # not erase the dead thread's retained records — a flight dump
        # after a worker death exists to read exactly that history.
        # Bounded: at most maxlen dead rings of ring_size records each.
        self._retired: deque = deque(maxlen=8)  # graftlock: guarded-by=_rings_lock
        # Epoch<->monotonic anchor, sampled together at construction.
        self.epoch_anchor = time.time()
        self.mono_anchor = time.perf_counter()

    # -- clock -----------------------------------------------------------

    def mono_to_epoch(self, t: float) -> float:
        return self.epoch_anchor + (t - self.mono_anchor)

    def epoch_to_mono(self, t: float) -> float:
        return self.mono_anchor + (t - self.epoch_anchor)

    # -- recording -------------------------------------------------------

    def _ring(self) -> deque:
        prev = getattr(self._local, "ring", None)
        if prev is None or prev.maxlen != self.ring_size:
            ring = deque(maxlen=self.ring_size)
            self._local.ring = ring
            thread = threading.current_thread()
            with self._rings_lock:
                old = self._rings.get(thread.ident or 0)
                if old is not None and old[1] is not prev:
                    # Recycled ident: ``old`` belongs to a DEAD thread
                    # (idents are only reused after termination), not to
                    # this thread's own resize — keep its records.
                    self._retired.append(old)
                self._rings[thread.ident or 0] = (thread.name, ring)
            return ring
        return prev

    @contextlib.contextmanager
    def span(
        self, name: str, trace_id: Optional[str] = None, **attrs: Any
    ) -> Iterator[None]:
        """Record the wall time of the ``with`` body as one span.
        Disabled tracers yield immediately — the body runs either way."""
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._ring().append(
                Span(name, t0, time.perf_counter(), trace_id, attrs or None)
            )

    def add_span(
        self,
        name: str,
        t0: float,
        t1: float,
        trace_id: Optional[str] = None,
        **attrs: Any,
    ) -> None:
        """Record an explicit interval (monotonic endpoints) — for spans
        whose start predates the tracer call site, e.g. a checkpoint's
        on-disk wait back-dated to its mtime (``epoch_to_mono`` converts)."""
        if not self.enabled:
            return
        self._ring().append(Span(name, t0, t1, trace_id, attrs or None))

    def event(
        self, name: str, trace_id: Optional[str] = None, **attrs: Any
    ) -> None:
        if not self.enabled:
            return
        self._ring().append(
            Event(name, time.perf_counter(), trace_id, attrs or None)
        )

    def incident(
        self, trigger: str, trace_id: Optional[str] = None, **context: Any
    ) -> Optional[Path]:
        """An operational event worth a postmortem — circuit break,
        rollback trip, wedged-barrier abort, worker death. Records an
        event (when enabled) and, when a flight recorder is attached,
        dumps the last-N records to disk REGARDLESS of the enabled flag
        (a disabled tracer has an empty ring, but the trigger context
        still lands). Returns the dump path, if any. Never raises —
        observability must not take down the path it observes."""
        self.incidents_total += 1
        try:
            self.event(f"incident.{trigger}", trace_id=trace_id, **context)
            if self.flightrec is not None:
                return self.flightrec.dump(
                    trigger, self, trace_id=trace_id, context=context
                )
        except Exception:  # noqa: BLE001
            pass
        return None

    # -- reading ---------------------------------------------------------

    def snapshot(self, last_n: Optional[int] = None) -> List[dict]:
        """All retained records across every thread's ring, as flat
        dicts with epoch timestamps, oldest first. ``last_n`` keeps only
        the newest N after the merge (the flight-recorder window)."""
        with self._rings_lock:
            rings = [(name, list(ring)) for name, ring in self._retired]
            rings += [
                (name, list(ring)) for name, ring in self._rings.values()
            ]
        out: List[dict] = []
        for thread_name, records in rings:
            for r in records:
                if r.kind == "span":
                    rec = {
                        "kind": "span",
                        "name": r.name,
                        "thread": thread_name,
                        "trace_id": r.trace_id,
                        "t0": self.mono_to_epoch(r.t0),
                        "t1": self.mono_to_epoch(r.t1),
                        "duration_s": r.t1 - r.t0,
                    }
                else:
                    rec = {
                        "kind": "event",
                        "name": r.name,
                        "thread": thread_name,
                        "trace_id": r.trace_id,
                        "t0": self.mono_to_epoch(r.t),
                    }
                if r.attrs:
                    rec["attrs"] = dict(r.attrs)
                out.append(rec)
        out.sort(key=lambda r: r["t0"])
        if last_n is not None:
            out = out[-last_n:]
        return out

    def dump(self, path: str | Path) -> Path:
        """Write every retained record to ``path`` as JSON (the input
        shape ``scripts/trace_report.py`` renders). Atomic via
        tmp+rename, same torn-write discipline as checkpoints."""
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f".{path.name}.tmp")
        payload = {
            "format": "marl-obs-spans",
            "version": 1,
            "time": time.time(),
            "records": self.snapshot(),
        }
        tmp.write_text(json.dumps(payload))
        tmp.replace(path)
        return path


# ----------------------------------------------------------------------
# Process-global registry
# ----------------------------------------------------------------------

_default_tracer = Tracer()


def get_tracer() -> Tracer:
    """The process-global tracer every instrumented seam resolves at
    call time."""
    return _default_tracer


def set_tracer(tracer: Tracer) -> Tracer:
    """Swap the process-global tracer (tests); returns the previous one."""
    global _default_tracer
    previous = _default_tracer
    _default_tracer = tracer
    return previous


def configure(
    enabled: Optional[bool] = None,
    ring_size: Optional[int] = None,
    flightrec_dir: Optional[str] = None,
    flightrec_last_n: int = 512,
) -> Tracer:
    """Re-shape the process-global tracer in place (the entry points'
    ``obs_trace`` / ``obs_ring_size`` / ``obs_flightrec`` knobs).
    ``flightrec_dir`` attaches a :class:`~.flightrec.FlightRecorder`
    writing under that directory; ``flightrec_dir=None`` leaves any
    existing recorder in place (pass the empty string to detach)."""
    tracer = get_tracer()
    if enabled is not None:
        tracer.enabled = bool(enabled)
    if ring_size is not None:
        tracer.ring_size = max(1, int(ring_size))
    if flightrec_dir == "":
        tracer.flightrec = None
    elif flightrec_dir is not None:
        from marl_distributedformation_tpu_torch.obs.flightrec import (
            FlightRecorder,
        )

        tracer.flightrec = FlightRecorder(
            flightrec_dir, last_n=flightrec_last_n
        )
    return tracer
