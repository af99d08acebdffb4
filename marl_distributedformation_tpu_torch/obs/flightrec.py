"""FlightRecorder: incident-triggered snapshots of the tracing ring.

Counterpart of the JAX package's ``obs/flightrec.py``, the same code.

The tracer's per-thread rings are a sliding window — perfect for live
export, useless for a postmortem that starts an hour after the incident.
The flight recorder closes that gap the way avionics do: when something
operationally notable happens (circuit break, rollback trip,
wedged-barrier abort, scheduler worker death — the ``Tracer.incident``
triggers), the last-N spans/events across every thread are written to
``{out_dir}/flightrec-{trigger}-{seq}.json`` immediately, so the
reconstruction does not depend on anyone having had logging enabled or
a scrape running at the time.

Dumps are atomic (tmp + rename), bounded in count (oldest pruned), and
failure-silent — a full disk during an incident must not add a second
incident.
"""

from __future__ import annotations

import json
import re
import threading
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

_DUMP_RE = re.compile(r"^flightrec-.+-(\d+)\.json$")


class FlightRecorder:
    """Write last-N tracer records to disk on demand.

    Args:
      out_dir: directory dumps land in (created on first dump).
      last_n: newest records kept per dump, merged across threads.
      max_files: dumps retained; older ones are pruned so a flapping
        replica cannot fill the disk with identical snapshots.
    """

    def __init__(
        self,
        out_dir: str | Path,
        last_n: int = 512,
        max_files: int = 16,
    ) -> None:
        self.out_dir = Path(out_dir)
        self.last_n = max(1, int(last_n))
        self.max_files = max(1, int(max_files))
        self.dumps_total = 0
        # Resume the sequence past any dumps already on disk: a restarted
        # process (the normal continuous-learning lifecycle) must never
        # overwrite a previous run's postmortem files, and _prune's
        # oldest-first ordering must keep meaning oldest.
        existing = self.dumps()
        self._seq = (
            int(_DUMP_RE.match(existing[-1].name).group(1))
            if existing
            else 0
        )
        self._lock = threading.Lock()

    def dump(
        self,
        trigger: str,
        tracer: Any,
        trace_id: Optional[str] = None,
        context: Optional[Dict[str, Any]] = None,
    ) -> Optional[Path]:
        """Snapshot ``tracer``'s rings under this trigger. Returns the
        dump path, or None when the write failed (never raises)."""
        safe_trigger = re.sub(r"[^A-Za-z0-9_\-]", "_", str(trigger))[:64]
        try:
            records = tracer.snapshot(last_n=self.last_n)
        except Exception:  # noqa: BLE001 — a broken tracer still dumps context
            records = []
        payload = {
            "format": "marl-obs-flightrec",
            "version": 1,
            "trigger": str(trigger),
            "time": time.time(),
            "trace_id": trace_id,
            "context": _jsonable(context or {}),
            "records": records,
        }
        with self._lock:
            self._seq += 1
            path = self.out_dir / f"flightrec-{safe_trigger}-{self._seq:04d}.json"
            try:
                self.out_dir.mkdir(parents=True, exist_ok=True)
                tmp = path.with_name(f".{path.name}.tmp")
                tmp.write_text(json.dumps(payload))
                tmp.replace(path)
                self.dumps_total += 1
                self._prune()
            except OSError:
                return None
        return path

    def dumps(self) -> List[Path]:
        """Existing dump files, oldest first (sequence order)."""
        try:
            found = [
                p
                for p in self.out_dir.iterdir()
                if _DUMP_RE.match(p.name)
            ]
        except OSError:
            return []
        return sorted(
            found, key=lambda p: int(_DUMP_RE.match(p.name).group(1))
        )

    def _prune(self) -> None:
        existing = self.dumps()
        for stale in existing[: max(0, len(existing) - self.max_files)]:
            stale.unlink(missing_ok=True)


def _jsonable(context: Dict[str, Any], depth: int = 2) -> Any:
    """Best-effort JSON-safe copy of incident context (bounded dict/
    list nesting preserved — the sentinel attaches a whole metrics
    snapshot, the chaos invariant checkers attach armed/fired fault
    schedules as lists of dicts — reprs for anything exotic; the dump
    must always serialize)."""
    out: Dict[str, Any] = {}
    for k, v in context.items():
        out[str(k)] = _jsonable_value(v, depth)
    return out


def _jsonable_value(v: Any, depth: int) -> Any:
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    if isinstance(v, dict) and depth > 0:
        return _jsonable(v, depth - 1)
    if isinstance(v, (list, tuple)) and depth > 0:
        converted = [_jsonable_value(e, depth - 1) for e in v]
        if all(
            isinstance(e, (str, int, float, bool, dict)) or e is None
            for e in converted
        ):
            return converted
    return repr(v)
