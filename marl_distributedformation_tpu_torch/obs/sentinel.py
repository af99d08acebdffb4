"""RegressionSentinel: a bench record of this device as a live tripwire.

Counterpart of the JAX package's ``obs/sentinel.py``, with its names,
arguments and behaviour: it loads a bench record (the newest repo-root
``BENCH_r*.json``, or an explicit file), compares the live
:class:`~.metrics.MetricsRegistry` gauges against the recorded fields with
a tolerance band and ``trip_after`` hysteresis (one noisy sample never
trips), and on SUSTAINED degradation

- records a ``perf_regression`` incident through the tracer, which dumps a
  ``flightrec-perf_regression-*.json`` flight record with the metrics
  snapshot and the recent span history, and
- appends an audit line to ``perf_incidents.jsonl``.

A tripped watch stays latched while it is breached and re-arms once the
live value is back inside the band.

Taxonomy (``missing``) is explicit: a watch whose bench field is absent
from the record, explicitly ``"skipped"``, or non-numeric is recorded as
unmeasurable, never a breach and never silently dropped. A live gauge that
has not been recorded yet leaves the streak untouched.

One difference from the JAX package: a record is this device's own or it
is not used. A record whose ``platform`` (or, where both are known,
``device``) names another device than the one the sentinel watches (a TPU
or CPU record on a CUDA card) is unloadable: every watch is reported in
``missing`` with a reason naming the record's device, as for a run with no
record, and nothing can trip against it.

Imports nothing but the standard library.
"""

from __future__ import annotations

import dataclasses
import json
import re
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

from marl_distributedformation_tpu_torch.obs.metrics import (
    MetricsRegistry,
    get_registry,
)
from marl_distributedformation_tpu_torch.obs.tracer import Tracer, get_tracer

# The bench's explicit not-run marker.
SKIPPED = "skipped"

_BENCH_RE = re.compile(r"^BENCH_r(\d+)\.json$")

# A record's platform word for each torch device type (JAX's words).
_PLATFORM_OF_DEVICE = {"cuda": "gpu", "cpu": "cpu"}


def load_bench_record(
    path: Optional[str | Path] = None, root: Optional[str | Path] = None
) -> Tuple[Dict[str, Any], Optional[Path]]:
    """The newest bench record as a flat dict.

    ``path`` pins an explicit file; otherwise the highest-numbered
    ``BENCH_r*.json`` under ``root`` (default: the repo root) wins, in
    numeric order, so r10 beats r9. Both the wrapper shape
    (``{"parsed": {...}}``) and a bare bench JSON line are accepted.
    Returns ``({}, None)`` when nothing is loadable: the sentinel then
    reports every watch as unmeasurable instead of crashing the process it
    guards."""
    if path is not None:
        candidates = [Path(path)]
    else:
        if root is None:
            root = Path(__file__).resolve().parents[2]
        found = [
            p for p in Path(root).glob("BENCH_r*.json") if _BENCH_RE.match(p.name)
        ]
        candidates = sorted(
            found,
            key=lambda p: int(_BENCH_RE.match(p.name).group(1)),
            reverse=True,
        )
    for candidate in candidates:
        try:
            record = json.loads(Path(candidate).read_text())
        except (OSError, json.JSONDecodeError):
            continue
        if isinstance(record, dict) and isinstance(
            record.get("parsed"), dict
        ):
            record = record["parsed"]
        if isinstance(record, dict):
            return record, Path(candidate)
    return {}, None


def platform_of(device: str) -> str:
    """The record's platform word for a torch device (``"cuda:0"`` ->
    ``"gpu"``)."""
    kind = str(device).split(":", 1)[0]
    return _PLATFORM_OF_DEVICE.get(kind, kind)


def foreign_record_reason(
    record: Dict[str, Any], device: str, device_kind: Optional[str] = None
) -> Optional[str]:
    """Why ``record`` is not a record of ``device`` (a torch device
    string; ``device_kind`` its name, as ``torch.cuda.get_device_name``
    gives it), or None when it is, or when it names no platform."""
    live = platform_of(device)
    recorded = record.get("platform")
    if isinstance(recorded, str):
        recorded = platform_of(recorded)
        if recorded != live:
            return (f"the bench record is a {recorded} record "
                    f"({record.get('device', 'device not named')}), not "
                    f"this {live} device's")
    name = record.get("device")
    if (isinstance(name, str) and device_kind
            and name.strip().lower() != str(device_kind).strip().lower()):
        return (f"the bench record is {name}'s, not this device's "
                f"({device_kind})")
    return None


@dataclasses.dataclass(frozen=True)
class Watch:
    """One live-gauge-vs-recorded-field comparison.

    ``direction="min"`` guards throughput (breach when the live value falls
    below ``(1 - tolerance) * recorded``); ``direction="max"`` guards
    latency (breach above ``(1 + tolerance) * recorded``).
    ``bench_fields`` is a preference list: the first field present and
    numeric in the record is the reference."""

    gauge: str
    bench_fields: Tuple[str, ...]
    direction: str = "min"
    tolerance: float = 0.5

    def __post_init__(self) -> None:
        if self.direction not in ("min", "max"):
            raise ValueError(
                f"direction must be 'min' or 'max', got {self.direction!r}"
            )
        if not self.bench_fields:
            raise ValueError(f"watch {self.gauge!r} names no bench fields")
        if self.tolerance <= 0.0:
            raise ValueError(f"tolerance must be > 0, got {self.tolerance}")


def ledger_watches(tolerance: float = 0.5) -> Tuple[Watch, ...]:
    """Program-ledger guards (``obs/ledger.py``): the largest build time
    (a CUDA graph capture on the card) against the record's
    ``ledger_compile_seconds_max``, and the live device memory against its
    ``device_memory_watermark_bytes``. Both gauges can recover, so a
    tripped watch re-arms in band."""
    return (
        Watch(
            gauge="ledger_compile_seconds_max",
            bench_fields=("ledger_compile_seconds_max",),
            direction="max",
            tolerance=tolerance,
        ),
        Watch(
            gauge="device_memory_bytes_in_use",
            bench_fields=("device_memory_watermark_bytes",),
            direction="max",
            tolerance=tolerance,
        ),
    )


def recovery_watches(tolerance: float = 1.0) -> Tuple[Watch, ...]:
    """Train-lane recovery guard (``train/recovery.py``): the live rollback
    MTTR tail (``train_recovery_mttr_seconds_p95``) against the record's
    ``recovery_mttr_s``. Wide default band: recovery is rare, so samples
    are few."""
    return (
        Watch(
            gauge="train_recovery_mttr_seconds_p95",
            bench_fields=("recovery_mttr_s",),
            direction="max",
            tolerance=tolerance,
        ),
    )


def default_watches(tolerance: float = 0.5) -> Tuple[Watch, ...]:
    """The stock lane guards: trainer throughput, gate eval throughput,
    fleet tail latency."""
    return (
        Watch(
            gauge="train_env_steps_per_sec",
            bench_fields=(
                "train_env_steps_per_sec_fused_scan",
                "train_env_steps_per_sec_tuned",
                "train_env_steps_per_sec",
            ),
            direction="min",
            tolerance=tolerance,
        ),
        Watch(
            gauge="gate_eval_steps_per_sec",
            bench_fields=("gate_eval_steps_per_sec",),
            direction="min",
            tolerance=tolerance,
        ),
        Watch(
            gauge="latency_p95_ms",
            bench_fields=("serving_fleet_p95_ms",),
            direction="max",
            tolerance=tolerance,
        ),
    )


class _WatchState:
    __slots__ = ("streak", "tripped")

    def __init__(self) -> None:
        self.streak = 0
        self.tripped = False


class RegressionSentinel:
    """Compare live registry gauges against a bench record of this device.

    Args:
      watches: the comparisons to run each check.
      record: an explicit bench record dict (tests); otherwise loaded
        from ``record_path`` / the newest ``BENCH_r*.json`` under
        ``bench_root``.
      trip_after: consecutive breaching checks before a watch trips.
      audit_dir: directory for ``perf_incidents.jsonl`` (None: no audit
        file, incidents still fire through the tracer).
      registry / tracer: explicit instances (tests); default to the
        process globals, resolved at check time.
      device / device_kind: the torch device the watched process runs on,
        and its name; a record of another device is not used (see the
        module docstring).
    """

    AUDIT_NAME = "perf_incidents.jsonl"

    def __init__(
        self,
        watches: Sequence[Watch] = (),
        record: Optional[Dict[str, Any]] = None,
        record_path: Optional[str | Path] = None,
        bench_root: Optional[str | Path] = None,
        trip_after: int = 3,
        audit_dir: Optional[str | Path] = None,
        registry: Optional[MetricsRegistry] = None,
        tracer: Optional[Tracer] = None,
        device: str = "cuda",
        device_kind: Optional[str] = None,
    ) -> None:
        self.watches = tuple(watches) or default_watches()
        if record is not None:
            self.record, self.record_source = dict(record), None
        else:
            self.record, self.record_source = load_bench_record(
                record_path, root=bench_root
            )
        # A record of another device is as good as none.
        self.foreign = foreign_record_reason(self.record, device,
                                             device_kind)
        if self.foreign is not None:
            source = self.record_source
            self.foreign += f" ({source})" if source is not None else ""
            self.record, self.record_source = {}, None
        self.trip_after = max(1, int(trip_after))
        self.audit_path = (
            Path(audit_dir) / self.AUDIT_NAME
            if audit_dir is not None
            else None
        )
        self._registry = registry
        self._tracer = tracer
        self._state: Dict[str, _WatchState] = {
            w.gauge: _WatchState() for w in self.watches
        }
        self.checks_total = 0
        self.trips: List[dict] = []
        # gauge -> reason, for watches that can never breach.
        self.missing: Dict[str, str] = {}
        # Watches whose live gauge has appeared in at least one checked
        # snapshot; summary() names the others.
        self._observed: set = set()

    # -- reference arithmetic --------------------------------------------

    def reference(self, watch: Watch) -> Optional[Tuple[str, float]]:
        """``(field, recorded_value)`` for the first usable bench field,
        recording the taxonomy for unusable ones."""
        reasons = []
        for field in watch.bench_fields:
            value = self.record.get(field)
            if value is None:
                reasons.append(f"{field}: absent")
                continue
            if value == SKIPPED:
                reasons.append(f"{field}: explicitly skipped (BENCH_SKIP_*)")
                continue
            try:
                v = float(value)
            except (TypeError, ValueError):
                reasons.append(f"{field}: non-numeric ({value!r})")
                continue
            self.missing.pop(watch.gauge, None)
            return field, v
        reason = "; ".join(reasons) or "no bench fields"
        if self.foreign is not None:
            reason = f"{self.foreign}: {reason}"
        self.missing[watch.gauge] = reason
        return None

    @staticmethod
    def _band(watch: Watch, recorded: float) -> float:
        if watch.direction == "min":
            return recorded * (1.0 - watch.tolerance)
        return recorded * (1.0 + watch.tolerance)

    def limit(self, watch: Watch) -> Optional[float]:
        ref = self.reference(watch)
        if ref is None:
            return None
        return self._band(watch, ref[1])

    # -- the check --------------------------------------------------------

    def check(
        self, snapshot: Optional[Dict[str, float]] = None
    ) -> List[dict]:
        """One comparison pass over every watch; returns the incidents that
        TRIPPED on this check (usually empty). A tripped watch stays latched
        (no repeat dumps while the degradation persists) and re-arms once
        it recovers inside the band."""
        registry = self._registry or get_registry()
        if snapshot is None:
            # The default snapshot carries the program ledger's aggregate
            # gauges too, so ledger_watches() work without every caller
            # merging namespaces (an explicit snapshot is taken verbatim).
            from marl_distributedformation_tpu_torch.obs.ledger import (
                merge_ledger_snapshot,
            )

            snapshot = merge_ledger_snapshot(registry.snapshot())
        self.checks_total += 1
        tripped_now: List[dict] = []
        for watch in self.watches:
            ref = self.reference(watch)
            if ref is None:
                continue
            live = snapshot.get(watch.gauge)
            if live is None:
                continue  # not yet recorded: no evidence either way
            self._observed.add(watch.gauge)
            field, recorded = ref
            live = float(live)
            limit = self._band(watch, recorded)
            breached = (
                live < limit if watch.direction == "min" else live > limit
            )
            state = self._state[watch.gauge]
            if not breached:
                state.streak = 0
                state.tripped = False  # recovered: re-arm
                continue
            state.streak += 1
            if state.streak < self.trip_after or state.tripped:
                continue
            state.tripped = True
            incident = {
                "gauge": watch.gauge,
                "live": live,
                "bench_field": field,
                "recorded": recorded,
                "limit": limit,
                "direction": watch.direction,
                "tolerance": watch.tolerance,
                "streak": state.streak,
                "bench_record": (
                    str(self.record_source) if self.record_source else None
                ),
            }
            self._trip(incident, snapshot)
            tripped_now.append(incident)
        return tripped_now

    def _trip(self, incident: dict, snapshot: Dict[str, float]) -> None:
        """A sustained regression: flight-record the evidence and write the
        audit line. Never raises: the sentinel observes the system, it must
        not become its failure mode."""
        self.trips.append(incident)
        registry = self._registry or get_registry()
        registry.counter("sentinel_trips_total").inc()
        tracer = self._tracer or get_tracer()
        dump = tracer.incident(
            "perf_regression", metrics_snapshot=dict(snapshot), **incident
        )
        if self.audit_path is None:
            return
        line = dict(incident)
        line["event"] = "perf_regression"
        line["time"] = time.time()
        line["flightrec"] = str(dump) if dump is not None else None
        try:
            self.audit_path.parent.mkdir(parents=True, exist_ok=True)
            with open(self.audit_path, "a") as f:
                f.write(json.dumps(line) + "\n")
        except OSError:
            pass

    # -- reporting --------------------------------------------------------

    def summary(self) -> Dict[str, Any]:
        return {
            "sentinel_checks": self.checks_total,
            "sentinel_trips": len(self.trips),
            "sentinel_missing": dict(self.missing),
            # Watches measurable against the record whose live gauge never
            # appeared in a checked snapshot: nothing here feeds them.
            "sentinel_never_observed": sorted(
                w.gauge
                for w in self.watches
                if w.gauge not in self._observed
                and w.gauge not in self.missing
            ),
            "sentinel_bench_record": (
                str(self.record_source) if self.record_source else None
            ),
        }
