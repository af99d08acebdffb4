"""Serving observability: occupancy, latency percentiles, queue health.

Counterpart of the JAX package's ``serving/metrics.py``, the same code and
the same ``snapshot()`` keys.

Thread-safe accumulator the scheduler records into on its worker thread
while clients read snapshots from theirs. Snapshots are flat
``{name: float}`` dicts, shaped for ``utils.logging.MetricsLogger.log``
(JSONL/stdout/wandb/tensorboard) — serving gets the same observability
pipeline training already has, one record per ``emit_every`` batches
instead of one per request.

The numbers that matter, and why (the JAX package's docs/serving.md):

- ``batch_occupancy_pct`` — real rows / padded bucket capacity. The
  direct cost of the bucket ladder: low occupancy means the ladder is
  too coarse for the traffic (or the coalescing window too short).
- ``latency_p50/p95/p99_ms`` — enqueue-to-result, the client-visible
  number. p99 >> p50 usually means the queue is saturating (backpressure
  about to engage), not that the model got slower.
- ``queue_depth`` / ``rejected_total`` — backpressure health: depth
  rides near zero in a healthy server; rejects mean callers must honor
  ``retry_after_s``.
- ``model_swap_count`` — hot-reload liveness (a stuck watcher shows as
  a flat line while the trainer keeps writing checkpoints).
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Deque, Dict, List


class ServingMetrics:
    def __init__(self, latency_window: int = 4096) -> None:
        self._lock = threading.Lock()
        self._latencies: Deque[float] = deque(maxlen=latency_window)  # graftlock: guarded-by=_lock
        self._batch_seconds: Deque[float] = deque(maxlen=256)  # graftlock: guarded-by=_lock
        self.requests_total = 0  # graftlock: guarded-by=_lock
        self.rows_total = 0  # graftlock: guarded-by=_lock
        self.batches_total = 0  # graftlock: guarded-by=_lock
        self.padded_rows_total = 0  # graftlock: guarded-by=_lock
        self.rejected_total = 0  # graftlock: guarded-by=_lock
        self.timeouts_total = 0  # graftlock: guarded-by=_lock
        self.preempted_total = 0  # graftlock: guarded-by=_lock — yielded batch slots
        self.queue_depth = 0  # graftlock: guarded-by=_lock

    # -- recording (scheduler side) -------------------------------------

    def record_submit(self, queue_depth: int) -> None:
        with self._lock:
            self.requests_total += 1
            self.queue_depth = queue_depth

    def record_reject(self) -> None:
        with self._lock:
            self.rejected_total += 1

    def record_timeout(self, n: int = 1) -> None:
        with self._lock:
            self.timeouts_total += n

    def record_preempted(self) -> None:
        """A queued batch-class request was evicted to admit an
        interactive one (scheduler SLO classes)."""
        with self._lock:
            self.preempted_total += 1

    def record_batch(
        self,
        rows: int,
        padded_rows: int,
        batch_seconds: float,
        latencies_s: List[float],
        queue_depth: int,
    ) -> None:
        with self._lock:
            self.batches_total += 1
            self.rows_total += rows
            self.padded_rows_total += padded_rows
            self._batch_seconds.append(batch_seconds)
            self._latencies.extend(latencies_s)
            self.queue_depth = queue_depth

    # -- reading ---------------------------------------------------------

    def latencies_snapshot(self) -> List[float]:
        """Copy of the recent latency window (seconds). The fleet
        aggregator merges these across replicas so fleet percentiles are
        computed over raw samples, not averaged per-replica percentiles
        (averaging percentiles is statistically meaningless)."""
        with self._lock:
            return list(self._latencies)

    def mean_batch_seconds(self, default: float = 1e-3) -> float:
        """Recent mean wall-clock per dispatched batch — the unit the
        scheduler prices ``retry_after_s`` in."""
        with self._lock:
            if not self._batch_seconds:
                return default
            return sum(self._batch_seconds) / len(self._batch_seconds)

    @staticmethod
    def _percentile(ordered: List[float], q: float) -> float:
        if not ordered:
            return 0.0
        # Nearest-rank on the sorted window: cheap, monotone, and exact
        # at the tails (p99 of 100 samples is the 99th largest, not an
        # interpolation past the data).
        idx = min(len(ordered) - 1, max(0, round(q * (len(ordered) - 1))))
        return ordered[int(idx)]

    def snapshot(self) -> Dict[str, float]:
        """Flat float dict for ``MetricsLogger.log`` / the smoke bench."""
        with self._lock:
            ordered = sorted(self._latencies)
            occupancy = (
                100.0 * self.rows_total / self.padded_rows_total
                if self.padded_rows_total
                else 0.0
            )
            return {
                "requests": float(self.requests_total),
                "rows": float(self.rows_total),
                "batches": float(self.batches_total),
                "batch_occupancy_pct": occupancy,
                "mean_rows_per_batch": (
                    self.rows_total / self.batches_total
                    if self.batches_total
                    else 0.0
                ),
                "latency_p50_ms": 1e3 * self._percentile(ordered, 0.50),
                "latency_p95_ms": 1e3 * self._percentile(ordered, 0.95),
                "latency_p99_ms": 1e3 * self._percentile(ordered, 0.99),
                "queue_depth": float(self.queue_depth),
                "rejected_total": float(self.rejected_total),
                "timeouts_total": float(self.timeouts_total),
                "batch_preempted_total": float(self.preempted_total),
            }
