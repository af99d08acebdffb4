"""Tenant smoke storm: the multi-tenant acceptance evidence in one report.

Counterpart of the JAX package's ``serving/tenancy/smoke.py``. The fleet
smoke (serving/fleet/smoke.py) proves routing + failover +
global step monotonicity for ONE model; this storm drives EVERY lane of
a :class:`~.fleet.TenantFleet` at once and reports the three numbers
that define tenant isolation:

- ``tenant_isolation_p95_ratio`` — each quiet lane's interactive p95
  during a batch storm on ANOTHER lane, over its own pre-storm
  baseline p95 (the worst such ratio across quiet lanes). Per-lane
  admission means a storm on lane A costs lane B queueing NOTHING —
  the ratio should stay near 1, and the quiet lanes must see zero
  rejections.
- ``model_{id}__step_monotonic_violations`` — per-LANE step
  monotonicity in response completion order, recorded via the
  router's ``on_result`` hook (inside the serving replica's
  batch-barrier region, so the log provably orders against lane
  swaps). Each lane is monotonic independently; a mid-storm swap of
  one lane must not wiggle any other lane's steps.
- ``shared_rung_compiles`` — the executable-sharing census:
  the most builds (captures on the card) a (arch, rung) across every
  replica. <= 1 everywhere means N same-arch lanes rode one set of
  captured rungs and each distinct arch paid exactly its own budget-1
  build.

``mid_storm`` is the chaos hook, fired once during the storm phase on
its own thread — the e2e test lands a one-lane coordinated swap there.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import TimeoutError as FutureTimeoutError
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from marl_distributedformation_tpu_torch.serving.scheduler import (
    BackpressureError,
    RequestTimeout,
)
from marl_distributedformation_tpu_torch.serving.smoke import DEFAULT_SIZES


class _LaneLog:
    """One lane's storm bookkeeping (lock-shared across its clients)."""

    def __init__(self) -> None:
        self.lock = threading.Lock()
        self.ok = 0
        self.rejected = 0
        self.timed_out = 0
        self.failed = 0
        self.latencies_baseline: List[float] = []
        self.latencies_storm: List[float] = []
        self.completion_steps: List[int] = []

    def record_step(self, result: Any) -> None:
        with self.lock:
            self.completion_steps.append(int(result.model_step))

    def monotonic_violations(self) -> int:
        violations, high = 0, None
        for step in self.completion_steps:
            if high is not None and step < high:
                violations += 1
            high = step if high is None else max(high, step)
        return violations


def _p95(samples: Sequence[float]) -> float:
    ordered = sorted(samples)
    if not ordered:
        return 0.0
    idx = min(len(ordered) - 1, int(round(0.95 * (len(ordered) - 1))))
    return ordered[idx]


def run_tenant_smoke(
    fleet: Any,
    sizes: Sequence[int] = DEFAULT_SIZES,
    duration_s: float = 2.0,
    clients_per_lane: int = 2,
    storm_lane: Optional[str] = None,
    storm_clients: int = 4,
    deterministic: bool = True,
    seed: int = 0,
    mid_storm: Optional[Callable[[], None]] = None,
    mid_storm_at_s: float = 0.25,
    warmup: bool = True,
    row_pools: Optional[Dict[str, np.ndarray]] = None,
) -> Dict[str, Any]:
    """Drive every lane concurrently; when ``storm_lane`` is set, run a
    baseline phase (all lanes interactive) then a storm phase (the same
    traffic plus ``storm_clients`` batch loops hammering that one lane)
    and report the isolation ratio between them. Rejections and
    timeouts are measured, not raised. ``row_pools`` (``model_id`` ->
    ``(P, *row_shape)``) serves a lane's rows as a slice of real
    observations at a random offset instead of Gaussian rows (a k-NN
    row carries its neighbors' indices, which Gaussian rows would not)."""
    if warmup:
        fleet.warmup()
    logs: Dict[str, _LaneLog] = {mid: _LaneLog() for mid in fleet.lane_ids}
    row_shape = {
        spec.model_id: spec.row_shape for spec in fleet.directory.lanes()
    }
    stop_at = [0.0]  # rebound per phase; clients read through the cell

    def loop(
        mid: str,
        idx: int,
        slo_class: str,
        sink: Callable[[_LaneLog, float], None],
    ) -> None:
        log = logs[mid]
        rng = np.random.default_rng(seed + 7919 * idx)
        i = idx
        while time.perf_counter() < stop_at[0]:
            n = int(sizes[i % len(sizes)])
            i += 1
            pool = (row_pools or {}).get(mid)
            if pool is None:
                obs = rng.standard_normal(
                    (n, *row_shape[mid]), dtype=np.float32
                )
            else:
                start = int(rng.integers(0, len(pool) - n + 1))
                obs = pool[start:start + n]
            t0 = time.perf_counter()
            try:
                future = fleet.submit(
                    obs,
                    deterministic=deterministic,
                    on_result=log.record_step,
                    slo_class=slo_class,
                    model_id=mid,
                )
                future.result(timeout=fleet.default_timeout_s + 5.0)
            except BackpressureError as e:
                with log.lock:
                    log.rejected += 1
                time.sleep(min(0.05, e.retry_after_s))
                continue
            except (RequestTimeout, TimeoutError, FutureTimeoutError):
                with log.lock:
                    log.timed_out += 1
                continue
            except Exception:  # noqa: BLE001 — measured, not raised
                with log.lock:
                    log.failed += 1
                continue
            with log.lock:
                log.ok += 1
                sink(log, time.perf_counter() - t0)

    def run_phase(
        phase_s: float,
        sink: Callable[[_LaneLog, float], None],
        storm: bool,
    ) -> float:
        threads = [
            threading.Thread(
                target=loop, args=(mid, c, "interactive", sink),
                daemon=True,
            )
            for mid in fleet.lane_ids
            for c in range(clients_per_lane)
        ]
        if storm:
            threads.extend(
                threading.Thread(
                    target=loop,
                    args=(
                        storm_lane,
                        clients_per_lane + c,
                        "batch",
                        sink,
                    ),
                    daemon=True,
                )
                for c in range(storm_clients)
            )
        chaos = None
        if storm and mid_storm is not None:

            def _chaos() -> None:
                time.sleep(mid_storm_at_s)
                mid_storm()

            chaos = threading.Thread(target=_chaos, daemon=True)
        t0 = time.perf_counter()
        stop_at[0] = t0 + phase_s
        for t in threads:
            t.start()
        if chaos is not None:
            chaos.start()
        for t in threads:
            t.join(timeout=phase_s + 30.0)
        if chaos is not None:
            chaos.join(timeout=30.0)
        return time.perf_counter() - t0

    if storm_lane is not None:
        if storm_lane not in logs:
            raise ValueError(
                f"storm_lane {storm_lane!r} is not a declared lane: "
                f"{sorted(logs)}"
            )
        baseline_s = run_phase(
            duration_s / 2,
            lambda log, dt: log.latencies_baseline.append(dt),
            storm=False,
        )
        storm_s = run_phase(
            duration_s / 2,
            lambda log, dt: log.latencies_storm.append(dt),
            storm=True,
        )
        elapsed = baseline_s + storm_s
    else:
        elapsed = run_phase(
            duration_s,
            lambda log, dt: log.latencies_baseline.append(dt),
            storm=False,
        )

    report: Dict[str, Any] = dict(fleet.snapshot())
    report["duration_s"] = round(elapsed, 3)
    total_ok = 0
    for mid, log in logs.items():
        total_ok += log.ok
        report[f"model_{mid}__requests_ok"] = float(log.ok)
        report[f"model_{mid}__rejected"] = float(log.rejected)
        report[f"model_{mid}__timed_out"] = float(log.timed_out)
        report[f"model_{mid}__failed"] = float(log.failed)
        report[f"model_{mid}__requests_per_sec"] = (
            log.ok / elapsed if elapsed > 0 else 0.0
        )
        report[f"model_{mid}__latency_p95_ms"] = 1e3 * _p95(
            log.latencies_baseline + log.latencies_storm
        )
        report[f"model_{mid}__step_monotonic_violations"] = float(
            log.monotonic_violations()
        )
        if log.completion_steps:
            report[f"model_{mid}__step_min"] = float(
                min(log.completion_steps)
            )
            report[f"model_{mid}__step_max"] = float(
                max(log.completion_steps)
            )
    report["requests_per_sec_fleet"] = (
        total_ok / elapsed if elapsed > 0 else 0.0
    )
    if storm_lane is not None:
        # Worst quiet-lane degradation: storm-phase p95 over its own
        # baseline p95. Floored at one scheduler window so a
        # near-zero baseline can't turn measurement noise into a
        # scary ratio.
        floor_s = 2e-3
        worst = 1.0
        for mid, log in logs.items():
            if mid == storm_lane:
                continue
            base = max(_p95(log.latencies_baseline), floor_s)
            storm_p95 = max(_p95(log.latencies_storm), floor_s)
            worst = max(worst, storm_p95 / base)
        report["tenant_isolation_p95_ratio"] = worst
        report["storm_lane"] = storm_lane
    shared = fleet.shared_rung_compiles()
    report["shared_rung_compiles"] = dict(shared)
    report["max_shared_rung_compiles"] = float(
        max(shared.values()) if shared else 0.0
    )
    return report
