"""Fleet smoke storm: mixed-size request traffic across every replica,
with the acceptance evidence in one flat report.

Counterpart of the JAX package's ``serving/fleet/smoke.py``, the same code
over the port's router; ``max_compiles_per_rung`` counts builds (a CUDA
graph capture a rung a replica on the card).

The single-engine smoke (serving/smoke.py) proves coalescing + padding +
compile-once on ONE engine; this storm drives the same mixed-size
request stream through the ROUTER so the fleet-only behaviors are what
gets exercised: routing across replicas, fleet backpressure, failover,
and — because every client records ``(completion order, model_step)``
into one shared log — the global step-monotonicity contract of the
coordinated hot swap.

The report is bench.py's one-JSON-line shape:

- ``requests_per_sec_fleet`` / merged latency percentiles — the fleet
  throughput headline.
- ``max_compiles_per_rung`` + per-replica ``replica{i}_compiles_bucket_{b}``
  — the RetraceGuard receipts: a storm of arbitrary sizes over N
  replicas must cost at most one compile per rung per replica, ever.
- ``step_monotonic_violations`` — count of responses whose
  ``model_step`` was lower than one already completed anywhere in the
  fleet. Zero is the coordinated-reload contract (reload.py).
- routed / rejected / failed-over / healthy-replica counters from
  ``FleetMetrics``.

``mid_storm`` is the chaos hook: a callable invoked once at
``mid_storm_at_s`` on its own thread — tests and the CLI use it to kill
a replica or land a coordinated swap while traffic flows.
"""

from __future__ import annotations

import threading
import time

# A wedged-worker wait counts as a timeout, not a failure, whichever
# TimeoutError class the interpreter raises.
from concurrent.futures import TimeoutError as FutureTimeoutError
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np

from marl_distributedformation_tpu_torch.serving.fleet.router import FleetRouter
from marl_distributedformation_tpu_torch.serving.scheduler import (
    BackpressureError,
    RequestTimeout,
)
from marl_distributedformation_tpu_torch.serving.smoke import DEFAULT_SIZES


def warmup_fleet(
    router: FleetRouter, row_shape: Tuple[int, ...]
) -> None:
    """Build every rung of every replica once, before any traffic: on the
    card each rung's first dispatch captures its CUDA graph, one replica
    after another (a sharded replica's rung captures one graph a row
    block of its slice). Call it before the schedulers start; a capture during
    traffic would be a rebuild, which the budget-1 ``RetraceGuard``
    refuses (and the router then breaks that replica).

    Uses each replica's REGISTRY params, the snapshot the scheduler
    dispatches with, so the first served batch copies nothing."""
    for r in router.replicas:
        params, _ = r.registry.active()
        for bucket in r.engine.buckets:
            r.engine.act(
                np.zeros((bucket, *row_shape), np.float32),
                deterministic=True,
                nn_params=params,
            )


def run_fleet_smoke(
    router: FleetRouter,
    row_shape: Tuple[int, ...],
    sizes: Sequence[int] = DEFAULT_SIZES,
    duration_s: float = 2.0,
    num_clients: int = 4,
    deterministic: bool = True,
    seed: int = 0,
    coordinator: Optional[object] = None,
    mid_storm: Optional[Callable[[], None]] = None,
    mid_storm_at_s: float = 0.5,
    warmup: bool = True,
    row_pool: Optional[np.ndarray] = None,
    log: Optional[dict] = None,
) -> Dict[str, float]:
    """Drive ``num_clients`` request loops through the router for
    ``duration_s`` seconds; returns the merged fleet report. Rejections
    and timeouts are measured, not raised. ``warmup`` builds every
    rung on every replica so the storm measures serving, not the builds.

    ``row_pool`` (``(P, *row_shape)``) serves each request's rows as a
    slice of real observations at a random offset instead of Gaussian
    rows. A ``log`` dict receives the invariant checkers' inputs:
    ``"steps"``, ``(t, model_step)`` in completion order
    (``chaos.check_step_monotonic``), and ``"outcomes"``, one
    ``{"ok", "error", "hung"}`` an accepted request
    (``chaos.check_no_request_lost``; hung: its future did not resolve
    within the router's timeout and slack)."""
    if warmup:
        warmup_fleet(router, row_shape)
    counts = {"ok": 0, "rejected": 0, "timed_out": 0, "failed": 0}
    lock = threading.Lock()
    # One global completion log of model_steps in response completion
    # order — the monotonicity witness. Recorded via the router's
    # ``on_result`` hook, which runs INSIDE the serving replica's
    # batch-barrier region: the append provably precedes any later
    # coordinated swap, so the log cannot be reordered by a client
    # thread preempted between resolution and its own bookkeeping.
    completion_steps: list = []
    samples: list = []
    outcomes: list = []

    def record(result) -> None:
        with lock:
            completion_steps.append(int(result.model_step))
            samples.append((time.perf_counter(), int(result.model_step)))

    def rows(rng, n: int) -> np.ndarray:
        if row_pool is None:
            return rng.standard_normal((n, *row_shape), dtype=np.float32)
        start = int(rng.integers(0, len(row_pool) - n + 1))
        return row_pool[start:start + n]

    stop_at = time.perf_counter() + duration_s

    def loop(idx: int) -> None:
        rng = np.random.default_rng(seed + idx)
        i = idx  # offset the size cycle per client
        while time.perf_counter() < stop_at:
            n = int(sizes[i % len(sizes)])
            i += 1
            obs = rows(rng, n)
            try:
                future = router.submit(
                    obs, deterministic=deterministic, on_result=record
                )
            except BackpressureError as e:
                with lock:
                    counts["rejected"] += 1
                time.sleep(min(0.05, e.retry_after_s))
                continue
            except Exception as e:  # noqa: BLE001 — incl. NoHealthyReplicas
                # Measured, not raised: a storm's job is to report what
                # the fleet did under fire, including the failures.
                with lock:
                    counts["failed"] += 1
                continue
            # Accepted: from here the request must resolve.
            try:
                result = future.result(
                    timeout=router.default_timeout_s + 5.0
                )
            except RequestTimeout as e:  # typed: the deadline passed
                with lock:
                    counts["timed_out"] += 1
                    outcomes.append(
                        {"ok": False, "error": repr(e), "hung": False})
                continue
            except BackpressureError as e:
                # A failover onto replicas that are all full.
                with lock:
                    counts["rejected"] += 1
                    outcomes.append(
                        {"ok": False, "error": repr(e), "hung": False})
                time.sleep(min(0.05, e.retry_after_s))
                continue
            except (TimeoutError, FutureTimeoutError) as e:
                # The wait ran out: hung unless it resolved meanwhile.
                with lock:
                    counts["timed_out"] += 1
                    outcomes.append({"ok": False, "error": repr(e),
                                     "hung": not future.done()})
                continue
            except Exception as e:  # noqa: BLE001
                with lock:
                    counts["failed"] += 1
                    outcomes.append(
                        {"ok": False, "error": repr(e), "hung": False})
                continue
            assert result.actions.shape[0] == n
            with lock:
                counts["ok"] += 1
                outcomes.append({"ok": True, "error": None, "hung": False})

    threads = [
        threading.Thread(target=loop, args=(i,), daemon=True)
        for i in range(num_clients)
    ]
    chaos = None
    if mid_storm is not None:

        def _chaos() -> None:
            time.sleep(mid_storm_at_s)
            mid_storm()

        chaos = threading.Thread(target=_chaos, daemon=True)
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    if chaos is not None:
        chaos.start()
    for t in threads:
        t.join(timeout=duration_s + 30.0)
    if chaos is not None:
        chaos.join(timeout=30.0)
    elapsed = time.perf_counter() - t0

    report = dict(router.snapshot())
    report["duration_s"] = round(elapsed, 3)
    report["client_requests_ok"] = float(counts["ok"])
    report["client_rejected"] = float(counts["rejected"])
    report["client_timed_out"] = float(counts["timed_out"])
    report["client_failed"] = float(counts["failed"])
    report["requests_per_sec_fleet"] = (
        counts["ok"] / elapsed if elapsed > 0 else 0.0
    )
    # Step monotonicity over the global completion order: a violation is
    # any response carrying a step older than one already returned.
    violations = 0
    high = None
    for step in completion_steps:
        if high is not None and step < high:
            violations += 1
        high = step if high is None else max(high, step)
    report["step_monotonic_violations"] = float(violations)
    if completion_steps:
        report["model_step_min"] = float(min(completion_steps))
        report["model_step_max"] = float(max(completion_steps))
    max_compiles = 0
    for r in router.replicas:
        for bucket, count in r.engine.compile_counts().items():
            report[f"replica{r.index}_compiles_bucket_{bucket}"] = float(
                count
            )
            max_compiles = max(max_compiles, count)
    report["max_compiles_per_rung"] = float(max_compiles)
    if log is not None:
        log["steps"] = samples
        log["outcomes"] = outcomes
    if coordinator is not None:
        report["fleet_swap_count"] = float(coordinator.swap_count)
        report["fleet_step"] = float(coordinator.fleet_step)
    return report
