"""Smoke benchmark: drive a live scheduler with a mixed-size request
stream and report the serving numbers that matter (one JSON line).

Counterpart of the JAX package's ``serving/smoke.py``. Request rows are
standard-normal draws, as there; the scenario perturbation reads the
port's scenario registry.

Used by ``python -m marl_distributedformation_tpu_torch.serve --smoke``:
a handful of client threads submit observation batches whose sizes span
several rungs of the bucket ladder, so one run exercises coalescing,
padding, splitting, and the compile-once pin together. The report is a
flat dict — ``batch_occupancy_pct``, ``latency_p50_ms`` /
``latency_p95_ms`` / ``latency_p99_ms``, throughput, per-bucket compile
counts — ready to print as a single JSON line.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from marl_distributedformation_tpu_torch.serving.client import ServingClient
from marl_distributedformation_tpu_torch.serving.scheduler import (
    BackpressureError,
    MicroBatchScheduler,
    RequestTimeout,
)

# Sizes straddling the default 1/8/64/512 ladder: singles, a mid rung,
# one just past a rung boundary (worst-case padding), one large.
DEFAULT_SIZES = (1, 3, 8, 9, 40, 100)


def run_smoke_benchmark(
    scheduler: MicroBatchScheduler,
    row_shape: Tuple[int, ...],
    sizes: Sequence[int] = DEFAULT_SIZES,
    duration_s: float = 2.0,
    num_clients: int = 4,
    deterministic: bool = True,
    seed: int = 0,
    registry: Optional[object] = None,
    scenario: Optional[str] = None,
    scenario_severity: float = 1.0,
) -> Dict[str, float]:
    """Run ``num_clients`` request loops for ``duration_s`` seconds.

    Each client cycles through ``sizes`` (offset by its index so the
    in-flight mix stays heterogeneous) with observations drawn from a
    seeded RNG. Returns the merged report; raises nothing on
    backpressure/timeouts — they are part of what is being measured.

    ``scenario`` perturbs the request observations with the named
    scenario's *sensor-noise* magnitudes from the registry
    (``scenarios/registry.py``, scaled by ``scenario_severity``) — smoke
    the serving path on the same disturbed inputs a robustness eval
    feeds the policy (unknown names fail fast with the registry listing).
    """
    obs_sigma = obs_bias_scale = 0.0
    if scenario is not None:
        from marl_distributedformation_tpu_torch.scenarios import get_scenario

        spec = get_scenario(scenario)
        obs_sigma = float(spec.obs_noise_sigma) * float(scenario_severity)
        obs_bias_scale = float(spec.obs_bias) * float(scenario_severity)

    client = ServingClient(scheduler, max_retries=2)
    counts = {"ok": 0, "rejected": 0, "timed_out": 0}
    lock = threading.Lock()
    stop_at = time.perf_counter() + duration_s

    def loop(idx: int) -> None:
        rng = np.random.default_rng(seed + idx)
        if scenario is not None:
            # Constant per-client sensor bias (the layer's per-episode
            # bias). Drawn only under a scenario so scenario-free smokes
            # keep their seeded obs streams unchanged.
            bias = obs_bias_scale * rng.standard_normal(
                row_shape, dtype=np.float32
            )
        i = idx  # offset the size cycle per client
        while time.perf_counter() < stop_at:
            n = int(sizes[i % len(sizes)])
            i += 1
            obs = rng.standard_normal((n, *row_shape), dtype=np.float32)
            if scenario is not None:
                obs = obs + obs_sigma * rng.standard_normal(
                    obs.shape, dtype=np.float32
                ) + bias
            try:
                actions, _ = client.predict(
                    obs, deterministic=deterministic
                )
                assert actions.shape[0] == n
                with lock:
                    counts["ok"] += 1
            except BackpressureError:
                with lock:
                    counts["rejected"] += 1
            except RequestTimeout:
                with lock:
                    counts["timed_out"] += 1

    threads = [
        threading.Thread(target=loop, args=(i,), daemon=True)
        for i in range(num_clients)
    ]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=duration_s + 30.0)
    elapsed = time.perf_counter() - t0

    report = dict(scheduler.metrics.snapshot())
    report["duration_s"] = round(elapsed, 3)
    report["client_requests_ok"] = float(counts["ok"])
    report["client_rejected"] = float(counts["rejected"])
    report["client_timed_out"] = float(counts["timed_out"])
    report["requests_per_sec"] = (
        counts["ok"] / elapsed if elapsed > 0 else 0.0
    )
    report["rows_per_sec"] = (
        report["rows"] / elapsed if elapsed > 0 else 0.0
    )
    if scenario is not None:
        report["scenario"] = scenario
        report["scenario_severity"] = float(scenario_severity)
    for bucket, n in scheduler.engine.compile_counts().items():
        report[f"compiles_bucket_{bucket}"] = float(n)
    if registry is not None:
        report["model_swap_count"] = float(registry.swap_count)
        report["model_step"] = float(registry.active_step)
    return report
