"""Traffic-replay load generator: drive a scheduler at production-like
load, measure req/s AT a latency target.

Counterpart of the JAX package's ``serving/loadgen.py``, the same code:
the same seed gives the same trace.

The smoke storms (smoke.py; the JAX package's fleet/smoke.py) are CLOSED-loop: each client
waits for its response before sending the next request, so measured
throughput self-limits to whatever the server sustains and the latency
tail never sees overload. Production traffic is OPEN-loop — arrivals
don't care how busy the server is — and the number capacity planning
needs is "max sustained request rate while p95 stays under the SLO",
not peak closed-loop req/s (the Podracer/JaxMARL throughput discipline,
applied to the serving side: report the rate you can HOLD, not the rate
you once touched).

This module provides:

- :class:`RequestTrace` — a replayable request stream: inter-arrival
  gaps, request sizes, SLO classes. Synthesize one from distributions
  (:func:`synthetic_trace`) or record/replay real traffic as JSONL
  (:func:`save_trace` / :func:`load_trace`). Traces are deterministic
  given a seed — the ladder autotuner (autotune.py) consumes the same
  trace the bench drives, so its decisions are reproducible.
- :class:`TraceRecorder` — a bounded ring the schedulers record LIVE
  arrivals into; its window replays through the same autotuner DP
  (serving/elastic) and dumps as the same JSONL
  (``serve_policy.py --record-trace``).
- :func:`run_load` — open-loop replay of a trace against anything with
  ``submit`` (scheduler or router): arrivals are scheduled on the trace
  clock regardless of completions; rejects/timeouts are counted, not
  retried (a retry storm would hide the overload the measurement
  exists to see).
- :func:`max_rate_at_slo` — bisection over offered rate: the highest
  rate whose replay holds ``p95 <= target`` with at most ``max_loss``
  of requests rejected/timed out (the JAX package's bench records it as
  ``serving_req_per_sec_at_p95_slo``).
"""

from __future__ import annotations

import dataclasses
import json
import threading
import time
from collections import deque
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from marl_distributedformation_tpu_torch.serving.scheduler import (
    BackpressureError,
    RequestTimeout,
)

# Size mix loosely shaped like interactive inference traffic: mostly
# single-row lookups, a tail of batched callers reaching into the big
# rungs. Weights are the knob — record a real trace when you have one.
DEFAULT_SIZE_MIX: Tuple[Tuple[int, float], ...] = (
    (1, 0.50),
    (4, 0.20),
    (16, 0.12),
    (64, 0.10),
    (256, 0.08),
)


@dataclasses.dataclass(frozen=True)
class RequestTrace:
    """A replayable request stream. ``inter_arrival_s[i]`` is the gap
    before request ``i``; ``sizes[i]`` its row count; ``slo_classes[i]``
    its admission class ("interactive"/"batch")."""

    inter_arrival_s: np.ndarray
    sizes: np.ndarray
    slo_classes: Tuple[str, ...]

    def __post_init__(self) -> None:
        n = len(self.sizes)
        if not (len(self.inter_arrival_s) == n == len(self.slo_classes)):
            raise ValueError(
                f"trace arrays disagree on length: {n} sizes, "
                f"{len(self.inter_arrival_s)} gaps, "
                f"{len(self.slo_classes)} classes"
            )

    def __len__(self) -> int:
        return len(self.sizes)

    @property
    def duration_s(self) -> float:
        return float(np.sum(self.inter_arrival_s))

    @property
    def offered_rps(self) -> float:
        d = self.duration_s
        return len(self) / d if d > 0 else 0.0

    def scaled_to_rate(self, rate_rps: float) -> "RequestTrace":
        """Same request sequence replayed at a different offered rate
        (gaps scaled uniformly) — how the SLO search sweeps rate
        without changing the size/class mix."""
        if rate_rps <= 0:
            raise ValueError(f"rate must be positive, got {rate_rps}")
        factor = self.offered_rps / rate_rps
        return dataclasses.replace(
            self, inter_arrival_s=self.inter_arrival_s * factor
        )


def synthetic_trace(
    duration_s: float,
    rate_rps: float,
    seed: int = 0,
    size_mix: Sequence[Tuple[int, float]] = DEFAULT_SIZE_MIX,
    batch_fraction: float = 0.0,
) -> RequestTrace:
    """Poisson arrivals at ``rate_rps`` for ``duration_s`` with sizes
    drawn from ``size_mix`` (``(rows, weight)`` pairs) and a
    ``batch_fraction`` share of batch-class requests. Deterministic in
    ``seed``."""
    rng = np.random.default_rng(seed)
    n = max(1, int(round(duration_s * rate_rps)))
    gaps = rng.exponential(1.0 / rate_rps, size=n)
    sizes_v = np.array([s for s, _ in size_mix], dtype=np.int64)
    weights = np.array([w for _, w in size_mix], dtype=np.float64)
    weights = weights / weights.sum()
    sizes = rng.choice(sizes_v, size=n, p=weights)
    classes = tuple(
        "batch" if rng.random() < batch_fraction else "interactive"
        for _ in range(n)
    )
    return RequestTrace(
        inter_arrival_s=gaps.astype(np.float64),
        sizes=sizes,
        slo_classes=classes,
    )


def save_trace(trace: RequestTrace, path: str | Path) -> None:
    """One JSONL line per request: ``{"dt": gap_s, "n": rows,
    "slo": class}`` — the recordable interchange format."""
    with open(path, "w") as f:
        for dt, n, slo in zip(
            trace.inter_arrival_s, trace.sizes, trace.slo_classes
        ):
            f.write(
                json.dumps({"dt": float(dt), "n": int(n), "slo": slo})
                + "\n"
            )


def load_trace(path: str | Path) -> RequestTrace:
    gaps: List[float] = []
    sizes: List[int] = []
    classes: List[str] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            gaps.append(float(rec["dt"]))
            sizes.append(int(rec["n"]))
            classes.append(str(rec.get("slo", "interactive")))
    if not sizes:
        raise ValueError(f"empty request trace: {path}")
    return RequestTrace(
        inter_arrival_s=np.asarray(gaps, np.float64),
        sizes=np.asarray(sizes, np.int64),
        slo_classes=tuple(classes),
    )


class TraceRecorder:
    """Bounded ring of LIVE arrivals, replayable as a
    :class:`RequestTrace`.

    The schedulers record every offered request (rows + SLO class,
    stamped at admission time) into one shared recorder; the elastic
    controller (serving/elastic) replays the recent window through the
    autotuner's exact DP, and ``serve_policy.py --record-trace`` dumps
    it as the same JSONL :func:`load_trace` reads back — closing the
    synthetic-only gap: the trace that retunes the fleet is the trace
    the fleet actually served.

    OFFERED load is what gets recorded — the sample lands before
    admission control, so backpressured requests still count (a retuner
    fed only the accepted stream would never see the overload it exists
    to fix). The ring is bounded (``capacity`` newest arrivals) and the
    record path is one lock + one deque append — cheap enough for the
    submit path.
    """

    def __init__(self, capacity: int = 4096) -> None:
        if capacity < 2:
            raise ValueError(
                f"capacity must allow at least one gap, got {capacity}"
            )
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        # (perf_counter arrival, rows, slo_class) newest-last.
        self._ring: "deque" = deque(maxlen=self.capacity)  # graftlock: guarded-by=_lock
        self._recorded_total = 0  # graftlock: guarded-by=_lock

    def record(
        self, rows: int, slo_class: str = "interactive"
    ) -> None:
        """One offered request (called by the schedulers at submit)."""
        now = time.perf_counter()
        with self._lock:
            self._ring.append((now, int(rows), str(slo_class)))
            self._recorded_total += 1

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    @property
    def recorded_total(self) -> int:
        """Arrivals ever recorded (the ring keeps only the newest)."""
        with self._lock:
            return self._recorded_total

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()

    def to_trace(self) -> Optional[RequestTrace]:
        """The ring as a replayable trace (None below two samples —
        one arrival has no gap to replay). The first gap is 0: the
        window starts at its own first arrival."""
        with self._lock:
            samples = list(self._ring)
        if len(samples) < 2:
            return None
        times = np.asarray([t for t, _, _ in samples], np.float64)
        gaps = np.diff(times, prepend=times[0])
        return RequestTrace(
            inter_arrival_s=gaps,
            sizes=np.asarray([n for _, n, _ in samples], np.int64),
            slo_classes=tuple(slo for _, _, slo in samples),
        )

    def save(self, path: str | Path) -> bool:
        """Dump the ring as replayable loadgen JSONL; False when there
        is not yet enough recorded traffic to form a trace."""
        trace = self.to_trace()
        if trace is None:
            return False
        save_trace(trace, path)
        return True


@dataclasses.dataclass
class LoadReport:
    """What one open-loop replay measured. ``per_size_p95_ms`` keys the
    p95 by request row count — how the sharded-vs-replicated bench
    isolates the big-rung latency from the mixed stream."""

    offered_rps: float
    duration_s: float
    submitted: int
    ok: int
    rejected: int
    timed_out: int
    failed: int
    p50_ms: float
    p95_ms: float
    p99_ms: float
    per_size_p95_ms: Dict[int, float] = dataclasses.field(
        default_factory=dict
    )

    @property
    def loss_fraction(self) -> float:
        bad = self.rejected + self.timed_out + self.failed
        return bad / self.submitted if self.submitted else 1.0

    def meets(self, p95_target_ms: float, max_loss: float) -> bool:
        """Did this replay hold the SLO? Requires completed traffic —
        an all-rejected replay has a vacuous p95."""
        return (
            self.ok > 0
            and self.p95_ms <= p95_target_ms
            and self.loss_fraction <= max_loss
        )

    def to_dict(self) -> Dict[str, object]:
        out = dataclasses.asdict(self)
        per_size = out.pop("per_size_p95_ms")
        out = {k: round(float(v), 6) for k, v in out.items()}
        out["loss_fraction"] = round(self.loss_fraction, 6)
        out["per_size_p95_ms"] = {
            str(k): round(float(v), 4) for k, v in per_size.items()
        }
        return out


def _percentile_ms(latencies_s: List[float], q: float) -> float:
    if not latencies_s:
        return 0.0
    ordered = sorted(latencies_s)
    idx = min(len(ordered) - 1, max(0, round(q * (len(ordered) - 1))))
    return 1e3 * ordered[int(idx)]


def run_load(
    target: Any,
    trace: RequestTrace,
    row_shape: Tuple[int, ...],
    deterministic: bool = True,
    timeout_s: float = 5.0,
    seed: int = 0,
    settle_timeout_s: float = 30.0,
) -> LoadReport:
    """Open-loop replay of ``trace`` against ``target.submit``.

    The replay loop walks the trace clock: each request is submitted at its
    scheduled arrival (sleeping ahead, submitting immediately when
    behind — lag never thins the offered load). Completion latencies
    are recorded by future callbacks; after the last submit the loop
    waits up to ``settle_timeout_s`` for stragglers. No retries: a
    reject is DATA here (the server saying "over capacity"), and
    retrying would re-offer the load the measurement is trying to
    price.
    """
    rng = np.random.default_rng(seed)
    # Pre-build one obs buffer per distinct size (outside the timed
    # replay: the generator must not rate-limit itself on allocation).
    obs_by_size = {
        int(n): rng.standard_normal(
            (int(n), *row_shape), dtype=np.float32
        )
        for n in np.unique(trace.sizes)
    }
    lock = threading.Lock()
    latencies: List[float] = []
    by_size: Dict[int, List[float]] = {}
    counts = {"ok": 0, "rejected": 0, "timed_out": 0, "failed": 0}
    pending = threading.Semaphore(0)
    submitted = 0

    def _on_done(t_submit: float, rows: int, fut: Any) -> None:
        exc = fut.exception()
        now = time.perf_counter()
        with lock:
            if exc is None:
                counts["ok"] += 1
                latencies.append(now - t_submit)
                by_size.setdefault(rows, []).append(now - t_submit)
            elif isinstance(exc, BackpressureError):
                counts["rejected"] += 1
            elif isinstance(exc, (RequestTimeout, TimeoutError)):
                counts["timed_out"] += 1
            else:
                counts["failed"] += 1
        pending.release()

    t0 = time.perf_counter()
    next_at = t0
    for gap, n, slo in zip(
        trace.inter_arrival_s, trace.sizes, trace.slo_classes
    ):
        next_at += float(gap)
        lag = next_at - time.perf_counter()
        if lag > 0:
            time.sleep(lag)
        t_submit = time.perf_counter()
        try:
            fut = target.submit(
                obs_by_size[int(n)],
                deterministic=deterministic,
                timeout_s=timeout_s,
                slo_class=slo,
            )
        except BackpressureError:
            with lock:
                counts["rejected"] += 1
            submitted += 1
            pending.release()
            continue
        except Exception:  # noqa: BLE001 — overload data, not a crash
            with lock:
                counts["failed"] += 1
            submitted += 1
            pending.release()
            continue
        submitted += 1
        fut.add_done_callback(
            lambda f, t=t_submit, rows=int(n): _on_done(t, rows, f)
        )
    # The offered window closes at the LAST SUBMIT: the settle wait
    # below is measurement bookkeeping, not offered load — folding it
    # into the denominator would understate offered_rps exactly on the
    # overloaded probes (slow completions, long settles) where the
    # rate matters most.
    elapsed = time.perf_counter() - t0
    # Wait for in-flight stragglers (bounded — a wedged server must not
    # wedge the measurement).
    settle_deadline = time.perf_counter() + settle_timeout_s
    for _ in range(submitted):
        remaining = settle_deadline - time.perf_counter()
        if remaining <= 0 or not pending.acquire(timeout=remaining):
            break
    with lock:
        lat = list(latencies)
        done = dict(counts)
        sized = {
            n: _percentile_ms(v, 0.95) for n, v in by_size.items()
        }
    unresolved = submitted - sum(done.values())
    done["failed"] += max(0, unresolved)
    return LoadReport(
        per_size_p95_ms=sized,
        offered_rps=submitted / elapsed if elapsed > 0 else 0.0,
        duration_s=elapsed,
        submitted=submitted,
        ok=done["ok"],
        rejected=done["rejected"],
        timed_out=done["timed_out"],
        failed=done["failed"],
        p50_ms=_percentile_ms(lat, 0.50),
        p95_ms=_percentile_ms(lat, 0.95),
        p99_ms=_percentile_ms(lat, 0.99),
    )


def max_rate_at_slo(
    target: Any,
    row_shape: Tuple[int, ...],
    p95_target_ms: float,
    lo_rps: float = 50.0,
    hi_rps: float = 3200.0,
    probe_duration_s: float = 1.0,
    iterations: int = 6,
    max_loss: float = 0.01,
    seed: int = 0,
    size_mix: Sequence[Tuple[int, float]] = DEFAULT_SIZE_MIX,
    batch_fraction: float = 0.0,
    probe_retries: int = 0,
) -> Tuple[float, List[LoadReport]]:
    """Bisect offered rate for the highest replay holding the p95 SLO.

    Doubles ``hi_rps`` upward first while the SLO still holds there (so
    a too-low initial bracket cannot understate capacity), then bisects
    ``iterations`` times. Returns ``(best_passing_rate, reports)``;
    best rate 0.0 means even ``lo_rps`` violated the target. The same
    ``seed`` derives every probe's trace, so the search is
    deterministic given the server's behavior.

    ``probe_retries`` re-runs a FAILING probe up to that many times and
    accepts any passing attempt. On a shared box the noise is one-sided
    — contention only ever makes latency worse — so a rate the server
    holds in any window is genuinely within capacity, while a quiet-
    window pass can never overstate it. Retries keep one CPU hiccup
    from collapsing the whole search to 0.0 at the first probe."""
    reports: List[LoadReport] = []

    def probe(rate: float) -> LoadReport:
        trace = synthetic_trace(
            probe_duration_s,
            rate,
            seed=seed,
            size_mix=size_mix,
            batch_fraction=batch_fraction,
        )
        rep = run_load(target, trace, row_shape, seed=seed)
        reports.append(rep)
        for _ in range(probe_retries):
            if rep.meets(p95_target_ms, max_loss):
                break
            retry = run_load(target, trace, row_shape, seed=seed)
            reports.append(retry)
            if retry.meets(p95_target_ms, max_loss) or (
                retry.p95_ms < rep.p95_ms and retry.ok
            ):
                rep = retry
        return rep

    if not probe(lo_rps).meets(p95_target_ms, max_loss):
        return 0.0, reports
    best = lo_rps
    # Grow the bracket: if the ceiling still passes, capacity is higher
    # than the caller guessed. Cap check FIRST — at the cap the loop
    # must not burn (and then discard) one more full replay.
    grows = 0
    while grows < 4 and probe(hi_rps).meets(p95_target_ms, max_loss):
        best = hi_rps
        lo_rps, hi_rps = hi_rps, hi_rps * 2.0
        grows += 1
    for _ in range(iterations):
        mid = 0.5 * (lo_rps + hi_rps)
        if probe(mid).meets(p95_target_ms, max_loss):
            best, lo_rps = mid, mid
        else:
            hi_rps = mid
    return best, reports
