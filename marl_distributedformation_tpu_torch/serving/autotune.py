"""Earn the ladder: pick bucket rungs + coalescing window from observed
traffic instead of guessing.

Counterpart of the JAX package's ``serving/autotune.py``, the same numpy
dynamic program: the same trace gives the same plan.

The serving ladder (1/8/64/512) and the 2 ms coalescing window were
hand-picked and never revisited — the classic way a serving
config rots. This module makes both *earned*: feed it the request-size
distribution and arrival rate of a :class:`~.loadgen.RequestTrace`
(synthetic or recorded) and it returns a :class:`LadderPlan`:

- **Rungs** by exact dynamic programming over the observed sizes:
  choose at most ``max_rungs`` bucket values (from the candidate set of
  observed sizes, rounded up to any mesh-divisibility constraint)
  minimizing total padded capacity — the direct cost model of the
  bucket ladder, where serving a size-``s`` request on rung ``b >= s``
  costs ``b`` rows of compute. The DP is exact and deterministic: the
  same trace always yields the same ladder (pinned by test — an
  autotuner that flaps on identical input would churn compiled rungs).
- **Coalescing window** from the arrival process: the window exists to
  fill batches, so it should be about the time a target batch takes to
  *arrive* at the observed rate — capped at a fraction of the p95
  budget (a window the size of the SLO would spend the whole budget
  waiting) and floored at zero.
- **Sharded split**: rungs at or above ``sharded_min_rows`` (when a
  mesh slice is available) are the sharded engine's ladder, the rest
  stay on the replicated single-device engines — the router's routing
  threshold falls out of the same plan.

The DP is pure — one trace in, one plan out — so the SAME plan shape
serves two callers: offline (a bench builds its engines from a plan
before traffic) and live (:func:`replay_recorder` replays the recent
recorded window; ``serving/elastic``'s controller lands the new plan at
the fleet batch barrier). A rung change
means new rung builds, paid before traffic, never on the request path.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from marl_distributedformation_tpu_torch.serving.loadgen import RequestTrace


@dataclasses.dataclass(frozen=True)
class LadderPlan:
    """An earned serving configuration, derived from one trace."""

    buckets: Tuple[int, ...]
    window_ms: float
    expected_occupancy_pct: float  # rows / padded capacity over the trace
    baseline_occupancy_pct: float  # same, on the ladder it replaces
    sharded_buckets: Tuple[int, ...]  # rungs the mesh slice should own
    replicated_buckets: Tuple[int, ...]
    observed_rps: float
    mean_rows_per_request: float
    # The dedicated lane's own coalescing window. 0.0 when every request
    # the router sends there already fills its smallest rung (the
    # min_rows floor >= the rung): the window exists to FILL batches
    # from mixed small arrivals, so a lane of pre-filled rungs waiting
    # is pure added latency.
    sharded_window_ms: float = 0.0

    def to_dict(self) -> Dict[str, object]:
        return {
            "buckets": list(self.buckets),
            "window_ms": round(self.window_ms, 3),
            "sharded_window_ms": round(self.sharded_window_ms, 3),
            "expected_occupancy_pct": round(
                self.expected_occupancy_pct, 2
            ),
            "baseline_occupancy_pct": round(
                self.baseline_occupancy_pct, 2
            ),
            "sharded_buckets": list(self.sharded_buckets),
            "replicated_buckets": list(self.replicated_buckets),
            "observed_rps": round(self.observed_rps, 2),
            "mean_rows_per_request": round(
                self.mean_rows_per_request, 3
            ),
        }


def _round_up(value: int, multiple: int) -> int:
    return ((value + multiple - 1) // multiple) * multiple


def padded_cost(sizes: np.ndarray, buckets: Sequence[int]) -> int:
    """Total padded rows a ladder spends serving ``sizes`` — the DP's
    objective, reusable as an evaluation metric for any ladder. Sizes
    above the top rung split into top-rung chunks plus a bucketed
    remainder, mirroring ``BucketedPolicyEngine.plan``."""
    ladder = sorted(set(int(b) for b in buckets))
    top = ladder[-1]
    total = 0
    for s in np.asarray(sizes, np.int64):
        s = int(s)
        total += (s // top) * top
        rest = s % top
        if rest:
            total += next(b for b in ladder if rest <= b)
    return total


def choose_buckets(
    sizes: np.ndarray,
    max_rungs: int = 4,
    divisor: int = 1,
    min_top: Optional[int] = None,
) -> Tuple[int, ...]:
    """Exact minimal-padded-cost ladder of at most ``max_rungs`` rungs.

    Candidates are the observed sizes rounded up to ``divisor``
    multiples (a sharded rung must divide by the mesh's dp width);
    ``min_top`` forces the top rung to at least that value (so a trace
    with no giant requests still keeps headroom for one). Exact DP:
    ``cost[j][k]`` = minimal padded rows covering the smallest ``j``
    candidate sizes with ``k`` rungs, the k-th being candidate ``j``.
    Deterministic — ties resolve to the first (smallest) candidate.
    """
    sizes = np.asarray(sizes, np.int64)
    if sizes.size == 0:
        raise ValueError("cannot tune a ladder from an empty trace")
    if max_rungs < 1:
        raise ValueError(f"need at least one rung, got {max_rungs}")
    divisor = max(1, int(divisor))
    rounded = np.array(
        [_round_up(int(s), divisor) for s in sizes], np.int64
    )
    cands, counts = np.unique(rounded, return_counts=True)
    if min_top is not None and cands[-1] < min_top:
        top = _round_up(int(min_top), divisor)
        cands = np.append(cands, top)
        counts = np.append(counts, 0)
    m = len(cands)
    k_max = min(max_rungs, m)
    # weight[i] = requests whose rounded size is cands[i]; covering
    # cands[(i..j]] with rung cands[j] costs cands[j] * sum(weights).
    prefix = np.concatenate([[0], np.cumsum(counts)])
    INF = float("inf")
    cost = [[INF] * (k_max + 1) for _ in range(m)]
    parent: List[List[Optional[int]]] = [
        [None] * (k_max + 1) for _ in range(m)
    ]
    for j in range(m):
        cost[j][1] = int(cands[j]) * int(prefix[j + 1])
    for k in range(2, k_max + 1):
        for j in range(k - 1, m):
            for i in range(k - 2, j):
                c = cost[i][k - 1] + int(cands[j]) * int(
                    prefix[j + 1] - prefix[i + 1]
                )
                if c < cost[j][k]:
                    cost[j][k] = c
                    parent[j][k] = i
    best_k = min(
        range(1, k_max + 1), key=lambda k: (cost[m - 1][k], k)
    )
    rungs: List[int] = []
    j: Optional[int] = m - 1
    k = best_k
    while j is not None and k >= 1:
        rungs.append(int(cands[j]))
        j = parent[j][k]
        k -= 1
    return tuple(sorted(rungs))


def choose_window_ms(
    rate_rps: float,
    mean_rows_per_request: float,
    fill_rows: int,
    p95_target_ms: float,
    max_fraction_of_slo: float = 0.2,
) -> float:
    """Coalescing window: time for ``fill_rows`` rows to ARRIVE at the
    observed rate, capped at ``max_fraction_of_slo`` of the p95 budget.
    At high rates the window collapses toward zero (batches fill from
    backlog alone); at low rates the cap keeps latency honest — an
    empty server must not hold a lone request hostage to fill a rung."""
    if rate_rps <= 0 or mean_rows_per_request <= 0:
        return max_fraction_of_slo * p95_target_ms
    t_fill_ms = 1e3 * fill_rows / (rate_rps * mean_rows_per_request)
    return max(0.0, min(t_fill_ms, max_fraction_of_slo * p95_target_ms))


def autotune_ladder(
    trace: RequestTrace,
    p95_target_ms: float,
    max_rungs: int = 4,
    mesh_divisor: int = 1,
    sharded_min_rows: Optional[int] = None,
    baseline_buckets: Sequence[int] = (1, 8, 64, 512),
    fill_fraction: float = 0.5,
) -> LadderPlan:
    """One trace in, one :class:`LadderPlan` out (module docstring).

    ``mesh_divisor`` is the dp width rungs above ``sharded_min_rows``
    must divide (the sharded engine's constraint); ``fill_fraction``
    sizes the coalescing target as a share of the smallest big rung (a
    window that reliably half-fills the rung it feeds is already deep
    into the batching win, without waiting for the perfect batch)."""
    sizes = np.asarray(trace.sizes, np.int64)
    split_at = (
        sharded_min_rows
        if sharded_min_rows is not None
        else max(int(sizes.max()) // 8, int(np.median(sizes)) + 1)
    )
    # Small rungs are unconstrained; rungs at/above the sharded split
    # must divide the mesh. Tune them jointly (one cost model), then
    # split the ladder for the two engine kinds.
    small = sizes[sizes < split_at]
    big = sizes[sizes >= split_at]
    rungs: List[int] = []
    if small.size:
        small_rungs = max(1, max_rungs - (1 if big.size else 0))
        rungs.extend(
            choose_buckets(small, max_rungs=small_rungs, divisor=1)
        )
    if big.size:
        big_rungs = max(1, max_rungs - len(rungs))
        rungs.extend(
            choose_buckets(
                big, max_rungs=big_rungs, divisor=max(1, mesh_divisor)
            )
        )
    buckets = tuple(sorted(set(rungs)))
    sharded = tuple(b for b in buckets if big.size and b >= split_at)
    replicated = tuple(b for b in buckets if b not in sharded)
    total_rows = int(sizes.sum())
    tuned_cost = padded_cost(sizes, buckets)
    base_cost = padded_cost(sizes, baseline_buckets)
    mean_rows = float(sizes.mean())
    fill_rows = max(
        1, int(fill_fraction * (min(sharded) if sharded else max(buckets)))
    )
    window_ms = choose_window_ms(
        trace.offered_rps, mean_rows, fill_rows, p95_target_ms
    )
    # Routing floor = the sharded split point; when it fills the slice's
    # smallest rung on arrival, the lane has nothing to coalesce. Only a
    # floor BELOW the rung (partial-rung requests pad up) re-earns the
    # global window.
    sharded_window_ms = (
        window_ms if sharded and split_at < min(sharded) else 0.0
    )
    return LadderPlan(
        buckets=buckets,
        window_ms=window_ms,
        expected_occupancy_pct=(
            100.0 * total_rows / tuned_cost if tuned_cost else 0.0
        ),
        baseline_occupancy_pct=(
            100.0 * total_rows / base_cost if base_cost else 0.0
        ),
        sharded_buckets=sharded,
        replicated_buckets=replicated,
        observed_rps=trace.offered_rps,
        mean_rows_per_request=mean_rows,
        sharded_window_ms=sharded_window_ms,
    )


def replay_recorder(
    recorder: "object",
    p95_target_ms: float,
    min_requests: int = 64,
    **autotune_kwargs: object,
) -> Optional[LadderPlan]:
    """The incremental live entrypoint: replay a
    :class:`~.loadgen.TraceRecorder`'s recent window through the exact
    same DP. Returns None below ``min_requests`` recorded arrivals — a
    ladder re-derived from a handful of requests would flap, and every
    flap costs prewarm compiles."""
    if len(recorder) < max(2, int(min_requests)):  # type: ignore[arg-type]
        return None
    trace = recorder.to_trace()  # type: ignore[attr-defined]
    if trace is None:
        return None
    return autotune_ladder(trace, p95_target_ms, **autotune_kwargs)


def plans_equivalent(
    a: Optional[LadderPlan],
    b: Optional[LadderPlan],
    window_tol_ms: float = 1.0,
) -> bool:
    """Hysteresis predicate: two plans that would build the same
    engines (same rung ladders, same sharded split, windows within
    ``window_tol_ms``) are the same capacity decision — re-splitting
    between them would pay prewarm compiles and a barrier pause to
    change nothing."""
    if a is None or b is None:
        return a is b
    return (
        a.replicated_buckets == b.replicated_buckets
        and a.sharded_buckets == b.sharded_buckets
        and abs(a.window_ms - b.window_ms) <= window_tol_ms
        and abs(a.sharded_window_ms - b.sharded_window_ms)
        <= window_tol_ms
    )
