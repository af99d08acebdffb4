"""RollbackMonitor: the serving-side tripwire behind the gate.

Counterpart of the JAX package's ``pipeline/rollback.py``.

The gate judges candidates OFFLINE (eval episodes on the eval seed); a
regression that only manifests under real serving conditions — latency
blowups from a pathological parameter pattern, a quality signal a
frontend computes, any number the fleet's ``/v1/metrics``-level
snapshot carries — needs a second, online line of defense. The monitor
samples one configured metric from a snapshot function (typically
``FleetRouter.snapshot`` in-process, or an HTTP ``GET /v1/metrics``
reader), establishes a baseline over the first samples after each
promotion, and trips after ``trip_after`` consecutive breaches of the
configured limit. Tripping is a SIGNAL — the supervisor owns the
demotion itself (retract + monotonicity-exempt pinned reload,
``pipeline/supervisor.py`` has the state machine).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional


class RollbackMonitor:
    """Watch one served metric; report when it regresses.

    Args:
      sample_fn: zero-arg callable returning a flat ``{name: float}``
        snapshot (``FleetRouter.snapshot()`` shape). Missing metric in a
        sample = the sample is skipped (a cold fleet has no latency
        percentiles yet).
      metric: key to watch.
      threshold: absolute limit; breach when the value crosses it in
        ``direction``. Takes precedence over ``ratio``.
      ratio: relative limit vs the post-promotion baseline (mean of the
        first ``baseline_samples`` observations): the limit sits
        ``|baseline| * (ratio - 1)`` away from the baseline in the
        breach ``direction`` — offset by magnitude, not multiplied, so
        negative-valued baselines (this env's episode returns are
        penalty sums) keep the limit on the breach side. Ratio > 1.
      direction: ``"above"`` for cost-like metrics (latency, error
        counts), ``"below"`` for quality-like metrics.
      baseline_samples: observations averaged into the baseline before
        breach checking starts (ignored with an absolute threshold).
      trip_after: consecutive breaches required — one noisy sample must
        not demote a healthy fleet.
    """

    def __init__(
        self,
        sample_fn: Callable[[], Dict[str, float]],
        metric: str,
        threshold: Optional[float] = None,
        ratio: Optional[float] = None,
        direction: str = "above",
        baseline_samples: int = 3,
        trip_after: int = 2,
    ) -> None:
        if direction not in ("above", "below"):
            raise ValueError(
                f"direction must be 'above' or 'below', got {direction!r}"
            )
        if threshold is None and ratio is None:
            raise ValueError(
                "RollbackMonitor needs an absolute threshold or a "
                "baseline ratio"
            )
        if ratio is not None and ratio <= 1.0:
            raise ValueError(f"ratio must be > 1, got {ratio}")
        self.sample_fn = sample_fn
        self.metric = metric
        self.threshold = threshold
        self.ratio = ratio
        self.direction = direction
        self.baseline_samples = max(1, int(baseline_samples))
        self.trip_after = max(1, int(trip_after))
        self._window: List[float] = []
        self.baseline: Optional[float] = None
        self.last_value: Optional[float] = None
        self._breaches = 0

    def reset(self) -> None:
        """Forget the baseline and breach streak — called after every
        promotion or rollback (a new checkpoint serves under a new
        normal)."""
        self._window = []
        self.baseline = None
        self._breaches = 0

    def limit(self) -> Optional[float]:
        """The current breach limit, or None while the baseline is
        still forming."""
        if self.threshold is not None:
            return self.threshold
        if self.baseline is None:
            return None
        # Offset by |baseline|, never multiply: baseline * ratio flips
        # to the WRONG side of a negative baseline (b=-10, ratio=1.5
        # puts the "above" limit at -15, below the baseline — every
        # healthy sample would breach).
        margin = abs(self.baseline) * (self.ratio - 1.0)
        return (
            self.baseline + margin
            if self.direction == "above"
            else self.baseline - margin
        )

    def observe(self) -> bool:
        """Take one sample; True when the regression streak trips."""
        try:
            value = self.sample_fn().get(self.metric)
        except Exception:  # noqa: BLE001 — a flaky sampler is not a
            # regression; the next sample decides.
            return False
        if value is None:
            return False
        value = float(value)
        self.last_value = value
        if self.threshold is None and self.baseline is None:
            self._window.append(value)
            if len(self._window) < self.baseline_samples:
                return False
            self.baseline = sum(self._window) / len(self._window)
            return False  # baseline sample, never a breach
        limit = self.limit()
        breached = (
            value > limit if self.direction == "above" else value < limit
        )
        self._breaches = self._breaches + 1 if breached else 0
        return self._breaches >= self.trip_after
