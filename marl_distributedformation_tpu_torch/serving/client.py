"""In-process serving client: the caller-side contract in one place.

Counterpart of the JAX package's ``serving/client.py`` (its in-process
path). ``predict`` is deliberately SB3-shaped (obs in, actions out) so
code written against ``compat.policy.LoadedPolicy.predict`` ports by
changing one constructor. On top of the raw future API it adds the two
behaviors every well-behaved caller needs:

- **honor backpressure** — on :class:`BackpressureError` it sleeps a
  capped-exponential backoff floored at the server-priced
  ``retry_after_s`` and retries, up to ``max_retries`` times (opt-in —
  ``max_retries=0`` surfaces every reject), instead of hammering a full
  queue;
- **bounded waiting** — the future wait is capped by the request's own
  timeout plus the retry budget, so a caller can never hang on a dead
  server.

The client is duck-typed over its target: anything with ``submit`` /
``default_timeout_s`` works (``MicroBatchScheduler`` here). The JAX
client's HTTP endpoint mode (a base-URL string or a list of them) needs
the fleet frontend, which is not ported yet (ROADMAP A13): passing
endpoints raises ``ValueError``.
"""

from __future__ import annotations

import random
import time
from typing import Callable, Optional, Tuple

import numpy as np

from marl_distributedformation_tpu_torch.obs import new_trace_id
from marl_distributedformation_tpu_torch.serving.scheduler import (
    BackpressureError,
    ServedResult,
)


def backoff_s(
    attempt: int,
    retry_after_s: float,
    base_s: float = 0.05,
    cap_s: float = 2.0,
    jitter: Optional[Callable[[], float]] = None,
) -> float:
    """Capped-exponential backoff that honors the server's hint.

    The exponential leg ``base_s * 2**attempt`` is capped at ``cap_s``
    (a client must not end up sleeping minutes because it retried six
    times); the server-priced ``retry_after_s`` is a FLOOR, never capped
    — sleeping less than the server's own drain estimate guarantees
    another reject, which helps nobody. The exponential leg is what
    saves the server when its estimate is too optimistic: a queue that
    keeps rejecting at a tiny ``retry_after_s`` still sees this client
    back off harder every attempt.

    ``jitter`` (a zero-arg callable returning uniform [0, 1)) turns the
    exponential leg into FULL JITTER: the sleep becomes a random
    fraction of the capped-exponential delay, still floored at the
    server's ``retry_after_s``. Without it, a fleet-wide 429 or a
    failover storm synchronizes every client's clock — they all sleep
    the SAME deterministic delay and stampede back in lockstep, re-
    rejecting each other forever; spreading retries uniformly over the
    window drains the herd in one pass. ``None`` keeps the
    deterministic delay (single-caller tools, tests).
    """
    exp = min(cap_s, base_s * (2.0 ** attempt))
    if jitter is not None:
        exp *= jitter()
    return max(float(retry_after_s), exp)


class ServingClient:
    def __init__(
        self,
        scheduler: object,
        max_retries: int = 3,
        backoff_base_s: float = 0.05,
        backoff_cap_s: float = 2.0,
        jitter: bool = True,
        rng: Optional[random.Random] = None,
        default_timeout_s: float = 10.0,
    ) -> None:
        if isinstance(scheduler, (str, list, tuple)):
            raise ValueError(
                "HTTP endpoints need the fleet frontend, which is not ported "
                "yet (ROADMAP A13); pass a scheduler"
            )
        self.default_timeout_s = float(default_timeout_s)
        self.scheduler = scheduler
        self.max_retries = max_retries
        self.backoff_base_s = backoff_base_s
        self.backoff_cap_s = backoff_cap_s
        # Full-jitter retries ship ON: a fleet of clients hitting the
        # same 429 must spread over the backoff window, not stampede
        # back in sync (backoff_s docstring). ``rng`` is injectable so
        # the distribution is pinnable in tests.
        self.jitter = bool(jitter)
        self._rng = rng if rng is not None else random.Random()

    def predict(
        self,
        obs: np.ndarray,
        deterministic: bool = True,
        timeout_s: Optional[float] = None,
        trace_id: Optional[str] = None,
        slo_class: str = "interactive",
    ) -> Tuple[np.ndarray, int]:
        """Blocking predict; returns ``(actions, model_step)``.

        Raises ``RequestTimeout`` when the request's deadline passes,
        ``BackpressureError`` when the queue stayed full through every
        retry (a batch-class request preempted by interactive traffic
        surfaces the same way and is retried the same way)."""
        result = self.predict_full(
            obs, deterministic, timeout_s, trace_id, slo_class
        )
        return result.actions, result.model_step

    def predict_full(
        self,
        obs: np.ndarray,
        deterministic: bool = True,
        timeout_s: Optional[float] = None,
        trace_id: Optional[str] = None,
        slo_class: str = "interactive",
    ) -> ServedResult:
        wait_s = (
            timeout_s
            if timeout_s is not None
            else self.scheduler.default_timeout_s
        )
        # ONE trace ID for the whole logical request: minted here when
        # the caller has none, re-sent on every backpressure retry, so
        # the server-side batch spans of all attempts correlate to this
        # single predict call (the whole point of retry observability).
        trace_id = trace_id or new_trace_id()
        for attempt in range(self.max_retries + 1):
            try:
                future = self.scheduler.submit(
                    obs, deterministic=deterministic, timeout_s=timeout_s,
                    trace_id=trace_id, slo_class=slo_class,
                )
                # Slack over the request's own deadline: the scheduler
                # fails expired requests itself; this outer bound only
                # covers a wedged worker. BackpressureError can ALSO
                # arrive through the future (a fleet router failing a
                # request over onto replicas that are all full) — it
                # consumes retry budget exactly like a submit-time
                # reject.
                return future.result(timeout=wait_s + 5.0)
            except BackpressureError as e:
                if attempt == self.max_retries:
                    raise
                time.sleep(
                    backoff_s(
                        attempt,
                        e.retry_after_s,
                        self.backoff_base_s,
                        self.backoff_cap_s,
                        jitter=self._rng.random if self.jitter else None,
                    )
                )
        raise AssertionError("unreachable")  # pragma: no cover
