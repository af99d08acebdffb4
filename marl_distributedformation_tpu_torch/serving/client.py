"""Serving client: the caller-side contract in one place.

Counterpart of the JAX package's ``serving/client.py``. ``predict`` is deliberately SB3-shaped (obs in, actions out) so
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
``default_timeout_s`` works, the surface ``MicroBatchScheduler`` and
``fleet.FleetRouter`` share — the same client code talks to one engine or
a whole fleet.

**HTTP endpoints**: the target may instead be a base-URL string (or a LIST
of them — several frontends). The client then speaks the fleet
frontend's ``POST /v1/act`` protocol with client-side failover:
connection errors and 5xx answers rotate to the next endpoint, drawing
from the SAME capped full-jitter retry budget as backpressure (a 429
sleeps the backoff floored at the server's ``retry_after_s``).
"""

from __future__ import annotations

import http.client
import json
import random
import time
import urllib.parse
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np

from marl_distributedformation_tpu_torch.obs import TRACE_HEADER, new_trace_id
from marl_distributedformation_tpu_torch.serving.scheduler import (
    BackpressureError,
    RequestTimeout,
    ServedResult,
)

MAX_RESPONSE_BYTES = 16 * 1024 * 1024


def post_json(
    base_url: str,
    path: str,
    body: bytes,
    headers: Optional[Dict[str, str]] = None,
    timeout_s: float = 5.0,
):
    """One ``POST {base_url}{path}`` with a JSON body. Returns ``(status,
    payload, response_headers)``; an unparseable body becomes
    ``{"error": <its start>}``. Transport failures propagate raw
    (``OSError`` / ``http.client.HTTPException``)."""
    parsed = urllib.parse.urlsplit(base_url)
    conn = http.client.HTTPConnection(
        parsed.hostname, parsed.port, timeout=timeout_s
    )
    try:
        conn.request(
            "POST", path, body=body,
            headers={"Content-Type": "application/json", **(headers or {})},
        )
        resp = conn.getresponse()
        raw = resp.read(MAX_RESPONSE_BYTES)
        try:
            payload = json.loads(raw) if raw else {}
        except ValueError:
            payload = {"error": raw[:200].decode("utf-8", "replace")}
        return resp.status, payload, resp.headers
    finally:
        conn.close()


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
        scheduler: Union[object, str, List[str]],
        max_retries: int = 3,
        backoff_base_s: float = 0.05,
        backoff_cap_s: float = 2.0,
        jitter: bool = True,
        rng: Optional[random.Random] = None,
        default_timeout_s: float = 10.0,
    ) -> None:
        # A base-URL string (or a list of them) selects HTTP mode.
        self._endpoints: Optional[List[str]] = None
        if isinstance(scheduler, str):
            self._endpoints = [scheduler.rstrip("/")]
        elif isinstance(scheduler, (list, tuple)):
            if not scheduler:
                raise ValueError("need at least one endpoint URL")
            bad = [e for e in scheduler if not isinstance(e, str)]
            if bad:
                raise TypeError(
                    f"endpoint list must be base-URL strings; got {bad[0]!r}"
                )
            self._endpoints = [e.rstrip("/") for e in scheduler]
        self._endpoint_idx = 0
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
        if self._endpoints is not None:
            return self._predict_http(
                obs, deterministic, timeout_s, trace_id, slo_class
            )
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

    # -- HTTP endpoint mode ----------------------------------------------

    def _predict_http(
        self,
        obs: np.ndarray,
        deterministic: bool,
        timeout_s: Optional[float],
        trace_id: Optional[str],
        slo_class: str,
    ) -> ServedResult:
        """``POST /v1/act`` against the endpoint list with client-side
        failover. One retry budget covers everything: a 429 consumes an
        attempt and sleeps the jittered backoff floored at the server's
        hint; a connection error or a 5xx consumes an attempt and ROTATES
        to the next endpoint; a 400 or 504 is the caller's own outcome and
        raises at once (``ValueError``, ``RequestTimeout``)."""
        wait_s = timeout_s if timeout_s is not None else self.default_timeout_s
        trace_id = trace_id or new_trace_id()
        body = json.dumps({
            "obs": np.asarray(obs, np.float32).tolist(),
            "deterministic": bool(deterministic),
            "timeout_s": wait_s,
            "slo_class": slo_class,
        }).encode()
        last_error: Optional[Exception] = None
        for attempt in range(self.max_retries + 1):
            url = self._endpoints[self._endpoint_idx % len(self._endpoints)]
            retry_after = 0.0
            try:
                status, payload = self._post_act(url, body, trace_id, wait_s)
            except (OSError, http.client.HTTPException) as e:
                # Nobody answered: fail over to the next address (the
                # backoff still applies, so a dead list does not spin).
                self._endpoint_idx += 1
                last_error = ConnectionError(f"{url} unreachable: {e!r}")
            else:
                if status == 200:
                    return ServedResult(
                        actions=np.asarray(payload["actions"], np.float32),
                        model_step=int(payload["model_step"]),
                        latency_s=float(payload.get("latency_s", 0.0)),
                        replica=int(payload.get("replica", -1)),
                    )
                if status == 429:
                    retry_after = float(payload.get("retry_after_s", 0.1))
                    # Another frontend may have room now: rotate, and
                    # honor this one's drain estimate only when there is
                    # nowhere else to go.
                    self._endpoint_idx += 1
                    last_error = BackpressureError(retry_after)
                    if len(self._endpoints) > 1:
                        retry_after = 0.0
                elif status == 400:
                    raise ValueError(str(payload.get("error", "bad request")))
                elif status == 504:
                    raise RequestTimeout(
                        str(payload.get("error", "deadline passed")))
                else:  # 5xx: that frontend is sick — rotate
                    self._endpoint_idx += 1
                    last_error = ConnectionError(
                        f"{url} answered {status}: "
                        f"{payload.get('error', '')!r}"
                    )
            if attempt == self.max_retries:
                raise last_error
            time.sleep(backoff_s(
                attempt, retry_after, self.backoff_base_s,
                self.backoff_cap_s,
                jitter=self._rng.random if self.jitter else None,
            ))
        raise AssertionError("unreachable")  # pragma: no cover

    def _post_act(
        self, base_url: str, body: bytes, trace_id: str, wait_s: float
    ) -> Tuple[int, dict]:
        # Wait slack as the frontend's own: the server fails expired
        # requests itself.
        status, payload, _ = post_json(
            base_url, "/v1/act", body, headers={TRACE_HEADER: trace_id},
            timeout_s=wait_s + 10.0,
        )
        return status, payload
