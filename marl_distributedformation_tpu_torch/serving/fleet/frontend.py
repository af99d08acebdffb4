"""Stdlib-only HTTP frontend: the network door, strictly above the fleet.

Counterpart of the JAX package's ``serving/fleet/frontend.py``, the same
code over the port's router.

The compiled path must never learn about sockets — the frontend's whole
job is translating HTTP+JSON to ``FleetRouter.submit`` and the router's
failure taxonomy to status codes. ``http.server.ThreadingHTTPServer``
(one thread per connection, stdlib) is plenty: the per-request work here
is JSON parsing and a future wait; throughput lives below, in the
coalescing scheduler and the compiled engines, exactly where TF-Agents
(arXiv:1709.02878) says it belongs.

Protocol (all bodies JSON):

- ``POST /v1/act`` with ``{"obs": [[...row...], ...],
  "deterministic": true, "timeout_s": 5.0,
  "slo_class": "interactive", "model_id": "lane-a"}`` →
  ``200 {"actions": [...], "model_step": N, "replica": i,
  "latency_s": x, "model_id": "lane-a"}``. ``model_step`` rides on
  every response — the fleet's version-pinning contract, end to end.
  ``slo_class`` (optional, default "interactive") is the admission
  class: "batch" traffic yields to interactive under backpressure
  (scheduler SLO classes — it dispatches behind queued interactive
  work and may be preempted with a 429 when an interactive request
  needs its slot). ``model_id`` names the tenant lane
  (serving/tenancy) — required by multi-tenant routers, rejected
  (400) by single-model ones — and is stamped on EVERY act response,
  success and failure alike, so a client juggling lanes can always
  attribute an answer (or a 429) to the lane that produced it.
- Backpressure → ``429`` with ``{"error": "backpressure",
  "retry_after_s": x}`` AND a standard ``Retry-After`` header (integer
  ceiling), so both JSON-aware clients and off-the-shelf HTTP retry
  middleware see the hint.
- Whole fleet broken → ``503``; request deadline passed → ``504``;
  malformed body/shape → ``400``. Unexpected server errors → ``500``
  with the exception class name (no tracebacks over the wire).
- ``GET /v1/health`` → ``200`` while any replica serves, ``503`` when
  none does (load-balancer shaped). ``GET /v1/metrics`` → the
  aggregated fleet snapshot — JSON by default, Prometheus text
  exposition when the client asks for it (``Accept: text/plain`` or an
  openmetrics type; ``obs/export.py``).
- **Trace identity**: ``POST /v1/act`` accepts an ``X-Trace-Id`` header
  (minting one when absent, sanitizing what arrives) and echoes it on
  EVERY response — success and failure alike — both as the header and
  as ``trace_id`` in the JSON body of errors (429/504/...), so a
  client's retries stay correlatable across failover. The same ID rides
  ``FleetRouter.submit`` down to the dispatch batch span (obs/).
"""

from __future__ import annotations

import json
import math
import threading

# concurrent.futures.TimeoutError is the builtin since Python 3.11; both
# are caught so a wedged-worker wait is a 504 on older interpreters too.
from concurrent.futures import TimeoutError as FutureTimeoutError
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Optional

import numpy as np

from marl_distributedformation_tpu_torch.chaos.plane import fault_point
from marl_distributedformation_tpu_torch.obs import (
    PROMETHEUS_CONTENT_TYPE,
    TRACE_HEADER,
    new_trace_id,
    prometheus_exposition,
    sanitize_trace_id,
    wants_prometheus,
)
from marl_distributedformation_tpu_torch.serving.fleet.router import (
    FleetRouter,
    NoHealthyReplicas,
)
from marl_distributedformation_tpu_torch.serving.scheduler import (
    BackpressureError,
    RequestTimeout,
    SchedulerStopped,
)

MAX_BODY_BYTES = 64 * 1024 * 1024  # one request can't OOM the frontend


def _make_handler(router: FleetRouter):
    class _Handler(BaseHTTPRequestHandler):
        # The default handler logs one stderr line per request — at
        # serving rates that is an accidental hot-loop host sync of the
        # logging kind. Observability lives in /v1/metrics instead.
        def log_message(self, fmt: str, *args: Any) -> None:
            pass

        def _reply(
            self,
            status: int,
            payload: dict,
            retry_after_s: Optional[float] = None,
            trace_id: Optional[str] = None,
        ) -> None:
            # One seam for the 'every response correlates' contract:
            # the ID rides both the header and the JSON body.
            if trace_id is not None:
                payload = {**payload, "trace_id": trace_id}
            body = json.dumps(payload).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            if trace_id is not None:
                self.send_header(TRACE_HEADER, trace_id)
            if retry_after_s is not None:
                self.send_header(
                    "Retry-After", str(max(1, math.ceil(retry_after_s)))
                )
            self.end_headers()
            try:
                self.wfile.write(body)
            except (BrokenPipeError, ConnectionResetError):
                pass  # client gave up; nothing to salvage

        def _reply_text(
            self, status: int, text: str, content_type: str
        ) -> None:
            body = text.encode()
            self.send_response(status)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            try:
                self.wfile.write(body)
            except (BrokenPipeError, ConnectionResetError):
                pass

        # -- reads -------------------------------------------------------

        def do_GET(self) -> None:  # noqa: N802 — BaseHTTPRequestHandler API
            if self.path == "/v1/health":
                healthy = router.healthy_replicas
                payload = {
                    "healthy_replicas": healthy,
                    "replicas": len(router.replicas),
                    "model_step": int(
                        max(
                            r.registry.active_step
                            for r in router.replicas
                        )
                    ),
                }
                if getattr(router, "lane_ids", ()):
                    # Tenant lanes: per-model steps (each monotonic on
                    # its own), and model_step is the newest any lane
                    # serves.
                    steps = router.lane_steps()
                    payload["model_steps"] = {
                        mid: int(s) for mid, s in steps.items()
                    }
                    payload["model_step"] = int(max(steps.values()))
                self._reply(200 if healthy else 503, payload)
            elif self.path == "/v1/metrics":
                snap = router.snapshot()
                if wants_prometheus(self.headers.get("Accept")):
                    # The Prometheus view is the MERGED namespace: the
                    # process registry (trainer/pipeline/checkpoint
                    # gauges, when co-resident) plus the program
                    # ledger's per-executable families plus this
                    # fleet's own families; the fleet's keys win on
                    # overlap. The JSON default stays byte-identical
                    # to the router snapshot.
                    from marl_distributedformation_tpu_torch.obs import (
                        get_registry,
                        merge_ledger_snapshot,
                    )

                    merged = merge_ledger_snapshot(
                        get_registry().snapshot()
                    )
                    merged.update(snap)
                    self._reply_text(
                        200,
                        prometheus_exposition(merged),
                        PROMETHEUS_CONTENT_TYPE,
                    )
                else:
                    self._reply(200, snap)
            else:
                self._reply(404, {"error": f"unknown path {self.path}"})

        # -- act ---------------------------------------------------------

        def do_POST(self) -> None:  # noqa: N802 — BaseHTTPRequestHandler API
            # Trace identity first: accepted from the client (sanitized)
            # or minted here, echoed on EVERY response below — success,
            # backpressure, timeout — and carried through the router so
            # the dispatch batch span links back to this request.
            trace_id = (
                sanitize_trace_id(self.headers.get(TRACE_HEADER))
                or new_trace_id()
            )
            try:
                # Chaos seam: an injected handler fault degrades to a
                # typed 500 (the client's retry loop owns it) — never a
                # dropped connection, never a dead frontend thread.
                fault_point("frontend.handler")
            except Exception as e:  # noqa: BLE001 — injected by design
                self._reply(
                    500,
                    {"error": f"injected fault: {e}"},
                    trace_id=trace_id,
                )
                return
            if self.path != "/v1/act":
                self._reply(
                    404,
                    {"error": f"unknown path {self.path}"},
                    trace_id=trace_id,
                )
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                if not 0 < length <= MAX_BODY_BYTES:
                    raise ValueError(
                        f"Content-Length must be in (0, {MAX_BODY_BYTES}]"
                    )
                req = json.loads(self.rfile.read(length))
                obs = np.asarray(req["obs"], np.float32)
                deterministic = bool(req.get("deterministic", True))
                timeout_s = req.get("timeout_s")
                if timeout_s is not None:
                    timeout_s = float(timeout_s)
                slo_class = str(req.get("slo_class", "interactive"))
                if slo_class not in ("interactive", "batch"):
                    raise ValueError(
                        f"slo_class must be 'interactive' or 'batch', "
                        f"got {slo_class!r}"
                    )
                model_id = req.get("model_id")
                if model_id is not None:
                    model_id = str(model_id)
            except (ValueError, KeyError, TypeError) as e:
                self._reply(
                    400,
                    {"error": f"bad request: {e}"},
                    trace_id=trace_id,
                )
                return

            def _stamp(payload: dict) -> dict:
                # The lane rides EVERY act response (tenancy contract),
                # null in single-model mode.
                return {**payload, "model_id": model_id}

            try:
                future = router.submit(
                    obs, deterministic=deterministic, timeout_s=timeout_s,
                    trace_id=trace_id, slo_class=slo_class,
                    model_id=model_id,
                )
                wait = (
                    timeout_s
                    if timeout_s is not None
                    else router.default_timeout_s
                )
                # Failover can legitimately re-queue once; leave slack
                # beyond the request's own deadline (the scheduler
                # expires it itself) before declaring the server wedged.
                result = future.result(timeout=wait + 10.0)
            except BackpressureError as e:
                self._reply(
                    429,
                    _stamp({
                        "error": "backpressure",
                        "retry_after_s": e.retry_after_s,
                    }),
                    retry_after_s=e.retry_after_s,
                    trace_id=trace_id,
                )
            except NoHealthyReplicas as e:
                self._reply(
                    503,
                    _stamp({"error": str(e)}),
                    trace_id=trace_id,
                )
            except (RequestTimeout, TimeoutError, FutureTimeoutError) as e:
                self._reply(
                    504,
                    _stamp({"error": f"deadline passed: {e}"}),
                    trace_id=trace_id,
                )
            except SchedulerStopped as e:
                self._reply(
                    503,
                    _stamp({"error": str(e)}),
                    trace_id=trace_id,
                )
            except ValueError as e:
                self._reply(
                    400,
                    _stamp({"error": f"bad request: {e}"}),
                    trace_id=trace_id,
                )
            except Exception as e:  # noqa: BLE001 — no tracebacks on the wire
                self._reply(
                    500,
                    _stamp({"error": type(e).__name__}),
                    trace_id=trace_id,
                )
            else:
                self._reply(
                    200,
                    {
                        "actions": np.asarray(result.actions).tolist(),
                        "model_step": int(result.model_step),
                        "replica": int(result.replica),
                        "latency_s": round(result.latency_s, 6),
                        # The lane that ANSWERED (scheduler-stamped) —
                        # matches the request's lane by construction.
                        "model_id": result.model_id,
                    },
                    trace_id=trace_id,
                )

    return _Handler


class FleetFrontend:
    """Threaded HTTP server over a router; ``port=0`` binds ephemeral
    (the bound port is ``self.port`` — tests and the CLI print it)."""

    def __init__(
        self,
        router: FleetRouter,
        host: str = "127.0.0.1",
        port: int = 0,
    ) -> None:
        self.router = router
        self.server = ThreadingHTTPServer(
            (host, port), _make_handler(router)
        )
        self.server.daemon_threads = True
        self.host = self.server.server_address[0]
        self.port = self.server.server_address[1]
        self._thread: Optional[threading.Thread] = None

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def start(self) -> "FleetFrontend":
        if self._thread is not None:
            return self
        self._thread = threading.Thread(
            target=self.server.serve_forever,
            name="fleet-frontend",
            daemon=True,
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._thread is None:
            return
        self.server.shutdown()
        self.server.server_close()
        self._thread.join(timeout=10.0)
        self._thread = None

    def __enter__(self) -> "FleetFrontend":
        return self.start()

    def __exit__(self, *exc: Any) -> None:
        self.stop()
