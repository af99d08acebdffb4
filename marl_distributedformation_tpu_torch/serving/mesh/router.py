"""MetaRouter: the host-tier frontend above per-host FleetRouters.

Counterpart of the JAX package's ``serving/mesh/router.py``, the same code
over the port's frontends; a host's build receipts are its CUDA-graph
captures, one a rung a replica. One tier up from
``serving/fleet/router.py``, same three duties, now over HTTP instead of
in-process schedulers:

- **Route.** Every request goes to the routable host (coordinator
  health view: not dead, serving the mesh step) with the lowest
  estimated drain — the host's own gossiped ``fleet_estimated_drain_s``
  (queue depth x recent batch seconds, summed over its replicas, riding
  every heartbeat) plus a local in-flight penalty that covers the
  gossip staleness window. The per-host fleet router then does its own
  per-replica routing below — two tiers of the same join-the-shortest-
  TIME-queue rule.
- **Degrade.** A host that refuses connections or answers 503 is
  circuit-broken locally (and reported to the coordinator's health
  view); its accepted requests transparently fail over to surviving
  hosts, bounded by ``max_failovers`` extra hosts and the request's own
  deadline. Half-open probing readmits it: after ``probe_interval_s``
  the next routed request is the probe.
- **Reject honestly.** Only when EVERY routable host answers 429 does
  the MetaRouter raise :class:`BackpressureError` with the smallest
  ``retry_after_s`` any host quoted — the same contract as the fleet
  router and the single scheduler, so ``ServingClient`` works unchanged
  over a whole mesh.

``X-Trace-Id`` propagates through the extra hop: the MetaRouter sends
the caller's ID on the forwarded request, the host frontend echoes it
into its own dispatch spans, and the meta response carries it back —
one trace ID correlates client -> meta -> host -> replica -> batch.

:class:`MeshFrontend` is the HTTP door above :meth:`MetaRouter.submit`,
the same protocol as ``FleetFrontend`` (``/v1/act``, ``/v1/health``,
``/v1/metrics``) with ``host`` added to act responses.
"""

from __future__ import annotations

import dataclasses
import http.client
import json
import math
import socket
import threading
import time
import urllib.parse
from concurrent.futures import Future
from http.server import BaseHTTPRequestHandler
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from marl_distributedformation_tpu_torch.serving.mesh.rpc import (
    ThreadedHttpEndpoint,
    post_json,
)
from marl_distributedformation_tpu_torch.obs import (
    PROMETHEUS_CONTENT_TYPE,
    TRACE_HEADER,
    get_registry,
    get_tracer,
    new_trace_id,
    prometheus_exposition,
    sanitize_trace_id,
    wants_prometheus,
)
from marl_distributedformation_tpu_torch.serving.scheduler import (
    BackpressureError,
    RequestTimeout,
)


class NoHealthyHosts(RuntimeError):
    """Every mesh host is dead or circuit-broken: the mesh is down."""


@dataclasses.dataclass
class MeshResult:
    """What a meta-routed request resolves to — ``ServedResult`` plus
    the host that answered and the echoed trace ID."""

    actions: np.ndarray
    model_step: int
    latency_s: float
    replica: int
    host: str
    trace_id: Optional[str] = None


class MetaRouter:
    """Drain-aware routing + circuit breaking over mesh hosts.

    Args:
      coordinator: the :class:`~.coordinator.MeshCoordinator` whose
        registry/health/gossip view this router reads (co-resident in
        the control-plane process — the data path never does RPC).
      default_timeout_s: request deadline when the caller names none.
      max_failovers: extra hosts one accepted request may be retried on
        after its first host fails mid-flight.
      probe_interval_s: how long a locally-broken host stays out of
        rotation before a half-open probe readmits it.
    """

    def __init__(
        self,
        coordinator: Any,
        default_timeout_s: float = 10.0,
        max_failovers: int = 1,
        probe_interval_s: float = 1.0,
    ) -> None:
        self.coordinator = coordinator
        self.default_timeout_s = float(default_timeout_s)
        self.max_failovers = int(max_failovers)
        self.probe_interval_s = float(probe_interval_s)
        self._lock = threading.Lock()
        self._broken: Dict[str, Tuple[float, str]] = {}  # graftlock: guarded-by=_lock — id -> (t, why)
        self._inflight: Dict[str, int] = {}  # graftlock: guarded-by=_lock
        self.routed_total = 0  # graftlock: guarded-by=_lock
        self.failed_over_total = 0  # graftlock: guarded-by=_lock
        self.rejected_total = 0  # graftlock: guarded-by=_lock
        self.breaks_total = 0  # graftlock: guarded-by=_lock
        self._routed_per_host: Dict[str, int] = {}  # graftlock: guarded-by=_lock

    # -- client side -----------------------------------------------------

    def submit(
        self,
        obs: np.ndarray,
        deterministic: bool = True,
        timeout_s: Optional[float] = None,
        trace_id: Optional[str] = None,
        slo_class: str = "interactive",
    ) -> Future:
        """Duck-type twin of ``FleetRouter.submit`` (the surface
        ``ServingClient`` and the pipeline's first-serve probe share):
        raises :class:`BackpressureError` / :class:`NoHealthyHosts` at
        submit time, resolves everything else through the future. The
        forward itself is synchronous on the calling thread — the
        frontend hands each request its own handler thread, and the
        blocking wait IS the request."""
        future: Future = Future()
        try:
            future.set_result(
                self.predict(
                    obs,
                    deterministic=deterministic,
                    timeout_s=timeout_s,
                    trace_id=trace_id,
                    slo_class=slo_class,
                )
            )
        except (BackpressureError, NoHealthyHosts):
            raise
        except Exception as e:  # noqa: BLE001 — typed through the future
            future.set_exception(e)
        return future

    def predict(
        self,
        obs: np.ndarray,
        deterministic: bool = True,
        timeout_s: Optional[float] = None,
        trace_id: Optional[str] = None,
        slo_class: str = "interactive",
    ) -> MeshResult:
        """Blocking meta-routed act. The failure taxonomy mirrors the
        fleet router's: BackpressureError when every routable host is
        full, NoHealthyHosts when none is routable, RequestTimeout past
        the deadline, ValueError for the caller's own malformed
        request."""
        timeout = (
            self.default_timeout_s if timeout_s is None else float(timeout_s)
        )
        deadline = time.perf_counter() + timeout
        trace_id = sanitize_trace_id(trace_id) or new_trace_id()
        body = json.dumps(
            {
                "obs": np.asarray(obs, np.float32).tolist(),
                "deterministic": bool(deterministic),
                "timeout_s": timeout,
                "slo_class": slo_class,
            }
        ).encode()
        tried: set = set()
        hops = 0
        rejections: List[float] = []
        while True:
            candidates = [
                h for h in self._eligible_hosts() if h.host_id not in tried
            ]
            if not candidates:
                break
            host = min(candidates, key=self._score)
            tried.add(host.host_id)
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                raise RequestTimeout(
                    f"deadline passed after trying {sorted(tried)}"
                )
            with self._lock:
                self._inflight[host.host_id] = (
                    self._inflight.get(host.host_id, 0) + 1
                )
            try:
                status, payload, echoed = self._forward(
                    host.data_url, body, trace_id, remaining
                )
            except (OSError, http.client.HTTPException) as e:
                # Nobody answered: the host-death signal. Break it,
                # fail the request over while the hop budget lasts.
                self._break(host.host_id, f"unreachable: {e!r}")
                if hops >= self.max_failovers:
                    raise NoHealthyHosts(
                        f"host {host.host_id} unreachable and failover "
                        f"budget spent: {e!r}"
                    ) from e
                hops += 1
                with self._lock:
                    self.failed_over_total += 1
                continue
            finally:
                with self._lock:
                    self._inflight[host.host_id] -= 1
            if status == 200:
                with self._lock:
                    self.routed_total += 1
                    self._routed_per_host[host.host_id] = (
                        self._routed_per_host.get(host.host_id, 0) + 1
                    )
                return MeshResult(
                    actions=np.asarray(payload["actions"], np.float32),
                    model_step=int(payload["model_step"]),
                    latency_s=float(payload.get("latency_s", 0.0)),
                    replica=int(payload.get("replica", -1)),
                    host=host.host_id,
                    trace_id=echoed or trace_id,
                )
            if status == 429:
                # That host is full, not broken — walk down the drain
                # ordering like the fleet router walks past full
                # replicas (no failover hop consumed).
                rejections.append(
                    float(payload.get("retry_after_s", 0.1))
                )
                continue
            if status == 400:
                raise ValueError(
                    str(payload.get("error", "bad request"))
                )
            if status == 504:
                raise RequestTimeout(
                    str(payload.get("error", "deadline passed"))
                )
            if status == 503:
                # The whole host fleet is down — circuit-break it and
                # keep WALKING (routing around a down host is routing,
                # not failover: no hop consumed). If every host ends
                # up broken this way, the loop exits with no
                # candidates and the typed NoHealthyHosts below keeps
                # the mesh-down taxonomy intact (a 503 everywhere must
                # never surface as a generic 500).
                self._break(
                    host.host_id,
                    f"503: {payload.get('error', 'fleet down')}",
                )
                continue
            # Other 5xx: the request is safely retryable (pure
            # inference) on another host while the hop budget lasts.
            if hops >= self.max_failovers:
                raise RuntimeError(
                    f"host {host.host_id} answered {status}: "
                    f"{payload.get('error', '')!r} (failover budget "
                    "spent)"
                )
            hops += 1
            with self._lock:
                self.failed_over_total += 1
        if rejections:
            with self._lock:
                self.rejected_total += 1
            raise BackpressureError(min(rejections))
        raise NoHealthyHosts(
            "no routable mesh host (all dead, stale, or circuit-broken)"
        )

    # -- transport -------------------------------------------------------

    @staticmethod
    def _forward(
        data_url: str,
        body: bytes,
        trace_id: str,
        timeout_s: float,
    ) -> Tuple[int, dict, Optional[str]]:
        """One ``POST /v1/act`` to a host frontend. Returns
        ``(status, payload, echoed_trace_id)``; transport errors raise
        OSError/HTTPException for the caller's failover logic. The
        wait slack mirrors the frontends' own: the host fails expired
        requests itself."""
        status, payload, headers = post_json(
            data_url,
            "/v1/act",
            body,
            headers={TRACE_HEADER: trace_id},
            timeout_s=timeout_s + 10.0,
        )
        return status, payload, headers.get(TRACE_HEADER)

    # -- routing state ---------------------------------------------------

    def _eligible_hosts(self) -> List[Any]:
        """Coordinator-routable hosts minus the locally-broken ones,
        with half-open readmission after ``probe_interval_s``."""
        now = time.monotonic()
        hosts = self.coordinator.routable_hosts()
        out = []
        with self._lock:
            for h in hosts:
                broken = self._broken.get(h.host_id)
                if broken is not None:
                    if now - broken[0] < self.probe_interval_s:
                        continue
                    del self._broken[h.host_id]  # half-open: next
                    # routed request is the probe; failure re-breaks
                out.append(h)
        return out

    def _score(self, host: Any) -> Tuple[float, int]:
        """Estimated drain from the host's gossip plus the local
        in-flight count (covers the gossip staleness window: two
        requests racing the same idle host must not both read 0)."""
        drain = 0.0
        metrics = getattr(host, "metrics", None) or {}
        try:
            drain = float(metrics.get("fleet_estimated_drain_s", 0.0))
        except (TypeError, ValueError):
            drain = 0.0
        with self._lock:
            inflight = self._inflight.get(host.host_id, 0)
        return (drain, inflight)

    def _break(self, host_id: str, reason: str) -> None:
        with self._lock:
            if host_id in self._broken:
                return
            self._broken[host_id] = (time.monotonic(), reason)
            self.breaks_total += 1
        # Feed the coordinator's health view: the data plane saw this
        # host dead before the lease did.
        try:
            self.coordinator.mark_dead(host_id, f"meta-router: {reason}")
        except Exception:  # noqa: BLE001 — local breaking still stands
            pass
        get_tracer().incident(
            "mesh_circuit_break", host=host_id, reason=reason
        )

    # -- observability ---------------------------------------------------

    @property
    def healthy_hosts(self) -> int:
        return len(self._eligible_hosts())

    def snapshot(self) -> Dict[str, float]:
        """Mesh-tier metrics: routing counters plus per-host health and
        the coordinator's registry view, flat floats like every other
        snapshot in the repo. Published into the process registry so
        the merged Prometheus namespace carries the mesh families."""
        hosts = self.coordinator.hosts()
        with self._lock:
            out: Dict[str, float] = {
                "mesh_hosts": float(len(hosts)),
                "mesh_routed_total": float(self.routed_total),
                "mesh_rejected_total": float(self.rejected_total),
                "mesh_failed_over_total": float(self.failed_over_total),
                "mesh_breaks_total": float(self.breaks_total),
                "mesh_step": float(self.coordinator.fleet_step),
                "mesh_commit_rounds": float(self.coordinator.commit_round),
            }
            routed = dict(self._routed_per_host)
            broken = set(self._broken)
        alive = 0
        for i, h in enumerate(sorted(hosts, key=lambda r: r["host_id"])):
            alive += int(
                h["state"] == "alive" and h["host_id"] not in broken
            )
            out[f"host{i}_routed"] = float(routed.get(h["host_id"], 0))
            out[f"host{i}_alive"] = float(h["state"] == "alive")
            out[f"host{i}_step"] = float(h["step"])
        out["mesh_hosts_routable"] = float(alive)
        get_registry().record_gauges(out)
        return out

    def host_compile_counts(self) -> Dict[str, Dict[str, float]]:
        """Per-host budget-1 receipts, scraped from each reachable
        host's ``/v1/metrics`` JSON (the ``rung*_compiles`` gauges its
        fleet already exports: CUDA-graph captures a rung on the card,
        eager builds on the CPU). Dead hosts are simply absent — they
        serve nothing, so they owe no receipt."""
        out: Dict[str, Dict[str, float]] = {}
        for h in self.coordinator.hosts():
            if h["state"] == "dead":
                continue
            parsed = urllib.parse.urlsplit(h["data_url"])
            conn = http.client.HTTPConnection(
                parsed.hostname, parsed.port, timeout=5.0
            )
            try:
                conn.request("GET", "/v1/metrics")
                resp = conn.getresponse()
                snap = json.loads(resp.read())
            except (OSError, ValueError, http.client.HTTPException):
                continue
            finally:
                conn.close()
            out[h["host_id"]] = {
                k: float(v)
                for k, v in snap.items()
                if k.endswith("_compiles")
            }
        return out


def _make_handler(router: MetaRouter):
    class _Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt: str, *args: Any) -> None:
            pass

        def _reply(
            self,
            status: int,
            payload: dict,
            retry_after_s: Optional[float] = None,
            trace_id: Optional[str] = None,
        ) -> None:
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
                pass

        def do_GET(self) -> None:  # noqa: N802 — stdlib handler API
            if self.path == "/v1/health":
                routable = router.healthy_hosts
                self._reply(
                    200 if routable else 503,
                    {
                        "routable_hosts": routable,
                        "hosts": len(router.coordinator.hosts()),
                        "model_step": int(router.coordinator.fleet_step),
                    },
                )
            elif self.path == "/v1/metrics":
                snap = router.snapshot()
                if wants_prometheus(self.headers.get("Accept")):
                    from marl_distributedformation_tpu_torch.obs.ledger import (
                        merge_ledger_snapshot,
                    )

                    merged = merge_ledger_snapshot(
                        get_registry().snapshot()
                    )
                    merged.update(snap)
                    body = prometheus_exposition(merged).encode()
                    self.send_response(200)
                    self.send_header(
                        "Content-Type", PROMETHEUS_CONTENT_TYPE
                    )
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    try:
                        self.wfile.write(body)
                    except (BrokenPipeError, ConnectionResetError):
                        pass
                else:
                    self._reply(200, snap)
            else:
                self._reply(404, {"error": f"unknown path {self.path}"})

        def do_POST(self) -> None:  # noqa: N802 — stdlib handler API
            trace_id = (
                sanitize_trace_id(self.headers.get(TRACE_HEADER))
                or new_trace_id()
            )
            if self.path != "/v1/act":
                self._reply(
                    404,
                    {"error": f"unknown path {self.path}"},
                    trace_id=trace_id,
                )
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(length))
                obs = np.asarray(req["obs"], np.float32)
                deterministic = bool(req.get("deterministic", True))
                timeout_s = req.get("timeout_s")
                if timeout_s is not None:
                    timeout_s = float(timeout_s)
                slo_class = str(req.get("slo_class", "interactive"))
            except (ValueError, KeyError, TypeError) as e:
                self._reply(
                    400, {"error": f"bad request: {e}"}, trace_id=trace_id
                )
                return
            try:
                result = router.predict(
                    obs,
                    deterministic=deterministic,
                    timeout_s=timeout_s,
                    trace_id=trace_id,
                    slo_class=slo_class,
                )
            except BackpressureError as e:
                self._reply(
                    429,
                    {
                        "error": "backpressure",
                        "retry_after_s": e.retry_after_s,
                    },
                    retry_after_s=e.retry_after_s,
                    trace_id=trace_id,
                )
            except NoHealthyHosts as e:
                self._reply(503, {"error": str(e)}, trace_id=trace_id)
            except (RequestTimeout, TimeoutError, socket.timeout) as e:
                self._reply(
                    504,
                    {"error": f"deadline passed: {e}"},
                    trace_id=trace_id,
                )
            except ValueError as e:
                self._reply(
                    400, {"error": f"bad request: {e}"}, trace_id=trace_id
                )
            except Exception as e:  # noqa: BLE001 — no tracebacks on wire
                self._reply(
                    500, {"error": type(e).__name__}, trace_id=trace_id
                )
            else:
                self._reply(
                    200,
                    {
                        "actions": np.asarray(result.actions).tolist(),
                        "model_step": int(result.model_step),
                        "replica": int(result.replica),
                        "host": result.host,
                        "latency_s": round(result.latency_s, 6),
                    },
                    trace_id=trace_id,
                )

    return _Handler


class MeshFrontend(ThreadedHttpEndpoint):
    """Threaded HTTP door above a MetaRouter; ``port=0`` = ephemeral.
    Lifecycle (serve thread, shutdown ordering) shared with the RPC
    endpoint via :class:`~.rpc.ThreadedHttpEndpoint`."""

    thread_name = "mesh-frontend"

    def __init__(
        self,
        router: MetaRouter,
        host: str = "127.0.0.1",
        port: int = 0,
    ) -> None:
        self.router = router
        super().__init__(_make_handler(router), host, port)
