"""Stdlib JSON-RPC plumbing for the mesh control plane.

Counterpart of the JAX package's ``serving/mesh/rpc.py``, the same code:
the port keeps its own copy, so the wire format, the status codes and the
error taxonomy are the same bytes on both sides.

The mesh tier (coordinator <-> host agents) needs exactly one transport
primitive: a blocking request/response call that either returns a JSON
payload or fails with a taxonomy the caller can act on. HTTP over
loopback already IS that primitive — the repo's serving frontend proved
the stdlib ``ThreadingHTTPServer`` handles it fine — so the control
plane reuses the same machinery instead of inventing a wire format:
``POST /rpc/{method}`` with a JSON body, JSON back.

Failure taxonomy (the whole point of having a wrapper):

- :class:`MeshUnreachable` — nobody answered: connection refused/reset,
  DNS, timeout. This is the *host-death signal* the coordinator's
  health logic and the MetaRouter's circuit breaker key on.
- :class:`MeshRpcError` — the peer answered with an error: unknown
  method (404) or a handler exception (500, carrying the exception type
  and a bounded detail string — no tracebacks over the wire, the
  frontend's discipline).

Everything here is host-side control-plane code: none of these calls may
run inside a captured CUDA graph's phase, where a socket round trip would
run once a capture and never on a replay.
"""

from __future__ import annotations

import http.client
import json
import socket
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, Optional

MAX_RPC_BODY_BYTES = 16 * 1024 * 1024  # gossip payloads are small dicts


class MeshRpcError(RuntimeError):
    """The peer answered with an error (bad method, handler raised)."""

    def __init__(
        self, method: str, detail: str, status: int = 500,
        error_type: str = "",
    ) -> None:
        super().__init__(f"rpc {method!r} failed ({status}): {detail}")
        self.method = method
        self.detail = detail
        self.status = status
        self.error_type = error_type


class MeshUnreachable(MeshRpcError):
    """Nobody answered: refused/reset/timeout — the host-death signal."""


def post_json(
    base_url: str,
    path: str,
    body: bytes,
    headers: Optional[Dict[str, str]] = None,
    timeout_s: float = 5.0,
):
    """One ``POST {base_url}{path}`` with a JSON body — the transport
    core shared by :func:`rpc_call`, the MetaRouter's ``/v1/act``
    forward, and ``ServingClient``'s endpoint mode (one place to fix
    connection handling, three callers). Returns ``(status,
    payload_dict, response_headers)``; an unparseable body degrades to
    ``{"error": <prefix>}``. Transport failures propagate raw
    (``OSError`` / ``http.client.HTTPException``) so each caller keeps
    its own failure taxonomy."""
    parsed = urllib.parse.urlsplit(base_url)
    conn = http.client.HTTPConnection(
        parsed.hostname, parsed.port, timeout=timeout_s
    )
    try:
        conn.request(
            "POST",
            path,
            body=body,
            headers={
                "Content-Type": "application/json",
                **(headers or {}),
            },
        )
        resp = conn.getresponse()
        raw = resp.read(MAX_RPC_BODY_BYTES)
        try:
            payload = json.loads(raw) if raw else {}
        except ValueError:
            payload = {"error": raw[:200].decode("utf-8", "replace")}
        return resp.status, payload, resp.headers
    finally:
        conn.close()


def rpc_call(
    base_url: str,
    method: str,
    payload: Optional[Dict[str, Any]] = None,
    timeout_s: float = 5.0,
) -> Dict[str, Any]:
    """One blocking ``POST {base_url}/rpc/{method}`` round trip.

    Returns the decoded JSON payload on 200; raises
    :class:`MeshUnreachable` when the transport fails and
    :class:`MeshRpcError` when the peer reports an error. Never used on
    the data path — the MetaRouter forwards ``/v1/act`` bodies itself —
    so a generous default timeout is fine."""
    parsed = urllib.parse.urlsplit(base_url)
    body = json.dumps(payload or {}).encode()
    conn = http.client.HTTPConnection(
        parsed.hostname, parsed.port, timeout=timeout_s
    )
    try:
        try:
            conn.request(
                "POST",
                f"/rpc/{method}",
                body=body,
                headers={"Content-Type": "application/json"},
            )
            resp = conn.getresponse()
            raw = resp.read(MAX_RPC_BODY_BYTES)
        except (OSError, socket.timeout, http.client.HTTPException) as e:
            raise MeshUnreachable(
                method, f"{base_url} unreachable: {e!r}"
            ) from e
        try:
            data = json.loads(raw) if raw else {}
        except ValueError as e:
            raise MeshRpcError(
                method, f"unparseable response from {base_url}: {e}",
                status=resp.status,
            ) from e
        if resp.status != 200:
            raise MeshRpcError(
                method,
                str(data.get("error", raw[:200])),
                status=resp.status,
                error_type=str(data.get("error_type", "")),
            )
        return data
    finally:
        conn.close()


def _make_handler(handlers: Dict[str, Callable[[dict], dict]]):
    class _Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt: str, *args: Any) -> None:
            pass  # observability lives in the coordinator's registry

        def _reply(self, status: int, payload: dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            try:
                self.wfile.write(body)
            except (BrokenPipeError, ConnectionResetError):
                pass

        def do_POST(self) -> None:  # noqa: N802 — stdlib handler API
            if not self.path.startswith("/rpc/"):
                self._reply(404, {"error": f"unknown path {self.path}"})
                return
            method = self.path[len("/rpc/"):]
            handler = handlers.get(method)
            if handler is None:
                self._reply(
                    404,
                    {
                        "error": f"unknown rpc method {method!r}",
                        "methods": sorted(handlers),
                    },
                )
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                if not 0 <= length <= MAX_RPC_BODY_BYTES:
                    raise ValueError(
                        f"Content-Length must be in [0, {MAX_RPC_BODY_BYTES}]"
                    )
                payload = (
                    json.loads(self.rfile.read(length)) if length else {}
                )
            except (ValueError, TypeError) as e:
                self._reply(400, {"error": f"bad request: {e}"})
                return
            try:
                result = handler(payload)
            except Exception as e:  # noqa: BLE001 — typed over the wire
                self._reply(
                    500,
                    {
                        "error": repr(e)[:300],
                        "error_type": type(e).__name__,
                    },
                )
                return
            self._reply(200, result if result is not None else {})

    return _Handler


class ThreadedHttpEndpoint:
    """Shared lifecycle for the mesh tier's stdlib HTTP servers (this
    RPC endpoint and the MeshFrontend): one place owning the
    daemon-thread serve loop, ephemeral-port binding (``port=0`` —
    the bound port is ``self.port``), and shutdown ordering."""

    thread_name = "mesh-http"

    def __init__(
        self, handler_cls, host: str = "127.0.0.1", port: int = 0
    ) -> None:
        self.server = ThreadingHTTPServer((host, port), handler_cls)
        self.server.daemon_threads = True
        self.host = self.server.server_address[0]
        self.port = self.server.server_address[1]
        self._thread: Optional[threading.Thread] = None

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def start(self):
        if self._thread is not None:
            return self
        self._thread = threading.Thread(
            target=self.server.serve_forever,
            name=self.thread_name,
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

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc: Any) -> None:
        self.stop()


class JsonRpcServer(ThreadedHttpEndpoint):
    """Threaded RPC endpoint over a handler table. Handlers take the
    decoded payload dict and return a JSON-able dict; an exception
    becomes a typed 500 for the caller's :class:`MeshRpcError`."""

    thread_name = "mesh-rpc-server"

    def __init__(
        self,
        handlers: Dict[str, Callable[[dict], dict]],
        host: str = "127.0.0.1",
        port: int = 0,
    ) -> None:
        super().__init__(_make_handler(dict(handlers)), host, port)
