"""HostAgent: one host's control-plane presence in the mesh.

Counterpart of the JAX package's ``serving/mesh/agent.py``, the same code
over the port's fleet. Runs beside the host's ``FleetRouter`` +
``FleetFrontend`` and does the three things the data plane cannot:

- **membership** — registers with the coordinator and heartbeats on a
  lease, carrying the host's merged ``/v1/metrics`` snapshot as the
  gossip payload (one ``router.snapshot()`` per beat — the same dict
  the host's own ``GET /v1/metrics`` serves, so the mesh's routing view
  and the host's observability view can never disagree);
- **the barrier's host side** — serves ``mesh.prepare`` /
  ``mesh.commit`` / ``mesh.abort`` over a control-plane RPC endpoint,
  delegating to the fleet coordinator's staged two-phase split
  (``prepare_global`` stages + pauses, ``commit_prepared`` /
  ``abort_prepared`` resolve it). Round tokens guard against a stale
  coordinator: a commit for a round this host never staged is refused;
- **catch-up** — a heartbeat reply whose ``mesh_step`` is ahead of the
  local fleet means this host missed a commit (it was dead, or it
  joined late): the agent reloads the advertised checkpoint locally.
  Until that lands, the coordinator's routing view quarantines this
  host (stale step), so the catch-up can never serve an old
  ``model_step`` after newer responses.

The coordinator being unreachable NEVER stops the data plane: the agent
keeps serving and keeps retrying registration — availability of the
serving path outranks control-plane liveness.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Optional

from marl_distributedformation_tpu_torch.chaos.plane import fault_point
from marl_distributedformation_tpu_torch.obs import get_registry
from marl_distributedformation_tpu_torch.serving.mesh.rpc import (
    JsonRpcServer,
    MeshRpcError,
    rpc_call,
)


class HostAgent:
    def __init__(
        self,
        host_id: str,
        router: Any,
        fleet: Any,  # FleetReloadCoordinator (the staged two-phase side)
        coordinator_url: str,
        data_url: str,
        host: str = "127.0.0.1",
        control_port: int = 0,
        heartbeat_interval_s: float = 0.5,
    ) -> None:
        self.host_id = host_id
        self.router = router
        self.fleet = fleet
        self.coordinator_url = coordinator_url
        self.data_url = data_url
        self.heartbeat_interval_s = float(heartbeat_interval_s)
        self.registered = False
        self.beats_sent = 0
        self.catch_ups = 0
        self.catch_up_failures = 0
        self._catch_up_thread: Optional[threading.Thread] = None
        self._round: Optional[int] = None  # graftlock: guarded-by=_round_lock
        # The last resolved commit, kept for idempotency: a commit RPC
        # whose response was lost (client timeout racing a slow
        # install) is retried by the coordinator, and the retry must
        # report what actually happened — not refuse a round this host
        # already landed.
        self._committed: Optional[tuple] = None  # graftlock: guarded-by=_round_lock — (round, ok, step)
        self._round_lock = threading.Lock()
        self._server = JsonRpcServer(
            {
                "mesh.prepare": self._rpc_prepare,
                "mesh.commit": self._rpc_commit,
                "mesh.abort": self._rpc_abort,
                "mesh.ping": lambda payload: {
                    "host_id": self.host_id,
                    "step": int(self.fleet.fleet_step),
                },
            },
            host=host,
            port=control_port,
        )
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    @property
    def control_url(self) -> str:
        return self._server.url

    # -- barrier host side (RPC handlers) --------------------------------

    def _rpc_prepare(self, payload: dict) -> dict:
        fault_point("mesh.prepare")
        round_id = int(payload["round"])
        step = payload.get("step")
        if step is not None and int(step) == int(self.fleet.fleet_step):
            # Already serving the round's target (a commit whose ack
            # was lost, or a catch-up that beat the round here): there
            # is nothing to stage OR pause — tell the coordinator to
            # count this host committed and move on.
            return {
                "staged": False,
                "already_at_step": True,
                "reason": f"already serving step {int(step)}",
                "round": round_id,
            }
        staged, reason = self.fleet.prepare_global(
            payload["path"],
            step=step,
            monotonic=bool(payload.get("monotonic", True)),
            trace_id=payload.get("trace_id"),
            ttl_s=float(payload.get("ttl_s", 60.0)),
        )
        with self._round_lock:
            self._round = round_id if staged else None
        return {"staged": staged, "reason": reason, "round": round_id}

    def _rpc_commit(self, payload: dict) -> dict:
        fault_point("mesh.commit")
        round_id = int(payload["round"])
        with self._round_lock:
            if self._committed is not None and self._committed[0] == round_id:
                # Idempotent retry: report what the first delivery did.
                return {
                    "ok": self._committed[1],
                    "step": self._committed[2],
                }
            if self._round != round_id:
                return {
                    "ok": False,
                    "reason": f"round {round_id} is not staged here "
                    f"(staged: {self._round})",
                }
            self._round = None
        ok = self.fleet.commit_prepared(trace_id=payload.get("trace_id"))
        with self._round_lock:
            self._committed = (round_id, ok, int(self.fleet.fleet_step))
        return {"ok": ok, "step": int(self.fleet.fleet_step)}

    def _rpc_abort(self, payload: dict) -> dict:
        with self._round_lock:
            self._round = None
        aborted = self.fleet.abort_prepared(
            str(payload.get("reason", "coordinator aborted the round"))
        )
        return {"ok": True, "aborted": aborted}

    # -- membership + gossip ---------------------------------------------

    def _beat_once(self) -> None:
        """One register-or-heartbeat round trip; transport failures are
        swallowed (the data plane must outlive the control plane) and
        surface only as ``registered=False`` until the coordinator
        answers again."""
        try:
            if not self.registered:
                reply = rpc_call(
                    self.coordinator_url,
                    "mesh.register",
                    {
                        "host_id": self.host_id,
                        "control_url": self.control_url,
                        "data_url": self.data_url,
                        "step": int(self.fleet.fleet_step),
                    },
                    timeout_s=self.heartbeat_interval_s * 4 + 1.0,
                )
                self.registered = bool(reply.get("registered"))
            else:
                reply = rpc_call(
                    self.coordinator_url,
                    "mesh.heartbeat",
                    {
                        "host_id": self.host_id,
                        "step": int(self.fleet.fleet_step),
                        "metrics": self._gossip_payload(),
                    },
                    timeout_s=self.heartbeat_interval_s * 4 + 1.0,
                )
                self.beats_sent += 1
                if not reply.get("registered"):
                    self.registered = False  # coordinator restarted
                    return
        except MeshRpcError:
            self.registered = False
            return
        self._maybe_catch_up(reply)

    def _gossip_payload(self) -> dict:
        """The host's merged metrics namespace — occupancy, queue
        depths, drain estimate, p95s — rides every heartbeat."""
        try:
            return self.router.snapshot()
        except Exception:  # noqa: BLE001 — gossip is advisory
            return {}

    def _maybe_catch_up(self, reply: dict) -> None:
        """A mesh_step ahead of the local fleet means this host missed
        a commit round — reload the advertised checkpoint locally, OFF
        the heartbeat thread: a restore + per-replica upload can take
        longer than the lease, and a host silenced by its own recovery
        would be spuriously declared dead mid-catch-up. One catch-up
        in flight at a time; failures cost a retry on a later beat,
        never the lane."""
        mesh_step = int(reply.get("mesh_step", -1))
        mesh_path = reply.get("mesh_path")
        if mesh_step <= int(self.fleet.fleet_step) or not mesh_path:
            return
        if (
            self._catch_up_thread is not None
            and self._catch_up_thread.is_alive()
        ):
            return  # already catching up; beats keep flowing

        def _do_catch_up() -> None:
            try:
                landed = self.fleet.reload_pinned(mesh_path)
            except Exception:  # noqa: BLE001 — retried on a later beat
                self.catch_up_failures += 1
                return
            if landed:
                self.catch_ups += 1
                get_registry().counter("mesh_catch_ups_total").inc()

        self._catch_up_thread = threading.Thread(
            target=_do_catch_up,
            name=f"mesh-catch-up-{self.host_id}",
            daemon=True,
        )
        self._catch_up_thread.start()

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self._beat_once()
            except Exception:  # noqa: BLE001 — the lane must outlive
                # any single beat; the lease taxonomy (not a dead
                # thread) owns declaring this host gone.
                self.registered = False
            self._stop.wait(self.heartbeat_interval_s)

    # -- lifecycle -------------------------------------------------------

    def start(self) -> "HostAgent":
        self._server.start()
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop,
                name=f"mesh-agent-{self.host_id}",
                daemon=True,
            )
            self._thread.start()
        return self

    def stop(self, deregister: bool = True) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
        if deregister and self.registered:
            try:
                rpc_call(
                    self.coordinator_url,
                    "mesh.deregister",
                    {"host_id": self.host_id},
                    timeout_s=2.0,
                )
            except MeshRpcError:
                pass
        self._server.stop()

    def wait_registered(self, timeout_s: float = 10.0) -> bool:
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if self.registered:
                return True
            time.sleep(0.02)
        return self.registered

    def __enter__(self) -> "HostAgent":
        return self.start()

    def __exit__(self, *exc: Any) -> None:
        self.stop()
