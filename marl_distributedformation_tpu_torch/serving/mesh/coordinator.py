"""MeshCoordinator: the control plane above per-host fleets.

Counterpart of the JAX package's ``serving/mesh/coordinator.py``, the same
code over the port's checkpoint discovery, chaos plane and metrics. The
host tier's single source of truth: a stdlib RPC service owning

- **the host registry** — hosts register ``(host_id, control_url,
  data_url, step)`` and renew a lease with every heartbeat; the
  heartbeat payload is the host's merged ``/v1/metrics`` namespace, so
  occupancy, queue depths, and p95s gossip upward with no extra
  endpoint (the MetaRouter routes off exactly this payload);
- **the health taxonomy** — a host that misses its lease turns
  ``suspect``; ``dead_after_s`` later it is ``dead`` (out of routing,
  out of barrier rounds) until a fresh heartbeat revives it. A revived
  or late-joining host whose served step is BEHIND the mesh step stays
  quarantined from routing until it catches up (the heartbeat reply
  carries the newest committed checkpoint path; the agent reloads
  locally and the next beat re-admits it) — "broken replicas still
  receive the new params" carried up a tier;
- **the cross-host reload barrier** — a two-phase generalization of the
  fleet's batch-barrier commit. ``global_reload`` drives PREPARE on
  every routable host (each host stages the checkpoint, closes its
  gates, and acquires every local replica barrier — it serves nothing
  while staged), and only when EVERY host acks does it drive COMMIT;
  any refusal, wedge, or timeout aborts the whole round and every host
  resumes on the old step. Because all hosts pause before any host
  commits, ``model_step`` stays globally monotonic in response
  completion order ACROSS hosts — the single-host invariant restated
  at the mesh tier. The pinned-reload exemption rides up unchanged:
  ``reload_pinned(..., monotonic=False)`` is the mesh-wide audited
  rollback.

The coordinator is duck-type-compatible with ``FleetReloadCoordinator``
where the pipeline supervisor touches it (``log_dir`` / ``refresh`` /
``fleet_step`` / ``reload_pinned`` / ``swap_count`` / ``load_errors`` /
``last_commit``), so ``AlwaysLearningPipeline.attach_fleet`` promotes
the always-learning loop to the mesh with zero supervisor changes: the
Promoter publishes ONCE into ``promoted/``, and this coordinator drives
the global commit.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from pathlib import Path
from typing import Any, Deque, Dict, List, Optional, Tuple

from marl_distributedformation_tpu_torch.chaos.plane import fault_point
from marl_distributedformation_tpu_torch.obs import get_registry, get_tracer
from marl_distributedformation_tpu_torch.serving.mesh.rpc import (
    JsonRpcServer,
    MeshRpcError,
    MeshUnreachable,
    rpc_call,
)
from marl_distributedformation_tpu_torch.utils.checkpoint import (
    CheckpointDiscovery,
    checkpoint_step,
)

HOST_ALIVE = "alive"
HOST_SUSPECT = "suspect"
HOST_DEAD = "dead"


@dataclasses.dataclass
class MeshHost:
    """One registered host's control-plane state."""

    host_id: str
    control_url: str
    data_url: str
    # Every mutable field below is owned by the coordinator's registry
    # lock: heartbeats, sweeps, out-of-band death verdicts, and commit
    # legs all mutate through ``MeshCoordinator._hosts_lock``.
    step: int  # graftlock: guarded-by=_hosts_lock — newest KNOWN served step
    last_beat: float  # graftlock: guarded-by=_hosts_lock — monotonic
    metrics: Dict[str, Any] = dataclasses.field(default_factory=dict)  # graftlock: guarded-by=_hosts_lock
    beats: int = 0  # graftlock: guarded-by=_hosts_lock
    forced_dead: bool = False  # graftlock: guarded-by=_hosts_lock — out-of-band
    # death verdict (barrier RPC unreachable); a fresh heartbeat clears it
    dead_reason: str = ""  # graftlock: guarded-by=_hosts_lock
    committed_round: int = -1  # graftlock: guarded-by=_hosts_lock — last acked commit round

    def record(self, state: str) -> dict:
        return {
            "host_id": self.host_id,
            "control_url": self.control_url,
            "data_url": self.data_url,
            "step": int(self.step),
            "state": state,
            "beats": int(self.beats),
            "dead_reason": self.dead_reason,
        }


class MeshCoordinator:
    """Host registry + gossip + the coordinator-barriered global reload.

    Args:
      log_dir: the ``promoted/`` directory whose newest checkpoint the
        mesh should serve (``refresh`` polls it once for the WHOLE
        mesh — the fleet coordinator's poll-once discipline, one tier
        up). ``None`` disables discovery (``global_reload`` by explicit
        path still works).
      lease_s: heartbeat lease; a host silent past it is ``suspect``.
      dead_after_s: additional silence before ``suspect`` becomes
        ``dead`` (out of routing and barrier rounds).
      prepare_timeout_s: per-host bound on the PREPARE RPC — a host
        wedged mid-stage aborts the round (every host restored) instead
        of pausing the mesh forever.
      commit_timeout_s: per-host bound on the COMMIT RPC; an
        unreachable host at commit time is marked dead (it serves
        nothing), the round still lands on the others.
      host/port: the RPC bind address (``port=0`` = ephemeral).
      model_id: optional tenant lane (serving/tenancy) this
        coordinator's watched directory promotes — stamped into
        ``last_commit`` so the promotion log's mesh attribution
        (schema 5) names the lane a global swap landed for.
    """

    def __init__(
        self,
        log_dir: Optional[str | Path] = None,
        lease_s: float = 2.0,
        dead_after_s: float = 4.0,
        prepare_timeout_s: float = 30.0,
        commit_timeout_s: float = 10.0,
        prepare_ttl_s: float = 60.0,
        poll_interval_s: float = 2.0,
        max_recorded_errors: int = 32,
        host: str = "127.0.0.1",
        port: int = 0,
        model_id: Optional[str] = None,
    ) -> None:
        self.log_dir = Path(log_dir) if log_dir is not None else None
        self.model_id = model_id
        self.lease_s = float(lease_s)
        self.dead_after_s = float(dead_after_s)
        self.prepare_timeout_s = float(prepare_timeout_s)
        self.commit_timeout_s = float(commit_timeout_s)
        # Host-side orphan bound, advertised with every PREPARE: must
        # outlive a live coordinator's whole round so it only ever
        # fires when the coordinator itself died mid-round.
        self.prepare_ttl_s = float(prepare_ttl_s)
        self.poll_interval_s = float(poll_interval_s)
        self.swap_count = 0  # graftlock: guarded-by=_refresh_lock
        self.commit_round = 0  # graftlock: guarded-by=_refresh_lock
        self.last_commit: Optional[dict] = None  # graftlock: guarded-by=_refresh_lock
        self.last_commit_path: Optional[str] = None  # graftlock: guarded-by=_refresh_lock
        # Unannotated on purpose: deque.append is atomic under the GIL
        # and the watch thread records poll failures without a lock.
        self.load_errors: Deque[Tuple[str, str]] = deque(
            maxlen=max_recorded_errors
        )
        self._mesh_step = -1  # graftlock: guarded-by=_hosts_lock
        self._hosts: Dict[str, MeshHost] = {}  # graftlock: guarded-by=_hosts_lock
        # Held on EVERY heartbeat/register RPC; any blocking work under
        # it stalls the whole gossip plane — hence the gate marking.
        self._hosts_lock = threading.Lock()  # graftlock: gate
        self._refresh_lock = threading.Lock()
        self._discovery = (
            CheckpointDiscovery(self.log_dir)
            if self.log_dir is not None
            else None
        )
        self._server = JsonRpcServer(
            {
                "mesh.register": self._rpc_register,
                "mesh.heartbeat": self._rpc_heartbeat,
                "mesh.deregister": self._rpc_deregister,
                "mesh.hosts": self._rpc_hosts,
            },
            host=host,
            port=port,
        )
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle -------------------------------------------------------

    @property
    def url(self) -> str:
        return self._server.url

    def start(self) -> "MeshCoordinator":
        """Serve the RPC endpoint and run the background watcher
        (directory poll + health sweep)."""
        self._server.start()
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._watch, name="mesh-coordinator", daemon=True
            )
            self._thread.start()
        return self

    def serve(self) -> "MeshCoordinator":
        """RPC endpoint only — no background poll (tests and callers
        that drive ``refresh()`` explicitly)."""
        self._server.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
        self._server.stop()

    def _watch(self) -> None:
        while not self._stop.wait(self.poll_interval_s):
            try:
                self.sweep()
                self.refresh()
            except Exception as e:  # noqa: BLE001 — the control plane
                # must outlive a transient poll failure
                self.load_errors.append(("<watch>", repr(e)))

    def __enter__(self) -> "MeshCoordinator":
        return self.start()

    def __exit__(self, *exc: Any) -> None:
        self.stop()

    # -- registry + gossip (RPC handlers) --------------------------------

    def _rpc_register(self, payload: dict) -> dict:
        host_id = str(payload["host_id"])
        with self._hosts_lock:
            self._hosts[host_id] = MeshHost(
                host_id=host_id,
                control_url=str(payload["control_url"]),
                data_url=str(payload["data_url"]),
                step=int(payload.get("step", -1)),
                last_beat=time.monotonic(),
            )
            # A mesh bootstrapping from already-serving hosts adopts
            # the newest step any of them serves (the fleet
            # coordinator's seeding rule, one tier up).
            if self._mesh_step < 0:
                self._mesh_step = max(
                    h.step for h in self._hosts.values()
                )
        get_registry().counter("mesh_registrations_total").inc()
        return self._beat_reply()

    def _rpc_heartbeat(self, payload: dict) -> dict:
        fault_point("mesh.heartbeat")
        host_id = str(payload["host_id"])
        with self._hosts_lock:
            h = self._hosts.get(host_id)
            if h is None:
                # Coordinator restarted (or the host was pruned): tell
                # the agent to re-register rather than silently gossip
                # into the void.
                return {"registered": False}
            h.last_beat = time.monotonic()
            h.beats += 1
            if h.forced_dead:
                h.forced_dead = False
                h.dead_reason = ""
            if "step" in payload:
                beat_step = int(payload["step"])
                if (
                    h.committed_round == self.commit_round
                    and beat_step != h.step
                ):
                    # A beat sent BEFORE this round's commit landed on
                    # the host but processed after the commit leg
                    # recorded its step — the host provably installed
                    # this round's step (it acked the commit) and only
                    # the coordinator moves steps, so a disagreeing
                    # beat is stale; honoring it would transiently
                    # quarantine a freshly-committed host.
                    pass
                else:
                    h.step = beat_step
            metrics = payload.get("metrics")
            if isinstance(metrics, dict):
                h.metrics = metrics
        return self._beat_reply()

    def _rpc_deregister(self, payload: dict) -> dict:
        with self._hosts_lock:
            self._hosts.pop(str(payload.get("host_id", "")), None)
        return {"ok": True}

    def _rpc_hosts(self, payload: dict) -> dict:
        return {"hosts": self.hosts()}

    def _beat_reply(self) -> dict:
        """What every register/heartbeat response carries: the lease
        terms plus the mesh's serving target, so a stale host learns it
        must catch up (``mesh_path`` is the checkpoint to reload)."""
        return {
            "registered": True,
            "lease_s": self.lease_s,
            "mesh_step": int(self._mesh_step),
            "mesh_path": self.last_commit_path,
            "commit_round": int(self.commit_round),
        }

    # -- health ----------------------------------------------------------

    def _state(self, h: MeshHost, now: float) -> str:
        if h.forced_dead:
            return HOST_DEAD
        silence = now - h.last_beat
        if silence <= self.lease_s:
            return HOST_ALIVE
        if silence <= self.lease_s + self.dead_after_s:
            return HOST_SUSPECT
        return HOST_DEAD

    def hosts(self) -> List[dict]:
        """Registry snapshot with the computed health state."""
        now = time.monotonic()
        with self._hosts_lock:
            return [
                h.record(self._state(h, now))
                for h in self._hosts.values()
            ]

    def routable_hosts(self) -> List[MeshHost]:
        """Hosts the MetaRouter may send traffic to: not dead AND
        serving EXACTLY the mesh step. A host behind (revived/late,
        missed a commit) OR ahead (a lost-ack commit the round never
        counted) is quarantined — either skew, routed next to an
        at-step peer, interleaves different ``model_step``s in
        response completion order, the exact violation the barrier
        exists to prevent. Behind-hosts catch up via the heartbeat's
        advertised path; ahead-hosts re-admit when the next refresh
        round counts them (``already_at_step``) and advances the mesh
        step."""
        now = time.monotonic()
        with self._hosts_lock:
            return [
                h
                for h in self._hosts.values()
                if self._state(h, now) != HOST_DEAD
                and (self._mesh_step < 0 or h.step == self._mesh_step)
            ]

    def barrier_hosts(self) -> List[MeshHost]:
        """Hosts a reload round must include: every not-dead host,
        stale ones too (the round is exactly how they advance)."""
        now = time.monotonic()
        with self._hosts_lock:
            return [
                h
                for h in self._hosts.values()
                if self._state(h, now) != HOST_DEAD
            ]

    def sweep(self) -> None:
        """Record health transitions (counters + incident on a death).
        State is computed from timestamps on every read, so the sweep
        only exists to make transitions OBSERVABLE, not to make them
        happen."""
        now = time.monotonic()
        alive = suspect = dead = 0
        died: List[Tuple[str, float]] = []
        with self._hosts_lock:
            total = len(self._hosts)
            for h in self._hosts.values():
                state = self._state(h, now)
                if state == HOST_ALIVE:
                    alive += 1
                elif state == HOST_SUSPECT:
                    suspect += 1
                else:
                    dead += 1
                    if not h.dead_reason:
                        # The verdict write stays under the registry
                        # lock — heartbeats clear dead_reason and
                        # mark_dead sets it, both under _hosts_lock.
                        h.dead_reason = (
                            f"lease expired {now - h.last_beat:.2f}s ago"
                        )
                        died.append((h.host_id, now - h.last_beat))
        # Counters and the incident dump run AFTER release: the tracer's
        # ring lock must never nest under the heartbeat dispatch lock.
        registry = get_registry()
        for host_id, silence_s in died:
            registry.counter("mesh_host_deaths_total").inc()
            get_tracer().incident(
                "mesh_host_dead",
                host_id=host_id,
                silence_s=round(silence_s, 3),
            )
        registry.gauge("mesh_hosts").set(total)
        registry.gauge("mesh_hosts_alive").set(alive)
        registry.gauge("mesh_hosts_suspect").set(suspect)
        registry.gauge("mesh_hosts_dead").set(dead)

    def mark_dead(self, host_id: str, reason: str) -> None:
        """Out-of-band death verdict (an unreachable barrier RPC, the
        MetaRouter's circuit breaker). A fresh heartbeat revives."""
        with self._hosts_lock:
            h = self._hosts.get(host_id)
            if h is None or h.forced_dead:
                return
            h.forced_dead = True
            h.dead_reason = reason
        get_registry().counter("mesh_host_deaths_total").inc()
        get_tracer().incident(
            "mesh_host_dead", host_id=host_id, reason=reason
        )

    # -- the cross-host reload barrier -----------------------------------

    @property
    def fleet_step(self) -> int:
        """The step every post-commit response carries, mesh-wide (the
        FleetReloadCoordinator-compatible name the supervisor reads)."""
        return self._mesh_step

    def refresh(self, trace_id: Optional[str] = None) -> bool:
        """Poll the promoted directory ONCE for the whole mesh;
        global-reload if a newer checkpoint landed."""
        if self._discovery is None:
            return False
        with self._refresh_lock:
            path = self._discovery.latest()
            if path is None:
                return False
            step = checkpoint_step(path)
            if step <= self._mesh_step:
                return False
            return self._global_reload_locked(
                path, step, monotonic=True, trace_id=trace_id
            )

    def reload_pinned(
        self,
        path: str | Path,
        monotonic: bool = True,
        trace_id: Optional[str] = None,
    ) -> bool:
        """Mesh-wide pinned swap; ``monotonic=False`` is the audited
        rollback exemption carried up from the fleet tier — same
        containment contract (failures recorded, old step serves)."""
        path = Path(path)
        with self._refresh_lock:
            try:
                step = checkpoint_step(path)
            except ValueError as e:
                self.load_errors.append((str(path), repr(e)))
                return False
            if monotonic and step <= self._mesh_step:
                return False
            if step == self._mesh_step:
                return False
            return self._global_reload_locked(
                path, step, monotonic=monotonic, trace_id=trace_id
            )

    def global_reload(
        self,
        path: str | Path,
        monotonic: bool = True,
        trace_id: Optional[str] = None,
    ) -> bool:
        """Explicit-path global swap (the CLI / smoke entry)."""
        return self.reload_pinned(path, monotonic=monotonic, trace_id=trace_id)

    # graftlock: holds=_refresh_lock
    def _global_reload_locked(
        self,
        path: Path,
        step: int,
        monotonic: bool,
        trace_id: Optional[str],
    ) -> bool:
        """Two-phase commit over every barrier-eligible host. Caller
        holds ``_refresh_lock``."""
        hosts = self.barrier_hosts()
        if not hosts:
            self.load_errors.append(
                (str(path), "no live hosts to commit to")
            )
            return False
        tracer = get_tracer()
        registry = get_registry()
        self.commit_round += 1
        round_id = self.commit_round
        t0 = time.perf_counter()
        staged: List[MeshHost] = []
        already: List[MeshHost] = []
        abort_reason = ""
        with tracer.span(
            "mesh.prepare", trace_id=trace_id, step=step, round=round_id,
            hosts=len(hosts),
        ):
            for h in hosts:
                try:
                    fault_point("mesh.rpc")
                    resp = rpc_call(
                        h.control_url,
                        "mesh.prepare",
                        {
                            "round": round_id,
                            "path": str(path),
                            "step": step,
                            "monotonic": monotonic,
                            "trace_id": trace_id,
                            "ttl_s": self.prepare_ttl_s,
                        },
                        timeout_s=self.prepare_timeout_s,
                    )
                except MeshUnreachable as e:
                    # SAFETY over progress: a host we cannot reach may
                    # still be serving the old step — committing the
                    # others would let its in-flight old-step responses
                    # complete after new-step ones. Abort the round;
                    # the health plane (missed leases) owns declaring
                    # it dead, after which the retry round proceeds
                    # without it.
                    abort_reason = (
                        f"host {h.host_id} unreachable at prepare: {e}"
                    )
                    break
                except MeshRpcError as e:
                    abort_reason = (
                        f"host {h.host_id} prepare failed: {e}"
                    )
                    break
                except Exception as e:  # noqa: BLE001 — injected fault
                    # (chaos plane) or a coordinator-side bug: same
                    # abort path, the control plane must not die.
                    abort_reason = f"prepare leg failed: {e!r}"
                    break
                if resp.get("already_at_step"):
                    # The host already serves this step (a commit ack
                    # lost to a timeout, a catch-up that won the race):
                    # nothing to stage or pause — count it committed.
                    already.append(h)
                    continue
                if not resp.get("staged"):
                    abort_reason = (
                        f"host {h.host_id} refused prepare: "
                        f"{resp.get('reason', 'unknown')}"
                    )
                    break
                staged.append(h)
        if abort_reason:
            # Best-effort abort to EVERY round participant, not just
            # the acked ones: a host whose prepare wedged past our
            # timeout may stage AFTER this abort round-trips — the
            # next round's refused-prepare -> abort (and the host-side
            # TTL) are the backstops that release it.
            for h in hosts:
                try:
                    rpc_call(
                        h.control_url,
                        "mesh.abort",
                        {"round": round_id, "reason": abort_reason},
                        timeout_s=self.commit_timeout_s,
                    )
                except MeshRpcError:
                    pass  # its prepare TTL is the backstop
            self.load_errors.append(
                (
                    str(path),
                    f"round {round_id} aborted: {abort_reason}; every "
                    "host restored, old step keeps serving mesh-wide",
                )
            )
            registry.counter("mesh_reload_aborts_total").inc()
            tracer.incident(
                "mesh_barrier_abort",
                trace_id=trace_id,
                round=round_id,
                step=step,
                reason=abort_reason,
                staged_hosts=[h.host_id for h in staged],
            )
            return False
        committed = 0
        with tracer.span(
            "mesh.commit", trace_id=trace_id, step=step, round=round_id,
        ):
            for h in staged:
                # The commit leg is the one place a transient failure
                # would leave a host staged-and-paused with requests
                # parked behind its gates — retried, because a parked
                # request resuming on the OLD step after others served
                # the new one is the exact violation this barrier
                # exists to prevent. A host UNREACHABLE through every
                # retry is presumed dead: staged means paused, so it
                # serves nothing until its prepare TTL aborts it, and
                # its stale step then keeps it out of routing until
                # catch-up.
                ok = False
                for commit_try in range(3):
                    try:
                        fault_point("mesh.rpc")
                        resp = rpc_call(
                            h.control_url,
                            "mesh.commit",
                            {"round": round_id, "trace_id": trace_id},
                            timeout_s=self.commit_timeout_s,
                        )
                        ok = bool(resp.get("ok"))
                        break
                    except MeshUnreachable as e:
                        if commit_try == 2:
                            self.mark_dead(
                                h.host_id,
                                f"unreachable at commit: {e}",
                            )
                    except Exception:  # noqa: BLE001 — injected
                        # fault (chaos) or a coordinator-side bug on
                        # this leg: retry; the host-side handler is
                        # idempotent per round.
                        pass
                if ok:
                    committed += 1
                    with self._hosts_lock:
                        h.step = step
                        h.committed_round = round_id
        for h in already:
            committed += 1
            with self._hosts_lock:
                h.step = step
                h.committed_round = round_id
        if committed == 0:
            self.load_errors.append(
                (
                    str(path),
                    f"round {round_id}: no host committed; old step "
                    "keeps serving",
                )
            )
            registry.counter("mesh_reload_aborts_total").inc()
            return False
        with self._hosts_lock:
            # The mesh step is the heartbeat/quarantine comparison point
            # (read by _beat_reply and routable_hosts under _hosts_lock)
            # — advancing it under only _refresh_lock let a concurrent
            # beat observe the new step before the host records did.
            self._mesh_step = step
        self.swap_count += 1
        self.last_commit_path = str(path)
        self.last_commit = {
            "commit_round": round_id,
            "host_count": committed,
            "step": step,
        }
        if self.model_id is not None:
            self.last_commit["model_id"] = self.model_id
        swap_s = time.perf_counter() - t0
        registry.counter("mesh_global_swaps_total").inc()
        registry.gauge("mesh_step").set(step)
        registry.histogram("mesh_global_swap_seconds").observe(swap_s)
        return True
