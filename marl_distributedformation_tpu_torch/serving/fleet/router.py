"""FleetRouter: N serving engines behind one submit surface.

Counterpart of the JAX package's ``serving/fleet/router.py``. Each replica
is the whole single-engine stack — a ``BucketedPolicyEngine`` (one CUDA
graph a rung, its own stream, pinned staging and generator) plus its own
``MicroBatchScheduler`` worker thread — and the router does only what a
replica cannot do for itself:

- **Route.** Every request goes to the healthy replica with the lowest
  estimated drain time (queue depth x recent mean batch wall-clock, the
  in-flight batch counted). Joining the shortest *time* queue keeps a
  replica that got slow from growing a latency tail.
- **Degrade.** A replica whose worker dies or whose budget-1
  ``RetraceGuard`` trips (a rung captured during traffic) is
  circuit-broken: marked unhealthy, its queued requests failed over to
  surviving replicas (bounded by ``max_failovers`` hops and the request's
  own deadline), and re-probed half-open after ``probe_interval_s`` (one
  routed request is the probe; a still-broken replica fails it over and
  re-breaks). The fleet keeps serving at reduced width.
- **Reject honestly.** Only when EVERY healthy replica rejects does the
  router raise fleet-level :class:`BackpressureError`, carrying the
  smallest ``retry_after_s`` any replica quoted, so ``ServingClient``
  works unchanged over a fleet.

Placement: ``devices`` defaults to every CUDA device; more replicas than
devices cycle over them, so on one card ``num_replicas=2`` is two whole
serving stacks on ``cuda:0`` (the CPU only when asked for,
``devices=["cpu"]``). Each replica's registry holds its own copy of the
parameters on its device, never an alias of the policy's. Rungs are
captured at their first dispatch (``serving/engine.py``):
``smoke.warmup_fleet`` captures every rung of every replica before
traffic, so a capture during traffic is a rebuild the budget refuses.

The sharded big-rung replica (``sharded=``), ``build_sharded_replica``
and the elastic membership swap are not ported: they raise naming their
ROADMAP items.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from concurrent.futures import Future
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from marl_distributedformation_tpu_torch.analysis.guards import RetraceError
from marl_distributedformation_tpu_torch.obs import get_tracer
from marl_distributedformation_tpu_torch.serving.engine import (
    DEFAULT_BUCKETS,
    BucketedPolicyEngine,
)
from marl_distributedformation_tpu_torch.serving.fleet.metrics import (
    FleetMetrics,
)
from marl_distributedformation_tpu_torch.serving.fleet.reload import (
    ReplicaRegistry,
    device_copy,
)
from marl_distributedformation_tpu_torch.serving.scheduler import (
    BackpressureError,
    MicroBatchScheduler,
    SchedulerStopped,
)


class NoHealthyReplicas(RuntimeError):
    """Every replica is circuit-broken: the fleet is down, not busy."""


# Exceptions that indict the REPLICA, not the request: the router breaks
# the circuit and fails the request over. Everything else (RequestTimeout,
# a ValueError for malformed rows) is the caller's own outcome and
# propagates untouched.
_REPLICA_FAULTS = (SchedulerStopped, RetraceError)


def default_devices() -> List[torch.device]:
    """Every CUDA device; raises without one (the CPU only when asked
    for)."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError(
            "no CUDA device for the fleet: pass devices=['cpu'] (or "
            "device='cpu' to fleet_from_checkpoint_dir) to serve on the CPU"
        )
    return [torch.device("cuda", i) for i in range(n)]


@dataclasses.dataclass
class Replica:
    """One replica's serving stack plus its circuit-breaker state (owned
    by ``FleetRouter._health_lock``)."""

    index: int
    device: Any
    engine: BucketedPolicyEngine
    scheduler: MicroBatchScheduler
    registry: ReplicaRegistry
    healthy: bool = True
    broken_at: float = 0.0
    break_reason: str = ""
    # Tenant lanes: one (params, step) cell a lane, each with its own
    # batch barrier; ``registry`` is then the first lane's cell.
    registries: Optional[Dict[str, ReplicaRegistry]] = None


class FleetRouter:
    """Queue-depth routing + circuit breaking over per-device replicas.

    Args:
      policy: a ``compat.policy.LoadedPolicy`` (the shared model
        definition; each replica gets its own engine and its own copy of
        the parameters on its device).
      devices: devices to replicate over; default every CUDA device.
      num_replicas: replica count; default one a device. More replicas
        than devices cycle over them.
      max_failovers: how many times one accepted request may be re-routed
        off a broken replica before its failure reaches the caller.
      probe_interval_s: how long a broken replica stays out of rotation
        before a half-open probe readmits it.
      initial_step: the ``model_step`` the seeded params report.
      logger: optional ``MetricsLogger``; the fleet snapshot is emitted
        every ``emit_every`` routed requests.
      lanes: optional ``model_id`` → ``(params, step)`` mapping: every
        replica serves tenant lanes (a registry cell a lane, each with its
        own barrier and monotonic step; the scheduler in tenant mode), and
        ``submit`` requires a ``model_id``. The lanes share each replica's
        engine and its captured rungs (same architecture).
      tenant_max_queue: per-lane admission bound in lanes mode.
      trace_recorder: optional ``loadgen.TraceRecorder`` shared by every
        replica's scheduler (the fleet's arrival process).
      sharded: not ported (ROADMAP A13 with A12); must be None.
    """

    def __init__(
        self,
        policy: Any,
        devices: Optional[Sequence[Any]] = None,
        num_replicas: Optional[int] = None,
        buckets: Tuple[int, ...] = DEFAULT_BUCKETS,
        window_ms: float = 2.0,
        max_queue: int = 256,
        default_timeout_s: float = 10.0,
        seed: int = 0,
        max_failovers: int = 1,
        probe_interval_s: float = 1.0,
        initial_step: int = 0,
        metrics: Optional[FleetMetrics] = None,
        logger: Any = None,
        emit_every: int = 200,
        sharded: Any = None,
        lanes: Any = None,
        tenant_max_queue: Optional[int] = None,
        trace_recorder: Any = None,
    ) -> None:
        if sharded is not None:
            raise NotImplementedError(
                "the sharded big-rung replica is not ported yet (ROADMAP "
                "A13: serving/sharded.py, with A12)"
            )
        devs = ([torch.device(d) for d in devices] if devices is not None
                else default_devices())
        if not devs:
            raise ValueError("need at least one device to build a fleet")
        n = len(devs) if num_replicas is None else int(num_replicas)
        if n < 1:
            raise ValueError(f"need at least one replica, got {n}")
        if lanes is not None and not lanes:
            raise ValueError("lanes must declare at least one model lane")
        self.policy = policy
        self.lane_ids: Tuple[str, ...] = (
            tuple(lanes) if lanes is not None else ()
        )
        self.default_timeout_s = default_timeout_s
        self.max_failovers = max_failovers
        self.probe_interval_s = probe_interval_s
        self.metrics = metrics or FleetMetrics()
        self.logger = logger
        self.emit_every = emit_every
        self.trace_recorder = trace_recorder
        self._health_lock = threading.Lock()
        self._stopping = False
        self.replicas: List[Replica] = []
        for i in range(n):
            dev = devs[i % len(devs)]
            engine = BucketedPolicyEngine(
                policy, buckets=buckets, seed=seed + i, device=dev
            )
            if lanes is not None:
                registries = {
                    mid: ReplicaRegistry(
                        device_copy(lane_params, dev), step=lane_step,
                        device=dev,
                    )
                    for mid, (lane_params, lane_step) in lanes.items()
                }
                registry = registries[next(iter(registries))]
                scheduler = MicroBatchScheduler(
                    engine, registries=registries, max_queue=max_queue,
                    tenant_max_queue=tenant_max_queue, window_ms=window_ms,
                    default_timeout_s=default_timeout_s,
                    trace_recorder=trace_recorder,
                )
            else:
                registries = None
                registry = ReplicaRegistry(
                    device_copy(policy.params, dev), step=initial_step,
                    device=dev,
                )
                scheduler = MicroBatchScheduler(
                    engine, registry=registry, max_queue=max_queue,
                    window_ms=window_ms,
                    default_timeout_s=default_timeout_s,
                    trace_recorder=trace_recorder,
                )
            self.replicas.append(Replica(
                index=i, device=dev, engine=engine, scheduler=scheduler,
                registry=registry, registries=registries,
            ))

    # -- lifecycle -------------------------------------------------------

    def start(self) -> "FleetRouter":
        self._stopping = False
        for r in self.replicas:
            r.scheduler.start()
        return self

    def stop(self) -> None:
        # Flag first: each scheduler's drain fails its queued futures with
        # SchedulerStopped, which must not bounce between replicas that
        # are shutting down too.
        self._stopping = True
        for r in self.replicas:
            r.scheduler.stop()

    def __enter__(self) -> "FleetRouter":
        return self.start()

    def __exit__(self, *exc: Any) -> None:
        self.stop()

    # -- client side -----------------------------------------------------

    def submit(
        self,
        obs: np.ndarray,
        deterministic: bool = True,
        timeout_s: Optional[float] = None,
        on_result: Optional[Any] = None,
        trace_id: Optional[str] = None,
        slo_class: str = "interactive",
        model_id: Optional[str] = None,
    ) -> Future:
        """Route one request; returns a future resolving to
        ``ServedResult`` (with ``.replica`` set). Raises
        :class:`BackpressureError` when every healthy replica is full,
        :class:`NoHealthyReplicas` when the whole fleet is broken.

        ``on_result(result)`` runs at resolution time INSIDE the serving
        replica's batch-barrier region, strictly before the reload
        coordinator can commit a swap: the race-free place to observe
        fleet-wide completion order (the smoke storm's monotonicity
        witness). Keep it cheap: it runs on the dispatch path."""
        timeout = self.default_timeout_s if timeout_s is None else timeout_s
        deadline = time.perf_counter() + timeout
        outer: Future = Future()
        replica, inner = self._route(
            obs, deterministic, timeout_s, set(), trace_id, slo_class,
            model_id,
        )
        self._chain(
            replica, inner, outer, obs, deterministic, timeout_s, hops=0,
            tried={replica.index}, deadline=deadline, on_result=on_result,
            trace_id=trace_id, slo_class=slo_class, model_id=model_id,
        )
        return outer

    # -- routing ---------------------------------------------------------

    def _route(
        self,
        obs: np.ndarray,
        deterministic: bool,
        timeout_s: Optional[float],
        tried: Set[int],
        trace_id: Optional[str] = None,
        slo_class: str = "interactive",
        model_id: Optional[str] = None,
    ) -> Tuple[Replica, Future]:
        """Submit to the best healthy replica not in ``tried``, walking
        down the drain-time order past individually full replicas."""
        self._probe_broken()
        candidates = sorted(
            (r for r in self.replicas
             if r.healthy and r.index not in tried),
            key=lambda r: r.scheduler.estimated_drain_s(model_id),
        )
        rejections: List[BackpressureError] = []
        for r in candidates:
            if not r.scheduler.alive:
                self._break(r, "worker thread dead at routing time")
                continue
            try:
                inner = r.scheduler.submit(
                    obs, deterministic=deterministic, timeout_s=timeout_s,
                    trace_id=trace_id, slo_class=slo_class,
                    model_id=model_id,
                )
                return r, inner
            except BackpressureError as e:
                rejections.append(e)
            except ValueError:
                raise  # malformed request: the caller's problem, as is
            except RuntimeError as e:
                # "scheduler not started" / racing a concurrent stop().
                self._break(r, f"submit failed: {e!r}")
        if rejections:
            self.metrics.record_rejected()
            raise BackpressureError(min(e.retry_after_s for e in rejections))
        raise NoHealthyReplicas(
            f"all {len(self.replicas)} replicas are circuit-broken: "
            + "; ".join(
                f"replica{r.index}: {r.break_reason or 'unknown'}"
                for r in self.replicas if not r.healthy
            )
        )

    def _chain(
        self,
        replica: Replica,
        inner: Future,
        outer: Future,
        obs: np.ndarray,
        deterministic: bool,
        timeout_s: Optional[float],
        hops: int,
        tried: Set[int],
        deadline: float,
        on_result: Optional[Any] = None,
        trace_id: Optional[str] = None,
        slo_class: str = "interactive",
        model_id: Optional[str] = None,
    ) -> None:
        """Resolve ``outer`` from ``inner``, failing replica faults over
        onto a fresh replica while the hop budget and deadline allow."""

        def _done(fut: Future) -> None:
            exc = fut.exception()
            if exc is None:
                result = dataclasses.replace(
                    fut.result(), replica=replica.index)
                count = self.metrics.record_routed(replica.index)
                if on_result is not None:
                    on_result(result)
                outer.set_result(result)
                if self.logger is not None and count % self.emit_every == 0:
                    # Off the dispatch path: this callback runs inside the
                    # replica's batch barrier.
                    threading.Thread(
                        target=self._emit_snapshot, args=(count,),
                        name="fleet-metrics-emit", daemon=True,
                    ).start()
                return
            if isinstance(exc, _REPLICA_FAULTS) and not self._stopping:
                self._break(replica, repr(exc))
                if hops < self.max_failovers and time.perf_counter() < deadline:
                    try:
                        nxt, nfut = self._route(
                            obs, deterministic, timeout_s, tried, trace_id,
                            slo_class, model_id,
                        )
                    except Exception as routing_exc:  # noqa: BLE001
                        outer.set_exception(routing_exc)
                        return
                    self.metrics.record_failover()
                    self._chain(
                        nxt, nfut, outer, obs, deterministic, timeout_s,
                        hops + 1, tried | {nxt.index}, deadline,
                        on_result=on_result, trace_id=trace_id,
                        slo_class=slo_class, model_id=model_id,
                    )
                    return
            outer.set_exception(exc)

        inner.add_done_callback(_done)

    def _emit_snapshot(self, count: int) -> None:
        try:
            self.logger.log(self.snapshot(), step=count)
        except Exception:  # noqa: BLE001 — observability never kills serving
            pass

    # -- health ----------------------------------------------------------

    def _break(self, replica: Replica, reason: str) -> None:
        with self._health_lock:
            if not replica.healthy:
                return
            replica.healthy = False
            replica.broken_at = time.monotonic()
            replica.break_reason = reason
        self.metrics.record_break()
        if not replica.scheduler.alive:
            # A dead worker's queued futures would wedge their callers:
            # fail them now, and the failover callbacks re-route them. A
            # live worker (a RetraceError break) drains its own queue.
            replica.scheduler.fail_queued()
        get_tracer().incident(
            "circuit_break", replica=replica.index, reason=reason,
            healthy_replicas=self.healthy_replicas,
        )

    def _probe_broken(self) -> None:
        """Half-open probing on the routing path: a broken replica whose
        probe interval elapsed and whose worker is alive is readmitted;
        its next routed request is the real probe. A dead worker is never
        readmitted (the watchdog restarts it first)."""
        now = time.monotonic()
        for r in self.replicas:
            if r.healthy or now - r.broken_at < self.probe_interval_s:
                continue
            self.metrics.record_probe()
            with self._health_lock:
                if r.scheduler.alive:
                    if not r.healthy:
                        r.healthy = True
                        r.break_reason = ""
                else:
                    r.broken_at = now  # still dead; re-check next interval

    def kill_replica(self, index: int, reason: str = "killed") -> None:
        """Stop one replica's worker (a chaos hook). Its queued requests
        fail with ``SchedulerStopped`` and fail over to the survivors. The
        replica comes back when its scheduler is started again and the
        half-open probe readmits it."""
        replica = next((r for r in self.replicas if r.index == index), None)
        if replica is None:
            raise KeyError(f"no replica with index {index}")
        self._break(replica, reason)
        replica.scheduler.stop()

    @property
    def healthy_replicas(self) -> int:
        return sum(1 for r in self.replicas if r.healthy)

    # -- not ported ------------------------------------------------------

    def build_sharded_replica(self, spec: Any) -> Replica:
        """Not ported (ROADMAP A13: serving/sharded.py, with A12)."""
        raise NotImplementedError(
            "the sharded big-rung replica is not ported yet (ROADMAP A13: "
            "serving/sharded.py, with A12)"
        )

    def _commit_resplit(self, *args: Any, **kwargs: Any) -> None:
        """Not ported (ROADMAP A13: serving/elastic, with A12)."""
        raise NotImplementedError(
            "the elastic membership swap is not ported yet (ROADMAP A13: "
            "serving/elastic, with A12)"
        )

    # -- capacity --------------------------------------------------------

    def drain_replica(self, replica: Replica, timeout_s: float = 10.0) -> bool:
        """Drain-before-retire: wait for a replica nothing routes to any
        more to finish its queued work, then stop its worker. True on a
        clean drain; on timeout the worker stops anyway and its queued
        requests fail over."""
        deadline = time.perf_counter() + timeout_s
        drained = False
        while time.perf_counter() < deadline:
            sched = replica.scheduler
            if sched.queue_depth == 0 and not sched._busy:
                drained = True
                break
            time.sleep(0.002)
        replica.scheduler.stop()
        return drained

    # -- observability ---------------------------------------------------

    def snapshot(self) -> Dict[str, float]:
        """Aggregated fleet metrics plus the newest step any replica
        serves (lanes mode: any lane, with ``model_{id}__step`` keys)."""
        snap = self.metrics.snapshot(self.replicas)
        if self.lane_ids:
            steps = self.lane_steps()
            for mid, step in steps.items():
                snap[f"model_{mid}__step"] = float(step)
                snap[f"model_{mid}__queue_depth"] = float(sum(
                    r.scheduler.lane_queue_depth(mid) for r in self.replicas
                    if r.registries is not None
                ))
            snap["model_step"] = float(max(steps.values()))
        else:
            snap["model_step"] = float(
                max(r.registry.active_step for r in self.replicas))
        return snap

    def lane_steps(self) -> Dict[str, int]:
        """Per-lane served step: the newest any replica's cell holds."""
        return {
            mid: max(r.registries[mid].active_step for r in self.replicas
                     if r.registries is not None)
            for mid in self.lane_ids
        }

    def compile_counts(self) -> Dict[int, Dict[int, int]]:
        """Builds a rung a replica (a capture on the card, the eager
        build on the CPU): the fleet-wide build-once receipt, every value
        at most 1."""
        return {r.index: r.engine.compile_counts() for r in self.replicas}
