"""Elastic capacity: a live control loop that re-splits the serving
devices and re-derives the rung ladder under traffic.

Counterpart of the JAX package's ``serving/elastic/controller.py``. The
fleet boots with a capacity split chosen before traffic: how many
replicas, whether a slice owns the big rungs, which rungs exist, how long
the coalescing window waits. This module closes the loop:

1. **Observe** the gauges the fleet already exports: the live
   :class:`~..loadgen.TraceRecorder` ring (offered sizes and arrival
   times, recorded at ``MicroBatchScheduler.submit`` before admission
   control, so overload is visible) and the memory the new replicas
   would need next to the old ones.
2. **Decide** by replaying the recorded window through the offline DP
   (:func:`~..autotune.replay_recorder`): same cost model, same
   determinism. :func:`~..autotune.plans_equivalent` is the hysteresis
   gate: a plan that would rebuild the same engines is not a decision.
3. **Apply, prewarm-then-commit**: build the new replicas off the serving
   path (a sharded replica's parameters placed on its slice) and capture
   every rung against their registry's parameters (the ``warmup_fleet``
   contract), each engine on its own stream and its own guards, while the
   old replicas keep replaying; then land the membership swap at the fleet
   batch barrier (``FleetReloadCoordinator.commit_resplit``). No request
   sees a cold rung; ``model_step`` stays monotonic (a prewarm the fleet
   stepped past is refused and redone). Retired replicas are de-routed at
   the commit, then drained and stopped after the gates reopen.

A re-split's serving interruption is therefore the barrier pause alone
(``pause_ms`` in the apply report); the captures happen before it and the
drains after it, both counted in the program ledger, so a census diff
shows that no capture ran on the request path.

**Headroom.** With ``headroom_bytes`` set, a round is skipped unless the
ledger's swap watermark plus the incoming replicas' bytes fit under it
(JAX's rule, on either device). Without it, on the card the incoming bytes
must fit in the device's free memory (``torch.cuda.mem_get_info``); the
CPU has no bound. The incoming bytes are each new replica's parameters
twice (its registry cell and the tensors its graphs read) plus the
largest growth of reserved device memory that one prewarmed replica's
captures have cost so far (its graphs' pools; 0 before the first).

Chaos seams (``chaos/plane.py``): ``elastic.prewarm`` aborts a round
before anything routes, ``elastic.commit`` fires inside the closed
barrier before the swap (the old split intact), ``elastic.retire`` fires
in the drain after the new split already routes.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from marl_distributedformation_tpu_torch.chaos.plane import fault_point
from marl_distributedformation_tpu_torch.obs.ledger import get_ledger
from marl_distributedformation_tpu_torch.serving.autotune import (
    LadderPlan,
    plans_equivalent,
    replay_recorder,
)
from marl_distributedformation_tpu_torch.serving.sharded import ShardedSpec


@dataclasses.dataclass(frozen=True)
class CapacityDecision:
    """One re-split the controller intends to apply: the plan that earned
    it plus the build recipe derived from it."""

    plan: LadderPlan
    replicated_count: int
    replicated_buckets: Tuple[int, ...]
    window_ms: float
    sharded_spec: Optional[ShardedSpec]
    sharded_min_rows: Optional[int]
    reason: str

    def to_dict(self) -> Dict[str, Any]:
        return {
            "replicated_count": self.replicated_count,
            "replicated_buckets": list(self.replicated_buckets),
            "window_ms": round(self.window_ms, 3),
            "sharded_buckets": (
                list(self.sharded_spec.buckets)
                if self.sharded_spec is not None
                else []
            ),
            "sharded_min_rows": self.sharded_min_rows,
            "reason": self.reason,
        }


def _tree_nbytes(params: Any) -> int:
    """Bytes of a ``state_dict``."""
    return sum(t.numel() * t.element_size() for t in params.values())


class CapacityController:
    """The live control loop over one fleet.

    Stepped explicitly (``step()``) or run as a background thread
    (``start(interval_s)`` / ``stop()``); both serialize on one lock (two
    concurrent re-splits would race the barrier)::

        recorder = TraceRecorder()
        router = FleetRouter(..., trace_recorder=recorder)
        coordinator = FleetReloadCoordinator(log_dir, router)
        ctl = CapacityController(router, coordinator, row_shape=(obs_dim,),
                                 p95_target_ms=50.0)
        report = ctl.step()   # None = no decision this round

    ``headroom_bytes`` bounds prewarm (see the module docstring).
    """

    def __init__(
        self,
        router: Any,
        coordinator: Any,
        row_shape: Tuple[int, ...],
        p95_target_ms: float,
        recorder: Any = None,
        min_requests: int = 64,
        max_rungs: int = 4,
        window_tol_ms: float = 1.0,
        headroom_bytes: Optional[float] = None,
        drain_timeout_s: float = 10.0,
        sharded_spec: Optional[ShardedSpec] = None,
        sharded_min_rows: Optional[int] = None,
        clear_after_decide: bool = True,
    ) -> None:
        self.router = router
        self.coordinator = coordinator
        self.row_shape = tuple(int(d) for d in row_shape)
        self.p95_target_ms = float(p95_target_ms)
        self.recorder = (recorder if recorder is not None
                         else getattr(router, "trace_recorder", None))
        if self.recorder is None:
            raise ValueError(
                "elastic control needs a TraceRecorder — pass one here "
                "or build the FleetRouter with trace_recorder="
            )
        self.min_requests = int(min_requests)
        self.max_rungs = int(max_rungs)
        self.window_tol_ms = float(window_tol_ms)
        self.headroom_bytes = headroom_bytes
        self.drain_timeout_s = float(drain_timeout_s)
        self.base_sharded_spec = sharded_spec or ShardedSpec()
        # Pins the replicated/sharded split point fed to the DP; None lets
        # autotune derive it from the size distribution.
        self.sharded_min_rows = sharded_min_rows
        # Each applied decision starts the next window fresh: a plan
        # re-derived from traffic the previous split already answered for
        # would count it twice.
        self.clear_after_decide = bool(clear_after_decide)
        self._step_lock = threading.Lock()
        self._gauge_lock = threading.Lock()
        # The plan the serving split embodies (None until the first
        # commit: the boot split was not earned by this loop); guarded by
        # _step_lock.
        self._current_plan: Optional[LadderPlan] = None
        self._counters: Dict[str, float] = {  # guarded by _gauge_lock
            "elastic_resplits_committed": 0.0,
            "elastic_resplits_aborted": 0.0,
            "elastic_resplits_skipped": 0.0,
            "elastic_prewarm_compiles_total": 0.0,
            "elastic_last_pause_ms": 0.0,
            "elastic_last_prewarm_ms": 0.0,
        }
        # The largest reserved-memory growth one replica's prewarm cost on
        # the card (its graphs' pools): the headroom estimate's pool term.
        self._pool_bytes = 0
        self._thread: Optional[threading.Thread] = None
        self._stop_evt = threading.Event()
        self.last_error: Optional[str] = None
        self.reports: List[dict] = []  # guarded by _gauge_lock

    # -- observe + decide ------------------------------------------------

    def decide(self) -> Optional[CapacityDecision]:
        """Replay the recorded window through the offline DP and turn the
        plan into a build recipe, or None when the window is too thin or
        the plan would rebuild what already serves."""
        devices = list(getattr(self.router, "_devices", []))
        n_dev = max(1, len(devices))
        plan = replay_recorder(
            self.recorder,
            self.p95_target_ms,
            min_requests=self.min_requests,
            max_rungs=self.max_rungs,
            mesh_divisor=n_dev if n_dev > 1 else 1,
            sharded_min_rows=self.sharded_min_rows,
        )
        if plan is None:
            return None
        if plans_equivalent(plan, self._current_plan,
                            window_tol_ms=self.window_tol_ms):
            self._bump("elastic_resplits_skipped")
            return None
        want_sharded = bool(plan.sharded_buckets) and n_dev > 1
        # The slice spans every device slot; replicas ride alongside
        # (max(1, D-1) keeps one slot's worth of small-rung capacity even
        # under a pure big-rung storm: small stragglers must not pad up to
        # a slice rung).
        replicated_count = max(1, n_dev - 1) if want_sharded else n_dev
        replicated_buckets = plan.replicated_buckets or plan.buckets
        spec = None
        sharded_min_rows = None
        if want_sharded:
            spec = self.base_sharded_spec.evolved(
                axis_sizes={"dp": n_dev},
                buckets=plan.sharded_buckets,
                window_ms=plan.sharded_window_ms,
            )
            sharded_min_rows = spec.route_min_rows
        return CapacityDecision(
            plan=plan,
            replicated_count=replicated_count,
            replicated_buckets=tuple(replicated_buckets),
            window_ms=plan.window_ms,
            sharded_spec=spec,
            sharded_min_rows=sharded_min_rows,
            reason=(
                f"ladder {list(plan.buckets)} @ window "
                f"{plan.window_ms:.2f}ms from {len(self.recorder)} "
                f"recorded arrivals ({plan.observed_rps:.1f} rps)"
            ),
        )

    def _incoming_bytes(self, decision: CapacityDecision) -> int:
        """The new replicas' bytes: each one's parameters twice (its cell
        and its served tensors; a slice's once a row block) plus the pool
        term (see the module docstring)."""
        params, _ = self.router.fleet_params()
        copies = decision.replicated_count
        replicas = decision.replicated_count
        if decision.sharded_spec is not None:
            axes = decision.sharded_spec.axis_sizes or {}
            copies += max(1, int(axes.get("dp", 1)))
            replicas += 1
        return 2 * copies * _tree_nbytes(params) + replicas * self._pool_bytes

    def _headroom_ok(self, decision: CapacityDecision) -> bool:
        incoming = self._incoming_bytes(decision)
        if self.headroom_bytes is not None:
            # The swap watermark already holds the double-residency peak a
            # commit reaches; the incoming engines stack on top of it until
            # the retired ones drain.
            watermark = get_ledger().watermark_bytes
            return (watermark + incoming) <= float(self.headroom_bytes)
        cuda = {torch.device(d) for d in getattr(self.router, "_devices", [])
                if torch.device(d).type == "cuda"}
        for dev in cuda:
            free, _ = torch.cuda.mem_get_info(dev)
            if incoming > free:
                return False
        return True

    # -- prewarm ---------------------------------------------------------

    def prewarm(self, decision: CapacityDecision) -> Tuple[List[Any], dict]:
        """Build the decision's replicas and capture every rung OFF the
        serving path, each against its registry's parameters (the
        ``warmup_fleet`` contract). Raises on an armed ``elastic.prewarm``
        fault: the caller aborts the round and the old split keeps
        serving, untouched."""
        ledger = get_ledger()
        programs_before = len(ledger.entries())
        t0 = time.perf_counter()
        built: List[Any] = []
        for _ in range(decision.replicated_count):
            fault_point("elastic.prewarm")
            r = self.router.build_replica(
                buckets=decision.replicated_buckets,
                window_ms=decision.window_ms,
            )
            self._warm(r)
            built.append(r)
        if decision.sharded_spec is not None:
            fault_point("elastic.prewarm")
            r = self.router.build_sharded_replica(decision.sharded_spec)
            self._warm(r)
            built.append(r)
        report = {
            "prewarm_ms": round((time.perf_counter() - t0) * 1e3, 3),
            "prewarm_programs_before": programs_before,
            "prewarm_programs_after": len(ledger.entries()),
        }
        report["prewarm_compiles"] = (
            report["prewarm_programs_after"] - programs_before
        )
        return built, report

    def _warm(self, replica: Any) -> None:
        """Every rung of ``replica`` built (captured on the card); on the
        card the reserved-memory growth is the pool term of later
        headroom estimates."""
        engine = replica.engine
        dev = engine.device
        before = (torch.cuda.memory_reserved(dev)
                  if dev.type == "cuda" else 0)
        params, _ = replica.registry.active()
        for bucket in engine.buckets:
            engine.act(
                np.zeros((bucket, *self.row_shape), np.float32),
                deterministic=True,
                nn_params=params,
            )
        if dev.type == "cuda":
            self._pool_bytes = max(
                self._pool_bytes, torch.cuda.memory_reserved(dev) - before)

    # -- apply: prewarm, commit at the barrier, drain after --------------

    def apply(self, decision: CapacityDecision) -> dict:
        """One whole re-split round. Returns a report dict; never raises.
        ``committed`` False means the old split still serves (a prewarm
        fault, a headroom refusal, a stale prewarm, or a barrier abort:
        the report says which)."""
        report: dict = {
            "committed": False,
            "decision": decision.to_dict(),
        }
        if not self._headroom_ok(decision):
            report["skipped"] = "headroom"
            self._bump("elastic_resplits_skipped")
            return report
        try:
            built, prewarm_report = self.prewarm(decision)
        except Exception as e:  # noqa: BLE001 — contain, keep serving
            report["error"] = f"prewarm aborted: {e!r}"
            self._bump("elastic_resplits_aborted")
            return report
        report.update(prewarm_report)
        self._bump("elastic_prewarm_compiles_total",
                   float(prewarm_report["prewarm_compiles"]))
        self._set_gauge("elastic_last_prewarm_ms",
                        prewarm_report["prewarm_ms"])
        for r in built:
            r.scheduler.start()  # unrouted until the commit lands
        retiring = list(self.router.replicas)
        commit = self.coordinator.commit_resplit(
            add=built,
            retire=[r.index for r in retiring],
            sharded_min_rows=decision.sharded_min_rows,
        )
        report.update(commit)
        if not commit.get("committed"):
            for r in built:
                r.scheduler.stop()
            self._bump("elastic_resplits_aborted")
            return report
        self._set_gauge("elastic_last_pause_ms", commit["pause_ms"])
        # Gates are open again: drain the de-routed replicas off-path.
        drained = []
        for r in retiring:
            try:
                fault_point("elastic.retire")
                drained.append(self.router.drain_replica(
                    r, timeout_s=self.drain_timeout_s))
            except Exception:  # noqa: BLE001 — injected retire fault
                # Stop undrained: queued requests surface SchedulerStopped
                # and fail over onto the new split.
                r.scheduler.stop()
                drained.append(False)
        report["drained_clean"] = int(sum(drained))
        report["retired_total"] = len(retiring)
        self._current_plan = decision.plan
        if self.clear_after_decide:
            self.recorder.clear()
        self._bump("elastic_resplits_committed")
        return report

    def step(self) -> Optional[dict]:
        """One control-loop tick: decide, then apply. Retries ONCE on a
        stale prewarm (a checkpoint reload landed mid-prewarm: the rebuilt
        replicas adopt the new step)."""
        with self._step_lock:
            decision = self.decide()
            if decision is None:
                return None
            report = self.apply(decision)
            if report.get("stale_prewarm"):
                report = self.apply(decision)
            with self._gauge_lock:
                self.reports.append(report)
            return report

    # -- background loop -------------------------------------------------

    def start(self, interval_s: float = 2.0) -> "CapacityController":
        if self._thread is not None:
            return self
        self._stop_evt.clear()

        def _loop() -> None:
            while not self._stop_evt.wait(interval_s):
                try:
                    self.step()
                except Exception as e:  # noqa: BLE001 — loop survives
                    self.last_error = repr(e)

        self._thread = threading.Thread(
            target=_loop, name="elastic-controller", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._thread is None:
            return
        self._stop_evt.set()
        self._thread.join(timeout=30.0)
        self._thread = None

    def __enter__(self) -> "CapacityController":
        return self.start()

    def __exit__(self, *exc: Any) -> None:
        self.stop()

    # -- observability ---------------------------------------------------

    def _bump(self, key: str, by: float = 1.0) -> None:
        with self._gauge_lock:
            self._counters[key] += by

    def _set_gauge(self, key: str, value: float) -> None:
        with self._gauge_lock:
            self._counters[key] = float(value)

    def snapshot(self) -> Dict[str, float]:
        with self._gauge_lock:
            return dict(self._counters)
