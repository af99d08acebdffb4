"""LaneWatchdog: self-healing supervision for long-lived host lanes.

Counterpart of the JAX package's ``chaos/watchdog.py``, the same code: the
pipeline's loop (:meth:`LaneWatchdog.watch_pipeline`), the fleet's workers
(:meth:`LaneWatchdog.watch_fleet`), Sebulba's lanes
(``SebulbaDriver.attach_watchdog``) and any lane registered by hand are
supervised.

An always-learning process is a handful of daemon threads (the pipeline
supervision loop, the reload watcher, the scheduler workers), and until
now a lane that DIED (an uncontained exception, a simulated kill) or
WEDGED (a hung device op, an injected sleep) simply stopped doing its
job — silently, forever. The watchdog closes that gap:

- every supervised lane **heartbeats** into the MetricsRegistry
  (``{lane}_heartbeat_age_s`` is scrapeable like every other gauge), so
  "is the control plane alive" is a metrics question, not a debugger
  question;
- the watchdog thread samples each lane: a dead thread or a heartbeat
  older than ``wedge_timeout_s`` triggers a **restart** through the
  lane's own ``restart`` callable, with capped exponential backoff
  between attempts (a lane that dies instantly on every start must not
  spin the process);
- every restart bumps ``pipeline_restarts_total`` and dumps a
  ``lane_restart`` flight record — a self-healed wedge still leaves a
  postmortem trail.

A wedged thread cannot be killed in CPython; restarting means
ABANDONING it (the lane owner hands out a fresh generation token — see
``AlwaysLearningPipeline.restart_loop``) and starting a replacement.
The abandoned thread exits at its next generation check.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from marl_distributedformation_tpu_torch.obs import get_registry, get_tracer


class Heartbeat:
    """One lane's liveness pulse. ``beat()`` is the lane's per-iteration
    call: one monotonic stamp plus one registry gauge set."""

    def __init__(self, name: str) -> None:
        self.name = name
        self._last = time.monotonic()

    def beat(self) -> None:
        self._last = time.monotonic()
        get_registry().gauge(f"{self.name}_heartbeat_age_s").set(0.0)

    def age_s(self) -> float:
        return time.monotonic() - self._last


@dataclasses.dataclass
class Lane:
    """One supervised lane: how to probe it and how to restart it.
    ``heartbeat=None`` supervises liveness only (a lane with no natural
    iteration cadence, like a scheduler worker that blocks on its
    queue, cannot beat — dead-thread detection still applies)."""

    name: str
    heartbeat: Optional[Heartbeat]
    is_alive: Callable[[], bool]
    restart: Callable[[], Any]
    restarts: int = 0  # cumulative, for reporting — never resets
    streak: int = 0  # consecutive restarts, drives backoff; heals to 0
    _last_restart: float = 0.0
    _healthy_since: float = 0.0


class LaneWatchdog:
    """Probe registered lanes; restart dead/wedged ones with capped
    exponential backoff.

    Args:
      wedge_timeout_s: a live thread whose heartbeat is older than this
        is wedged (size it past the longest legitimate iteration —
        e.g. one gate eval — or the watchdog will flap).
      backoff_base_s / backoff_cap_s: restart pacing. The Nth
        consecutive restart waits ``min(cap, base * 2**(N-1))`` after
        the previous one; a lane healthy for ``heal_after_s`` resets
        the streak.
      poll_interval_s: watchdog sampling cadence.
    """

    def __init__(
        self,
        wedge_timeout_s: float = 10.0,
        backoff_base_s: float = 0.5,
        backoff_cap_s: float = 30.0,
        heal_after_s: float = 30.0,
        poll_interval_s: float = 0.25,
    ) -> None:
        self.wedge_timeout_s = float(wedge_timeout_s)
        self.backoff_base_s = float(backoff_base_s)
        self.backoff_cap_s = float(backoff_cap_s)
        self.heal_after_s = float(heal_after_s)
        self.poll_interval_s = float(poll_interval_s)
        self.lanes: Dict[str, Lane] = {}
        self.restart_log: List[dict] = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- wiring ----------------------------------------------------------

    def register(
        self,
        name: str,
        heartbeat: Optional[Heartbeat],
        is_alive: Callable[[], bool],
        restart: Callable[[], Any],
    ) -> Lane:
        lane = Lane(
            name=name, heartbeat=heartbeat, is_alive=is_alive,
            restart=restart,
        )
        lane._healthy_since = time.monotonic()
        self.lanes[name] = lane
        return lane

    def watch_pipeline(self, pipeline: Any) -> Lane:
        """Supervise an ``AlwaysLearningPipeline``'s run loop (the lane
        the storm wedges): heartbeat from the loop body, restart via
        ``restart_loop`` (abandon-and-replace)."""
        return self.register(
            "pipeline_loop",
            pipeline.heartbeat,
            pipeline.loop_alive,
            pipeline.restart_loop,
        )

    def watch_fleet(self, router: Any) -> List[Lane]:
        """Supervise every replica's scheduler worker (liveness-only:
        a blocked-on-queue worker has no iteration cadence to beat).
        A crashed worker is restarted through
        ``MicroBatchScheduler.restart``; the router's half-open probe
        then readmits the healed replica into rotation — the fleet
        regrows to full width instead of bleeding replicas until
        ``NoHealthyReplicas``."""
        lanes = []
        for replica in router.replicas:
            scheduler = replica.scheduler
            lanes.append(
                self.register(
                    f"replica{replica.index}_worker",
                    None,
                    lambda s=scheduler: s.alive,
                    lambda s=scheduler: s.restart(),
                )
            )
        return lanes

    # -- supervision -----------------------------------------------------

    def restarts_total(self) -> int:
        return sum(lane.restarts for lane in self.lanes.values())

    def check_once(self) -> int:
        """One supervision sweep; returns restarts performed. Public so
        tests and the storm can drive supervision deterministically."""
        restarted = 0
        now = time.monotonic()
        for lane in self.lanes.values():
            age = 0.0
            if lane.heartbeat is not None:
                age = lane.heartbeat.age_s()
                get_registry().gauge(
                    f"{lane.heartbeat.name}_heartbeat_age_s"
                ).set(age)
            alive = True
            try:
                alive = bool(lane.is_alive())
            except Exception:  # noqa: BLE001 — a broken probe reads dead
                alive = False
            reason = None
            if not alive:
                reason = "lane thread dead"
            elif age > self.wedge_timeout_s:
                reason = (
                    f"heartbeat stale {age:.2f}s "
                    f"(wedge_timeout_s={self.wedge_timeout_s:g})"
                )
            if reason is None:
                if now - lane._healthy_since > self.heal_after_s:
                    lane.streak = 0  # streak heals: backoff resets
                continue
            lane._healthy_since = now
            backoff = min(
                self.backoff_cap_s,
                self.backoff_base_s * (2.0 ** max(0, lane.streak - 1)),
            )
            if lane.streak and now - lane._last_restart < backoff:
                continue  # backoff window: do not flap-restart
            restarted += self._restart(lane, reason)
        return restarted

    def _restart(self, lane: Lane, reason: str) -> int:
        entry = {
            "lane": lane.name,
            "reason": reason,
            "restarts": lane.restarts + 1,
            "time": time.time(),
        }
        try:
            lane.restart()
        except Exception as e:  # noqa: BLE001 — a failed restart is a
            # recorded incident, never a dead watchdog; backoff retries.
            entry["restart_error"] = repr(e)[:200]
        lane.restarts += 1
        lane.streak += 1
        lane._last_restart = time.monotonic()
        if lane.heartbeat is not None:
            lane.heartbeat.beat()  # grace: a fresh lane gets a full window
        self.restart_log.append(entry)
        registry = get_registry()
        registry.counter("pipeline_restarts_total").inc()
        registry.counter(f"lane_restarts_total_{lane.name}").inc()
        # Every self-heal leaves a postmortem trail: the ring still holds
        # the spans that led to the wedge/death.
        get_tracer().incident("lane_restart", **entry)
        return 1

    # -- background loop -------------------------------------------------

    def start(self) -> "LaneWatchdog":
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._watch, name="lane-watchdog", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join(timeout=10.0)
        self._thread = None

    def _watch(self) -> None:
        while not self._stop.wait(self.poll_interval_s):
            try:
                self.check_once()
            except Exception:  # noqa: BLE001 — the supervisor of last
                pass  # resort must never die of its own probe

    def __enter__(self) -> "LaneWatchdog":
        return self.start()

    def __exit__(self, *exc: Any) -> None:
        self.stop()
