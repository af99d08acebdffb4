"""AlwaysLearningPipeline: the control plane over trainer, gate, fleet.

Counterpart of the JAX package's ``pipeline/supervisor.py``. The loop:

    trainer writes logs/{name}/rl_model_*  ──►  CheckpointStream
        │ new candidate, step order
        ▼
    PromotionGate.evaluate  ── reject ──►  promotions.jsonl "rejected"
        │ pass
        ▼
    Promoter.publish ──► promoted/ ──► FleetReloadCoordinator.refresh
        │ fleet serves the step (globally monotonic model_step)
        ▼
    promotions.jsonl "promoted" (+ promotion_latency_s)
        ▲
    RollbackMonitor regression  ──►  demote: retract above last-good,
        reload_pinned(last-good, monotonic=False), gate.rebase,
        promotions.jsonl "rolled_back"

Everything is driven by explicit ``poll_once()`` calls — deterministic
for tests — and ``run()`` wraps them in the background loop the CLI
uses. The fleet attaches AFTER the first promotion exists (a fleet
cannot boot from an empty promoted directory); until then passing
candidates are published and the verdicts logged, so
``wait_first_promotion`` + ``fleet_from_checkpoint_dir(promoted_dir)``
is the bootstrap sequence (``always_learning.py``).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np

from marl_distributedformation_tpu_torch.chaos.plane import fault_point
from marl_distributedformation_tpu_torch.chaos.watchdog import Heartbeat
from marl_distributedformation_tpu_torch.env.types import EnvParams
from marl_distributedformation_tpu_torch.obs import (
    get_registry,
    get_tracer,
    new_trace_id,
)
from marl_distributedformation_tpu_torch.pipeline.gate import (
    GateConfig,
    GateVerdict,
    PromotionGate,
)
from marl_distributedformation_tpu_torch.pipeline.promote import (
    Promoter,
    PromotionLog,
)
from marl_distributedformation_tpu_torch.pipeline.rollback import RollbackMonitor
from marl_distributedformation_tpu_torch.pipeline.stream import CheckpointStream


@dataclasses.dataclass
class PromotionRecord:
    """One served promotion: where it came from, where it serves from,
    and how long train-step -> served took."""

    step: int
    source: str
    promoted: str
    latency_s: Optional[float]  # None before a fleet is attached
    trace_id: Optional[str] = None  # the candidate's promotion trace
    spans: Optional[Dict[str, float]] = None  # per-stage decomposition


class _PromotionTrace:
    """One candidate's trace identity plus its stage clock.

    The stages are the promotion-latency decomposition the obs spine
    exists to measure: ``stream_poll_s`` (durable write ->
    gate start, including the poll interval and any queue wait behind
    earlier candidates), ``gate_eval_s``, ``publish_s``,
    ``barrier_commit_s``, ``first_serve_s`` (commit -> a post-commit
    dispatch answering with this step), and — only when a wedged commit
    deferred the candidate — ``deferred_wait_s``. The measurement points
    are back-to-back in ``process_candidate``, so the stage sum tracks
    ``promotion_latency_s`` to within clock-read noise."""

    def __init__(self, path: Path) -> None:
        self.trace_id = new_trace_id()
        self.stages: Dict[str, float] = {}
        self.deferred_at: Optional[float] = None
        try:
            self.t_write: Optional[float] = path.stat().st_mtime
        except OSError:
            self.t_write = None

    def add(self, stage: str, seconds: float) -> None:
        self.stages[stage] = self.stages.get(stage, 0.0) + max(0.0, seconds)

    def rounded(self) -> Dict[str, float]:
        return {k: round(v, 4) for k, v in self.stages.items()}


class AlwaysLearningPipeline:
    """Wire stream -> gate -> promoter -> fleet, with rollback."""

    def __init__(
        self,
        log_dir: str | Path,
        env_params: EnvParams,
        gate_config: GateConfig = GateConfig(),
        promoted_dir: Optional[str | Path] = None,
        poll_interval_s: float = 0.25,
        start_after_step: int = -1,
        feedback_rollouts: int = 50,
        gate_device=None,
        model_id: Optional[str] = None,
    ) -> None:
        # The tenant lane this pipeline promotes into (serving/tenancy):
        # stamped on every promotions.jsonl line (schema 5) and sent
        # with the first-serve probe so a lane-keyed fleet routes it
        # down the right lane. None = single-model pipeline, unchanged.
        self.model_id = model_id
        self.log_dir = Path(log_dir)
        self.env_params = env_params  # sized requests (first-serve probe)
        self.stream = CheckpointStream(
            self.log_dir,
            poll_interval_s=poll_interval_s,
            start_after_step=start_after_step,
        )
        # gate_device: the gate's own device assignment
        # (train.assign_gate_device). The promotion span breakdown and the
        # verdict log then record which device served each eval.
        self.gate = PromotionGate(env_params, gate_config, device=gate_device)
        self.promoted_dir = Path(
            promoted_dir if promoted_dir is not None
            else self.log_dir / "promoted"
        )
        self.promoter = Promoter(self.promoted_dir)
        self.log = PromotionLog(
            self.log_dir / "promotions.jsonl", model_id=model_id
        )
        self.router: Optional[Any] = None
        self.coordinator: Optional[Any] = None
        self.monitor: Optional[RollbackMonitor] = None
        self.trainer: Optional[Any] = None
        # Auto-curriculum feedback (scenarios/adversary.py): rejections
        # whose verdict carries falsifiers are fed back into an attached
        # trainer's scenario schedule as a from_falsifiers stage of this
        # many rollouts.
        self.feedback_rollouts = int(feedback_rollouts)
        self.curriculum_updates = 0
        self.promotions: List[PromotionRecord] = []
        self.rejections: List[GateVerdict] = []
        self.rollbacks: List[dict] = []
        # Candidates discovered but not yet judged (wait_first_promotion
        # stops at the first pass; the backlog is served once the fleet
        # is attached, so every later promotion actually swaps).
        self._pending: List[Path] = []
        # Published candidates whose fleet commit did NOT land (a wedged
        # replica aborts the batch-barrier swap) — retried each poll;
        # they only become promotions when the fleet actually serves
        # them. Step-ascending by construction.
        self._deferred: List[tuple] = []
        # Background-loop errors (run() must survive them, not die
        # silently) — newest last, surfaced in summary().
        self.errors: List[str] = []
        # The serving stack: promoted records still considered good
        # (rollback pops). Top = what the fleet serves.
        self._good: List[PromotionRecord] = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # Self-healing supervision (chaos/watchdog.py): the run loop
        # heartbeats every iteration; a LaneWatchdog watching this lane
        # restarts it on wedge/death via restart_loop(). The generation
        # token is how a wedged thread is ABANDONED — it exits at its
        # next generation check instead of racing its replacement.
        self.heartbeat = Heartbeat("pipeline_loop")
        self._generation = 0
        self._interval_s = 0.25

    # -- wiring ----------------------------------------------------------

    def attach_fleet(self, router: Any, coordinator: Any) -> None:
        """Hand over the serving side. The coordinator MUST watch the
        promoted directory — watching the trainer's own directory would
        serve unvetted candidates, the exact hole this subsystem
        closes."""
        if Path(coordinator.log_dir).resolve() != self.promoted_dir.resolve():
            raise ValueError(
                f"coordinator watches {coordinator.log_dir}, but only "
                f"the promoted directory {self.promoted_dir} holds "
                "vetted checkpoints — build the fleet with "
                "fleet_from_checkpoint_dir(pipeline.promoted_dir)"
            )
        self.router = router
        self.coordinator = coordinator

    def attach_monitor(self, monitor: RollbackMonitor) -> None:
        self.monitor = monitor

    def attach_trainer(self, trainer: Any) -> None:
        """Push-path hookup: the trainer nudges the stream the moment a
        checkpoint is durable (no poll-interval floor on promotion
        latency) — and, with the gate's adversarial rung on, receives
        rejected candidates' falsifiers back as curriculum stages (the
        train -> gate -> train robustness loop)."""
        trainer.on_checkpoint = self.stream.nudge
        self.trainer = trainer

    # -- the loop --------------------------------------------------------

    def process_candidate(self, path: Path) -> GateVerdict:
        """Gate one candidate; publish + swap + log on pass, log on
        reject. A passing candidate whose FLEET COMMIT does not land (a
        wedged replica aborts the barrier swap — reload.py's abort path)
        is 'promotion_deferred', not 'promoted': the baseline, the
        good-stack, and the audit log only ever advance to checkpoints
        that actually serve; the commit is retried on later polls.

        Every candidate gets ONE trace ID (obs/) that labels the gate
        eval span, the reload barrier spans, the first-serve batch span,
        and the ``promotions.jsonl`` line — one trace reconstructs the
        whole promotion."""
        tracer = get_tracer()
        registry = get_registry()
        tr = _PromotionTrace(path)
        t_gate_start = time.time()
        if tr.t_write is not None:
            # On-disk wait from durable write to gate pickup — back-dated
            # to the checkpoint's mtime on the tracer's shared clock.
            tr.add("stream_poll_s", t_gate_start - tr.t_write)
            tracer.add_span(
                "promotion.stream_poll",
                tracer.epoch_to_mono(tr.t_write),
                tracer.epoch_to_mono(t_gate_start),
                trace_id=tr.trace_id,
                path=str(path),
            )
            # Live lag gauge: how far behind the trainer's durable
            # writes the gate is running right now.
            registry.gauge("pipeline_stream_poll_lag_seconds").set(
                t_gate_start - tr.t_write
            )
        t0 = time.perf_counter()
        with tracer.span(
            "promotion.gate_eval",
            trace_id=tr.trace_id,
            device=self.gate.device_str(),
        ):
            verdict = self.gate.evaluate(path, trace_id=tr.trace_id)
        gate_eval_s = time.perf_counter() - t0
        tr.add("gate_eval_s", gate_eval_s)
        registry.histogram("pipeline_gate_eval_seconds").observe(gate_eval_s)
        registry.gauge("gate_eval_steps_per_sec").set(
            self.gate.eval_steps_per_sec()
        )
        if not verdict.passed:
            self.rejections.append(verdict)
            registry.counter("pipeline_rejections_total").inc()
            self.log.append(
                "rejected", **verdict.record(), trace_id=tr.trace_id
            )
            self._feed_falsifiers(verdict, tr.trace_id)
            return verdict
        t0 = time.perf_counter()
        try:
            with tracer.span(
                "promotion.publish", trace_id=tr.trace_id, step=verdict.step
            ):
                promoted = self.promoter.publish(path)
        except FileNotFoundError:
            # The candidate vanished between gate verdict and publish —
            # the trainer's retention ring pruned it (keep_last_n sized
            # under the pipeline's lag, train/recovery.py) or a rollback
            # retracted it. A missing FILE is a skipped candidate, never
            # a dead supervisor: audit it and let the stream move on (a
            # newer checkpoint is usually the reason the old one was
            # prunable at all).
            registry.counter("pipeline_candidates_vanished_total").inc()
            self.log.append(
                "candidate_vanished",
                step=verdict.step,
                checkpoint=str(path),
                trace_id=tr.trace_id,
            )
            return verdict
        tr.add("publish_s", time.perf_counter() - t0)
        if self.coordinator is not None:
            t0 = time.perf_counter()
            with tracer.span(
                "promotion.barrier_commit", trace_id=tr.trace_id,
                step=verdict.step,
            ):
                self.coordinator.refresh(trace_id=tr.trace_id)
            tr.add("barrier_commit_s", time.perf_counter() - t0)
            # refresh() may return False for benign reasons (a started
            # background watcher raced us to the swap) — what matters is
            # whether the fleet now serves at least this step.
            if self.coordinator.fleet_step < verdict.step:
                tr.deferred_at = time.time()
                self._deferred.append((verdict, str(promoted), path, tr))
                get_registry().counter("pipeline_deferred_total").inc()
                self.log.append(
                    "promotion_deferred",
                    **verdict.record(),
                    trace_id=tr.trace_id,
                    promoted_path=str(promoted),
                    reason="fleet commit did not land (see coordinator "
                    "load_errors); retrying on later polls",
                )
                return verdict
            self._probe_first_serve(tr, verdict.step)
            # Served wall-clock: from the moment the trainer's write
            # became durable (the file's mtime) to the moment every
            # post-commit dispatch answers with this step (the probe
            # above just witnessed one).
            latency = self._latency_since_write(path)
        else:
            latency = None
        self._finalize_promotion(verdict, str(promoted), path, latency, tr)
        return verdict

    def _feed_falsifiers(
        self, verdict: GateVerdict, trace_id: Optional[str]
    ) -> None:
        """Close the train -> gate -> train loop: a rejection that
        carries discovered falsifiers becomes a new curriculum stage in
        the attached trainer (``scenarios.from_falsifiers``, applied by
        the training thread at its next dispatch boundary). Audit-logged
        as ``curriculum_updated`` with the falsifier payloads — the
        schedule the trainer runs is reconstructible from the log. A
        trainer without the scenario seam degrades to a logged
        ``curriculum_update_failed``, never a crashed control plane."""
        falsifiers = getattr(verdict, "falsifiers", None) or []
        if self.trainer is None or not falsifiers:
            return
        from marl_distributedformation_tpu_torch.scenarios import from_falsifiers

        try:
            schedule = from_falsifiers(
                falsifiers, rollouts=self.feedback_rollouts
            )
            self.trainer.request_scenario_schedule(schedule)
        except Exception as e:  # noqa: BLE001 — feedback is advisory;
            # a mis-wired trainer must not kill the promotion loop.
            self.log.append(
                "curriculum_update_failed",
                step=verdict.step,
                reason=repr(e)[:300],
                trace_id=trace_id,
            )
            return
        self.curriculum_updates += 1
        self.log.append(
            "curriculum_updated",
            step=verdict.step,
            falsifiers=list(falsifiers),
            feedback_rollouts=self.feedback_rollouts,
            scenarios=list(schedule.names),
            trace_id=trace_id,
        )

    def _probe_first_serve(self, tr: _PromotionTrace, step: int) -> None:
        """Witness the first post-commit response at the promoted step:
        one 1-row request through the router, timed as the
        ``first_serve`` stage. Best-effort — a probe failure (per-
        formation row shapes, transient backpressure) leaves the stage
        unmeasured and never blocks the promotion itself."""
        if self.router is None:
            return
        t0 = time.perf_counter()
        try:
            obs = np.zeros((1, *self._probe_row_shape()), np.float32)
            kwargs = (
                {} if self.model_id is None
                else {"model_id": self.model_id}
            )
            result = self.router.submit(
                obs, trace_id=tr.trace_id, **kwargs
            ).result(timeout=self.router.default_timeout_s + 5.0)
            done = time.perf_counter()
            tr.add("first_serve_s", done - t0)
            get_tracer().add_span(
                "promotion.first_serve",
                t0,
                done,
                trace_id=tr.trace_id,
                step=step,
                served_step=int(result.model_step),
            )
        except Exception:  # noqa: BLE001 — observability never gates serving
            pass

    def _probe_row_shape(self) -> tuple:
        """One request row of the served policy: ``(obs_dim,)``, or a
        whole formation for a per-formation policy (CTDE, GNN)."""
        p = self.env_params
        directory = getattr(self.router, "directory", None)
        if directory is not None and self.model_id is not None:
            return directory.get(self.model_id).row_shape
        policy = getattr(self.router, "policy", None)
        if getattr(policy, "per_formation", False):
            return (p.num_agents, p.obs_dim)
        return (p.obs_dim,)

    @staticmethod
    def _latency_since_write(path: Path) -> Optional[float]:
        try:
            return max(0.0, time.time() - path.stat().st_mtime)
        except OSError:  # source pruned after the gate read it — the
            # promotion stands, only its latency is unmeasurable
            return None

    def _finalize_promotion(
        self,
        verdict: GateVerdict,
        promoted: str,
        path: Path,
        latency: Optional[float],
        tr: Optional[_PromotionTrace] = None,
    ) -> None:
        """The candidate SERVES (or no fleet is attached yet): install
        it as the gate baseline and the new last-good."""
        self.gate.accept(verdict)
        record = PromotionRecord(
            step=verdict.step,
            source=str(path),
            promoted=promoted,
            latency_s=latency,
            trace_id=tr.trace_id if tr is not None else None,
            spans=tr.rounded() if tr is not None else None,
        )
        self.promotions.append(record)
        self._good.append(record)
        registry = get_registry()
        registry.counter("pipeline_promotions_total").inc()
        registry.gauge("pipeline_served_step").set(verdict.step)
        if latency is not None:
            registry.histogram("promotion_latency_seconds").observe(latency)
        if self.monitor is not None:
            self.monitor.reset()
        # Schema-4 commit attribution: which coordinator round served
        # this candidate and how many hosts it committed (1 for a
        # single-host fleet; the mesh coordinator reports the real
        # round's host count). Only claimed when the newest landed
        # commit is EXACTLY this candidate's step — an aborted refresh
        # (benign at line level, the deferred path owns it) must not
        # stamp this promotion with the PREVIOUS round's attribution.
        # No fleet attached yet -> None.
        commit = getattr(self.coordinator, "last_commit", None) or {}
        if commit.get("step") != verdict.step:
            commit = {}
        self.log.append(
            "promoted",
            **verdict.record(),
            trace_id=record.trace_id,
            spans=record.spans,
            promoted_path=promoted,
            promotion_latency_s=(
                round(latency, 4) if latency is not None else None
            ),
            host_count=commit.get("host_count"),
            commit_round=commit.get("commit_round"),
        )

    def _retry_deferred(self) -> None:
        """Re-attempt the fleet commit for published-but-unserved
        candidates. A deferred candidate finalizes ONLY when the fleet
        serves EXACTLY its step; if the fleet moved past it (refresh
        always commits the newest published checkpoint, so clearing a
        wedge with several candidates queued jumps straight to the
        latest), the older candidate never served and never will — it
        terminates as 'promotion_superseded', not 'promoted', and never
        becomes the gate baseline or a rollback target."""
        if not self._deferred or self.coordinator is None:
            return
        # refresh commits the NEWEST published checkpoint — label its
        # spans with that candidate's trace so the retry leg joins the
        # same promotion trace as the original attempt.
        retry_trace = self._deferred[-1][3]
        # The deferred wait ends where the retry commit begins — snapshot
        # the boundary BEFORE refresh() so the commit seconds land only
        # in barrier_commit_s and the stages still sum to the latency.
        wait_end = time.time()
        t_retry = time.perf_counter()
        self.coordinator.refresh(trace_id=retry_trace.trace_id)
        retry_commit_s = time.perf_counter() - t_retry
        still_deferred = []
        for verdict, promoted, path, tr in self._deferred:
            fleet_step = self.coordinator.fleet_step
            if fleet_step == verdict.step:
                if tr.deferred_at is not None:
                    tr.add("deferred_wait_s", wait_end - tr.deferred_at)
                tr.add("barrier_commit_s", retry_commit_s)
                self._probe_first_serve(tr, verdict.step)
                self._finalize_promotion(
                    verdict, promoted, path,
                    self._latency_since_write(path), tr,
                )
            elif fleet_step > verdict.step:
                self.log.append(
                    "promotion_superseded",
                    step=verdict.step,
                    checkpoint=verdict.path,
                    reason=f"fleet committed step {fleet_step} while this "
                    "candidate's swap was deferred; it never served",
                    trace_id=tr.trace_id,
                )
            else:
                still_deferred.append((verdict, promoted, path, tr))
        self._deferred = still_deferred

    def check_rollback(self) -> bool:
        """One monitor sample; demote to last-good on a tripped
        regression. Returns True iff a rollback happened."""
        if (
            self.monitor is None
            or self.coordinator is None
            or len(self._good) < 2
            # With one good checkpoint there is nothing to demote TO —
            # an empty fleet is strictly worse than a suspect one.
        ):
            return False
        if not self.monitor.observe():
            return False
        bad = self._good.pop()
        last_good = self._good[-1]
        entry = {
            "from_step": bad.step,
            "to_step": last_good.step,
            "metric": self.monitor.metric,
            "value": self.monitor.last_value,
            "limit": self.monitor.limit(),
            "baseline": self.monitor.baseline,
        }
        # The tripped alarm is a postmortem-grade incident BEFORE the
        # demotion is attempted: the flight recorder snapshots the ring
        # while the regressed checkpoint's serving history is still in
        # it. The demotion itself shares the rollback's trace ID.
        rollback_trace = new_trace_id()
        get_tracer().incident(
            "rollback_trip", trace_id=rollback_trace, **entry
        )
        # Retract FIRST so a concurrently-polling coordinator cannot
        # re-promote the demoted step between the swap and the cleanup.
        # Deferred candidates above last-good lose their published files
        # here too — terminate them (they can never commit now; leaving
        # them queued would retry forever and could later finalize a
        # retracted, never-served checkpoint).
        self.promoter.retract_above(last_good.step)
        still_deferred = []
        for verdict, promoted, path, tr in self._deferred:
            if verdict.step > last_good.step:
                self.log.append(
                    "promotion_superseded",
                    step=verdict.step,
                    checkpoint=verdict.path,
                    reason=f"retracted by the rollback to step "
                    f"{last_good.step} while its swap was deferred",
                    trace_id=tr.trace_id,
                )
            else:
                still_deferred.append((verdict, promoted, path, tr))
        self._deferred = still_deferred
        if not self.coordinator.reload_pinned(
            last_good.promoted, monotonic=False, trace_id=rollback_trace
        ):
            # The demotion commit itself failed (wedged replica /
            # unreadable last-good): the regressed checkpoint is STILL
            # serving — record that truthfully, restore the good-stack
            # AND its published file (retract_above already removed it;
            # without the re-publish, a later rollback TO this record
            # would pin a nonexistent path forever), and leave the
            # breach streak alive so the next poll retries
            # (monitor.reset here would silence the alarm).
            try:
                self.promoter.publish(bad.source)
            except OSError:  # source pruned: the record stays, only
                pass  # its file is gone — reload_pinned will record it
            self._good.append(bad)
            self.log.append(
                "rollback_failed",
                **entry,
                reason="pinned reload did not commit (see coordinator "
                "load_errors); retrying on later polls",
                trace_id=rollback_trace,
            )
            return False
        self.gate.rebase(last_good.step)
        self.monitor.reset()
        self.rollbacks.append(entry)
        registry = get_registry()
        registry.counter("pipeline_rollbacks_total").inc()
        registry.gauge("pipeline_served_step").set(last_good.step)
        commit = getattr(self.coordinator, "last_commit", None) or {}
        if commit.get("step") != last_good.step:
            commit = {}  # attribution must be THIS demotion's round
        self.log.append(
            "rolled_back",
            **entry,
            trace_id=rollback_trace,
            host_count=commit.get("host_count"),
            commit_round=commit.get("commit_round"),
        )
        return True

    def poll_once(self) -> int:
        """One supervision step: retry deferred fleet commits, gate
        every queued + newly-discovered candidate, then sample the
        rollback monitor once. Returns candidates processed."""
        self._retry_deferred()
        self._pending.extend(self.stream.poll())
        processed = 0
        while self._pending:
            self.process_candidate(self._pending.pop(0))
            processed += 1
        self.check_rollback()
        return processed

    def wait_first_promotion(self, timeout_s: float = 60.0) -> bool:
        """Bootstrap: block until the first candidate PASSES the gate
        (rejecting failures along the way — one candidate at a time, so
        everything after the first pass stays queued for the
        fleet-attached loop). After this the promoted directory is
        non-empty and a fleet can boot from it."""
        deadline = time.monotonic() + timeout_s
        while not self.promotions:
            if not self._pending:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._pending.extend(self.stream.wait(min(remaining, 5.0)))
                continue
            self.process_candidate(self._pending.pop(0))
        return True

    # -- background loop (the CLI's mode) --------------------------------

    def run(self, interval_s: float = 0.25) -> "AlwaysLearningPipeline":
        if self._thread is not None:
            return self
        self._stop.clear()
        self._interval_s = interval_s
        self._start_loop()
        return self

    def _start_loop(self) -> None:
        """Spawn one generation of the supervision loop. The generation
        token gates every blocking boundary: a superseded (restarted-
        over) thread exits before touching the gate or the pending
        queue again, so a watchdog restart can never double-process a
        candidate or build the eval program twice."""
        self._generation += 1
        gen = self._generation
        interval_s = self._interval_s

        def live() -> bool:
            return not self._stop.is_set() and self._generation == gen

        def loop() -> None:
            while live():
                # A transient failure (full disk during publish/log, a
                # checkpoint pruned mid-judgment) must not silently kill
                # the control plane — record it and keep supervising. A
                # SimulatedCrash (BaseException) is NOT contained: it
                # kills this lane like a real kill and the watchdog owns
                # the restart.
                try:
                    self.heartbeat.beat()
                    fault_point("pipeline.poll")
                    if not live():
                        return  # restarted over while wedged: abandon
                    self._retry_deferred()
                    self._pending.extend(self.stream.wait(interval_s))
                    while self._pending and live():
                        # Beat per candidate: a healthy lane working
                        # through a deep backlog must not read as
                        # wedged. (One eval LONGER than the watchdog's
                        # wedge_timeout_s still trips — size the
                        # timeout past a gate eval; the gate's eval
                        # lock keeps an overlapping restart from
                        # building twice either way.)
                        self.heartbeat.beat()
                        self.process_candidate(self._pending.pop(0))
                    self.check_rollback()
                except Exception as e:  # noqa: BLE001
                    self.errors.append(repr(e))
                    del self.errors[:-32]  # bounded
                    self._stop.wait(interval_s)

        self._thread = threading.Thread(
            target=loop,
            name=f"always-learning-pipeline-g{gen}",
            daemon=True,
        )
        self._thread.start()

    def loop_alive(self) -> bool:
        """Liveness probe for the watchdog: is the CURRENT generation's
        thread running?"""
        return self._thread is not None and self._thread.is_alive()

    def restart_loop(self) -> None:
        """Abandon-and-replace the supervision lane (the watchdog's
        restart hook): bump the generation — the old thread, wedged or
        dead, exits at its next generation check — and start a fresh
        one. No-op after stop()."""
        if self._stop.is_set():
            return
        self._start_loop()

    def stop(self) -> None:
        if self._thread is None:
            return
        self._stop.set()
        self.stream.nudge()
        self._thread.join(timeout=30.0)
        self._thread = None

    def __enter__(self) -> "AlwaysLearningPipeline":
        return self.run()

    def __exit__(self, *exc: Any) -> None:
        self.stop()

    # -- observability ---------------------------------------------------

    def summary(self) -> Dict[str, Any]:
        """Flat report (the CLI's JSON line feeds off it)."""
        latencies = sorted(
            r.latency_s for r in self.promotions if r.latency_s is not None
        )

        def pct(q: float) -> Optional[float]:
            if not latencies:
                return None
            idx = min(len(latencies) - 1, int(q * len(latencies)))
            return round(latencies[idx], 4)

        # Per-stage p50s over every traced promotion — the bench's
        # promotion_span_breakdown (where did the promotion seconds go).
        by_stage: Dict[str, List[float]] = {}
        for r in self.promotions:
            for stage, seconds in (r.spans or {}).items():
                by_stage.setdefault(stage, []).append(seconds)
        breakdown = {}
        for stage, values in by_stage.items():
            values.sort()
            breakdown[stage] = round(
                values[min(len(values) - 1, int(0.5 * len(values)))], 4
            )

        return {
            "promotion_span_breakdown": breakdown,
            # Which device served the gate evals (None: the default
            # device, the Anakin time-share) — pairs with the breakdown's
            # gate_eval_s so a latency report names its silicon.
            "gate_device": self.gate.device_str(),
            "promotions": len(self.promotions),
            "rejections": len(self.rejections),
            "rollbacks": len(self.rollbacks),
            "curriculum_updates": self.curriculum_updates,
            "deferred_promotions": len(self._deferred),
            "pipeline_errors": list(self.errors),
            "served_step": (
                self.coordinator.fleet_step
                if self.coordinator is not None
                else (self._good[-1].step if self._good else None)
            ),
            "promotion_latency_s_p50": pct(0.50),
            "promotion_latency_s_p95": pct(0.95),
            "gate_eval_steps_per_sec": round(
                self.gate.eval_steps_per_sec(), 1
            ),
            "gate_eval_compiles": (
                self.gate.program.compile_count
                if self.gate.program is not None
                else 0
            ),
        }
