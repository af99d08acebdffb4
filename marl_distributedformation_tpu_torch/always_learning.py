"""One process, the whole product: trainer -> gate -> fleet, always learning.

Counterpart of the repository's ``scripts/always_learning.py``. Runs the
supervised continuous-learning loop (``pipeline/``) end to end: a Trainer
streams checkpoints into ``logs/{name}/``, every candidate is judged by the
PromotionGate (the robustness matrix plus a clean-return regression against
the served baseline, ONE eval program across all candidates: a CUDA graph
captured once on the card, the budget-1 RetraceGuard receipt), passing
candidates are published to ``logs/{name}/promoted/`` and hot-swapped into
a multi-replica serving fleet at the batch barrier (globally
step-monotonic ``model_step``), and an optional RollbackMonitor demotes to
the last good checkpoint on a served-metric regression. Verdicts land in
``logs/{name}/promotions.jsonl``.

Usage (the ``key=value`` CLI of every entry point; trainer keys ride
through to ``train.cli.build_trainer``):

    python -m marl_distributedformation_tpu_torch.always_learning \\
        name=always num_formation=64 total_timesteps=64000 max_steps=100 \\
        pipeline_replicas=2

    # on the CPU, tiny:
    python -m marl_distributedformation_tpu_torch.always_learning \\
        name=always_cpu num_formation=16 total_timesteps=4800 \\
        max_steps=60 gate_formations=8 pipeline_replicas=2 device=cpu

On one card the trainer, the gate and every replica share the device, each
replaying its CUDA graphs on a stream of its own (``train/capture.py``);
under ``architecture=sebulba`` the gate takes ``assign_gate_device``'s
device, the learner's own on one card. ``mesh_serve=true`` serves through
a loopback multi-host mesh instead (``serving/mesh``): ``mesh_hosts`` host
subprocesses on the trainer's device behind the ``MetaRouter``, the
``MeshCoordinator`` driving every promotion as a coordinator-barriered
global commit (``mesh_heartbeat_s``, ``mesh_lease_s``,
``mesh_dead_after_s``, ``mesh_prepare_timeout_s``; ``mesh_port`` starts
the ``MeshFrontend``). ``sentinel=true`` checks the live gauges against a
bench record of this device (``sentinel_bench``; ``obs/sentinel.py``) at
every supervision poll. ``guard_transfers`` is refused,
as Sebulba refuses it: the CUDA sync debug mode is the process's, and the
gate's and the fleet's threads synchronize.

Prints exactly one JSON line: promotions, rejections and rollbacks,
``promotion_latency_s_p50``/``p95`` (the trainer's durable write to the
served ``model_step``, wall time), ``gate_eval_steps_per_sec``, the
build-once receipts, and the final served step.
"""

from __future__ import annotations

import json
import sys
import threading
import time
from pathlib import Path
from typing import Any, Callable, Dict, Optional

PIPELINE_KEYS = (
    # gate
    "gate_scenarios",
    "gate_severities",
    "gate_formations",
    "gate_seed",
    "gate_clean_tolerance",
    "gate_rung_tolerance",
    # adversarial rung + auto-curriculum feedback
    "gate_adversarial",
    "gate_adversarial_scenarios",
    "gate_adversarial_min_severity",
    "gate_adversarial_drop_tolerance",
    "gate_adversarial_max_severity",
    "gate_adversarial_grid",
    "gate_adversarial_generations",
    "gate_adversarial_formations",
    "feedback_rollouts",
    # gate-eval deadline
    "gate_timeout_s",
    # self-healing supervision (chaos/watchdog.py)
    "watchdog",
    "watchdog_wedge_timeout_s",
    "watchdog_backoff_s",
    "watchdog_backoff_cap_s",
    # chaos plane (chaos/): arm a seeded fault campaign against THIS run
    "chaos",
    "chaos_seed",
    "chaos_faults",
    # fleet
    "pipeline_replicas",
    "pipeline_buckets",
    "pipeline_port",
    "pipeline_poll_s",
    "pipeline_budget_s",
    "pipeline_verify_requests",
    # mesh tier (serving/mesh): serve through a loopback multi-host mesh,
    # host subprocesses behind the MetaRouter, the MeshCoordinator driving
    # every promotion as a global barrier commit.
    "mesh_serve",
    "mesh_hosts",
    "mesh_heartbeat_s",
    "mesh_lease_s",
    "mesh_dead_after_s",
    "mesh_prepare_timeout_s",
    "mesh_port",
    # rollback
    "rollback_metric",
    "rollback_threshold",
    "rollback_ratio",
    "rollback_direction",
    "rollback_trip_after",
    "rollback_baseline_samples",
    # observability spine (obs/)
    "obs_trace",
    "obs_ring_size",
    "obs_flightrec",
    # live-metrics plane (obs/metrics.py)
    "telemetry",
    "telemetry_port",
    "telemetry_reservoir",
    # program ledger (obs/ledger.py)
    "ledger",
    "ledger_reservoir",
    # perf-regression sentinel (obs/sentinel.py)
    "sentinel",
    "sentinel_tolerance",
    "sentinel_trip_after",
    "sentinel_bench",
    "out",
)
# Trainer knobs beyond the YAML's: the JAX entry point's list, checked here
# so a mistyped pipeline key cannot silently run the defaults.
TRAIN_EXTRA_KEYS = (
    "save_freq", "policy", "hidden_sizes", "mesh", "num_seeds",
    "curriculum", "learning_rates", "platform", "preset", "fused_chunk",
    "iters_per_dispatch", "guard_retraces", "guard_transfers",
    "guard_nans", "profile", "profile_iterations",
    # Sebulba: the gate then takes assign_gate_device's device.
    "architecture", "actor_devices", "transfer_queue_depth",
    "max_param_staleness",
)
# Pipeline keys of parts not ported yet, and the ROADMAP item of each.
UNPORTED_PREFIXES: Dict[str, str] = {}


def _key(override: str) -> str:
    return override.split("=", 1)[0].split(".", 1)[0]


def refuse_unported(cfg) -> None:
    """Exit when ``cfg`` asks for a part of the pipeline not ported yet, or
    for ``guard_transfers``."""
    for key in PIPELINE_KEYS:
        value = cfg.get(key)
        if value in (None, False, "", 0):
            continue
        for prefix, item in UNPORTED_PREFIXES.items():
            if key.startswith(prefix):
                raise SystemExit(
                    f"{key}={value!r} is not ported yet (ROADMAP {item}); "
                    "leave it unset"
                )
    if cfg.get("guard_transfers"):
        raise SystemExit(
            "guard_transfers guards one dispatching thread; the "
            "always-learning process runs the gate and the fleet on "
            "threads of their own that synchronize (the CUDA sync debug "
            "mode is the process's), so it is refused here as under "
            "architecture=sebulba; guard_retraces and guard_nans stay"
        )


def _as_list(value, default):
    value = value if value not in (None, "", []) else default
    return list(value) if isinstance(value, (list, tuple)) else [value]


def gate_config(cfg):
    from marl_distributedformation_tpu_torch.pipeline import GateConfig

    return GateConfig(
        scenarios=tuple(
            str(s) for s in _as_list(cfg.get("gate_scenarios"),
                                     ["wind", "sensor_noise"])),
        severities=tuple(
            float(s) for s in _as_list(cfg.get("gate_severities"),
                                       [0.5, 1.0])),
        eval_formations=int(cfg.get("gate_formations", 64)),
        eval_seed=int(cfg.get("gate_seed", 1234)),
        clean_tolerance=float(cfg.get("gate_clean_tolerance", 0.05)),
        rung_tolerance=float(cfg.get("gate_rung_tolerance", 0.10)),
        adversarial=bool(cfg.get("gate_adversarial", False)),
        adversarial_scenarios=tuple(
            str(s) for s in _as_list(cfg.get("gate_adversarial_scenarios"),
                                     [])),
        adversarial_min_severity=float(
            cfg.get("gate_adversarial_min_severity", 0.5)),
        adversarial_drop_tolerance=float(
            cfg.get("gate_adversarial_drop_tolerance", 0.2)),
        adversarial_max_severity=float(
            cfg.get("gate_adversarial_max_severity", 1.5)),
        adversarial_grid=int(cfg.get("gate_adversarial_grid", 4)),
        adversarial_generations=int(
            cfg.get("gate_adversarial_generations", 3)),
        adversarial_formations=int(
            cfg.get("gate_adversarial_formations", 64)),
        # The eval deadline: size it past the first eval, which builds
        # the program, or leave it unset.
        gate_timeout_s=(
            float(cfg["gate_timeout_s"])
            if cfg.get("gate_timeout_s") is not None else None
        ),
    )


def rollback_monitor(cfg, router):
    """The ``rollback_*`` monitor over the router's snapshot merged into
    the process registry's (None without ``rollback_metric``)."""
    metric = cfg.get("rollback_metric")
    if not metric:
        return None
    from marl_distributedformation_tpu_torch.obs import get_registry
    from marl_distributedformation_tpu_torch.pipeline import RollbackMonitor

    def sample():
        # The router snapshot refreshes the fleet gauges in the process
        # registry, then the monitor reads the merged namespace (the
        # numbers GET /metrics serves); the fresh snapshot overlays the
        # registry copy, so a disabled registry never blinds it.
        snap = router.snapshot()
        merged = get_registry().snapshot()
        merged.update(snap)
        return merged

    return RollbackMonitor(
        sample,
        metric=str(metric),
        threshold=cfg.get("rollback_threshold"),
        ratio=cfg.get("rollback_ratio"),
        direction=str(cfg.get("rollback_direction") or "above"),
        baseline_samples=int(cfg.get("rollback_baseline_samples", 3)),
        trip_after=int(cfg.get("rollback_trip_after", 2)),
    )


def request_row_shape(policy, env_params) -> tuple:
    """One request row of the served policy: ``(obs_dim,)``, or a whole
    formation ``(num_agents, obs_dim)`` for a per-formation policy."""
    if getattr(policy, "per_formation", False):
        return (env_params.num_agents, env_params.obs_dim)
    return (env_params.obs_dim,)


def main(
    argv=None,
    on_trainer: Optional[Callable[[Any, Any], None]] = None,
    on_fleet: Optional[Callable[[Any, Any, Any],
                                Optional[Callable[[], None]]]] = None,
) -> Dict[str, Any]:
    """Run the loop; returns the report it prints. ``on_trainer(trainer,
    pipeline)`` is called before training starts and ``on_fleet(pipeline,
    router, coordinator)`` once the fleet is attached; what the latter
    returns is called before the verification traffic (a caller's traffic
    stops there)."""
    from marl_distributedformation_tpu_torch.train import cli as train_cli
    from marl_distributedformation_tpu_torch.utils.config import (
        env_params_from_config,
        load_config,
        validate_override_keys,
    )

    overrides = list(sys.argv[1:] if argv is None else argv)
    validate_override_keys(
        overrides,
        extra_keys=PIPELINE_KEYS + TRAIN_EXTRA_KEYS + train_cli.TRAIN_KEYS,
    )
    cfg = load_config(overrides)
    refuse_unported(cfg)

    import numpy as np
    import torch

    from marl_distributedformation_tpu_torch import obs as obs_spine
    from marl_distributedformation_tpu_torch.pipeline import (
        AlwaysLearningPipeline,
    )
    from marl_distributedformation_tpu_torch.train import (
        Trainer,
        assign_gate_device,
    )

    replicas = int(cfg.get("pipeline_replicas", 2))
    sebulba = str(cfg.get("architecture") or "anakin") == "sebulba"
    env_params = env_params_from_config(cfg)
    if bool(cfg.get("gate_adversarial", False)) and not cfg.get("scenarios"):
        # The adversarial rung feeds rejected candidates' falsifiers back
        # into the trainer's schedule, which needs the iteration's
        # scenario buffers: reserve them with the identity scenario; the
        # feedback stages replace it live.
        overrides.append("scenarios=[clean]")
    trainer = train_cli.build_trainer(
        [o for o in overrides if _key(o) not in PIPELINE_KEYS])
    if not isinstance(trainer, Trainer):
        raise SystemExit(
            "the always-learning pipeline drives the single-run Trainer; "
            "population sweeps / curriculum trainers checkpoint a "
            "different layout (drop num_seeds / curriculum)"
        )
    device = trainer.device

    # Observability spine (obs/): the tracer records promotion and serving
    # batch spans into per-thread rings, and the flight recorder snapshots
    # them next to the checkpoints on incidents.
    obs_enabled = bool(cfg.get("obs_trace", True))
    obs_spine.configure(
        enabled=obs_enabled,
        ring_size=int(cfg.get("obs_ring_size", 4096)),
        flightrec_dir=(str(trainer.log_dir)
                       if cfg.get("obs_flightrec", True) else ""),
    )
    obs_spine.configure_metrics(
        enabled=bool(cfg.get("telemetry", True)),
        reservoir=int(cfg.get("telemetry_reservoir", 512)),
    )
    obs_spine.configure_ledger(
        enabled=bool(cfg.get("ledger", True)),
        reservoir=int(cfg.get("ledger_reservoir", 256)),
    )
    telemetry = None
    telemetry_url = None
    if cfg.get("telemetry_port") is not None:
        telemetry = obs_spine.TelemetryServer(
            port=int(cfg.telemetry_port)).start()
        telemetry_url = telemetry.url
        print(f"[always] telemetry: {telemetry.url}", file=sys.stderr)

    # Perf-regression sentinel (obs/sentinel.py): live gauges against a
    # bench record of this device; a sustained regression dumps a
    # flightrec-perf_regression-*.json and an audit line beside the
    # checkpoints.
    sentinel = None
    if bool(cfg.get("sentinel", False)):
        if not bool(cfg.get("telemetry", True)):
            # The sentinel compares LIVE registry gauges; with the registry
            # disabled every snapshot is empty and the tripwire is blind.
            raise SystemExit(
                "sentinel=true needs telemetry=true (the sentinel "
                "watches the live MetricsRegistry gauges; a disabled "
                "registry records nothing, so no regression could "
                "ever trip)"
            )
        sentinel_tol = float(cfg.get("sentinel_tolerance", 0.5))
        sentinel = obs_spine.RegressionSentinel(
            obs_spine.default_watches(tolerance=sentinel_tol)
            # A record without the ledger or recovery fields reports them
            # as sentinel_missing, never a breach.
            + obs_spine.ledger_watches(tolerance=sentinel_tol)
            + obs_spine.recovery_watches(),
            record_path=cfg.get("sentinel_bench"),
            trip_after=int(cfg.get("sentinel_trip_after", 3)),
            audit_dir=trainer.log_dir,
            device=str(device),
            device_kind=(torch.cuda.get_device_name(device)
                         if device.type == "cuda" else None),
        )

    budget_s = float(cfg.get("pipeline_budget_s", 600.0))
    deadline = time.time() + budget_s
    if sebulba:
        # The gate's own device under the Sebulba partition; on one card
        # the learner's, a time-share the summary records.
        gate_device = assign_gate_device(int(cfg.get("actor_devices", 1)),
                                         device)
        print(
            f"[always] sebulba: actor slice {trainer.actor_slice}, "
            f"learner slice {trainer.learner_slice}, gate on "
            f"{gate_device}",
            file=sys.stderr,
        )
    else:
        gate_device = device
    pipeline = AlwaysLearningPipeline(
        trainer.log_dir,
        env_params,
        gate_config=gate_config(cfg),
        poll_interval_s=float(cfg.get("pipeline_poll_s", 0.25)),
        feedback_rollouts=int(cfg.get("feedback_rollouts", 50)),
        gate_device=gate_device,
    )
    pipeline.attach_trainer(trainer)
    if on_trainer is not None:
        on_trainer(trainer, pipeline)

    train_error: list = []

    def run_training() -> None:
        # The trainer's eager work runs on its own capture stream too, so
        # the gate's and the fleet's threads never queue behind its chunks
        # on the shared default stream (a no-op off the card).
        try:
            with torch.cuda.stream(getattr(trainer, "capture_stream", None)):
                trainer.train()
        except BaseException as e:  # noqa: BLE001 — surfaced in the report
            train_error.append(repr(e))

    train_thread = threading.Thread(
        target=run_training, name="always-learning-trainer", daemon=True
    )
    print(
        f"[always] {cfg.name}: training M={cfg.num_formation} to "
        f"{trainer.total_timesteps} agent-transitions; gate "
        f"{pipeline.gate.config.scenarios} x "
        f"{pipeline.gate.config.severities}; fleet {replicas} replicas on "
        f"{device}",
        file=sys.stderr,
    )
    train_thread.start()

    report: Dict[str, Any] = {"name": str(cfg.name)}
    router = None
    frontend = None
    watchdog = None
    mesh = None
    stop_traffic = None
    try:
        if not pipeline.wait_first_promotion(
            timeout_s=max(deadline - time.time(), 1.0)
        ):
            raise SystemExit(
                "no candidate passed the gate within pipeline_budget_s "
                f"({budget_s:g}s) — see {trainer.log_dir}/promotions.jsonl"
            )

        buckets = _as_list(cfg.get("pipeline_buckets"), [1, 8])
        mesh_serve = bool(cfg.get("mesh_serve", False))
        if mesh_serve:
            # The cross-host shape: host SUBPROCESSES serve the promoted
            # directory (their env params from the run's config.json)
            # behind the MetaRouter; the MeshCoordinator drives every
            # promotion as a coordinator-barriered global commit, and the
            # supervisor is none the wiser (duck-typed attach_fleet).
            from marl_distributedformation_tpu_torch.serving.mesh import (
                spawn_local_mesh,
            )

            mesh_port = cfg.get("mesh_port")
            mesh = spawn_local_mesh(
                pipeline.promoted_dir,
                hosts=int(cfg.get("mesh_hosts", 2)),
                replicas_per_host=replicas,
                buckets=tuple(int(b) for b in buckets),
                num_agents=env_params.num_agents,
                heartbeat_s=float(cfg.get("mesh_heartbeat_s", 0.25)),
                lease_s=float(cfg.get("mesh_lease_s", 1.0)),
                dead_after_s=float(cfg.get("mesh_dead_after_s", 1.0)),
                prepare_timeout_s=float(
                    cfg.get("mesh_prepare_timeout_s", 30.0)),
                frontend_port=(
                    int(mesh_port) if mesh_port is not None else None),
                ready_timeout_s=max(deadline - time.time(), 30.0),
                device=device,
            )
            router, coordinator = mesh.router, mesh.coordinator
            if mesh.frontend is not None:
                report["frontend_url"] = mesh.frontend.url
                print(f"[always] mesh frontend: {mesh.frontend.url}",
                      file=sys.stderr)
            print(f"[always] mesh: {len(mesh.hosts)} host subprocesses on "
                  f"{device}, coordinator {coordinator.url}",
                  file=sys.stderr)
            row_shape = request_row_shape(trainer.model, env_params)
        else:
            from marl_distributedformation_tpu_torch.serving.fleet import (
                FleetFrontend,
                fleet_from_checkpoint_dir,
                warmup_fleet,
            )

            router, coordinator = fleet_from_checkpoint_dir(
                pipeline.promoted_dir,
                env_params=env_params,
                act_dim=env_params.act_dim,
                num_replicas=replicas,
                buckets=tuple(int(b) for b in buckets),
                device=device,
            )
            row_shape = request_row_shape(router.policy, env_params)
            # Every rung of every replica built (captured on the card)
            # before the schedulers start.
            warmup_fleet(router, row_shape)
            router.start()
            port = cfg.get("pipeline_port")
            if port is not None:
                frontend = FleetFrontend(router, port=int(port)).start()
                report["frontend_url"] = frontend.url
                print(f"[always] frontend: {frontend.url}", file=sys.stderr)
        pipeline.attach_fleet(router, coordinator)
        monitor = rollback_monitor(cfg, router)
        if monitor is not None:
            pipeline.attach_monitor(monitor)

        # Self-healing supervision: a crashed replica worker restarts and
        # the router's half-open probe readmits it. The pipeline lane is
        # this thread here; pipeline.run() mode watches it too
        # (watchdog.watch_pipeline). The mesh has no in-process fleet lanes
        # to watch: each host subprocess supervises its own schedulers, and
        # host DEATH is the coordinator's lease taxonomy's job.
        if bool(cfg.get("watchdog", True)) and not mesh_serve:
            from marl_distributedformation_tpu_torch.chaos import (
                LaneWatchdog,
            )

            watchdog = LaneWatchdog(
                wedge_timeout_s=float(
                    cfg.get("watchdog_wedge_timeout_s", 30.0)),
                backoff_base_s=float(cfg.get("watchdog_backoff_s", 0.5)),
                backoff_cap_s=float(cfg.get("watchdog_backoff_cap_s", 30.0)),
            )
            watchdog.watch_fleet(router)
            if sebulba:
                trainer.attach_watchdog(watchdog)
            watchdog.start()

        # Chaos drill: a seeded fault campaign against THIS run (the
        # schedule is a pure function of chaos_seed).
        if bool(cfg.get("chaos", False)):
            from marl_distributedformation_tpu_torch.chaos import (
                FaultSchedule,
                get_fault_plane,
            )

            plane = get_fault_plane()
            plane.arm(FaultSchedule.from_seed(
                int(cfg.get("chaos_seed", 0)),
                faults=int(cfg.get("chaos_faults", 25))))
            plane.enabled = True
            print(f"[always] chaos armed: {plane.pending()} faults, seed "
                  f"{int(cfg.get('chaos_seed', 0))}", file=sys.stderr)

        if on_fleet is not None:
            stop_traffic = on_fleet(pipeline, router, coordinator)

        # Supervision: drain candidates while the trainer runs, then the
        # tail after it finishes; the loop heartbeats for liveness.
        while time.time() < deadline:
            pipeline.heartbeat.beat()
            processed = pipeline.poll_once()
            if sentinel is not None:
                # The router's snapshot publishes the fleet's gauges, so
                # the latency watch sees live numbers.
                router.snapshot()
                sentinel.check()
            if not train_thread.is_alive() and processed == 0:
                # train() returning drained the async writer, but its last
                # checkpoint may have landed after this poll: one more.
                if pipeline.poll_once() == 0:
                    break
                continue
            if processed == 0:
                time.sleep(0.05)
        train_thread.join(timeout=max(deadline - time.time(), 0.0))
        if stop_traffic is not None:
            stop_traffic()
            stop_traffic = None

        # Verification traffic: the served step must be the promoted one.
        n_verify = int(cfg.get("pipeline_verify_requests", 4))
        served_steps = []
        rng = np.random.default_rng(0)
        for _ in range(n_verify):
            rows = rng.standard_normal((2, *row_shape), dtype=np.float32)
            res = router.submit(rows).result(timeout=30.0)
            served_steps.append(int(res.model_step))

        report.update(pipeline.summary())
        if sentinel is not None:
            report.update(sentinel.summary())
        if telemetry_url is not None:
            report["telemetry_url"] = telemetry_url
        report["pipeline_replicas"] = replicas
        if sebulba:
            report["architecture"] = "sebulba"
            report["transfer_queue_occupancy_p95"] = round(
                trainer.occupancy_p95(), 2)
            report["param_staleness_p95_updates"] = round(
                trainer.staleness_p95(), 2)
            report["sebulba_stale_dropped"] = trainer.stale_dropped
            report["sebulba_actor_compiles"] = trainer.actor_guard.count
            report["sebulba_learner_compiles"] = trainer.learner_guard.count
        report["fleet_swap_count"] = coordinator.swap_count
        if watchdog is not None:
            report["lane_restarts"] = watchdog.restarts_total()
        from marl_distributedformation_tpu_torch.chaos import get_fault_plane

        if get_fault_plane().fired:
            report["chaos_faults_fired"] = len(
                get_fault_plane().fired_record())
        live = obs_spine.get_registry().snapshot()
        for key in (
            "checkpoint_writes_skipped_total",
            "checkpoint_quarantined_total",
            "checkpoint_nonfinite_skipped_total",
            "checkpoint_pruned_total",
            "pipeline_gate_timeouts_total",
        ):
            if live.get(key):
                report[key] = int(live[key])
        if trainer.recovery_ladder is not None:
            ladder = trainer.recovery_ladder
            report["train_recoveries"] = ladder.recoveries
            report["train_divergence_events"] = ladder.breaches
            report["train_skipped_updates"] = ladder.skipped_total
            report["train_halted"] = bool(trainer.halted)
        report["verified_served_steps"] = served_steps
        report["train_alive"] = train_thread.is_alive()
        if train_error:
            report["train_error"] = train_error[0][:300]
        if mesh_serve:
            # Per-host receipts scraped over HTTP (the captured rungs live
            # in the host subprocesses); the ledger's receipt equality
            # below covers THIS process only.
            receipt_sets = router.host_compile_counts()
            report["mesh_hosts"] = len(mesh.hosts)
            report["mesh_commit_rounds"] = coordinator.commit_round
            report["mesh_host_states"] = {
                h["host_id"]: h["state"] for h in coordinator.hosts()
            }
            compile_receipts = {}
        else:
            compile_receipts = router.compile_counts()
            receipt_sets = compile_receipts
        report["serving_max_compiles_per_rung"] = max(
            (c for per in receipt_sets.values() for c in per.values()),
            default=0,
        )
        # Program ledger: every budget-1 build site registers once a build,
        # so the entry count equals the sum of the RetraceGuard receipts
        # over the loop's programs; the report carries both sides.
        ledger = obs_spine.get_ledger()
        if ledger.enabled:
            receipts = trainer.retrace_guard.count
            sampler_guard = getattr(trainer, "_sampler_guard", None)
            if sampler_guard is not None:
                receipts += sampler_guard.count
            if sebulba:
                receipts += trainer.actor_guard.count
                receipts += trainer.learner_guard.count
            receipts += pipeline.gate.program.guard.count
            if pipeline.gate.adversary is not None:
                receipts += pipeline.gate.adversary.guard.count
            receipts += sum(c for per in compile_receipts.values()
                            for c in per.values())
            report["ledger_programs"] = len(ledger.entries())
            report["ledger_receipts"] = receipts
            report["ledger_compile_seconds_total"] = round(
                ledger.compile_seconds_total(), 3)
            try:
                report["ledger_census"] = str(ledger.write_census(
                    Path(trainer.log_dir) / "program_ledger.json"))
            except OSError:
                pass
    finally:
        from marl_distributedformation_tpu_torch.chaos import get_fault_plane

        get_fault_plane().enabled = False
        if stop_traffic is not None:
            stop_traffic()
        if watchdog is not None:
            watchdog.stop()
        if telemetry is not None:
            telemetry.stop()
        if frontend is not None:
            frontend.stop()
        if mesh is not None:
            mesh.stop()
        elif router is not None:
            router.stop()
        pipeline.stop()

    if obs_enabled:
        # The run's spans beside promotions.jsonl.
        try:
            report["trace_dump"] = str(obs_spine.get_tracer().dump(
                Path(trainer.log_dir) / "trace_spans.json"))
        except OSError:
            pass

    out = cfg.get("out")
    if out:
        Path(out).parent.mkdir(parents=True, exist_ok=True)
        with open(out, "w") as f:
            json.dump(report, f, indent=2)
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
