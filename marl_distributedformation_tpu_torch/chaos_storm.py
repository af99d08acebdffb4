"""Chaos storm: trainer -> gate -> fleet under a seeded fault campaign.

Counterpart of the repository's ``scripts/chaos_storm.py``, with its
names, arguments, defaults, report keys and exit codes. One command runs
the whole always-learning loop while a seeded
:class:`chaos.FaultSchedule` injects crashes, wedges, checkpoint
corruption, ENOSPC and delays at the host seams the code declares
(``chaos.INJECTION_POINTS``), then checks every invariant (step
monotonicity, no request lost, budget-1 receipts, audit-log and
checkpoint-directory consistency) and reports MTTR and violations as ONE
JSON line:

    python -m marl_distributedformation_tpu_torch.chaos_storm --seed 0
    python -m marl_distributedformation_tpu_torch.chaos_storm --train
    python -m marl_distributedformation_tpu_torch.chaos_storm --sebulba
    python -m marl_distributedformation_tpu_torch.chaos_storm --mesh
    python -m marl_distributedformation_tpu_torch.chaos_storm --elastic
    # on the CPU:
    python -m marl_distributedformation_tpu_torch.chaos_storm device=cpu

Every campaign runs on ``cuda`` unless ``device=cpu`` is given (the
``key=value`` spelling of the port's entry points; ``--device cpu`` too),
and raises without a card. ``--mesh`` points the storm at a loopback
multi-process mesh (``serving/mesh``): ``--hosts`` host subprocesses on
the campaign's device (on one card they share ``cuda:0``), the
control-plane faults armed in this process, and a real ``kill -9`` of one
host. ``--elastic`` points it at the elastic re-split seams
(``serving/elastic``): a live fleet on two device slots of the campaign's
device (on one card both are ``cuda:0``) serves alternating traffic mixes
while a ``CapacityController`` re-splits it round after round.

The campaign is DETERMINISTIC from its seed: ``--print-schedule`` emits
the armed fault schedule (a pure function of the CLI arguments, equal to
the JAX script's) without running anything, and the report's
``deterministic`` section replays bit-identically. Wall-clock fields
(``chaos_mttr_s``, rates) are measurements and live OUTSIDE that section.

Phases of the single-host campaign:

1. **train**: a fused-dispatch Trainer writes checkpoints through the
   AsyncCheckpointWriter while crash/ENOSPC/corruption faults hit the
   write path; training must SURVIVE (skip-with-audit) and leave a
   crash-consistent directory.
2. **resume**: ``restore_latest_partial`` walks back over quarantined
   damage to the newest valid checkpoint.
3. **serve**: bootstrap the promotion pipeline, attach a 2-replica fleet
   and a LaneWatchdog, then run the supervised loop under the
   pipeline/serving half of the schedule while a prober measures recovery
   (kill -> first served response = MTTR).
4. **verify**: the chaos invariant suite over everything the campaign
   left on disk and in memory.

Each campaign takes ``overrides``, the train CLI's ``key=value`` list
(``always_learning.py`` takes the same): None runs the JAX script's tiny
ring/MLP settings; a list replaces the env's width, the policy and the PPO
settings with the command's (``chip_smoke.py`` runs ``gnn100``'s), and
nothing of the storm's own (``max_steps=20``, the gate, the fleet, the
checkpoint cadence, the fused chunk, the hit windows, the pacing). A
per-formation policy's request is a whole formation, so the prober's and
the overhead's request is one formation of the fleet's row shape, ``(N,
obs_dim)`` for the GNN: a seeded formation's observation from the env's
reset (through the k-NN kernel on the card) where the JAX script sends
zeros of ``(1, obs_dim)``, which the MLP keeps.

Whatever a campaign raises, it leaves the process-global fault plane
disabled and empty.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import shutil
import sys
import tempfile
import threading
import time
from pathlib import Path
from typing import (
    Any, Dict, List, Optional, Sequence, Tuple, Union,
)

# Points armed during the TRAIN leg vs the SERVE leg (the two halves of
# one campaign; per-leg pacing waits for that leg's cells to fire).
TRAIN_POINTS = (
    "checkpoint.write",
    "checkpoint.pre_rename",
    "checkpoint.post_rename",
    "ckpt_writer.submit",
)
SERVE_POINTS = (
    "stream.poll",
    "gate.eval",
    "pipeline.poll",
    "fleet.barrier",
    "registry.swap",
    "scheduler.dispatch",
)
# The --mesh campaign's serve leg: the control-plane seams that live in
# this process (the coordinator's legs and the heartbeats it serves).
MESH_SERVE_POINTS = (
    "stream.poll",
    "gate.eval",
    "pipeline.poll",
    "mesh.rpc",
    "mesh.heartbeat",
)
# The --train campaign's divergence seams (train/recovery.py): carry
# poison and grad bombs at the dispatch boundary plus checkpoint-time
# snapshot corruption, layered over the write-path weather of the train
# leg.
TRAIN_LANE_POINTS = (
    "train.carry_poison",
    "train.grad_bomb",
    "train.snapshot",
)
# The --sebulba campaign's seams (train/sebulba/queues.py): the three host
# transfer points between the actor and learner lanes. Each armed 'raise'
# is that seam's transport failure: enqueue DROPs the batch (a seq gap),
# dequeue DUPLICATEs the delivery (the seq guard must absorb it),
# param_publish holds the publish back (actors act on STALE params until
# the next version lands).
SEBULBA_POINTS = (
    "sebulba.enqueue",
    "sebulba.dequeue",
    "sebulba.param_publish",
)
# elastic: the re-split's prewarm, barrier commit and drain-retire legs
# (serving/elastic).
ELASTIC_POINTS = (
    "elastic.prewarm",
    "elastic.commit",
    "elastic.retire",
)

# Hit windows per point: high-frequency seams (polls, worker loops) can
# absorb faults deep into the campaign; rare seams (one hit per commit or
# per candidate) need their faults armed early or they never fire.
WINDOWS = {
    "checkpoint.write": 3,
    "checkpoint.pre_rename": 3,
    "checkpoint.post_rename": 3,
    "ckpt_writer.submit": 3,
    "gate.eval": 2,
    "fleet.barrier": 3,
    "registry.swap": 2,
    "stream.poll": 12,
    "pipeline.poll": 12,
    "scheduler.dispatch": 12,
    # mesh: rpc legs fire a few times per commit round, heartbeats
    # continuously.
    "mesh.rpc": 4,
    "mesh.heartbeat": 12,
    # train lane: the poison points hit once per dispatch and the
    # snapshot point once per save; each recovery REWINDS progress, so
    # faults must land early enough that the rewound run absorbs them.
    "train.carry_poison": 10,
    "train.grad_bomb": 10,
    "train.snapshot": 4,
    # sebulba: enqueue/dequeue hit once per rollout, param_publish once
    # per learner chunk.
    "sebulba.enqueue": 10,
    "sebulba.dequeue": 10,
    "sebulba.param_publish": 6,
    # elastic: prewarm once per replica build, commit once per round,
    # retire once per retired replica.
    "elastic.prewarm": 8,
    "elastic.commit": 4,
    "elastic.retire": 6,
}

Overrides = Optional[Sequence[str]]


def build_schedule(
    seed: int,
    faults: int,
    wedge_s: float = 3.0,
    delay_s: float = 0.02,
    point_names: Optional[Tuple[str, ...]] = None,
):
    """The campaign's armed faults: a pure function of the arguments.
    ``point_names`` defaults to the single-host campaign's seams."""
    from marl_distributedformation_tpu_torch.chaos import (
        INJECTION_POINTS,
        FaultSchedule,
    )

    if point_names is None:
        point_names = TRAIN_POINTS + SERVE_POINTS
    points = {p: INJECTION_POINTS[p] for p in point_names}
    return FaultSchedule.from_seed(
        seed,
        faults=faults,
        points=points,
        windows=WINDOWS,
        delay_s=delay_s,
        wedge_s=wedge_s,
    )


def _split(schedule, points: Tuple[str, ...]):
    from marl_distributedformation_tpu_torch.chaos import FaultSchedule

    wanted = set(points)
    return FaultSchedule(
        [s for s in schedule.specs if s.point in wanted],
        seed=schedule.seed,
    )


def _rows(obs_dim: Union[int, Any]):
    """One request: zeros of ``(1, obs_dim)``, or the row ``obs_dim`` (an
    array of the fleet's row shape)."""
    import numpy as np

    if isinstance(obs_dim, int):
        return np.zeros((1, obs_dim), np.float32)
    return np.asarray(obs_dim, np.float32)[None]


def _formation_row(env, device):
    """One seeded formation's observation ``(N, obs_dim)`` from the env's
    reset: a per-formation policy's probe request."""
    import torch

    from marl_distributedformation_tpu_torch.envs import spec_for_params

    spec = spec_for_params(env)
    gen = torch.Generator(device=device).manual_seed(0)
    state = spec.reset_batch(env, 1, gen, device)
    return spec.obs(state, env)[0].cpu().numpy()


class _Prober:
    """Background request stream through the router: the campaign's
    recovery witness. Each probe resolves to a success (with the served
    step) or a typed error; a future that never resolves is exactly the
    lost-request invariant violation. ``obs_dim`` is the MLP's observation
    width, or a formation's row (``_rows``)."""

    def __init__(self, router, obs_dim, interval_s: float = 0.05):
        self.router = router
        self.obs = _rows(obs_dim)
        self.interval_s = interval_s
        self.outcomes: List[dict] = []
        self.steps: List[Tuple[float, int]] = []  # (t_done, served step)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _probe_once(self) -> None:
        from concurrent.futures import TimeoutError as FutureTimeout

        try:
            future = self.router.submit(self.obs, timeout_s=2.0)
        except Exception as e:  # noqa: BLE001 — typed reject = resolved
            self.outcomes.append(
                {"ok": False, "hung": False, "error": type(e).__name__}
            )
            return
        try:
            result = future.result(timeout=10.0)
        except FutureTimeout as e:
            # A RequestTimeout is a TimeoutError too: a typed outcome,
            # hung only when the future never resolved.
            self.outcomes.append({"ok": False, "hung": not future.done(),
                                  "error": type(e).__name__})
            return
        except Exception as e:  # noqa: BLE001 — typed failure = resolved
            self.outcomes.append(
                {"ok": False, "hung": False, "error": type(e).__name__}
            )
            return
        done = time.perf_counter()
        self.outcomes.append({"ok": True, "hung": False, "error": None})
        self.steps.append((done, int(result.model_step)))

    def _loop(self) -> None:
        while not self._stop.is_set():
            self._probe_once()
            self._stop.wait(self.interval_s)

    def start(self) -> "_Prober":
        self._thread = threading.Thread(
            target=self._loop, name="chaos-prober", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=15.0)

    def mttr_samples(self, disruptions: List[float]) -> List[float]:
        """For each disruptive-fault time, seconds until the first LATER
        successful probe."""
        samples = []
        for t_fault in disruptions:
            after = [t for t, _ in self.steps if t > t_fault]
            if after:
                samples.append(after[0] - t_fault)
        return samples


def _measure_overhead(router, obs_dim, probes: int = 30) -> float:
    """Cost of the DISABLED fault plane on a served request: the per-call
    cost of ``fault_point`` over a large tight loop (minus the same loop's
    own cost), times the injection points a request crosses, relative to
    the measured request latency on the warm fleet. An A/B of whole
    request latencies cannot resolve this: coalescing noise is orders of
    magnitude larger than one attribute read."""
    from marl_distributedformation_tpu_torch.chaos import (
        fault_point,
        get_fault_plane,
    )

    plane = get_fault_plane()
    was_enabled = plane.enabled
    plane.enabled = False
    n = 200_000
    t0 = time.perf_counter()
    for _ in range(n):
        fault_point("storm.overhead_probe")
    t_call = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(n):
        pass
    t_loop = time.perf_counter() - t0
    per_call_s = max(0.0, (t_call - t_loop) / n)
    # One request crosses the frontend handler, the scheduler loop and the
    # registry-adjacent seams: call it four points, generously.
    points_per_request = 4
    obs = _rows(obs_dim)
    latencies = []
    for _ in range(probes):
        t0 = time.perf_counter()
        router.submit(obs).result(timeout=10.0)
        latencies.append(time.perf_counter() - t0)
    lat = sorted(latencies)[len(latencies) // 2]
    plane.enabled = was_enabled
    if lat <= 0.0:
        return 0.0
    return 100.0 * points_per_request * per_call_s / lat


@dataclasses.dataclass
class _Run:
    """What a campaign trains: the env, the PPO settings, the policy and
    the formations."""

    env: Any
    ppo: Any
    num_formations: int
    cfg: Any = None  # the overrides' config, None for the tiny default

    @property
    def per_iter(self) -> int:
        return self.num_formations * self.env.num_agents * self.ppo.n_steps

    def model(self):
        """A fresh policy, seeded as the train CLI seeds it."""
        import torch

        from marl_distributedformation_tpu_torch.models import MLPActorCritic
        from marl_distributedformation_tpu_torch.train import cli

        if self.cfg is None:
            return MLPActorCritic(
                self.env.obs_dim, self.env.act_dim,
                generator=torch.Generator().manual_seed(0),
            )
        return cli.build_model(self.cfg, self.env,
                               self.cfg.get("policy", "mlp"))


def _run_settings(overrides: Overrides, num_agents: int,
                  num_formations: int) -> _Run:
    """The JAX script's tiny run (``overrides`` None) or the command's
    width, policy and PPO settings, at the storm's ``max_steps=20``."""
    from marl_distributedformation_tpu_torch.algo import PPOConfig
    from marl_distributedformation_tpu_torch.env import EnvParams

    if overrides is None:
        return _Run(EnvParams(num_agents=num_agents, max_steps=20),
                    PPOConfig(n_steps=5, n_epochs=2, batch_size=32),
                    num_formations)
    from marl_distributedformation_tpu_torch.train import cli
    from marl_distributedformation_tpu_torch.utils.config import (
        env_params_from_config,
        load_config,
        validate_override_keys,
    )

    overrides = list(overrides)
    validate_override_keys(overrides, extra_keys=cli.TRAIN_KEYS)
    cfg = load_config(overrides)
    env = env_params_from_config(cfg).replace(max_steps=20)
    return _Run(env, cli.ppo_from_config(cfg), int(cfg.num_formation), cfg)


def _trainer(cls, run: _Run, device, **config):
    """``cls`` (a Trainer or the SebulbaDriver) over ``run`` with the
    storm's ``TrainConfig`` fields ``config``."""
    from marl_distributedformation_tpu_torch.train import TrainConfig

    return cls(run.env, ppo=run.ppo,
               config=TrainConfig(num_formations=run.num_formations, seed=0,
                                  **config),
               model=run.model(), device=device)


def host_params(trainer) -> Dict[str, Any]:
    """Host copy of the trainer's parameters (the final-finiteness
    witness)."""
    return {k: p.detach().cpu().numpy()
            for k, p in trainer.model.named_parameters()}


def _release() -> None:
    """Collect a finished leg's trainer, with its capture stream and its
    device memory, before the next leg builds its own."""
    import torch

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def run_campaign(
    seed: int = 0,
    faults: int = 25,
    workdir: Optional[str] = None,
    budget_s: float = 300.0,
    num_agents: int = 3,
    num_formations: int = 4,
    train_iterations: int = 16,
    eval_formations: int = 8,
    wedge_s: float = 3.0,
    gate_timeout_s: float = 1.5,
    probe_interval_s: float = 0.05,
    device: Any = "cuda",
    overrides: Overrides = None,
) -> Dict[str, Any]:
    """One full campaign; returns the report dict (the CLI prints it as
    one JSON line). Import-safe: tests and ``chip_smoke.py`` drive it."""
    from marl_distributedformation_tpu_torch.always_learning import (
        request_row_shape,
    )
    from marl_distributedformation_tpu_torch.chaos import (
        DISRUPTIVE_KINDS,
        LaneWatchdog,
        Violation,
        check_audit_log,
        check_budget_one,
        check_checkpoint_dir,
        check_no_request_lost,
        check_step_monotonic,
        get_fault_plane,
        report_violations,
    )
    from marl_distributedformation_tpu_torch.device import resolve_device
    from marl_distributedformation_tpu_torch.obs import get_registry
    from marl_distributedformation_tpu_torch.pipeline import (
        AlwaysLearningPipeline,
        GateConfig,
    )
    from marl_distributedformation_tpu_torch.serving.fleet import (
        fleet_from_checkpoint_dir,
        warmup_fleet,
    )
    from marl_distributedformation_tpu_torch.train import Trainer
    from marl_distributedformation_tpu_torch.utils.checkpoint import (
        checkpoint_path,
        checkpoint_step,
        latest_checkpoint,
        restore_latest_partial,
    )

    device = resolve_device(device)
    t_start = time.perf_counter()
    deadline = t_start + budget_s
    workdir = Path(
        workdir if workdir is not None else tempfile.mkdtemp(prefix="chaos_")
    )
    log_dir = workdir / "run"
    run = _run_settings(overrides, num_agents, num_formations)
    env = run.env
    schedule = build_schedule(seed, faults, wedge_s=wedge_s)
    plane = get_fault_plane()
    plane.reset()
    report: Dict[str, Any] = {
        "deterministic": {
            "chaos_seed": int(seed),
            "chaos_faults_armed": len(schedule),
            "schedule": schedule.record(),
        },
    }
    violations = []
    pipeline = router = prober = watchdog = None
    try:
        # ---- phase 1: train under checkpoint-path faults ---------------
        per_iter = run.per_iter
        trainer = _trainer(
            Trainer, run, device,
            total_timesteps=train_iterations * per_iter,
            save_freq=5,
            fused_chunk=2,
            name="chaos_storm",
            log_dir=str(log_dir),
        )
        plane.arm(_split(schedule, TRAIN_POINTS))
        plane.enabled = True
        trainer.train()  # must SURVIVE the injected write failures
        plane.enabled = False
        report["train_writes_skipped"] = None  # filled from registry below

        # ---- phase 2: crash-consistent resume --------------------------
        found = restore_latest_partial(log_dir, trainer.resume_keys)
        report["resume_ok"] = bool(found)
        if found is not None:
            report["resume_step"] = int(checkpoint_step(found[0]))
        del trainer
        _release()

        # ---- phase 3: pipeline + fleet under serve-path faults ---------
        gate_cfg = GateConfig(
            scenarios=("wind",),
            severities=(1.0,),
            eval_formations=eval_formations,
            clean_tolerance=10.0,
            rung_tolerance=10.0,
        )
        pipeline = AlwaysLearningPipeline(
            log_dir, env, gate_config=gate_cfg, poll_interval_s=0.05,
            gate_device=device,
        )
        if not pipeline.wait_first_promotion(timeout_s=max(
            30.0, deadline - time.perf_counter()
        )):
            report["error"] = "no candidate passed the bootstrap gate"
            report["chaos_invariant_violations"] = -1
            return report
        router, coordinator = fleet_from_checkpoint_dir(
            pipeline.promoted_dir,
            env_params=env,
            act_dim=env.act_dim,
            num_replicas=2,
            buckets=(1, 8),
            device=device,
        )
        row_shape = request_row_shape(router.policy, env)
        probe_row = (env.obs_dim if row_shape == (env.obs_dim,)
                     else _formation_row(env, device))
        watchdog = LaneWatchdog(
            wedge_timeout_s=1.0,
            backoff_base_s=0.1,
            backoff_cap_s=2.0,
            poll_interval_s=0.1,
        )
        # Every rung of every replica built (captured on the card) before
        # the schedulers start.
        warmup_fleet(router, row_shape)
        router.start()
        pipeline.attach_fleet(router, coordinator)
        # The disabled-plane overhead, measured on the warm fleet BEFORE
        # the serve-leg faults arm (both passes fault-free).
        report["fault_plane_overhead_pct"] = round(
            _measure_overhead(router, probe_row), 2
        )
        # The deadline only needed to outlast the bootstrap eval, which
        # built the program: now the wedge faults get a real timeout.
        pipeline.gate.config = dataclasses.replace(
            gate_cfg, gate_timeout_s=gate_timeout_s
        )
        watchdog.watch_pipeline(pipeline)
        watchdog.watch_fleet(router)
        watchdog.start()
        prober = _Prober(
            router, probe_row, interval_s=probe_interval_s
        ).start()
        plane.arm(_split(schedule, SERVE_POINTS))
        plane.enabled = True
        pipeline.run(interval_s=0.05)
        # Pace: run until every serve-leg fault fired or the budget ends.
        # High-frequency seams absorb their faults on their own; the
        # CANDIDATE-DRIVEN seams (gate eval, fleet commit) only hit when a
        # checkpoint flows, and a seed whose gate faults reject every real
        # candidate would starve the commit-path cells forever. So while
        # those cells are pending, the storm keeps the candidate stream
        # fed: byte copies of the newest valid checkpoint at advancing
        # steps (what a still-running trainer would provide).
        candidate_points = ("gate.eval", "fleet.barrier", "registry.swap")
        synth_src = found[0] if found is not None else None
        newest = latest_checkpoint(log_dir)
        synth_step = checkpoint_step(newest) if newest is not None else 0
        synth_last, synth_count = time.perf_counter(), 0
        while (
            plane.pending(SERVE_POINTS) > 0
            and time.perf_counter() < deadline
        ):
            time.sleep(0.1)
            if (
                synth_src is not None
                and plane.pending(candidate_points) > 0
                and time.perf_counter() - synth_last > 1.5
                and synth_count < 24
            ):
                synth_step += per_iter
                dst = checkpoint_path(log_dir, synth_step)
                tmp = dst.with_name(f".{dst.name}.tmp")
                shutil.copyfile(synth_src, tmp)
                tmp.replace(dst)
                pipeline.stream.nudge()
                synth_last = time.perf_counter()
                synth_count += 1
        # Grace so recovery from the LAST fault is observable.
        time.sleep(max(2.0, wedge_s * 0.75))
        plane.enabled = False
        pipeline.stop()
        watchdog.stop()
        prober.stop()

        # ---- phase 4: invariants ---------------------------------------
        fired = plane.fired_record()
        disruptions = [
            f["t"]
            for f in plane.fired
            if f["kind"] in DISRUPTIVE_KINDS and f["point"] in SERVE_POINTS
        ]
        mttr = prober.mttr_samples(disruptions)
        violations += check_step_monotonic(
            prober.steps,
            rollback_to_steps=[r["to_step"] for r in pipeline.rollbacks],
        )
        violations += check_no_request_lost(prober.outcomes)
        compiles = {
            "gate_matrix": (
                pipeline.gate.program.compile_count
                if pipeline.gate.program is not None
                else 0
            ),
        }
        for replica, per_rung in router.compile_counts().items():
            for rung, count in per_rung.items():
                compiles[f"replica{replica}_rung{rung}"] = count
        violations += check_budget_one(compiles)
        violations += check_audit_log(log_dir / "promotions.jsonl")
        violations += check_checkpoint_dir(log_dir)
        violations += check_checkpoint_dir(pipeline.promoted_dir)
        if disruptions and not mttr:
            violations.append(
                Violation(
                    "recovery",
                    f"{len(disruptions)} disruptive fault(s) fired but no "
                    "probe ever succeeded afterwards — the fleet never "
                    "recovered",
                )
            )
        report["chaos_violations"] = report_violations(violations, plane)
        report["chaos_invariant_violations"] = len(violations)
        report["chaos_faults_fired"] = len(fired)
        report["chaos_faults_unfired"] = plane.pending()
        if mttr:
            report["chaos_mttr_s"] = round(max(mttr), 3)
            report["chaos_mttr_p50_s"] = round(
                sorted(mttr)[len(mttr) // 2], 3
            )
        report["chaos_disruptions"] = len(disruptions)
        report["probes_total"] = len(prober.outcomes)
        report["probes_ok"] = sum(1 for o in prober.outcomes if o["ok"])
        report["promotions"] = len(pipeline.promotions)
        report["rejections"] = len(pipeline.rejections)
        report["gate_timeouts"] = sum(
            1 for v in pipeline.rejections if v.timed_out
        )
        report["pipeline_restarts"] = watchdog.restarts_total()
        # The port's: the receipts, and the healthy gate evals after the
        # bootstrap's build beside the deadline they must stay under.
        report["compile_receipts"] = compiles
        report["gate_timeout_s"] = float(gate_timeout_s)
        healthy = [r.spans["gate_eval_s"] for r in pipeline.promotions[1:]
                   if r.spans and "gate_eval_s" in r.spans]
        healthy += [v.eval_seconds for v in pipeline.rejections
                    if not v.timed_out and v.eval_seconds > 0]
        report["gate_eval_s_max"] = (round(max(healthy), 4) if healthy
                                     else None)
        report["gate_cells_evaluated"] = int(pipeline.gate.cells_evaluated)
        snap = get_registry().snapshot()
        report["train_writes_skipped"] = int(
            snap.get("checkpoint_writes_skipped_total", 0)
        )
        report["checkpoints_quarantined"] = int(
            snap.get("checkpoint_quarantined_total", 0)
        )
        report["campaign_seconds"] = round(time.perf_counter() - t_start, 2)
        return report
    finally:
        plane.enabled = False
        plane.reset()
        if prober is not None:
            prober.stop()
        if watchdog is not None:
            watchdog.stop()
        if pipeline is not None:
            pipeline.stop()
        if router is not None:
            router.stop()


def run_mesh_campaign(
    seed: int = 0,
    faults: int = 20,
    hosts: int = 2,
    workdir: Optional[str] = None,
    budget_s: float = 300.0,
    num_agents: int = 3,
    num_formations: int = 4,
    train_iterations: int = 16,
    eval_formations: int = 8,
    wedge_s: float = 2.0,
    gate_timeout_s: float = 1.5,
    probe_interval_s: float = 0.05,
    device: Any = "cuda",
    overrides: Overrides = None,
) -> Dict[str, Any]:
    """The storm pointed at a loopback multi-process mesh: the SAME
    invariant checkers, now with the fleet spread over ``hosts`` real
    subprocesses on ``device``, the control-plane faults armed in this
    process, and a real ``kill -9`` of one host mid-storm instead of a
    ``SimulatedCrash``. One JSON line out, :func:`run_campaign`'s shape
    plus the ``mesh_*`` fields (and the port's ``compile_receipts``)."""
    import signal

    from marl_distributedformation_tpu_torch.chaos import (
        DISRUPTIVE_KINDS,
        LaneWatchdog,
        Violation,
        check_audit_log,
        check_budget_one,
        check_checkpoint_dir,
        check_no_request_lost,
        check_step_monotonic,
        get_fault_plane,
        report_violations,
    )
    from marl_distributedformation_tpu_torch.device import resolve_device
    from marl_distributedformation_tpu_torch.pipeline import (
        AlwaysLearningPipeline,
        GateConfig,
    )
    from marl_distributedformation_tpu_torch.serving.mesh import (
        spawn_local_mesh,
    )
    from marl_distributedformation_tpu_torch.serving.mesh.host import (
        write_run_config,
    )
    from marl_distributedformation_tpu_torch.train import Trainer
    from marl_distributedformation_tpu_torch.utils.checkpoint import (
        checkpoint_path,
        checkpoint_step,
        latest_checkpoint,
        restore_latest_partial,
    )

    device = resolve_device(device)
    t_start = time.perf_counter()
    deadline = t_start + budget_s
    workdir = Path(
        workdir
        if workdir is not None
        else tempfile.mkdtemp(prefix="chaos_mesh_")
    )
    log_dir = workdir / "run"
    run = _run_settings(overrides, num_agents, num_formations)
    env = run.env
    schedule = build_schedule(
        seed,
        faults,
        wedge_s=wedge_s,
        point_names=TRAIN_POINTS + MESH_SERVE_POINTS,
    )
    plane = get_fault_plane()
    plane.reset()
    report: Dict[str, Any] = {
        "deterministic": {
            "chaos_seed": int(seed),
            "chaos_faults_armed": len(schedule),
            "schedule": schedule.record(),
        },
        "mesh_hosts": int(hosts),
    }
    violations: List[Any] = []
    pipeline = mesh = prober = watchdog = None
    try:
        # ---- phase 1: train under checkpoint-path faults ---------------
        per_iter = run.per_iter
        trainer = _trainer(
            Trainer, run, device,
            total_timesteps=train_iterations * per_iter,
            save_freq=5,
            fused_chunk=2,
            name="chaos_mesh_storm",
            log_dir=str(log_dir),
        )
        per_formation = getattr(trainer.model, "per_formation", False)
        plane.arm(_split(schedule, TRAIN_POINTS))
        plane.enabled = True
        trainer.train()  # must SURVIVE the injected write failures
        plane.enabled = False

        # ---- phase 2: crash-consistent resume --------------------------
        found = restore_latest_partial(log_dir, trainer.resume_keys)
        report["resume_ok"] = bool(found)
        del trainer
        _release()

        # ---- phase 3: bootstrap the pipeline, then the mesh ------------
        gate_cfg = GateConfig(
            scenarios=("wind",),
            severities=(1.0,),
            eval_formations=eval_formations,
            clean_tolerance=10.0,
            rung_tolerance=10.0,
        )
        pipeline = AlwaysLearningPipeline(
            log_dir, env, gate_config=gate_cfg, poll_interval_s=0.05,
            gate_device=device,
        )
        if not pipeline.wait_first_promotion(
            timeout_s=max(30.0, deadline - time.perf_counter())
        ):
            report["error"] = "no candidate passed the bootstrap gate"
            report["chaos_invariant_violations"] = -1
            return report
        # The hosts read the run's env params beside its checkpoints (the
        # promoted directory's parent), as the serve CLI does.
        write_run_config(log_dir, env)
        mesh = spawn_local_mesh(
            pipeline.promoted_dir,
            hosts=hosts,
            buckets=(1, 8),
            heartbeat_s=0.2,
            lease_s=0.8,
            dead_after_s=0.8,
            probe_interval_s=0.5,
            ready_timeout_s=max(30.0, deadline - time.perf_counter()),
            device=device,
        )
        killed_host = None
        t_kill = None
        # The pipeline lane is the only in-process lane to supervise: the
        # hosts are separate processes whose death IS the scenario (the
        # coordinator's lease taxonomy owns declaring it).
        watchdog = LaneWatchdog(
            wedge_timeout_s=1.0,
            backoff_base_s=0.1,
            backoff_cap_s=2.0,
            poll_interval_s=0.1,
        )
        pipeline.attach_fleet(mesh.router, mesh.coordinator)
        pipeline.gate.config = dataclasses.replace(
            gate_cfg, gate_timeout_s=gate_timeout_s
        )
        watchdog.watch_pipeline(pipeline)
        watchdog.start()
        probe_row = (_formation_row(env, device) if per_formation
                     else env.obs_dim)
        prober = _Prober(
            mesh.router, probe_row, interval_s=probe_interval_s
        ).start()
        plane.arm(_split(schedule, MESH_SERVE_POINTS))
        plane.enabled = True
        pipeline.run(interval_s=0.05)
        # Pace like the single-host storm: keep the candidate stream fed
        # while commit-path cells are pending, and mid-storm drop the
        # hammer — a REAL SIGKILL of one host subprocess.
        candidate_points = ("gate.eval", "mesh.rpc")
        synth_src = found[0] if found is not None else None
        newest = latest_checkpoint(log_dir)
        synth_step = checkpoint_step(newest) if newest is not None else 0
        synth_last, synth_count = time.perf_counter(), 0
        kill_at = time.perf_counter() + 3.0
        # Pace until every serve-leg fault fired AND at least one
        # coordinator-driven global swap LANDED (swap_count counts commits
        # that served; commit_round counts attempts, aborts included) — or
        # the budget ends.
        while (
            plane.pending(MESH_SERVE_POINTS) > 0
            or mesh.coordinator.swap_count == 0
        ) and time.perf_counter() < deadline:
            time.sleep(0.1)
            if killed_host is None and time.perf_counter() >= kill_at:
                t_kill = time.perf_counter()
                killed_host = mesh.kill_host(0, sig=signal.SIGKILL)
            if (
                synth_src is not None
                and plane.pending(candidate_points) > 0
                and time.perf_counter() - synth_last > 1.0
                and synth_count < 24
            ):
                synth_step += per_iter
                dst = checkpoint_path(log_dir, synth_step)
                tmp = dst.with_name(f".{dst.name}.tmp")
                shutil.copyfile(synth_src, tmp)
                tmp.replace(dst)
                pipeline.stream.nudge()
                synth_last = time.perf_counter()
                synth_count += 1
        if killed_host is None:
            # Every fault fired before the timer: the kill is still owed
            # (it IS the campaign's headline disruption).
            t_kill = time.perf_counter()
            killed_host = mesh.kill_host(0, sig=signal.SIGKILL)
        time.sleep(max(2.0, wedge_s))
        plane.enabled = False
        pipeline.stop()
        watchdog.stop()
        prober.stop()
        receipts = mesh.router.host_compile_counts()
        mesh_snapshot = mesh.router.snapshot()
        mesh_swaps_landed = mesh.coordinator.swap_count
        host_states = {
            h["host_id"]: h["state"] for h in mesh.coordinator.hosts()
        }

        # ---- phase 4: invariants ---------------------------------------
        fired = plane.fired_record()
        disruptions = [
            f["t"]
            for f in plane.fired
            if f["kind"] in DISRUPTIVE_KINDS
            and f["point"] in MESH_SERVE_POINTS
        ]
        if t_kill is not None:
            disruptions.append(t_kill)  # the kill -9 IS a disruption
        mttr = prober.mttr_samples(disruptions)
        violations += check_step_monotonic(
            prober.steps,
            rollback_to_steps=[r["to_step"] for r in pipeline.rollbacks],
        )
        violations += check_no_request_lost(prober.outcomes)
        compiles = {
            "gate_matrix": (
                pipeline.gate.program.compile_count
                if pipeline.gate.program is not None
                else 0
            ),
        }
        for host_id, per_rung in receipts.items():
            for rung, count in per_rung.items():
                compiles[f"{host_id}_{rung}"] = int(count)
        violations += check_budget_one(compiles)
        violations += check_audit_log(log_dir / "promotions.jsonl")
        violations += check_checkpoint_dir(log_dir)
        violations += check_checkpoint_dir(pipeline.promoted_dir)
        if disruptions and not mttr:
            violations.append(
                Violation(
                    "recovery",
                    f"{len(disruptions)} disruption(s) (incl. the host "
                    "kill) but no probe ever succeeded afterwards — the "
                    "mesh never recovered",
                )
            )
        if killed_host is not None and host_states.get(killed_host) != "dead":
            violations.append(
                Violation(
                    "gossip",
                    f"killed host {killed_host} never declared dead "
                    f"(state: {host_states.get(killed_host)!r}) — the "
                    "lease/suspect/dead taxonomy missed a real SIGKILL",
                )
            )
        if mesh_swaps_landed == 0:
            violations.append(
                Violation(
                    "global_commit",
                    "no coordinator-driven global swap LANDED during the "
                    "campaign (aborted rounds don't count) — the "
                    "monotonicity witness never crossed a cross-host "
                    "commit, so the acceptance criterion was not exercised",
                )
            )
        report["chaos_violations"] = report_violations(violations, plane)
        report["chaos_invariant_violations"] = len(violations)
        report["chaos_faults_fired"] = len(fired)
        report["chaos_faults_unfired"] = plane.pending()
        if mttr:
            report["chaos_mttr_s"] = round(max(mttr), 3)
            report["chaos_mttr_p50_s"] = round(
                sorted(mttr)[len(mttr) // 2], 3
            )
        report["chaos_disruptions"] = len(disruptions)
        report["probes_total"] = len(prober.outcomes)
        report["probes_ok"] = sum(1 for o in prober.outcomes if o["ok"])
        report["promotions"] = len(pipeline.promotions)
        report["rejections"] = len(pipeline.rejections)
        report["pipeline_restarts"] = watchdog.restarts_total()
        report["mesh_host_killed"] = killed_host
        report["mesh_host_states"] = host_states
        report["mesh_commit_rounds"] = int(
            mesh_snapshot.get("mesh_commit_rounds", 0)
        )
        report["mesh_global_swaps"] = int(mesh_swaps_landed)
        report["mesh_failed_over_total"] = int(
            mesh_snapshot.get("mesh_failed_over_total", 0)
        )
        report["mesh_final_step"] = int(mesh_snapshot.get("mesh_step", -1))
        # The port's: the receipts and the faults that fired.
        report["compile_receipts"] = compiles
        report["chaos_fired"] = fired
        report["campaign_seconds"] = round(time.perf_counter() - t_start, 2)
        return report
    finally:
        plane.enabled = False
        plane.reset()
        if prober is not None:
            prober.stop()
        if watchdog is not None:
            watchdog.stop()
        if pipeline is not None:
            pipeline.stop()
        if mesh is not None:
            mesh.stop()


def run_train_campaign(
    seed: int = 0,
    faults: int = 10,
    workdir: Optional[str] = None,
    budget_s: float = 240.0,
    num_agents: int = 3,
    num_formations: int = 4,
    train_iterations: int = 40,
    fused_chunk: int = 2,
    mttr_bound_s: float = 60.0,
    device: Any = "cuda",
    overrides: Overrides = None,
) -> Dict[str, Any]:
    """The storm pointed at the TRAIN lane (train/recovery.py): a
    fused-dispatch Trainer with the in-program health word and the
    recovery ladder armed runs to completion while the seeded schedule
    drives NaN carry bombs, finite grad bombs and checkpoint-time snapshot
    corruption through the dispatch boundary (plus the write-path
    weather). The campaign then checks the lane's invariants:
    crash-consistent checkpoint dir, NO non-finite checkpoint visible to
    discovery, the run terminated on finite params without halting,
    recovery MTTR bounded, budget-1 receipts with health and chaos both
    ON. One JSON line out."""
    from marl_distributedformation_tpu_torch.chaos import (
        Violation,
        check_budget_one,
        check_checkpoint_dir,
        check_final_params_finite,
        check_finite_checkpoints,
        check_recovery_log,
        get_fault_plane,
        report_violations,
    )
    from marl_distributedformation_tpu_torch.device import resolve_device
    from marl_distributedformation_tpu_torch.obs import get_registry
    from marl_distributedformation_tpu_torch.train import (
        Trainer,
        read_recovery_log,
    )

    device = resolve_device(device)
    t_start = time.perf_counter()
    workdir = Path(
        workdir
        if workdir is not None
        else tempfile.mkdtemp(prefix="chaos_train_")
    )
    log_dir = workdir / "run"
    run = _run_settings(overrides, num_agents, num_formations)
    train_points = TRAIN_LANE_POINTS + TRAIN_POINTS
    schedule = build_schedule(seed, faults, point_names=train_points)
    plane = get_fault_plane()
    plane.reset()
    report: Dict[str, Any] = {
        "deterministic": {
            "chaos_seed": int(seed),
            "chaos_faults_armed": len(schedule),
            "schedule": schedule.record(),
        },
    }
    violations: List[Violation] = []
    try:
        # One leg: the fused driver (dispatch N+1, drain N, detect at the
        # drain, roll back, keep going) runs its whole budget under the
        # armed schedule. Every rollback REWINDS num_timesteps, so the
        # loop self-extends past each recovery.
        max_rollbacks = max(8, faults)
        trainer = _trainer(
            Trainer, run, device,
            total_timesteps=train_iterations * run.per_iter,
            save_freq=5,
            fused_chunk=fused_chunk,
            name="chaos_train_storm",
            log_dir=str(log_dir),
            health=True,
            recovery=True,
            recovery_breach_iters=2,
            recovery_max_rollbacks=max_rollbacks,
            keep_last_n=6,
        )
        plane.arm(schedule)
        plane.enabled = True
        trainer.train()  # must SURVIVE every bomb and finish finite
        plane.enabled = False

        # ---- invariants ------------------------------------------------
        fired = plane.fired_record()
        unfired = plane.pending()
        ladder = trainer.recovery_ladder
        events = read_recovery_log(log_dir / "recovery.jsonl")
        mttr = [
            float(e["mttr_s"]) for e in events if e["event"] == "rollback"
        ]
        violations += check_checkpoint_dir(log_dir)
        violations += check_finite_checkpoints(log_dir)
        violations += check_recovery_log(
            log_dir / "recovery.jsonl",
            # +1: the run-end finite-params guarantee may restore once
            # past the retry budget (Trainer._ensure_finite_final_state).
            max_rollbacks=max_rollbacks + 1,
            mttr_bound_s=mttr_bound_s,
        )
        violations += check_final_params_finite(host_params(trainer))
        violations += check_budget_one(
            {"train_iteration": trainer.retrace_guard.count}
        )
        if trainer.halted:
            violations.append(
                Violation(
                    "train_halt",
                    "the campaign's faults are all recoverable but the run "
                    "HALTED — the ladder burned its rollback budget on "
                    "faults it should have absorbed",
                )
            )
        poison_fired = [
            f for f in fired
            if f["point"] in ("train.carry_poison", "train.grad_bomb")
            and f["kind"] == "raise"
        ]
        if poison_fired and (ladder is None or ladder.recoveries == 0):
            violations.append(
                Violation(
                    "recovery",
                    f"{len(poison_fired)} poison fault(s) fired but the "
                    "ladder never rolled back — divergence went undetected",
                )
            )
        if unfired:
            violations.append(
                Violation(
                    "campaign_coverage",
                    f"{unfired} armed fault(s) never fired — the campaign "
                    "ended before exercising its whole schedule (raise "
                    "train_iterations or lower the hit windows)",
                )
            )
        report["chaos_violations"] = report_violations(violations, plane)
        report["chaos_invariant_violations"] = len(violations)
        report["chaos_faults_fired"] = len(fired)
        report["chaos_faults_unfired"] = unfired
        report["train_recoveries"] = ladder.recoveries if ladder else 0
        report["train_divergence_events"] = ladder.breaches if ladder else 0
        report["train_skipped_updates"] = (
            ladder.skipped_total if ladder else 0
        )
        report["train_halted"] = bool(trainer.halted)
        if mttr:
            report["recovery_mttr_s"] = round(max(mttr), 3)
            report["recovery_mttr_p50_s"] = round(
                sorted(mttr)[len(mttr) // 2], 3
            )
        snap = get_registry().snapshot()
        report["train_writes_skipped"] = int(
            snap.get("checkpoint_writes_skipped_total", 0)
        )
        report["checkpoints_nonfinite_skipped"] = int(
            snap.get("checkpoint_nonfinite_skipped_total", 0)
        )
        report["checkpoints_quarantined"] = int(
            snap.get("checkpoint_quarantined_total", 0)
        )
        report["checkpoints_pruned"] = int(
            snap.get("checkpoint_pruned_total", 0)
        )
        report["final_timesteps"] = int(trainer.num_timesteps)
        report["train_compiles"] = int(trainer.retrace_guard.count)
        report["campaign_seconds"] = round(time.perf_counter() - t_start, 2)
        del budget_s  # the fused run is bounded by its iteration count
        return report
    finally:
        # An escaping exception must not leave the PROCESS-GLOBAL plane
        # live: anything after this campaign would train under faults.
        plane.enabled = False
        plane.reset()


def run_sebulba_campaign(
    seed: int = 0,
    faults: int = 10,
    workdir: Optional[str] = None,
    budget_s: float = 240.0,
    num_agents: int = 3,
    num_formations: int = 4,
    train_iterations: int = 40,
    fused_chunk: int = 2,
    transfer_queue_depth: int = 2,
    max_param_staleness: int = 2,
    device: Any = "cuda",
    overrides: Overrides = None,
) -> Dict[str, Any]:
    """The storm pointed at the SEBULBA transfer seams (train/sebulba/):
    a pipelined actor/learner run completes its whole timestep budget
    while the seeded schedule drops trajectory batches at the enqueue
    seam, redelivers them at the dequeue seam and holds parameter
    publishes back at the bus; then the lane's contracts are checked over
    the run's artifacts: no trajectory consumed twice, parameter versions
    monotone at the consumer, staleness of every CONSUMED batch bounded by
    ``max_param_staleness``, budget-1 receipts per lane, crash-consistent
    checkpoint dir, finite final params. One JSON line out."""
    from marl_distributedformation_tpu_torch.chaos import (
        Violation,
        check_bounded_staleness,
        check_budget_one,
        check_checkpoint_dir,
        check_final_params_finite,
        check_no_duplicate_consume,
        check_params_version_monotone,
        get_fault_plane,
        report_violations,
    )
    from marl_distributedformation_tpu_torch.device import resolve_device
    from marl_distributedformation_tpu_torch.train import SebulbaDriver

    device = resolve_device(device)
    t_start = time.perf_counter()
    workdir = Path(
        workdir
        if workdir is not None
        else tempfile.mkdtemp(prefix="chaos_sebulba_")
    )
    log_dir = workdir / "run"
    run = _run_settings(overrides, num_agents, num_formations)
    schedule = build_schedule(seed, faults, point_names=SEBULBA_POINTS)
    plane = get_fault_plane()
    plane.reset()
    report: Dict[str, Any] = {
        "deterministic": {
            "chaos_seed": int(seed),
            "chaos_faults_armed": len(schedule),
            "schedule": schedule.record(),
        },
    }
    violations: List[Violation] = []
    try:
        # One leg: the pipelined driver runs its whole budget (counted at
        # the actor) under the armed transfer weather. Dropped batches
        # slow the learner, never the budget; held-back publishes raise
        # measured staleness, and the staleness gate must keep every batch
        # that REACHES an update inside the bound.
        driver = _trainer(
            SebulbaDriver, run, device,
            total_timesteps=train_iterations * run.per_iter,
            save_freq=5,
            fused_chunk=fused_chunk,
            name="chaos_sebulba_storm",
            log_dir=str(log_dir),
            architecture="sebulba",
            transfer_queue_depth=transfer_queue_depth,
            max_param_staleness=max_param_staleness,
        )
        plane.arm(schedule)
        plane.enabled = True
        driver.train()  # must SURVIVE every transport failure
        plane.enabled = False

        # ---- invariants ------------------------------------------------
        fired = plane.fired_record()
        unfired = plane.pending()
        queue = driver.transfer_queue
        bus = driver.param_bus
        violations += check_no_duplicate_consume(queue.consumed_seqs)
        violations += check_params_version_monotone(driver.consumed_versions)
        violations += check_bounded_staleness(
            driver.consumed_staleness, max_param_staleness
        )
        violations += check_budget_one(
            {
                "sebulba_actor_rollout": driver.actor_guard.count,
                "sebulba_learner_chunk": driver.learner_guard.count,
            }
        )
        violations += check_checkpoint_dir(log_dir)
        violations += check_final_params_finite(host_params(driver))
        dup_fired = [
            f
            for f in fired
            if f["point"] == "sebulba.dequeue" and f["kind"] == "raise"
        ]
        if dup_fired and queue.duplicates_absorbed == 0:
            violations.append(
                Violation(
                    "no_duplicate_consume",
                    f"{len(dup_fired)} dequeue redelivery fault(s) fired "
                    "but the queue never absorbed a duplicate — the seq "
                    "guard was not exercised (the redelivery path is dead "
                    "code under this campaign)",
                )
            )
        if unfired:
            violations.append(
                Violation(
                    "campaign_coverage",
                    f"{unfired} armed fault(s) never fired — the campaign "
                    "ended before exercising its whole schedule (raise "
                    "train_iterations or lower the hit windows)",
                )
            )
        report["chaos_violations"] = report_violations(violations, plane)
        report["chaos_invariant_violations"] = len(violations)
        report["chaos_faults_fired"] = len(fired)
        report["chaos_faults_unfired"] = unfired
        report["sebulba_batches_enqueued"] = int(queue.enqueued_total)
        report["sebulba_batches_dropped"] = int(queue.dropped_total)
        report["sebulba_duplicates_absorbed"] = int(
            queue.duplicates_absorbed)
        report["sebulba_publishes_dropped"] = int(bus.publishes_dropped)
        report["sebulba_stale_dropped"] = int(driver.stale_dropped)
        report["sebulba_batches_consumed"] = len(queue.consumed_seqs)
        report["transfer_queue_occupancy_p95"] = round(
            driver.occupancy_p95(), 2
        )
        report["param_staleness_p95_updates"] = round(
            driver.staleness_p95(), 2
        )
        report["sebulba_actor_compiles"] = int(driver.actor_guard.count)
        report["sebulba_learner_compiles"] = int(driver.learner_guard.count)
        report["sebulba_dequeue_raises_fired"] = len(dup_fired)
        report["final_timesteps"] = int(driver.num_timesteps)
        report["campaign_seconds"] = round(time.perf_counter() - t_start, 2)
        del budget_s  # the pipelined run is bounded by its timestep budget
        return report
    finally:
        plane.enabled = False
        plane.reset()


def run_elastic_campaign(
    seed: int = 0,
    faults: int = 9,
    budget_s: float = 240.0,
    obs_dim: int = 8,
    rounds: int = 6,
    requests_per_round: int = 60,
    probe_interval_s: float = 0.03,
    device: Any = "cuda",
    overrides: Overrides = None,
) -> Dict[str, Any]:
    """The storm pointed at the elastic re-split seams (``serving/
    elastic``): a live fleet (two replicas, rungs 1/8, on two device slots
    of ``device``) serves alternating traffic mixes while a
    ``CapacityController`` re-splits it round after round, with the seeded
    schedule raising and delaying at the prewarm, barrier-commit and
    drain-retire legs. Invariants: every accepted request resolves
    (aborted rounds keep the old split serving; retire faults stop
    replicas undrained and their queued work must fail over), served steps
    stay monotonic through every commit, budget-1 receipts on the final
    replica set, at least 2 re-splits committed, and every armed fault
    fired. ``overrides`` (the train CLI's list) serve that command's
    policy at its width, whole formations of its env a request row (drawn
    from 64 formations of the env's reset, through the k-NN kernel on the
    card); None serves JAX's
    (8, 8) MLP at ``obs_dim``. One JSON line out."""
    import numpy as np
    import torch

    from marl_distributedformation_tpu_torch.chaos import (
        Violation,
        check_budget_one,
        check_no_request_lost,
        check_step_monotonic,
        get_fault_plane,
        report_violations,
    )
    from marl_distributedformation_tpu_torch.compat.policy import LoadedPolicy
    from marl_distributedformation_tpu_torch.device import resolve_device
    from marl_distributedformation_tpu_torch.models import MLPActorCritic
    from marl_distributedformation_tpu_torch.serving import (
        CapacityController,
        TraceRecorder,
    )
    from marl_distributedformation_tpu_torch.serving.fleet import (
        FleetReloadCoordinator,
        FleetRouter,
        warmup_fleet,
    )

    device = resolve_device(device)
    t_start = time.perf_counter()
    deadline = t_start + budget_s
    rng = np.random.default_rng(seed)
    if overrides is None:
        model = MLPActorCritic(obs_dim, 2, hidden=(8, 8),
                               generator=torch.Generator().manual_seed(0))
        row_shape: Tuple[int, ...] = (obs_dim,)
        pool = None
        probe_row: Any = obs_dim
    else:
        from marl_distributedformation_tpu_torch.envs import spec_for_params

        run = _run_settings(overrides, 3, 4)
        model = run.model()
        spec = spec_for_params(run.env)
        gen = torch.Generator(device=device).manual_seed(seed)
        pool = spec.obs(spec.reset_batch(run.env, 64, gen, device),
                        run.env).cpu().numpy()
        if not getattr(model, "per_formation", False):
            pool = pool.reshape(-1, pool.shape[-1])
        row_shape = tuple(pool.shape[1:])
        probe_row = pool[0]
    policy = LoadedPolicy(model.to(device).eval())

    schedule = build_schedule(seed, faults, point_names=ELASTIC_POINTS)
    plane = get_fault_plane()
    plane.reset()
    report: Dict[str, Any] = {
        "deterministic": {
            "chaos_seed": int(seed),
            "chaos_faults_armed": len(schedule),
            "schedule": schedule.record(),
        },
    }
    violations: List[Any] = []

    recorder = TraceRecorder()
    router = FleetRouter(policy, devices=[device, device], num_replicas=2,
                         buckets=(1, 8), window_ms=0.0,
                         trace_recorder=recorder)
    workdir = tempfile.mkdtemp(prefix="chaos_elastic_")
    coordinator = FleetReloadCoordinator(workdir, router)
    controller = CapacityController(
        router, coordinator, row_shape=row_shape, p95_target_ms=50.0,
        min_requests=24, drain_timeout_s=5.0,
    )
    # Three mixes cycling, so a round's plan always differs from the last
    # COMMITTED one even when the round between aborted (the same mix two
    # rounds apart would be skipped as equivalent and starve the armed
    # commit and retire cells).
    mixes = (
        ((1, 0.6), (4, 0.4)),
        ((64, 0.5), (128, 0.5)),
        ((8, 0.5), (16, 0.5)),
    )
    outcomes: List[dict] = []
    steps: List[Tuple[float, int]] = []

    def _request(n: int):
        if pool is None:
            return rng.standard_normal((n, obs_dim)).astype(np.float32)
        return pool[rng.integers(0, len(pool), n)]

    def _drive_round(mix) -> None:
        """One round of offered traffic; every accepted future must
        resolve (collected for the no-lost-request invariant)."""
        from concurrent.futures import TimeoutError as FutureTimeout

        sizes = [s for s, _ in mix]
        probs = [p for _, p in mix]
        futures = []
        for _ in range(requests_per_round):
            n = int(rng.choice(sizes, p=probs))
            try:
                futures.append(router.submit(_request(n), timeout_s=5.0))
            except Exception as e:  # noqa: BLE001 — typed reject
                outcomes.append(
                    {"ok": False, "hung": False, "error": type(e).__name__})
            time.sleep(0.002)
        for f in futures:
            try:
                result = f.result(timeout=15.0)
            except FutureTimeout as e:
                # A RequestTimeout is a TimeoutError too: a typed outcome,
                # hung only when the future never resolved.
                outcomes.append({"ok": False, "hung": not f.done(),
                                 "error": type(e).__name__})
                continue
            except Exception as e:  # noqa: BLE001 — typed failure
                outcomes.append(
                    {"ok": False, "hung": False, "error": type(e).__name__})
                continue
            outcomes.append({"ok": True, "hung": False, "error": None})
            steps.append((time.perf_counter(), int(result.model_step)))

    prober = None
    rounds_run = 0
    try:
        router.start()
        warmup_fleet(router, row_shape)
        plane.arm(schedule)
        plane.enabled = True
        prober = _Prober(router, probe_row,
                         interval_s=probe_interval_s).start()
        # Scheduled rounds, then flush rounds until every armed fault fired
        # (an aborted prewarm consumes no commit or retire cells, so the
        # campaign keeps re-splitting until the schedule drains).
        while rounds_run < rounds or (
            plane.pending(ELASTIC_POINTS) > 0
            and rounds_run < rounds + 6
            and time.perf_counter() < deadline - 10
        ):
            recorder.clear()  # each round decides from ITS mix alone
            _drive_round(mixes[rounds_run % len(mixes)])
            controller.step()
            rounds_run += 1
    finally:
        # Never leave the process-global plane live past the campaign.
        plane.enabled = False
        if prober is not None:
            prober.stop()
        router.stop()

    # ---- invariants ----------------------------------------------------
    fired = plane.fired_record()
    unfired = plane.pending()
    probed = prober.outcomes if prober is not None else []
    violations += check_no_request_lost(outcomes + probed)
    violations += check_step_monotonic(sorted(
        steps + (prober.steps if prober is not None else []),
        key=lambda s: s[0]))
    compiles = {
        f"replica{idx}_rung{bucket}": count
        for idx, counts in router.compile_counts().items()
        for bucket, count in counts.items()
    }
    violations += check_budget_one(compiles)
    snap = controller.snapshot()
    if snap["elastic_resplits_committed"] < 2:
        violations.append(Violation(
            "campaign_coverage",
            f"only {snap['elastic_resplits_committed']:.0f} re-split(s) "
            "committed — the campaign never exercised the commit seam "
            "under weather (raise rounds or lower the fault count)",
        ))
    if unfired:
        violations.append(Violation(
            "campaign_coverage",
            f"{unfired} armed fault(s) never fired — the campaign ended "
            "before exercising its whole schedule (raise rounds or lower "
            "the hit windows)",
        ))
    report["chaos_violations"] = report_violations(violations, plane)
    report["chaos_invariant_violations"] = len(violations)
    report["chaos_faults_fired"] = len(fired)
    report["chaos_faults_unfired"] = unfired
    report["elastic_rounds"] = rounds_run
    report["elastic_resplits_committed"] = int(
        snap["elastic_resplits_committed"])
    report["elastic_resplits_aborted"] = int(snap["elastic_resplits_aborted"])
    report["elastic_resplits_skipped"] = int(snap["elastic_resplits_skipped"])
    report["elastic_prewarm_compiles"] = int(
        snap["elastic_prewarm_compiles_total"])
    report["elastic_last_pause_ms"] = snap["elastic_last_pause_ms"]
    report["requests_resolved"] = len(outcomes) + len(probed)
    report["requests_ok"] = sum(1 for o in outcomes + probed if o["ok"])
    report["final_replicas"] = len(router.replicas)
    report["campaign_seconds"] = round(time.perf_counter() - t_start, 2)
    # The port's own: the final replica set's receipts.
    report["compile_receipts"] = compiles
    return report


def _schedule_line(seed: int, faults: int,
                   point_names: Optional[Tuple[str, ...]]) -> str:
    schedule = build_schedule(seed, faults, point_names=point_names)
    return json.dumps({
        "chaos_seed": seed,
        "chaos_faults_armed": len(schedule),
        "schedule": schedule.record(),
    })


def _capped(args, flag: str, cap: int, what: str) -> int:
    faults = min(args.faults, cap)
    if faults < args.faults:
        print(
            f"[storm] {flag} caps --faults at {cap} (requested "
            f"{args.faults}): {what}",
            file=sys.stderr,
        )
    return faults


def _split_device(argv: List[str]) -> Tuple[List[str], str]:
    """``device=cpu`` (the port's ``key=value`` spelling) out of ``argv``."""
    device = "cuda"
    rest = []
    for a in argv:
        if a.startswith("device="):
            device = a.split("=", 1)[1]
        else:
            rest.append(a)
    return rest, device


def main(argv: Optional[List[str]] = None) -> int:
    argv, device = _split_device(list(sys.argv[1:] if argv is None
                                      else argv))
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--faults", type=int, default=25)
    ap.add_argument("--budget-s", type=float, default=300.0)
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--device", default=device,
                    help="cuda (the default; raises without a card) or cpu")
    ap.add_argument(
        "--mesh",
        action="store_true",
        help="point the storm at a loopback multi-process mesh "
        "(serving/mesh): control-plane faults in this process plus a "
        "real kill -9 of one host subprocess mid-storm",
    )
    ap.add_argument(
        "--hosts", type=int, default=2,
        help="with --mesh: host subprocesses to spawn",
    )
    ap.add_argument(
        "--train",
        action="store_true",
        help="point the storm at the TRAIN lane (train/recovery.py): "
        "NaN carry bombs, finite grad bombs, and checkpoint-time "
        "snapshot corruption through a live fused run with the health "
        "word + recovery ladder armed; invariants: crash-consistent "
        "dir, no non-finite checkpoint visible, finite finish, bounded "
        "MTTR, budget-1 receipts",
    )
    ap.add_argument(
        "--sebulba",
        action="store_true",
        help="point the storm at the sebulba transfer seams "
        "(train/sebulba): batch drops at enqueue, redeliveries at "
        "dequeue, held-back params publishes at the bus, through a "
        "live pipelined actor/learner run; invariants: no trajectory "
        "consumed twice, params versions monotone, bounded staleness "
        "on every consumed batch, budget-1 receipts per lane",
    )
    ap.add_argument(
        "--elastic",
        action="store_true",
        help="point the storm at the elastic re-split seams "
        "(serving/elastic): a live fleet re-split round after round by a "
        "CapacityController under alternating traffic mixes, with faults "
        "at the prewarm, barrier-commit and drain-retire legs; "
        "invariants: no request lost, monotonic steps, budget-1 "
        "receipts, >= 2 re-splits committed, every armed fault fired",
    )
    ap.add_argument(
        "--print-schedule",
        action="store_true",
        help="emit the armed fault schedule (deterministic from the "
        "seed) and exit without running anything",
    )
    args = ap.parse_args(argv)
    exclusive = [
        name
        for name, on in (
            ("--mesh", args.mesh),
            ("--train", args.train),
            ("--sebulba", args.sebulba),
            ("--elastic", args.elastic),
        )
        if on
    ]
    if len(exclusive) > 1:
        ap.error(
            f"{' and '.join(exclusive)} are separate campaigns; pick one"
        )
    if args.elastic:
        faults = _capped(args, "--elastic", 9, "the three re-split seams' "
                         "armable cells are bounded by the hit windows")
        if args.print_schedule:
            print(_schedule_line(args.seed, faults, ELASTIC_POINTS))
            return 0
        report = run_elastic_campaign(
            seed=args.seed,
            faults=faults,
            budget_s=args.budget_s,
            device=args.device,
        )
        print(json.dumps(report))
        return 0 if report.get("chaos_invariant_violations") == 0 else 1
    if args.sebulba:
        faults = _capped(args, "--sebulba", 12, "the three transfer seams' "
                         "armable cells are bounded by the hit windows")
        if args.print_schedule:
            print(_schedule_line(args.seed, faults, SEBULBA_POINTS))
            return 0
        report = run_sebulba_campaign(
            seed=args.seed,
            faults=faults,
            workdir=args.workdir,
            budget_s=args.budget_s,
            device=args.device,
        )
        print(json.dumps(report))
        return 0 if report.get("chaos_invariant_violations") == 0 else 1
    if args.train:
        faults = _capped(args, "--train", 14, "the train lane's armable "
                         "cells are bounded by the hit windows")
        if args.print_schedule:
            print(_schedule_line(args.seed, faults,
                                 TRAIN_LANE_POINTS + TRAIN_POINTS))
            return 0
        report = run_train_campaign(
            seed=args.seed,
            faults=faults,
            workdir=args.workdir,
            budget_s=args.budget_s,
            device=args.device,
        )
        print(json.dumps(report))
        return 0 if report.get("chaos_invariant_violations") == 0 else 1
    faults = args.faults
    if args.mesh:
        faults = _capped(args, "--mesh", 20, "the mesh serve leg has fewer "
                         "armable cells and paces until every one fires")
    if args.print_schedule:
        print(_schedule_line(
            args.seed, faults,
            TRAIN_POINTS + MESH_SERVE_POINTS if args.mesh else None))
        return 0
    if args.mesh:
        report = run_mesh_campaign(
            seed=args.seed,
            faults=faults,
            hosts=args.hosts,
            workdir=args.workdir,
            budget_s=args.budget_s,
            device=args.device,
        )
        print(json.dumps(report))
        return 0 if report.get("chaos_invariant_violations") == 0 else 1
    report = run_campaign(
        seed=args.seed,
        faults=faults,
        workdir=args.workdir,
        budget_s=args.budget_s,
        device=args.device,
    )
    print(json.dumps(report))
    return 0 if report.get("chaos_invariant_violations") == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
