"""The port's always-learning pipeline against the JAX package on the CPU.

What is pure host logic (the gate's verdicts, the verdict log and its
audit, the checkpoint stream, the rollback monitor) is held equal to the
JAX package's on the same inputs: the same reasons, the same log records
read back by either package, the same violations, the same order, the same
trips. The gate's cells for one seeded checkpoint come from the port's
matrix program started from JAX's reset states with JAX's layer draws
injected (``test_torch_scenarios.JaxStreams``, as ``test_torch_matrix.py``
does), within ``rtol=1e-5`` of JAX's ``PromotionGate``. The end-to-end run
is JAX's ``test_pipeline_end_to_end`` on the port: three tiny iterations,
one NaN candidate, two replicas, a forced rollback.
"""

import json
import math
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marl_distributedformation_tpu.chaos import (
    check_audit_log as jax_check_audit_log,
)
from marl_distributedformation_tpu.env.formation import (
    reset_batch as jax_reset_batch,
)
from marl_distributedformation_tpu.models import MLPActorCritic as JaxMLP
from marl_distributedformation_tpu.pipeline import (
    CheckpointStream as JaxCheckpointStream,
    GateConfig as JaxGateConfig,
    PromotionGate as JaxPromotionGate,
    PromotionLog as JaxPromotionLog,
    RollbackMonitor as JaxRollbackMonitor,
    judge_candidate as jax_judge_candidate,
    judge_falsifiers as jax_judge_falsifiers,
)
from marl_distributedformation_tpu.utils.checkpoint import (
    save_checkpoint as jax_save_checkpoint,
)
from marl_distributedformation_tpu_torch import always_learning
from marl_distributedformation_tpu_torch.algo import PPOConfig
from marl_distributedformation_tpu_torch.chaos import (
    LaneWatchdog,
    check_audit_log,
    check_budget_one,
    check_step_monotonic,
)
from marl_distributedformation_tpu_torch.env import EnvParams
from marl_distributedformation_tpu_torch.models import MLPActorCritic
from marl_distributedformation_tpu_torch.obs import (
    MetricsRegistry,
    ProgramLedger,
    set_ledger,
    set_registry,
)
from marl_distributedformation_tpu_torch.pipeline import (
    AlwaysLearningPipeline,
    CheckpointStream,
    GateConfig,
    GateVerdict,
    PromotionGate,
    PromotionLog,
    RollbackMonitor,
    judge_candidate,
    judge_falsifiers,
)
from marl_distributedformation_tpu_torch.pipeline.promote import (
    PROMOTIONS_SCHEMA,
)
from marl_distributedformation_tpu_torch.serving.fleet import (
    fleet_from_checkpoint_dir,
    warmup_fleet,
)
from marl_distributedformation_tpu_torch.train import (
    TrainConfig,
    Trainer,
    assign_gate_device,
)
from marl_distributedformation_tpu_torch.utils.checkpoint import (
    checkpoint_path,
    checkpoint_step,
    msgpack_restore_file,
    msgpack_serialize,
    with_footer,
)
from test_torch_env import jax_params, to_port
from test_torch_scenarios import JaxStreams

RTOL = 1e-5
METRIC = "episode_return_per_agent"
ENV = EnvParams(num_agents=3, max_steps=20)


@pytest.fixture
def private_obs():
    """A fresh metrics registry and program ledger as the process's."""
    registry, ledger = MetricsRegistry(), ProgramLedger(enabled=True)
    previous = set_registry(registry), set_ledger(ledger)
    yield registry, ledger
    set_registry(previous[0])
    set_ledger(previous[1])


# ---------------------------------------------------------------------------
# The gate's verdicts
# ---------------------------------------------------------------------------


def _cells(value, scenario="wind", severity="1"):
    return {scenario: {severity: {METRIC: value}}}


JUDGE_CASES = {
    "bootstrap": ({METRIC: 100.0}, _cells(50.0), None, None),
    "pass": ({METRIC: 101.0}, _cells(55.0), {METRIC: 100.0}, _cells(50.0)),
    "clean_regression": ({METRIC: 80.0}, _cells(50.0), {METRIC: 100.0},
                         _cells(50.0)),
    "rung_regression": ({METRIC: 100.0}, _cells(30.0), {METRIC: 100.0},
                        _cells(50.0)),
    "both_regress": ({METRIC: -50.0}, _cells(-90.0), {METRIC: -10.0},
                     _cells(-20.0)),
    "non_finite_bootstrap": ({METRIC: math.nan}, _cells(50.0), None, None),
    "inf_rung": ({METRIC: 10.0}, _cells(math.inf), {METRIC: 100.0},
                 _cells(50.0)),
    "missing_baseline_cell": ({METRIC: 100.0}, _cells(1.0, "storm"),
                              {METRIC: 100.0}, _cells(50.0)),
    "metric_absent": ({"other": 1.0}, _cells(1.0), None, None),
    "near_zero_baseline": ({METRIC: -0.4}, _cells(0.1), {METRIC: 0.2},
                           _cells(0.3)),
}


@pytest.mark.parametrize("case", sorted(JUDGE_CASES))
def test_judge_candidate_matches_jax(case):
    clean, cells, base_clean, base_cells = JUDGE_CASES[case]
    args = (METRIC, clean, cells, base_clean, base_cells, 0.05, 0.10)
    assert judge_candidate(*args) == jax_judge_candidate(*args)


FALSIFIER_CASES = {
    "none": [],
    "below_floor": [{"scenario": "wind", "severity": 0.3, "drop": 0.4}],
    "at_floor": [{"scenario": "wind", "severity": 0.5, "drop": 0.25}],
    "mixed": [{"scenario": "wind", "severity": 0.9, "drop": 0.3},
              {"scenario": "storm", "severity": 0.1, "drop": 0.8}],
    "nan_severity": [{"scenario": "storm", "severity": math.nan,
                      "drop": 0.5}],
}


@pytest.mark.parametrize("case", sorted(FALSIFIER_CASES))
def test_judge_falsifiers_matches_jax(case):
    falsifiers = FALSIFIER_CASES[case]
    assert (judge_falsifiers(falsifiers, 0.5, METRIC)
            == jax_judge_falsifiers(falsifiers, 0.5, METRIC))


def test_gate_rebase_survives_evicted_history():
    """A demotion cascade longer than the bounded baseline history
    degrades to bootstrap judging, as JAX's does."""
    gate = PromotionGate(ENV, GateConfig(), device="cpu")
    for step in range(10, 110, 10):  # 10 promotions, history keeps 8
        gate.accept(GateVerdict(
            step=step, path=f"rl_model_{step}_steps.msgpack", passed=True,
            reasons=[], clean={METRIC: 1.0}, cells=_cells(1.0),
            baseline_step=None, eval_compiles=1, eval_seconds=0.0))
    gate.rebase(10)  # long since evicted
    assert gate.baseline_step == 10 and gate._baseline_clean is None
    gate.rebase(100)
    assert gate._baseline_clean == {METRIC: 1.0}


def test_gate_rejects_non_checkpoint_path(tmp_path):
    gate = PromotionGate(ENV, GateConfig(), device="cpu")
    weird = tmp_path / "rl_model_final.msgpack"
    weird.write_bytes(b"x")
    verdict = gate.evaluate(weird)
    assert not verdict.passed
    assert "not a checkpoint path" in verdict.reasons[0]


# ---------------------------------------------------------------------------
# The verdict log and its audit
# ---------------------------------------------------------------------------


def _write_log(log_cls, path, model_id):
    log = log_cls(path, model_id=model_id)
    log.append("rejected", step=10, checkpoint="a", reasons=["bad"],
               trace_id="t1")
    log.append("promoted", step=20, checkpoint="b", reasons=[],
               trace_id="t2", spans={"gate_eval_s": 0.5},
               host_count=1, commit_round=3)
    log.append("rolled_back", from_step=20, to_step=20, metric="v",
               value=1.0, limit=0.5, baseline=None, trace_id="t3")
    log.append("curriculum_updated", step=30,
               falsifiers=[{"scenario": "wind", "severity": 0.4}],
               trace_id="t4")


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("model_id", [None, "formation-a"])
def test_promotion_log_reads_back_in_the_other_package(tmp_path, writer,
                                                       model_id):
    path = tmp_path / "promotions.jsonl"
    _write_log(JaxPromotionLog if writer == "jax" else PromotionLog, path,
               model_id)
    ours, theirs = PromotionLog.read(path), JaxPromotionLog.read(path)
    assert ours == theirs and len(ours) == 4
    assert all(r["schema"] == PROMOTIONS_SCHEMA == 5 for r in ours)
    assert all(r["model_id"] == model_id for r in ours)
    # Old schemas read back with the newer fields backfilled; an unknown
    # one raises in both.
    with open(path, "a") as f:
        f.write(json.dumps({"schema": 1, "event": "promoted", "time": 1.0,
                            "step": 40}) + "\n")
    assert PromotionLog.read(path) == JaxPromotionLog.read(path)
    assert PromotionLog.read(path)[-1]["model_id"] is None
    with open(path, "a") as f:
        f.write(json.dumps({"schema": 99, "event": "promoted"}) + "\n")
    for reader in (PromotionLog, JaxPromotionLog):
        with pytest.raises(ValueError, match="schema 99"):
            reader.read(path)


AUDIT_LOGS = {
    "clean": [("promoted", {"step": 10}), ("rejected", {"step": 20}),
              ("promoted", {"step": 30}),
              ("rolled_back", {"from_step": 30, "to_step": 10}),
              ("promoted", {"step": 40})],
    "unknown_event": [("promoted", {"step": 10}), ("exploded", {"step": 5})],
    "not_ascending": [("promoted", {"step": 30}), ("promoted", {"step": 20})],
    "rollback_to_unserved": [("promoted", {"step": 10}),
                             ("rolled_back", {"from_step": 10,
                                              "to_step": 5})],
    "superseded_then_promoted": [
        ("promoted", {"step": 10}),
        ("promotion_superseded", {"step": 20}),
        ("promoted", {"step": 20})],
}


@pytest.mark.parametrize("case", sorted(AUDIT_LOGS) + ["unreadable"])
def test_check_audit_log_matches_jax(tmp_path, case):
    path = tmp_path / "promotions.jsonl"
    if case == "unreadable":
        path.write_text("{not json\n")
    else:
        log = PromotionLog(path)
        for event, fields in AUDIT_LOGS[case]:
            log.append(event, **fields)
    ours = [v.record() for v in check_audit_log(path)]
    theirs = [v.record() for v in jax_check_audit_log(path)]
    assert ours == theirs
    assert bool(ours) == (case != "clean")


# ---------------------------------------------------------------------------
# The checkpoint stream
# ---------------------------------------------------------------------------


def _touch_ckpt(log_dir, step):
    path = checkpoint_path(log_dir, step)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(b"x")
    return path


def test_stream_order_matches_jax(tmp_path):
    """Step order whatever the creation order, torn ``.tmp`` writes never
    seen, each checkpoint once, a late lower step ignored, the start
    offset honored: the port's stream yields JAX's sequence poll by
    poll."""
    streams = [(CheckpointStream(tmp_path, poll_interval_s=0.01),
                JaxCheckpointStream(tmp_path, poll_interval_s=0.01)),
               (CheckpointStream(tmp_path, start_after_step=10),
                JaxCheckpointStream(tmp_path, start_after_step=10))]
    script = [(5, 30, 10), (), (40,), (20,), (50, 45)]
    for i, steps in enumerate(script):
        for step in steps:
            _touch_ckpt(tmp_path, step)
        (tmp_path / f".rl_model_{999 + i}_steps.msgpack.tmp").write_bytes(
            b"torn")
        for ours, theirs in streams:
            got = [checkpoint_step(p) for p in ours.poll()]
            want = [checkpoint_step(p) for p in theirs.poll()]
            assert got == want, (i, got, want)
    # The push path: a nudge wakes a blocked wait at once.
    stream = CheckpointStream(tmp_path / "push", poll_interval_s=30.0)
    threading.Timer(0.1, lambda: (_touch_ckpt(tmp_path / "push", 7),
                                  stream.nudge())).start()
    t0 = time.perf_counter()
    assert [checkpoint_step(p) for p in stream.wait(20.0)] == [7]
    assert time.perf_counter() - t0 < 10.0


# ---------------------------------------------------------------------------
# The rollback monitor
# ---------------------------------------------------------------------------

MONITOR_CASES = {
    "ratio_sustained": (dict(ratio=2.0, baseline_samples=2, trip_after=2),
                        [10, 10, 50, 11, 50, 50, 50]),
    "ratio_negative_baseline": (
        dict(ratio=1.5, direction="below", baseline_samples=1,
             trip_after=1), [-10, -10, -14, -16, -9]),
    "threshold_below": (dict(threshold=1.0, direction="below",
                             trip_after=1), [5, 0.5, 2, 0.1]),
    "threshold_above_missing": (dict(threshold=3.0, trip_after=2),
                                [1, None, 4, None, 5, 2, 6, 7]),
}


@pytest.mark.parametrize("case", sorted(MONITOR_CASES))
def test_rollback_monitor_trips_match_jax(case):
    kwargs, samples = MONITOR_CASES[case]
    values = {}
    ours = RollbackMonitor(lambda: values, "m", **kwargs)
    theirs = JaxRollbackMonitor(lambda: values, "m", **kwargs)
    trips = []
    for sample in samples:
        values.clear()
        if sample is not None:
            values["m"] = float(sample)
        trips.append((ours.observe(), theirs.observe()))
        assert ours.limit() == theirs.limit()
    assert [a for a, _ in trips] == [b for _, b in trips]
    assert any(a for a, _ in trips)
    for bad in (dict(), dict(ratio=0.5)):
        with pytest.raises(ValueError):
            RollbackMonitor(lambda: values, "m", **bad)


# ---------------------------------------------------------------------------
# The gate's cells against JAX's PromotionGate
# ---------------------------------------------------------------------------


def test_gate_cells_match_jax(tmp_path):
    """One seeded checkpoint through both gates: every cell within rtol
    1e-5, the same verdict and reasons, one build each across two
    candidates (the receipt is the first eager run on the CPU)."""
    params = EnvParams(num_agents=3, max_steps=6)
    jp = jax_params(params)
    config = dict(scenarios=("wind", "sensor_noise"), severities=(0.5, 1.0),
                  eval_formations=4, eval_seed=7)
    jmodel = JaxMLP(act_dim=2, hidden=(8, 8))
    paths = []
    for seed in (0, 1):
        variables = jmodel.init(jax.random.PRNGKey(seed),
                                jnp.zeros((1, params.obs_dim)))
        paths.append(jax_save_checkpoint(tmp_path, 100 * (seed + 1), {
            "policy": "MLPActorCritic", "params": variables,
            "num_timesteps": 100 * (seed + 1)}))
    js = jax_reset_batch(jax.random.PRNGKey(config["eval_seed"]), jp, 4)
    ours = PromotionGate(
        params, GateConfig(**config), device="cpu",
        initial_state=to_port(js),
        streams_factory=lambda: JaxStreams(js.key, js.steps, params))
    theirs = JaxPromotionGate(jp, JaxGateConfig(**config))
    for path in paths:
        got, want = ours.evaluate(path), theirs.evaluate(path)
        assert got.passed == want.passed and got.reasons == want.reasons
        for key in want.clean:
            np.testing.assert_allclose(got.clean[key], want.clean[key],
                                       rtol=RTOL, err_msg=key)
        assert set(got.cells) == set(want.cells)
        for scenario, per_sev in want.cells.items():
            assert set(got.cells[scenario]) == set(per_sev)
            for sev, metrics in per_sev.items():
                for key, value in metrics.items():
                    np.testing.assert_allclose(
                        got.cells[scenario][sev][key], value, rtol=RTOL,
                        err_msg=f"{scenario}@{sev} {key}")
        if got.passed:
            ours.accept(got)
            theirs.accept(want)
    assert ours.program.compile_count == theirs.program.compile_count == 1


# ---------------------------------------------------------------------------
# End to end: trainer -> gate -> fleet, sabotage and rollback
# ---------------------------------------------------------------------------


def _train_checkpoints(log_dir, iterations=3, seed=0, on_checkpoint=None):
    """A tiny real training run of the port; returns its checkpoints and
    the trainer."""
    per_iter = 4 * ENV.num_agents * 5
    trainer = Trainer(
        ENV,
        ppo=PPOConfig(n_steps=5, n_epochs=2, batch_size=32),
        config=TrainConfig(
            num_formations=4, total_timesteps=iterations * per_iter,
            save_freq=5, name="pipeline_test", log_dir=str(log_dir),
            seed=seed,
        ),
        model=MLPActorCritic(ENV.obs_dim,
                             generator=torch.Generator().manual_seed(seed)),
        device="cpu",
    )
    trainer.on_checkpoint = on_checkpoint
    trainer.train()
    return sorted(log_dir.glob("rl_model_*_steps.msgpack"),
                  key=checkpoint_step), trainer


def _sabotage_nan(path):
    """NaN parameters under a valid footer: the file loads and fails the
    gate on its eval (the trainer's own writer refuses non-finite
    trees)."""
    raw = msgpack_restore_file(path)

    def nan(tree):
        if isinstance(tree, dict):
            return {k: nan(v) for k, v in tree.items()}
        if isinstance(tree, np.ndarray) and tree.dtype.kind == "f":
            return np.full_like(tree, np.nan)
        return tree

    raw["params"] = nan(raw["params"])
    path.write_bytes(with_footer(msgpack_serialize(raw)))


def test_trainer_on_checkpoint_fires_after_each_durable_write(tmp_path):
    seen = []
    ckpts, trainer = _train_checkpoints(tmp_path, iterations=2,
                                        on_checkpoint=seen.append)
    # Every checkpoint written, in order (the end of the run writes its
    # last step again), each file there when the hook ran.
    got = [checkpoint_step(p) for p in seen]
    assert sorted(set(got)) == got[:len(set(got))] == [
        checkpoint_step(p) for p in ckpts]
    assert all(p.exists() for p in map(type(ckpts[0]), seen))
    trainer.num_timesteps += 1
    path = trainer.save()
    assert str(seen[-1]) == path


def test_pipeline_end_to_end(tmp_path, private_obs):
    registry, ledger = private_obs
    log_dir = tmp_path / "run"
    ckpts, trainer = _train_checkpoints(log_dir, iterations=3)
    steps = [checkpoint_step(p) for p in ckpts]
    assert len(steps) >= 3
    s1, s_bad, s3 = steps[0], steps[1], steps[-1]
    _sabotage_nan(ckpts[1])
    pipeline = AlwaysLearningPipeline(
        log_dir, ENV,
        gate_config=GateConfig(scenarios=("wind",), severities=(1.0,),
                               eval_formations=8, clean_tolerance=10.0,
                               rung_tolerance=10.0),
        poll_interval_s=0.01, gate_device="cpu",
    )
    assert pipeline.wait_first_promotion(timeout_s=120.0)
    assert [r.step for r in pipeline.promotions] == [s1]
    router, coordinator = fleet_from_checkpoint_dir(
        pipeline.promoted_dir, env_params=ENV, act_dim=ENV.act_dim,
        num_replicas=2, buckets=(1, 8), device="cpu",
    )
    samples = []  # (time, served step), for the monotonicity checker
    warmup_fleet(router, (ENV.obs_dim,))
    with router:
        with pytest.raises(ValueError, match="promoted directory"):
            pipeline.attach_fleet(router, type(coordinator)(log_dir, router))
        pipeline.attach_fleet(router, coordinator)
        served = {"v": 0.0}
        pipeline.attach_monitor(
            RollbackMonitor(lambda: served, "v", threshold=10.0,
                            trip_after=1))

        def served_step():
            obs = np.zeros((2, ENV.obs_dim), np.float32)
            step = router.submit(obs).result(timeout=30.0).model_step
            samples.append((time.perf_counter(), int(step)))
            return step

        assert served_step() == s1
        while pipeline.poll_once():
            served_step()
        assert [v.step for v in pipeline.rejections] == [s_bad]
        assert "non-finite" in pipeline.rejections[0].reasons[0]
        assert [r.step for r in pipeline.promotions] == [
            s for s in steps if s != s_bad]
        assert s_bad not in pipeline.promoter.published_steps()
        assert coordinator.fleet_step == s3 and served_step() == s3
        # The forced regression demotes to the last good checkpoint
        # through reload_pinned.
        last_good = [s for s in steps if s != s_bad][-2]
        served["v"] = 100.0
        pipeline.poll_once()
        assert [(r["from_step"], r["to_step"])
                for r in pipeline.rollbacks] == [(s3, last_good)]
        assert coordinator.fleet_step == last_good == served_step()
        assert not coordinator.refresh()
        assert pipeline.gate.baseline_step == last_good

    assert pipeline.gate.program.compile_count == 1
    records = PromotionLog.read(log_dir / "promotions.jsonl")
    events = [r["event"] for r in records]
    assert events.count("promoted") == len(pipeline.promotions)
    assert events.count("rejected") == events.count("rolled_back") == 1
    assert all(r["gate_eval_compiles"] == 1 for r in records
               if r["event"] in ("promoted", "rejected"))
    # Zero invariant violations, by both packages' audit.
    assert check_audit_log(log_dir / "promotions.jsonl") == []
    assert jax_check_audit_log(log_dir / "promotions.jsonl") == []
    rollback_to = [r["to_step"] for r in pipeline.rollbacks]
    assert check_step_monotonic(samples, rollback_to) == []
    receipts = {f"gate:{pipeline.gate.program.guard.name}":
                pipeline.gate.program.compile_count}
    for i, per in router.compile_counts().items():
        receipts.update({f"replica{i}:rung{b}": c for b, c in per.items()})
    assert check_budget_one(receipts) == []
    summary = pipeline.summary()
    assert summary["gate_eval_compiles"] == 1
    assert summary["rollbacks"] == 1 and summary["rejections"] == 1
    assert summary["gate_eval_steps_per_sec"] > 0
    assert summary["gate_device"] == "cpu"
    live = registry.snapshot()
    assert live["pipeline_rollbacks_total"] == 1.0
    assert live["pipeline_served_step"] == float(last_good)
    # The ledger: every build site once, the gate's among them.
    assert {"gate", "serving"} <= {e.subsystem for e in ledger.entries()}
    # Every promoted line after the fleet attached carries its spans,
    # which sum to its latency.
    for r in records:
        if r["event"] == "promoted" and r["promotion_latency_s"]:
            total = sum(r["spans"].values())
            assert abs(total - r["promotion_latency_s"]) <= (
                0.1 * r["promotion_latency_s"] + 0.05), r


def test_watchdog_restarts_the_pipeline_loop(tmp_path):
    """``LaneWatchdog.watch_pipeline``: a dead loop thread is restarted
    through ``restart_loop`` (a new generation)."""
    pipeline = AlwaysLearningPipeline(tmp_path, ENV, gate_device="cpu",
                                      poll_interval_s=0.01)
    watchdog = LaneWatchdog(wedge_timeout_s=60.0, backoff_base_s=0.0)
    lane = watchdog.watch_pipeline(pipeline)
    assert lane.name == "pipeline_loop"
    pipeline.run(interval_s=0.01)
    try:
        assert watchdog.check_once() == 0
        generation = pipeline._generation
        pipeline._generation += 1  # the live thread exits at its check
        pipeline._thread.join(timeout=10.0)
        pipeline._generation = generation
        assert not pipeline.loop_alive()
        assert watchdog.check_once() == 1
        assert pipeline.loop_alive()
        assert pipeline._generation == generation + 1
    finally:
        pipeline.stop()


def test_assign_gate_device_on_one_device_is_the_learners():
    assert str(assign_gate_device(1, "cpu")) == "cpu"


# ---------------------------------------------------------------------------
# The entry point
# ---------------------------------------------------------------------------

TINY = ("num_formation=4", "num_agents_per_formation=3", "n_steps=10",
        "max_steps=10", "gate_formations=4", "pipeline_replicas=2",
        "device=cpu")


def test_always_learning_cli_on_cpu(tmp_path, private_obs, capsys,
                                    monkeypatch):
    from marl_distributedformation_tpu_torch.train import cli as train_cli

    monkeypatch.setattr(train_cli, "repo_root", lambda: tmp_path)
    report = always_learning.main([
        "name=always_test", *TINY, "total_timesteps=360", "save_freq=1",
        "pipeline_budget_s=120",
    ])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == json.loads(json.dumps(report))
    assert report["promotions"] >= 2 and report["gate_eval_compiles"] == 1
    assert report["pipeline_errors"] == [] and not report["train_alive"]
    assert set(report["verified_served_steps"]) == {report["served_step"]}
    assert report["serving_max_compiles_per_rung"] == 1
    log = tmp_path / "logs" / "always_test" / "promotions.jsonl"
    assert check_audit_log(log) == [] and jax_check_audit_log(log) == []


# The ids the cases had beside the two mesh refusals the mesh's port
# removed (argv0, argv1).
@pytest.mark.parametrize("argv, match", [
    pytest.param(["sentinel=true"], "A14", id="argv2-A14"),
    pytest.param(["guard_transfers=true"], "guard_transfers",
                 id="argv3-guard_transfers"),
    pytest.param(["gate_formatoins=4"], "gate_formations",
                 id="argv4-gate_formations"),
])
def test_always_learning_cli_refuses(argv, match, tmp_path, monkeypatch):
    from marl_distributedformation_tpu_torch.train import cli as train_cli

    monkeypatch.setattr(train_cli, "repo_root", lambda: tmp_path)
    with pytest.raises(SystemExit, match=match):
        always_learning.main(["name=always_refused", *TINY, *argv])


def test_always_learning_needs_a_gpu_unless_cpu_is_asked_for(
        monkeypatch, tmp_path):
    from marl_distributedformation_tpu_torch.train import cli as train_cli

    monkeypatch.setattr(train_cli, "repo_root", lambda: tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        always_learning.main(["name=always_gpu", "num_formation=2"])
    # The gate never raises for a candidate: the refusal is its verdict.
    verdict = PromotionGate(ENV).evaluate(_touch_ckpt(tmp_path, 5))
    assert not verdict.passed and "device='cpu'" in verdict.reasons[0]


@pytest.mark.parametrize("seam", [True, False])
def test_rejected_falsifiers_feed_the_trainers_schedule(tmp_path,
                                                        monkeypatch, seam):
    """A rejection carrying falsifiers becomes a curriculum stage in the
    attached trainer (``curriculum_updated``, its scenarios named); a
    trainer without the seam is a logged ``curriculum_update_failed``,
    never a dead control plane (JAX's ``_feed_falsifiers``)."""
    from marl_distributedformation_tpu_torch.scenarios import (
        registry as scenario_registry,
    )

    monkeypatch.setattr(scenario_registry, "_REGISTRY",
                        dict(scenario_registry._REGISTRY))
    got = []

    class Trainer_:
        on_checkpoint = None

        def request_scenario_schedule(self, schedule):
            if not seam:
                raise ValueError("built without scenario training")
            got.append(schedule)

    pipeline = AlwaysLearningPipeline(tmp_path, ENV, gate_device="cpu",
                                      feedback_rollouts=7)
    pipeline.attach_trainer(Trainer_())
    falsifiers = [{"scenario": "wind", "severity": 0.4, "drop": 0.5}]
    verdict = GateVerdict(step=10, path="x", passed=False, reasons=["r"],
                          clean={}, cells={}, baseline_step=None,
                          eval_compiles=1, eval_seconds=0.0,
                          falsifiers=falsifiers)
    pipeline._feed_falsifiers(verdict, "t")
    (record,) = PromotionLog.read(tmp_path / "promotions.jsonl")
    if seam:
        assert record["event"] == "curriculum_updated"
        assert record["falsifiers"] == falsifiers
        assert record["feedback_rollouts"] == 7
        assert "adv:wind" in record["scenarios"]
        assert pipeline.curriculum_updates == 1 and len(got) == 1
    else:
        assert record["event"] == "curriculum_update_failed"
        assert "scenario training" in record["reason"]
    assert check_audit_log(tmp_path / "promotions.jsonl") == []
