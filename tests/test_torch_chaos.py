"""The port's chaos seams, lane watchdog and invariant checkers on the CPU,
held against the JAX package.

- The train seams: the same seeded ``FaultSchedule`` armed in a JAX
  trainer and a port trainer poisons the same dispatch, and the recovery
  ladders' ``recovery.jsonl`` read alike (as ``test_torch_recovery.py``
  holds them); ``train.grad_bomb`` and ``train.snapshot`` keep JAX's
  meaning.
- The checkpoint seams, as JAX's ``tests/test_chaos.py`` tests them: a
  crash mid-rename leaves nothing discoverable, a transient ENOSPC retries
  and lands, a persistent one skips with an audit record, a bitflip is
  quarantined by the walk-back.
- The watchdog restarts a wedged lane and then a dead one (a plainly
  registered lane and a fleet worker killed through the seeded
  ``scheduler.dispatch`` seam), and ``attach_watchdog`` wires a CPU
  Sebulba driver's lanes.
- The invariant checkers return JAX's violations on the same inputs.
"""

import json
import threading
import time

import numpy as np
import pytest
import torch

from marl_distributedformation_tpu import chaos as jax_chaos
from marl_distributedformation_tpu.chaos import (
    FaultSchedule as JaxFaultSchedule,
    get_fault_plane as jax_get_fault_plane,
)
from marl_distributedformation_tpu.train import (
    TrainConfig as JaxTrainConfig,
    Trainer as JaxTrainer,
)
from marl_distributedformation_tpu_torch import chaos
from marl_distributedformation_tpu_torch.chaos import (
    FaultPlane,
    FaultSchedule,
    FaultSpec,
    LaneWatchdog,
    SimulatedCrash,
    set_fault_plane,
)
from marl_distributedformation_tpu_torch.obs import (
    FlightRecorder,
    MetricsRegistry,
    Tracer,
    set_registry,
    set_tracer,
)
from marl_distributedformation_tpu_torch.serving.fleet import (
    FleetRouter,
    warmup_fleet,
)
from marl_distributedformation_tpu_torch.utils.checkpoint import (
    AsyncCheckpointWriter,
    checkpoint_path,
    latest_checkpoint,
    msgpack_restore_file,
    restore_latest_partial,
    write_atomic,
)
from test_torch_env import jax_params
from test_torch_fleet import _make_policy, _obs
from test_torch_recovery import (
    BOMB,
    PARAMS,
    PER_ITER,
    _all_finite,
    _events,
    _jax_ppo,
    make_trainer,
)
from test_torch_sebulba import make_sebulba


@pytest.fixture
def plane():
    fresh = FaultPlane(enabled=True)
    previous = set_fault_plane(fresh)
    yield fresh
    set_fault_plane(previous)


@pytest.fixture(autouse=True)
def registry():
    fresh = MetricsRegistry()
    previous = set_registry(fresh)
    yield fresh
    set_registry(previous)


@pytest.fixture(autouse=True)
def tracer(tmp_path):
    fresh = Tracer(ring_size=256,
                   flightrec=FlightRecorder(tmp_path / "flightrec",
                                            last_n=64))
    previous = set_tracer(fresh)
    yield fresh
    set_tracer(previous)


def _writer(io_retries):
    writer = AsyncCheckpointWriter()
    writer.io_retries, writer.io_backoff_s = io_retries, 0.001
    return writer


def _target(step=40):
    return {"params": np.arange(64, dtype=np.float32).reshape(8, 8),
            "num_timesteps": step}


# ---------------------------------------------------------------------------
# The train seams
# ---------------------------------------------------------------------------

POISON = {"train.carry_poison": ("raise",)}


def test_seeded_carry_poison_hits_the_same_dispatch_as_jax(plane, tmp_path):
    """One seeded schedule, both planes: the same armed cell, the same
    dispatch poisoned, and the recovery ladders' logs read alike."""
    seed = next(s for s in range(100)
                if 2 <= FaultSchedule.from_seed(
                    s, faults=1, points=POISON, max_hit=5).specs[0].at_hit)
    ours = FaultSchedule.from_seed(seed, faults=1, points=POISON, max_hit=5)
    theirs = JaxFaultSchedule.from_seed(seed, faults=1, points=POISON,
                                        max_hit=5)
    assert ours.record() == theirs.record()
    plane.arm(ours)
    port = make_trainer(tmp_path, "port", **BOMB)
    port.train()
    assert [f["at_hit"] for f in plane.fired] == [ours.specs[0].at_hit]
    assert not port.halted and _all_finite(port)
    assert port.num_timesteps == 12 * PER_ITER
    jplane = jax_get_fault_plane()
    jplane.reset()
    jplane.arm(theirs)
    jplane.enabled = True
    try:
        JaxTrainer(jax_params(PARAMS), ppo=_jax_ppo(), config=JaxTrainConfig(
            num_formations=4, seed=0, log_dir=str(tmp_path / "jax"),
            **BOMB)).train()
    finally:
        jplane.enabled = False
        jplane.reset()
    got = _events(tmp_path / "port" / "recovery.jsonl")
    assert got == _events(tmp_path / "jax" / "recovery.jsonl")
    assert [e["event"] for e in got] == ["skip", "rollback"]
    assert chaos.check_finite_checkpoints(tmp_path / "port") == []
    assert chaos.check_recovery_log(
        tmp_path / "port" / "recovery.jsonl", max_rollbacks=3) == []


def test_grad_bomb_and_snapshot_seams(plane, tmp_path):
    """``train.grad_bomb`` multiplies the live parameters by 1e18 at the
    dispatch boundary; ``train.snapshot`` poisons the snapshot copy only,
    which the non-finite gate keeps out of discovery."""
    trainer = make_trainer(tmp_path, "seams")
    before = [p.detach().clone() for p in trainer.model.parameters()]
    plane.arm(FaultSchedule([FaultSpec("train.grad_bomb", "raise", 1),
                             FaultSpec("train.snapshot", "raise", 1)]))
    with torch.no_grad():
        trainer._poison_carry(1.0)  # a no-op multiply, for the baseline
    original = trainer._iteration.run
    seen = []

    def spy(*args, **kwargs):
        seen.append([p.detach().clone() for p in trainer.model.parameters()])
        return original(*args, **kwargs)

    trainer._iteration.run = spy
    trainer.run_iteration()
    for got, want in zip(seen[0], before):
        torch.testing.assert_close(got, want * 1.0e18)
    live = [p.detach().clone() for p in trainer.model.parameters()]
    assert trainer.save() is None  # the poisoned copy was refused
    assert latest_checkpoint(trainer.log_dir) is None
    assert all(torch.equal(a, p) for a, p in
               zip(live, trainer.model.parameters()))
    assert trainer.save() is not None  # the seam fired once
    assert chaos.check_finite_checkpoints(trainer.log_dir) == []


def test_snapshot_seam_under_the_async_writer(plane, tmp_path, registry):
    trainer = make_trainer(tmp_path, "async")
    plane.arm(FaultSchedule([FaultSpec("train.snapshot", "raise", 1),
                             FaultSpec("ckpt_writer.submit", "delay", 1,
                                       seconds=0.001)]))
    writer = AsyncCheckpointWriter()
    trainer.save_async(writer)
    writer.close()
    assert writer.writes_skipped == 1
    assert latest_checkpoint(trainer.log_dir) is None
    assert registry.snapshot()["checkpoint_nonfinite_skipped_total"] == 1.0
    assert [f["point"] for f in plane.fired] == ["train.snapshot",
                                                 "ckpt_writer.submit"]


# ---------------------------------------------------------------------------
# The checkpoint seams
# ---------------------------------------------------------------------------


def test_crash_mid_rename_leaves_nothing_discoverable(plane, tmp_path):
    plane.arm(FaultSchedule([FaultSpec("checkpoint.pre_rename", "crash", 1)]))
    path = checkpoint_path(tmp_path, 40)
    with pytest.raises(SimulatedCrash):
        write_atomic(path, _target())
    assert not path.exists()
    assert (tmp_path / f".{path.name}.tmp").exists()
    assert latest_checkpoint(tmp_path) is None
    assert chaos.check_checkpoint_dir(tmp_path) == []
    assert jax_chaos.check_checkpoint_dir(tmp_path) == []


def test_writer_transient_enospc_retries_and_lands(plane, tmp_path):
    plane.arm(FaultSchedule([FaultSpec("checkpoint.write", "enospc", 1)]))
    writer = _writer(io_retries=3)
    path = writer.submit(checkpoint_path(tmp_path, 40), _target())
    writer.close()
    assert path.exists() and writer.writes_skipped == 0
    assert int(msgpack_restore_file(path)["num_timesteps"]) == 40


def test_writer_persistent_enospc_skips_with_audit(plane, tmp_path, registry,
                                                   tracer):
    plane.arm(FaultSchedule([FaultSpec("checkpoint.write", "enospc", h)
                             for h in (1, 2, 3)]))
    writer = _writer(io_retries=2)
    path = writer.submit(checkpoint_path(tmp_path, 40), _target())
    writer.wait()  # degraded, not dead
    assert not path.exists() and writer.writes_skipped == 1
    assert registry.snapshot()["checkpoint_writes_skipped_total"] == 1.0
    assert any("checkpoint_write_skipped" in p.name
               for p in tracer.flightrec.dumps())
    path2 = writer.submit(checkpoint_path(tmp_path, 80), _target(80))
    writer.close()
    assert path2.exists()


def test_writer_injected_crash_skips(plane, tmp_path):
    plane.arm(FaultSchedule([FaultSpec("checkpoint.pre_rename", "crash", 1)]))
    writer = _writer(io_retries=2)
    path = writer.submit(checkpoint_path(tmp_path, 40), _target())
    writer.close()  # a crashed write is skipped, never surfaced
    assert not path.exists() and writer.writes_skipped == 1
    assert latest_checkpoint(tmp_path) is None


@pytest.mark.parametrize("kind", ["bitflip", "truncate"])
def test_post_rename_corruption_is_quarantined_by_the_walkback(
        plane, tmp_path, registry, kind):
    plane.arm(FaultSchedule([FaultSpec("checkpoint.post_rename", kind, 2)]))
    write_atomic(checkpoint_path(tmp_path, 40), _target(40))
    bad = checkpoint_path(tmp_path, 80)
    write_atomic(bad, _target(80))  # lands, then the bytes are damaged
    # A bitflip fails the footer's checksum; a truncation cuts the footer
    # off, and both packages read the rest as a footer-less legacy file:
    # the walk-back's decode catches it.
    found = len(chaos.check_checkpoint_dir(tmp_path))
    assert found == len(jax_chaos.check_checkpoint_dir(tmp_path))
    assert found == (1 if kind == "bitflip" else 0)
    path, restored = restore_latest_partial(tmp_path, ["num_timesteps"])
    assert path == checkpoint_path(tmp_path, 40)
    assert int(restored["num_timesteps"]) == 40
    assert not bad.exists()
    assert bad.with_name(bad.name + ".quarantined").exists()
    assert registry.snapshot()["checkpoint_quarantined_total"] == 1.0
    assert chaos.check_checkpoint_dir(tmp_path) == []


def test_every_checkpoint_seam_costs_nothing_while_disabled(tmp_path):
    quiet = FaultPlane(enabled=False)
    quiet.arm(FaultSchedule([FaultSpec("checkpoint.write", "enospc", 1)]))
    previous = set_fault_plane(quiet)
    try:
        write_atomic(checkpoint_path(tmp_path, 1), _target(1))
    finally:
        set_fault_plane(previous)
    assert quiet.pending() == 1 and not quiet.fired


# ---------------------------------------------------------------------------
# The watchdog
# ---------------------------------------------------------------------------


class _Lane:
    """A plain lane: a thread that beats every few ms, wedges while
    ``wedge`` is set and dies when ``die`` is set."""

    def __init__(self, heartbeat):
        self.heartbeat = heartbeat
        self.wedge = threading.Event()
        self.die = threading.Event()
        self.generation = 0
        self.thread = None

    def start(self):
        self.generation += 1
        gen = self.generation
        self.wedge.clear()
        self.die.clear()

        def run():
            while gen == self.generation:
                if self.die.is_set():
                    return
                if not self.wedge.is_set():
                    self.heartbeat.beat()
                time.sleep(0.002)

        self.thread = threading.Thread(target=run, daemon=True)
        self.thread.start()

    def alive(self):
        return self.thread is not None and self.thread.is_alive()


def test_watchdog_restarts_a_wedged_then_a_dead_lane(registry, tracer):
    lane = _Lane(chaos.Heartbeat("plain"))
    watchdog = LaneWatchdog(wedge_timeout_s=0.05, backoff_base_s=0.0,
                            poll_interval_s=0.01)
    watchdog.register("plain", lane.heartbeat, lane.alive, lane.start)
    lane.start()
    assert watchdog.check_once() == 0
    lane.wedge.set()
    time.sleep(0.08)
    assert watchdog.check_once() == 1
    lane.die.set()
    lane.thread.join(timeout=5)
    assert watchdog.check_once() == 1
    reasons = [e["reason"] for e in watchdog.restart_log]
    assert "stale" in reasons[0] and "dead" in reasons[1]
    assert lane.alive() and watchdog.restarts_total() == 2
    assert registry.snapshot()["pipeline_restarts_total"] == 2.0
    assert any("lane_restart" in p.name for p in tracer.flightrec.dumps())
    lane.generation += 1  # retire the lane's thread
    # The pipeline's loop registers as a lane of its own (it raised naming
    # A13 until the pipeline was ported; test_torch_pipeline.py restarts a
    # real one).
    stub = type("Loop", (), {"heartbeat": chaos.Heartbeat("pipeline_loop"),
                             "loop_alive": lambda self: True,
                             "restart_loop": lambda self: None})()
    registered = watchdog.watch_pipeline(stub)
    assert registered.name == "pipeline_loop"
    assert registered.heartbeat is stub.heartbeat
    assert watchdog.lanes["pipeline_loop"] is registered


def test_watchdog_restarts_a_fleet_worker_killed_by_the_seeded_seam(plane):
    """``scheduler.dispatch`` crash from a seeded schedule kills a
    replica's worker; ``watch_fleet`` restarts it, the half-open probe
    readmits it, and no accepted request is lost."""
    schedule = FaultSchedule.from_seed(
        4, faults=1, points={"scheduler.dispatch": ("crash",)}, max_hit=3)
    assert schedule.record() == JaxFaultSchedule.from_seed(
        4, faults=1, points={"scheduler.dispatch": ("crash",)},
        max_hit=3).record()
    policy = _make_policy()
    router = FleetRouter(policy, devices=["cpu"], num_replicas=2,
                         buckets=(1, 8), probe_interval_s=0.02,
                         max_failovers=2)
    warmup_fleet(router, (8,))
    watchdog = LaneWatchdog(backoff_base_s=0.0, poll_interval_s=0.01)
    lanes = watchdog.watch_fleet(router)
    assert [lane.name for lane in lanes] == ["replica0_worker",
                                             "replica1_worker"]
    plane.enabled = False
    with router:
        plane.arm(schedule)
        plane.enabled = True
        deadline = time.monotonic() + 10
        while (all(r.scheduler.alive for r in router.replicas)
               and time.monotonic() < deadline):
            time.sleep(0.002)
        killed = next(r for r in router.replicas if not r.scheduler.alive)
        dead = killed.scheduler  # the worker died at its armed hit
        futures = [router.submit(_obs(2, seed=i)) for i in range(8)]
        t0 = time.perf_counter()
        assert watchdog.check_once() >= 1
        assert dead.alive
        mttr = time.perf_counter() - t0
        results = [f.result(timeout=30) for f in futures]
        deadline = time.monotonic() + 10
        while not killed.healthy and time.monotonic() < deadline:
            router.submit(_obs(1)).result(timeout=30)
            time.sleep(0.005)
    assert killed.healthy
    assert watchdog.restarts_total() == 1 and mttr < 5.0
    ref = policy.predict(_obs(2, seed=0))[0]
    np.testing.assert_allclose(results[0].actions, ref, rtol=1e-5, atol=1e-6)
    assert chaos.check_no_request_lost(
        [{"ok": True, "hung": False} for _ in results]) == []


def test_attach_watchdog_wires_both_sebulba_lanes(tmp_path):
    per_iter = 4 * 4 * 3
    driver = make_sebulba(tmp_path, fused_chunk=2,
                          total_timesteps=4 * per_iter)
    watchdog = LaneWatchdog(wedge_timeout_s=60.0, backoff_base_s=0.0)
    driver.attach_watchdog(watchdog)
    assert set(watchdog.lanes) == {"sebulba_actor", "sebulba_learner"}
    driver.train()
    assert driver._actor_heartbeat.age_s() < 60.0
    assert driver._learner_heartbeat.age_s() < 60.0
    # A dead actor thread is restarted through _restart_actor.
    spawned = []
    driver._spawn_actor = lambda: spawned.append(1)
    driver._stop.clear()
    dead = threading.Thread(target=lambda: None)
    dead.start()
    dead.join()
    driver._actor_thread = dead
    assert watchdog.check_once() == 1 and spawned == [1]
    driver._stop.set()  # a stopped driver is never respawned
    driver._restart_actor()
    assert spawned == [1]


# ---------------------------------------------------------------------------
# The invariant checkers against JAX's
# ---------------------------------------------------------------------------


def _records(violations):
    return [v.record() for v in violations]


def test_invariant_checkers_match_jax(tmp_path):
    cases = [
        ("check_step_monotonic", ([(0, 10), (1, 20), (2, 20)],)),
        ("check_step_monotonic", ([(0, 10), (1, 20), (2, 10)],)),
        ("check_step_monotonic", ([(0, 10), (1, 20), (2, 10)], [10])),
        ("check_no_request_lost",
         ([{"ok": True, "hung": False}, {"ok": False, "hung": False}],)),
        ("check_no_request_lost", ([{"ok": False, "hung": True}],)),
        ("check_budget_one", ({"gate": 1, "rung8": 0},)),
        ("check_budget_one", ({"gate": 2, "rung1": 3},)),
        ("check_no_duplicate_consume", ([1, 2, 3],)),
        ("check_no_duplicate_consume", ([1, 2, 2, 1, 4],)),
        ("check_params_version_monotone", ([0, 1, 1, 3],)),
        ("check_params_version_monotone", ([0, 2, 1],)),
        ("check_bounded_staleness", ([0, 1, 2], 2)),
        ("check_bounded_staleness", ([0, 3, 5], 2)),
    ]
    for name, args in cases:
        got = _records(getattr(chaos, name)(*args))
        assert got == _records(getattr(jax_chaos, name)(*args)), name
    # Checkpoint directories, written by the port and read by both.
    d = tmp_path / "ckpts"
    write_atomic(checkpoint_path(d, 40), _target())
    bad = checkpoint_path(d, 80)
    write_atomic(bad, _target())
    with open(bad, "r+b") as f:
        f.seek(10)
        f.write(b"\x00\x01\x02")
    (d / ".rl_model_90_steps.msgpack.tmp").write_bytes(b"torn")
    for name in ("check_checkpoint_dir", "check_finite_checkpoints"):
        # The detail quotes each package's own reader's message.
        assert [(v.invariant, v.context) for v in getattr(chaos, name)(d)] \
            == [(v.invariant, v.context)
                for v in getattr(jax_chaos, name)(d)], name
    assert len(chaos.check_checkpoint_dir(d)) == 1
    nan = np.array([1.0, np.nan], np.float32)
    for params in ({"w": np.ones(2, np.float32)}, {"w": nan}):
        # The leaf is named in each package's path style ("/w", "['w']").
        assert [v.invariant for v in chaos.check_final_params_finite(
            params)] == [v.invariant for v in
                         jax_chaos.check_final_params_finite(params)]
    assert chaos.check_final_params_finite({"w": torch.tensor(nan)})
    # A recovery log: a valid ladder history, then a broken one.
    log = tmp_path / "recovery.jsonl"
    good = [
        {"schema": 1, "event": "skip", "time": 1.0, "iteration": 3,
         "skipped": 1, "consecutive": 1, "health_word": 0.0},
        {"schema": 1, "event": "rollback", "time": 2.0, "iteration": 4,
         "to_step": 96, "recoveries": 1, "mttr_s": 0.5,
         "path": "rl_model_96_steps.msgpack"},
    ]
    broken = good + [
        {**good[1], "recoveries": 3, "mttr_s": -1.0},
        {"schema": 1, "event": "halt", "time": 3.0, "iteration": 5,
         "reason": "x", "recoveries": 3},
        {**good[0], "iteration": 6},
    ]
    for lines in (good, broken):
        log.write_text("".join(json.dumps(r) + "\n" for r in lines))
        for kw in ({}, {"max_rollbacks": 2, "mttr_bound_s": 0.1}):
            assert _records(chaos.check_recovery_log(log, **kw)) == _records(
                jax_chaos.check_recovery_log(log, **kw))


def test_report_violations_dumps_the_schedule(plane, registry, tracer):
    plane.arm(FaultSchedule([FaultSpec("frontend.handler", "raise", 3)]))
    records = chaos.report_violations(
        [chaos.Violation("step_monotonic", "backward", {"t": 1})])
    assert records == [{"invariant": "step_monotonic", "detail": "backward",
                        "context": {"t": 1}}]
    assert registry.snapshot()["chaos_invariant_violations_total"] == 1.0
    dumps = [p for p in tracer.flightrec.dumps()
             if "chaos_violation" in p.name]
    assert dumps
    body = json.loads(dumps[0].read_text())
    assert "frontend.handler" in json.dumps(body)
