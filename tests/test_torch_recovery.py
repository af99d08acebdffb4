"""The port's self-healing train lane and checkpoint pipeline on the CPU,
against the JAX package: the health word, the skip-update guard, the
recovery ladder and its log, rollback and its retry stream, the async
checkpoint writer, the retention ring and the ``inject_hyperparams``
checkpoint layout.

Tolerances: the health word and flags exactly; health on and off bitwise
on a healthy run; ladder verdicts and ``recovery.jsonl`` events exactly
(without ``time``); a retry from (checkpoint, recovery) bitwise; async
checkpoint bytes equal the synchronous writer's; the learning rate and Adam
state of an ``inject_hyperparams`` checkpoint bitwise both ways.
"""

import collections
import json
import shutil
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from marl_distributedformation_tpu.chaos import (
    FaultSchedule,
    FaultSpec,
    get_fault_plane,
)
from marl_distributedformation_tpu.train import (
    HealthConfig as JaxHealthConfig,
    RecoveryConfig as JaxRecoveryConfig,
    RecoveryLadder as JaxRecoveryLadder,
    TrainConfig as JaxTrainConfig,
    Trainer as JaxTrainer,
    make_health_iteration as jax_make_health_iteration,
)
from marl_distributedformation_tpu.train.recovery import (
    nonfinite_flag_count as jax_nonfinite_flag_count,
)
from marl_distributedformation_tpu.utils import (
    prune_checkpoints as jax_prune_checkpoints,
)
from marl_distributedformation_tpu_torch.algo import PPOConfig
from marl_distributedformation_tpu_torch.compat.convert import (
    opt_state_to_jax,
    params_to_jax,
)
from marl_distributedformation_tpu_torch.env import EnvParams
from marl_distributedformation_tpu_torch.models import MLPActorCritic
from marl_distributedformation_tpu_torch.train import TrainConfig, Trainer
from marl_distributedformation_tpu_torch.train.recovery import (
    HEALTH_ALL,
    HealthConfig,
    HealthGuard,
    RecoveryConfig,
    RecoveryLadder,
    fold_recovery_generator,
    health_flags,
    nonfinite_flag_count,
    read_recovery_log,
    scale_injected_lr,
)
from marl_distributedformation_tpu_torch.utils.checkpoint import (
    AsyncCheckpointWriter,
    checkpoint_path,
    device_snapshot,
    latest_checkpoint,
    msgpack_restore_file,
    prune_checkpoints,
    quarantine_checkpoint,
    save_checkpoint,
)
from test_torch_checkpoint import assert_trees_equal
from test_torch_env import jax_params
from test_torch_models import np_tree

PARAMS = EnvParams(num_agents=3)
PPO = PPOConfig(n_steps=4, batch_size=24, n_epochs=2)
PER_ITER = 4 * 4 * 3  # n_steps * M * N


def make_trainer(tmp_path, name="run", scenario_schedule=None,
                 **overrides):
    cfg = dict(num_formations=4, checkpoint=False, seed=0, name=name,
               log_dir=str(tmp_path / name), log_interval=1)
    cfg.update(overrides)
    model = MLPActorCritic(PARAMS.obs_dim,
                           generator=torch.Generator().manual_seed(0))
    return Trainer(PARAMS, PPO, TrainConfig(**cfg), model=model,
                   device="cpu", scenario_schedule=scenario_schedule)


def _learner(trainer):
    it = trainer._iteration
    return [t.clone() for t in it.learner_tensors()] + [
        it.env.agents.clone(), it.env.steps.clone(), it.obs.clone()]


def _all_finite(trainer):
    return all(bool(torch.isfinite(p).all())
               for p in trainer.model.parameters())


# ---------------------------------------------------------------------------
# The health word
# ---------------------------------------------------------------------------

HEALTH_CASES = {
    "healthy": (1.0, 1.0, 1.0),
    "nan_loss": (float("nan"), 1.0, 1.0),
    "inf_loss": (float("inf"), 1.0, 1.0),
    "grad_1e18": (1.0, 1.0e18, 1.0),
    "grad_inf": (1.0, float("inf"), 1.0),
    "grad_nan": (1.0, float("nan"), 1.0),
    "drift": (1.0, 1.0, 1.0e9),
    "params_nan": (1.0, 1.0, float("nan")),
    "params_inf": (1.0, 1.0, float("inf")),
    "edge_of_drift": (1.0, 1.0e6, 5.0),
}


@pytest.mark.parametrize("case", sorted(HEALTH_CASES))
def test_health_word_matches_jax(case):
    """The flags and the word of ``health_flags`` against JAX's
    ``make_health_iteration`` on one toy iteration: the same loss, raw
    grad norm and old/new parameters."""
    loss, grad_norm, scale = HEALTH_CASES[case]
    rng = np.random.default_rng(1)
    old = {"a": rng.normal(size=(4, 3)).astype(np.float32),
           "b": rng.normal(size=(3,)).astype(np.float32)}
    new = {k: (v * np.float32(scale)).astype(np.float32)
           for k, v in old.items()}
    TS = collections.namedtuple("TS", "params")

    def toy(ts, env, obs, key):
        metrics = {"loss": jnp.float32(loss),
                   "grad_norm": jnp.float32(grad_norm)}
        return TS({k: jnp.asarray(v) for k, v in new.items()}), env, obs, \
            key, metrics

    wrapped = jax_make_health_iteration(toy, JaxHealthConfig())
    ts, _, _, _, m = jax.jit(wrapped)(
        TS({k: jnp.asarray(v) for k, v in old.items()}), jnp.int32(0),
        jnp.zeros((2,)), jax.random.PRNGKey(0))
    healthy, word = health_flags(
        torch.tensor(loss), torch.tensor(grad_norm, dtype=torch.float32),
        [torch.from_numpy(v) for v in old.values()],
        [torch.from_numpy(v) for v in new.values()], HealthConfig(),
    )
    assert float(word) == float(m["health_word"])
    assert float(healthy) == float(m["health_ok"])
    # The guard selects as JAX's does: the new parameters when healthy,
    # the old ones when not.
    live = [torch.from_numpy(v.copy()) for v in old.values()]
    guard = HealthGuard(HealthConfig(), live, live)
    guard.save()
    for t, v in zip(live, new.values()):
        t.copy_(torch.from_numpy(v))
    flags = guard.apply(torch.tensor(loss),
                        torch.tensor(grad_norm, dtype=torch.float32), [])
    assert flags.tolist() == [float(m["health_ok"]), float(m["health_word"])]
    for t, k in zip(live, old):
        np.testing.assert_array_equal(t.numpy(), np.asarray(ts.params[k]))
    if case == "healthy":
        assert float(word) == HEALTH_ALL


def test_nonfinite_flag_count_matches_jax():
    host = {"health_ok": np.array([[1.0, 0.0], [0.0, 1.0], [0.4, 0.6]])}
    assert nonfinite_flag_count(host) == jax_nonfinite_flag_count(host) == 3
    assert nonfinite_flag_count({}) == jax_nonfinite_flag_count({}) == 0


def test_health_on_equals_off_bitwise(tmp_path):
    """A healthy run is the same with the guard on as off: every shared
    metric and the whole carry, bitwise; the word reads all bits set."""
    off = make_trainer(tmp_path, "off")
    on = make_trainer(tmp_path, "on", health=True)
    for _ in range(3):
        m_off, m_on = off.run_iteration(), on.run_iteration()
        for name, v in m_off.items():
            assert torch.equal(v, m_on[name]), name
        assert float(m_on["health_ok"]) == 1.0
        assert float(m_on["health_word"]) == HEALTH_ALL
    for a, b in zip(_learner(off), _learner(on)):
        assert torch.equal(a, b)


def test_poisoned_iteration_mid_chunk_is_contained(tmp_path):
    """The parameters are poisoned with NaN after the rollout of the third
    iteration of a chunk of five (the guard's backups are taken): that
    iteration is skipped, its whole carry (learner, env, observation)
    reverts to its values before it, and the other four land."""
    trainer = make_trainer(tmp_path, fused_chunk=5, health=True)
    seen = []

    def hook(phase):
        if phase == "rollout":
            seen.append(_learner(trainer))
        elif phase == "update" and len(seen) == 3:
            trainer._poison_carry(float("nan"))

    trainer.phase_hook = hook
    host = trainer.run_chunk().to_host()
    trainer.phase_hook = None
    np.testing.assert_array_equal(host["health_ok"],
                                  np.array([1, 1, 0, 1, 1], np.float32))
    assert host["health_word"][2] < HEALTH_ALL
    assert _all_finite(trainer)
    for a, b in zip(seen[2], seen[3]):  # before and after the skip
        assert torch.equal(a, b)
    steps = trainer._iteration.num_minibatch_steps
    assert trainer.step == int(trainer.opt_state.count) == 4 * steps


# ---------------------------------------------------------------------------
# The ladder
# ---------------------------------------------------------------------------

FLAG_SEQUENCES = {
    "transient": [[1, 0], [1, 1], [0, 1]],
    "breach_rollback": [[1, 0], [0, 0], [1, 1], [1, 1]],
    "budget_spent_halts": [[0, 0], [0, 0], [0, 1], [0, 0], [0, 0], [0, 0]],
    "probation": [[0, 0], [0, 1], [0, 0], [0, 1], [1, 1]],
}


@pytest.mark.parametrize("case", sorted(FLAG_SEQUENCES))
def test_ladder_verdicts_and_log_match_jax(tmp_path, case):
    """Both ladders fed the same drained flags, the trainer's actions
    replayed on each (``note_rollback`` with a fixed MTTR, ``note_halt``):
    the same verdicts, ``suspect`` states and ``recovery.jsonl`` lines
    (without ``time``)."""
    cfg = dict(breach_iters=2, max_rollbacks=1)
    ladders = {
        "port": RecoveryLadder(RecoveryConfig(**cfg), tmp_path / "port"),
        "jax": JaxRecoveryLadder(JaxRecoveryConfig(**cfg), tmp_path / "jax"),
    }
    trace = {}
    for name, ladder in ladders.items():
        out = trace[name] = []
        for i, flags in enumerate(FLAG_SEQUENCES[case]):
            words = [15.0 if f else 14.0 for f in flags]
            verdict = ladder.observe(np.array(flags, np.float32), words,
                                     2 * i)
            if verdict == "rollback":
                ladder.note_rollback(to_step=96 * i, path=f"ckpt{i}",
                                     mttr_s=0.25, iteration=2 * i + 2)
            elif verdict == "halt" and not ladder.halted:
                ladder.note_halt(2 * i + 2, "budget spent")
            out.append((verdict, ladder.suspect, ladder.recoveries))

    def events(name):
        lines = (tmp_path / name / "recovery.jsonl").read_text()
        recs = [json.loads(line) for line in lines.splitlines()]
        for r in recs:
            del r["time"]
        return recs

    assert trace["port"] == trace["jax"]
    assert events("port") == events("jax")
    read_recovery_log(tmp_path / "port" / "recovery.jsonl")
    if case == "budget_spent_halts":
        assert trace["port"][-1][0] == "halt" and ladders["port"].halted


def test_recovery_log_schema(tmp_path):
    path = tmp_path / "recovery.jsonl"
    assert read_recovery_log(path) == []
    ladder = RecoveryLadder(RecoveryConfig(breach_iters=1), tmp_path)
    ladder.observe([0.0], [14.0], 3)
    ladder.note_rollback(10, None, 0.1, 4)
    ladder.note_halt(5, "why")
    assert [r["event"] for r in read_recovery_log(path)] == [
        "skip", "rollback", "halt"]
    path.write_text(path.read_text() + '{"event": "rollback"}\n')
    with pytest.raises(ValueError, match="missing required"):
        read_recovery_log(path)
    # A new ladder (a new process) moves the old history aside.
    RecoveryLadder(RecoveryConfig(), tmp_path)
    assert not path.exists()
    assert list(tmp_path.glob("recovery.jsonl.*"))


# ---------------------------------------------------------------------------
# Rollback end to end, against the JAX trainer
# ---------------------------------------------------------------------------


def _bomb(trainer, at_dispatch):
    """Poison the carry with NaN before dispatch ``at_dispatch`` (from 1),
    as the JAX package's ``train.carry_poison`` fault point does."""
    run_chunk, calls = trainer.run_chunk, []

    def poisoned():
        calls.append(1)
        if len(calls) == at_dispatch:
            trainer._poison_carry(float("nan"))
        return run_chunk()

    trainer.run_chunk = poisoned


BOMB = dict(checkpoint=True, save_freq=4, fused_chunk=2,
            total_timesteps=12 * PER_ITER, health=True, recovery=True,
            recovery_breach_iters=2, log_interval=1000)


def _events(path):
    keep = ("event", "iteration", "skipped", "consecutive", "to_step",
            "recoveries")
    return [{k: r[k] for k in keep if k in r} for r in read_recovery_log(path)]


def test_nan_bomb_rolls_back_and_finishes_finite_as_jax(tmp_path):
    """A NaN bomb before the fourth chunk: the skip is seen at the drain of
    that chunk, the ladder rolls back while the next chunk is in flight,
    no non-finite checkpoint is ever visible, the run ends finite on its
    full budget, and ``recovery.jsonl`` reads as the JAX trainer's under
    the same fault."""
    port = make_trainer(tmp_path, "port", **BOMB)
    _bomb(port, 4)
    port.train()
    assert not port.halted and _all_finite(port)
    assert port.num_timesteps == 12 * PER_ITER
    assert port.recovery_ladder.recoveries == 1
    for p in (tmp_path / "port").glob("rl_model_*.msgpack"):
        leaves = jax.tree_util.tree_leaves(msgpack_restore_file(p)["params"])
        assert all(np.isfinite(np.asarray(x)).all() for x in leaves), p

    plane = get_fault_plane()
    plane.reset()
    plane.arm(FaultSchedule([FaultSpec("train.carry_poison", "raise", 4)]))
    plane.enabled = True
    try:
        JaxTrainer(jax_params(PARAMS), ppo=_jax_ppo(), config=JaxTrainConfig(
            num_formations=4, seed=0, log_dir=str(tmp_path / "jax"),
            **BOMB)).train()
    finally:
        plane.enabled = False
        plane.reset()
    got = _events(tmp_path / "port" / "recovery.jsonl")
    assert got == _events(tmp_path / "jax" / "recovery.jsonl")
    assert [e["event"] for e in got] == ["skip", "rollback"]


def _jax_ppo():
    from marl_distributedformation_tpu.algo import PPOConfig as JaxPPOConfig

    return JaxPPOConfig(n_steps=4, batch_size=24, n_epochs=2)


def test_rollback_retry_is_a_pure_function_of_checkpoint_and_count(tmp_path):
    """The run after a rollback equals, bitwise, a fresh trainer resumed
    from the rollback's checkpoint with its generator moved into retry
    stream 1; retry streams differ across N and repeat for one N."""
    a = make_trainer(tmp_path, "a", **BOMB)
    _bomb(a, 4)
    a.train()
    rollback = [e for e in read_recovery_log(tmp_path / "a" /
                                             "recovery.jsonl")
                if e["event"] == "rollback"][0]
    (tmp_path / "b").mkdir()
    shutil.copy(rollback["checkpoint"], tmp_path / "b")
    b = make_trainer(tmp_path, "b", resume=True, fused_chunk=2, health=True,
                     total_timesteps=12 * PER_ITER, log_interval=1000)
    assert b.num_timesteps == rollback["to_step"]
    fold_recovery_generator(b.generator, 1)
    b.train()
    assert b.num_timesteps == a.num_timesteps
    for x, y in zip(_learner(a), _learner(b)):
        assert torch.equal(x, y)

    def stream(n):
        gen = torch.Generator().manual_seed(5)
        fold_recovery_generator(gen, n)
        return torch.rand(4, generator=gen)

    assert torch.equal(stream(1), stream(1))
    assert not torch.equal(stream(1), stream(2))


def test_lr_backoff_scales_the_rate_in_the_carry(tmp_path):
    trainer = make_trainer(tmp_path, recovery_lr_backoff=0.5, health=True,
                           recovery=True)
    trainer._perform_rollback(None, 0)  # to the run's starting state
    assert float(trainer._iteration.lr) == np.float32(PPO.learning_rate * 0.5)
    scale_injected_lr(trainer._iteration.lr, 0.5)
    assert float(trainer._iteration.lr) == np.float32(
        np.float32(PPO.learning_rate * 0.5) * np.float32(0.5))
    events = read_recovery_log(tmp_path / "run" / "recovery.jsonl")
    assert events[-1]["lr_scale"] == 0.5 and events[-1]["checkpoint"] is None


WIND_RAMP = ("[{rollouts: 4, scenarios: [wind], severity: 1.0, "
             "severity_start: 0.2}]")


def test_severity_backoff_at_each_rollback_as_jax(tmp_path):
    """``recovery_severity_backoff``: each rollback multiplies the scale on
    every sampled severity, re-enters the schedule at the restored
    rollout and keeps the draw counter (fresh mixes); the severities, the
    wind the next dispatch trains at and ``recovery.jsonl``'s
    ``severity_scale`` equal the JAX trainer's after the same two
    rollbacks (to the run's starting state)."""
    from marl_distributedformation_tpu.scenarios import (
        schedule_from_cfg as jax_schedule_from_cfg,
    )
    from marl_distributedformation_tpu_torch.scenarios import (
        schedule_from_cfg,
    )

    knobs = dict(health=True, recovery=True, recovery_severity_backoff=0.5)
    port = make_trainer(tmp_path, "port", schedule_from_cfg(WIND_RAMP),
                        **knobs)
    jt = JaxTrainer(jax_params(PARAMS), ppo=_jax_ppo(), config=JaxTrainConfig(
        num_formations=4, seed=0, checkpoint=False,
        log_dir=str(tmp_path / "jax"), **knobs),
        scenario_schedule=jax_schedule_from_cfg(WIND_RAMP))
    for rollbacks in range(3):
        for _ in range(2):
            assert port.scenario_severity == jt.scenario_severity
            wind = np.asarray(jt.scenario_params.wind)
            jt.run_iteration()
            port.run_iteration()
            np.testing.assert_array_equal(port.scenario_params.wind.numpy(),
                                          wind)
        if rollbacks == 2:
            break
        jt._perform_rollback(None, 2 * rollbacks + 2)
        port._perform_rollback(None, 2 * rollbacks + 2)
        assert port._severity_scale == jt._severity_scale == 0.5 ** (
            rollbacks + 1)
        assert port._scenario_rollouts == jt._scenario_rollouts == 0
        assert port._scenario_draws == jt._scenario_draws == 2 * (
            rollbacks + 1)
    scales = [e["severity_scale"] for e in read_recovery_log(
        tmp_path / "port" / "recovery.jsonl") if e["event"] == "rollback"]
    want = [e["severity_scale"] for e in read_recovery_log(
        tmp_path / "jax" / "recovery.jsonl") if e["event"] == "rollback"]
    assert scales == want == [0.5, 0.25]


# ---------------------------------------------------------------------------
# Checkpoints off the hot path
# ---------------------------------------------------------------------------


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"params": {"w": rng.normal(size=(3, 2)).astype(np.float32)},
            "num_timesteps": seed}


def test_async_bytes_equal_sync_bytes(tmp_path):
    trainer = make_trainer(tmp_path, checkpoint=True)
    trainer.run_iteration()
    sync = Path(trainer.save())
    data = sync.read_bytes()
    sync.unlink()
    writer = AsyncCheckpointWriter()
    done = []
    assert trainer.save_async(writer) == str(sync)
    writer.submit(tmp_path / "x.msgpack",
                  device_snapshot({"t": torch.ones(2)}), on_done=done.append)
    writer.close()
    assert sync.read_bytes() == data
    assert done == [tmp_path / "x.msgpack"]


def test_writes_are_ordered_and_a_failure_surfaces_on_the_next_submit(
    tmp_path, monkeypatch
):
    writer = AsyncCheckpointWriter()
    order, gate = [], threading.Event()

    def slow_write():
        gate.wait(timeout=10)
        order.append(1)

    writer.submit_write(slow_write)
    gate.set()
    writer.submit_write(lambda: order.append(2))
    writer.wait()
    assert order == [1, 2]

    # A crash between the temporary file and the rename: nothing
    # discoverable, and the error is raised by the next submit.
    def crash(self, target):
        raise RuntimeError("killed mid-write")

    monkeypatch.setattr(Path, "replace", crash)
    writer.submit(checkpoint_path(tmp_path, 1), _tree(1))
    writer._thread.join(timeout=10)
    monkeypatch.undo()
    assert latest_checkpoint(tmp_path) is None
    assert [p.name for p in tmp_path.iterdir()] == [
        ".rl_model_1_steps.msgpack.tmp"]
    with pytest.raises(RuntimeError, match="killed mid-write"):
        writer.submit(checkpoint_path(tmp_path, 2), _tree(2))
    writer.close()  # the failed submit queued nothing

    # A refused (non-finite) state and disk errors are skipped, not raised.
    bad = _tree(3)
    bad["params"]["w"][0, 0] = np.nan
    writer.submit(checkpoint_path(tmp_path, 3), bad)
    writer.close()
    assert writer.writes_skipped == 1 and latest_checkpoint(tmp_path) is None


def test_prune_keeps_the_same_files_as_jax(tmp_path):
    names = [f"rl_model_{s}_steps.msgpack" for s in (10, 200, 30, 4000, 50)]
    names += ["rl_model_7_steps.msgpack.quarantined",
              ".rl_model_9000_steps.msgpack.tmp", "metrics.jsonl"]
    for side in ("port", "jax"):
        (tmp_path / side).mkdir()
        for n in names:
            (tmp_path / side / n).write_bytes(b"x")
    port_removed = prune_checkpoints(
        tmp_path / "port", 2, protect=[tmp_path / "port" /
                                       "rl_model_10_steps.msgpack"])
    jax_removed = jax_prune_checkpoints(
        tmp_path / "jax", 2, protect=[tmp_path / "jax" /
                                      "rl_model_10_steps.msgpack"])
    assert sorted(p.name for p in port_removed) == sorted(
        p.name for p in jax_removed) == ["rl_model_30_steps.msgpack",
                                         "rl_model_50_steps.msgpack"]
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == sorted(
        p.name for p in (tmp_path / "jax").iterdir())


def test_trainer_keeps_the_last_n(tmp_path):
    trainer = make_trainer(tmp_path, checkpoint=True, save_freq=4,
                           fused_chunk=1, keep_last_n=2,
                           total_timesteps=5 * PER_ITER)
    trainer.train()
    assert sorted(p.name for p in (tmp_path / "run").glob("rl_model_*")) == [
        f"rl_model_{4 * PER_ITER}_steps.msgpack",
        f"rl_model_{5 * PER_ITER}_steps.msgpack"]


def test_quarantine_writes_its_audit_line(tmp_path):
    path = save_checkpoint(tmp_path, 5, _tree(5))
    moved = quarantine_checkpoint(path, "bad bytes")
    assert moved == path.with_name(path.name + ".quarantined")
    line = json.loads((tmp_path / "quarantine.jsonl").read_text())
    assert line["file"] == path.name and line["reason"] == "bad bytes"
    assert quarantine_checkpoint(path, "gone") is None  # never raises


# ---------------------------------------------------------------------------
# optax's inject_hyperparams layout, both ways
# ---------------------------------------------------------------------------


def test_inject_hyperparams_checkpoint_round_trips_both_ways(tmp_path):
    params = EnvParams()
    cfg = dict(num_formations=2, total_timesteps=100, seed=4,
               recovery_lr_backoff=0.5)
    # The JAX trainer writes the injected layout; the port resumes it.
    JaxTrainer(jax_params(params), config=JaxTrainConfig(
        log_dir=str(tmp_path / "jax"), **cfg)).train()
    jpath = latest_checkpoint(tmp_path / "jax")
    port = Trainer(params, PPOConfig(), TrainConfig(
        log_dir=str(tmp_path / "jax"), resume=True, checkpoint=False, **cfg),
        model=MLPActorCritic(params.obs_dim), device="cpu")
    raw = msgpack_restore_file(jpath)
    assert float(port._iteration.lr) == float(
        raw["opt_state"]["1"]["hyperparams"]["learning_rate"])
    # The port writes it back in the same layout, bit for bit.
    port_tree = port._host_tree()
    assert_trees_equal(np_tree(port_tree["opt_state"]),
                       np_tree(raw["opt_state"]))
    assert_trees_equal(port_tree["params"], np_tree(raw["params"]))

    # The port writes the injected layout; the JAX trainer resumes it.
    port = Trainer(params, PPOConfig(), TrainConfig(
        log_dir=str(tmp_path / "port"), **cfg),
        model=MLPActorCritic(params.obs_dim), device="cpu")
    scale_injected_lr(port._iteration.lr, 0.5)
    port.train()
    jtrainer = JaxTrainer(jax_params(params), config=JaxTrainConfig(
        log_dir=str(tmp_path / "port"), resume=True, **cfg))
    jopt = np_tree(serialization.to_state_dict(
        jtrainer.train_state.opt_state))
    assert_trees_equal(
        jopt, opt_state_to_jax(
            vars(port.opt_state), port.policy,
            {k: np.asarray(v) for k, v in
             jopt["1"]["hyperparams"].items()}))
    assert float(jopt["1"]["hyperparams"]["learning_rate"]) == float(
        port._iteration.lr) == np.float32(np.float32(1e-3) * 0.5)
    assert_trees_equal(
        np_tree(jtrainer.train_state.params),
        params_to_jax(dict(port.model.named_parameters()), port.policy))
