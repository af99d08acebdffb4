"""The port's Sebulba lane (``train/sebulba/``) against the port's Anakin
loop and the JAX package's Sebulba, the counterparts of
``tests/test_sebulba.py``:

- depth-1 lockstep equals the port's Anakin host loop bitwise, parameters
  and every iteration's metrics (MLP/ring and GNN/knn, health on too), and
  under a ramped scenario schedule the whole run, env trajectory included,
  is bitwise (JAX pins only its first rollout bitwise: its Anakin program
  fuses what its lanes materialise; the port's phases are the same
  kernels either way);
- lockstep against JAX's lockstep with JAX's resets, action noise and
  permutations injected: env steps bitwise, rollout metrics within
  ``rtol=1e-4``, parameters within ``tests/adam_budget.py``'s budget, as
  ``tests/test_torch_trainer.py`` holds the Anakin loop;
- each lane builds once (its guard and the ledger say so) and the base
  class's Anakin phases never run;
- the fenced surfaces and refusals, in JAX's words;
- pipelined ``train()`` checkpoints at chunk boundaries and resumes
  exactly; every consumed batch is within ``max_param_staleness``;
- the continuous adversary feeds the schedule with zero rebuilds;
- the chaos seams: an enqueue drop is a seq gap, a redelivery is absorbed,
  a dropped publish keeps the latest version.
"""

import jax
import numpy as np
import pytest
import torch

from adam_budget import adam_parity_atol, trajectory_rtol
from marl_distributedformation_tpu import jax_compat  # noqa: F401
from marl_distributedformation_tpu.chaos import (
    check_no_duplicate_consume,
    check_params_version_monotone,
)
from marl_distributedformation_tpu.train import (
    SebulbaDriver as JaxSebulbaDriver,
)
from marl_distributedformation_tpu.train import TrainConfig as JaxTrainConfig
from marl_distributedformation_tpu_torch.algo import PPOConfig
from marl_distributedformation_tpu_torch.chaos import (
    FaultPlane,
    FaultSchedule,
    FaultSpec,
    set_fault_plane,
)
from marl_distributedformation_tpu_torch.compat.convert import (
    params_from_jax,
    params_to_jax,
)
from marl_distributedformation_tpu_torch.env import EnvParams
from marl_distributedformation_tpu_torch.models import (
    GNNActorCritic,
    MLPActorCritic,
    distributions,
)
from marl_distributedformation_tpu_torch.obs import ProgramLedger, set_ledger
from marl_distributedformation_tpu_torch.scenarios import (
    AdversaryConfig,
    ContinuousAdversary,
    ScenarioSchedule,
    ScenarioStage,
    from_falsifiers,
)
from marl_distributedformation_tpu_torch.scenarios import registry as preg
from marl_distributedformation_tpu_torch.train import (
    ParamBus,
    SebulbaDriver,
    TrainConfig,
    Trainer,
    TransferItem,
    TransferQueue,
    partition_devices,
)
from marl_distributedformation_tpu_torch.train import cli as train_cli
from marl_distributedformation_tpu_torch.utils.checkpoint import (
    latest_checkpoint,
)
from test_torch_adversary import jax_hooks
from test_torch_algo import (
    GNN_K,
    GNN_N,
    LR,
    _configs,
    _jax_permutations,
    _pair,
    injected_env_step,
    jax_rollout_noise,
    t,
)
from test_torch_env import jax_params, to_port
from test_torch_models import np_tree

PPO = PPOConfig(n_steps=4, batch_size=24, n_epochs=2)
ENV = EnvParams(num_agents=3, max_steps=20)
GNN_ENV = EnvParams(num_agents=GNN_N, obs_mode="knn", knn_k=GNN_K,
                    max_steps=20)
GNN_PPO = PPOConfig(n_steps=4, batch_size=40, n_epochs=2)
CASES = {"mlp_ring": (ENV, PPO), "gnn_knn": (GNN_ENV, GNN_PPO)}


@pytest.fixture
def plane():
    fresh = FaultPlane(enabled=True)
    previous = set_fault_plane(fresh)
    yield fresh
    set_fault_plane(previous)


@pytest.fixture
def ledger():
    previous = set_ledger(ProgramLedger())
    try:
        yield
    finally:
        set_ledger(previous)


def _model(params):
    gen = torch.Generator().manual_seed(0)
    if params.obs_mode == "knn":
        return GNNActorCritic(k=params.knn_k, generator=gen)
    return MLPActorCritic(params.obs_dim, params.act_dim, generator=gen)


def _config(tmp_path, name, **overrides):
    defaults = dict(num_formations=4, checkpoint=False, seed=0, name=name,
                    log_dir=str(tmp_path / name), log_interval=1)
    defaults.update(overrides)
    return TrainConfig(**defaults)


def make_anakin(tmp_path, case="mlp_ring", scenario=None, **overrides):
    params, ppo = CASES[case]
    return Trainer(params, ppo, _config(tmp_path, "anakin", **overrides),
                   model=_model(params), device="cpu",
                   scenario_schedule=scenario)


def make_sebulba(tmp_path, case="mlp_ring", scenario=None, **overrides):
    params, ppo = CASES[case]
    return SebulbaDriver(
        params, ppo,
        _config(tmp_path, "sebulba", architecture="sebulba", **overrides),
        model=_model(params), device="cpu", scenario_schedule=scenario)


def two_stage_schedule():
    return ScenarioSchedule(stages=(
        ScenarioStage(rollouts=2, scenarios=("wind",), severity=0.8),
        ScenarioStage(rollouts=2, scenarios=("wind", "sensor_noise"),
                      severity=0.3),
    ))


def clean_schedule():
    return ScenarioSchedule(stages=(ScenarioStage(
        rollouts=1, scenarios=("clean",), severity=0.0,
        severity_start=0.0),))


def _params(trainer):
    return [p.detach().clone() for p in trainer.model.parameters()]


# ---------------------------------------------------------------------------
# Lockstep parity
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("health", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_lockstep_bitwise_matches_anakin_host_loop(tmp_path, case, health):
    """Lockstep drives the real plumbing (seq stamps, bus versions, slots,
    snapshots) and still reproduces the port's Anakin host loop bit for
    bit (tolerance: none)."""
    anakin = make_anakin(tmp_path, case, health=health)
    sebulba = make_sebulba(tmp_path, case, health=health)
    for i in range(3):
        a = anakin.run_iteration()
        s = sebulba.run_lockstep_iteration()
        assert set(a) == set(s)
        for name in a:
            assert torch.equal(a[name], s[name]), (i, name)
    assert anakin.num_timesteps == sebulba.num_timesteps
    for a, s in zip(_params(anakin), _params(sebulba)):
        assert torch.equal(a, s)
    for f in anakin._iteration.env_fields:
        assert torch.equal(getattr(anakin.env_state, f),
                           getattr(sebulba.env_state, f))
    assert torch.equal(anakin.obs, sebulba.obs)
    assert anakin.step == sebulba.step
    assert list(sebulba.transfer_queue.consumed_seqs) == [0, 1, 2]
    assert sebulba.param_bus.version == 3
    assert sebulba.consumed_versions == [0, 1, 2]


def test_lockstep_scenario_run_bitwise(tmp_path):
    """Under a ramped-severity, changing-mix schedule every rollout (the
    first as in JAX's test, and the rest too) and every metric equal the
    Anakin loop's bitwise."""
    anakin = make_anakin(tmp_path, scenario=two_stage_schedule())
    sebulba = make_sebulba(tmp_path, scenario=two_stage_schedule())
    for i in range(4):
        a = anakin.run_iteration()
        s = sebulba.run_lockstep_iteration()
        for f in anakin._iteration.env_fields:
            assert torch.equal(getattr(anakin.env_state, f),
                               getattr(sebulba.env_state, f)), (i, f)
        for name in a:
            assert torch.equal(a[name], s[name]), (i, name)
        assert anakin.scenario_params.wind.equal(
            sebulba.scenario_params.wind)
    assert anakin._scenario_rollouts == sebulba._scenario_rollouts == 4
    for a, s in zip(_params(anakin), _params(sebulba)):
        assert torch.equal(a, s)


JAX_CASES = {
    # 48 agent rows of 24: two minibatches.
    "ring_mlp": (EnvParams(num_agents=5, max_steps=4), "mlp", 40),
    # 16 formation rows, 40 // N = 4 formations a minibatch.
    "knn_gnn": (EnvParams(num_agents=GNN_N, obs_mode="knn", knn_k=GNN_K,
                          max_steps=4), "gnn", 40),
}


@pytest.mark.parametrize("case", sorted(JAX_CASES))
def test_lockstep_matches_jax_lockstep_injected(tmp_path, case):
    """The port's lockstep against JAX's SebulbaDriver lockstep for 2
    iterations, with JAX's initial state, resets, noise and permutations
    injected into the actor lane."""
    params, kind, batch_size = JAX_CASES[case]
    jp = jax_params(params)
    jmodel, _, model, policy = _pair(kind)
    jcfg, cfg = _configs(n_epochs=2, batch_size=batch_size, n_steps=4,
                         learning_rate=LR)
    m, n = 4, params.num_agents
    jd = JaxSebulbaDriver(
        jp, ppo=jcfg, model=jmodel,
        config=JaxTrainConfig(num_formations=m, seed=3, checkpoint=False,
                              log_dir=str(tmp_path / "jax"),
                              architecture="sebulba"),
    )
    model.load_state_dict(params_from_jax(np_tree(jd.train_state.params),
                                          policy))
    sd = SebulbaDriver(
        params, cfg, TrainConfig(num_formations=m, seed=3, checkpoint=False,
                                 log_dir=str(tmp_path / "port"),
                                 architecture="sebulba"),
        model=model, device="cpu")
    it = sd.actor_iteration
    js = jax.tree_util.tree_map(np.array, jd.env_state)
    with torch.no_grad():
        for f in it.env_fields:
            getattr(it.env, f).copy_(getattr(to_port(js), f))
        it.obs.copy_(t(jd.obs))
    it.env_step_fn = injected_env_step(js, params)
    per_formation = kind == "gnn"
    rows = cfg.n_steps * m * (1 if per_formation else n)
    mb = batch_size // n if per_formation else batch_size
    used = rows // mb * mb
    rollout_keys = {"reward", "episode_dones", "avg_dist_to_goal",
                    "ave_dist_to_neighbor", "std_dist_to_neighbor"}
    for i in range(2):
        _, k_roll, k_update = jax.random.split(jd.key, 3)
        injected = (jax_rollout_noise(k_roll, cfg.n_steps, (m, n, 2)),
                    _jax_permutations(k_update, 2, rows, used))
        sd._actor_phase.fn = lambda inj=injected: sd._actor_step(*inj)
        jmetrics = jax.device_get(jd.run_lockstep_iteration())
        metrics = sd.run_lockstep_iteration()
        np.testing.assert_array_equal(it.env.steps.numpy(),
                                      np.asarray(jd.env_state.steps))
        updates = sd.step
        assert set(metrics) == set(jmetrics)
        for k in jmetrics:
            rtol = (1e-4 if k in rollout_keys and i == 0
                    else trajectory_rtol(LR, updates))
            np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]),
                                       rtol=rtol, atol=1e-6, err_msg=k)
    assert sd.consumed_versions == list(jd.consumed_versions) == [0, 1]
    atol = adam_parity_atol(LR, updates)
    got = params_to_jax(dict(model.named_parameters()), policy)
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(np_tree(jd.train_state.params))):
        np.testing.assert_allclose(a, b, rtol=0, atol=atol)


# ---------------------------------------------------------------------------
# One build a lane; Anakin's surfaces fenced
# ---------------------------------------------------------------------------


def test_each_lane_builds_once(tmp_path, ledger):
    from marl_distributedformation_tpu_torch.obs.ledger import get_ledger

    sebulba = make_sebulba(tmp_path)
    for _ in range(4):
        sebulba.run_lockstep_iteration()
    assert sebulba.actor_guard.count == 1
    assert sebulba.learner_guard.count == 1
    # The base class's Anakin phases never ran.
    assert sebulba.retrace_guard.count == 0
    assert all(p.calls == 0 for p in sebulba._phases)
    keys = [e.key for e in get_ledger().entries()]
    assert keys == ["sebulba_sebulba_actor_rollout",
                    "sebulba_sebulba_learner_minibatch",
                    "sebulba_sebulba_learner_end"]
    assert sebulba.lanes_built()


def test_anakin_dispatch_surfaces_and_options_are_fenced(tmp_path):
    sebulba = make_sebulba(tmp_path)
    with pytest.raises(SystemExit, match="run_lockstep_iteration"):
        sebulba.run_iteration()
    with pytest.raises(SystemExit, match="drain width"):
        sebulba.run_chunk()
    with pytest.raises(SystemExit, match="recovery"):
        make_sebulba(tmp_path / "rec", health=True, recovery=True)
    with pytest.raises(SystemExit, match="iters_per_dispatch"):
        make_sebulba(tmp_path / "ipd", iters_per_dispatch=2)
    with pytest.raises(SystemExit, match="shard_fn"):
        SebulbaDriver(ENV, PPO, _config(tmp_path, "m"), model=_model(ENV),
                      device="cpu", shard_fn=lambda x: x)


def test_partition_devices_on_one_device():
    assert partition_devices(1, "cpu") == ((torch.device("cpu"),),
                                           (torch.device("cpu"),))


@pytest.mark.parametrize("override,match", [
    ("curriculum=[{rollouts: 2, agent_counts: [3]}]",
     "architecture=sebulba does not compose with curriculum"),
    ("num_seeds=2", "architecture=sebulba does not compose with num_seeds>1"),
])
def test_cli_refuses_as_jax(override, match):
    with pytest.raises(SystemExit, match=match):
        train_cli.main(["architecture=sebulba", override, "device=cpu",
                        "total_timesteps=0"])


def test_cli_refuses_an_unknown_architecture():
    with pytest.raises(SystemExit, match="architecture='podracer' is unknown"):
        train_cli.main(["architecture=podracer", "device=cpu",
                        "total_timesteps=0"])


def test_cli_trains_sebulba(tmp_path, monkeypatch, ledger):
    monkeypatch.setattr(train_cli, "repo_root", lambda: tmp_path)
    driver = train_cli.main([
        "name=seb", "device=cpu", "num_formation=2", "architecture=sebulba",
        "fused_chunk=2", "transfer_queue_depth=1", "max_param_staleness=3",
        "total_timesteps=400"])
    assert isinstance(driver, SebulbaDriver)
    assert driver.config.transfer_queue_depth == 1
    assert driver.config.max_param_staleness == 3
    run = tmp_path / "logs" / "seb"
    assert (run / "metrics.jsonl").exists()
    assert (run / "program_ledger.json").exists()
    assert latest_checkpoint(run) is not None


# ---------------------------------------------------------------------------
# Pipelined train()
# ---------------------------------------------------------------------------


def test_pipelined_train_checkpoints_and_resumes_exactly(tmp_path):
    per_iter = PPO.n_steps * 4 * ENV.num_agents
    kw = dict(checkpoint=True, save_freq=8, fused_chunk=2,
              total_timesteps=6 * per_iter)
    first = make_sebulba(tmp_path, **kw)
    record = first.train()
    assert record, "pipelined train produced no metrics record"
    assert {"learner_steps_per_sec", "actor_env_steps_per_sec",
            "param_staleness_updates"} <= set(record)
    assert first.num_timesteps >= 6 * per_iter
    assert latest_checkpoint(first.log_dir) is not None
    assert not check_no_duplicate_consume(
        list(first.transfer_queue.consumed_seqs))
    assert not check_params_version_monotone(first.consumed_versions)
    assert max(first.consumed_staleness) <= first.config.max_param_staleness
    assert first.actor_guard.count == 1
    assert first.learner_guard.count == 1
    assert first.rollouts >= len(first.consumed_versions)

    resumed = make_sebulba(tmp_path, resume=True, **kw)
    assert resumed.num_timesteps == first.num_timesteps
    for a, b in zip(_params(first), _params(resumed)):
        assert torch.equal(a, b)
    for f in first.actor_iteration.env_fields:
        assert torch.equal(getattr(first.env_state, f),
                           getattr(resumed.env_state, f))
    version, _ = resumed.param_bus.latest()
    assert version == 0
    before = resumed.num_timesteps
    assert resumed.run_lockstep_iteration()
    assert resumed.num_timesteps == before + per_iter


@pytest.mark.parametrize("case", ["mlp_ring", "gnn_knn"])
def test_pipelined_batches_were_acted_with_their_stamped_version(
    tmp_path, case
):
    """Every batch a pipelined run trains on is the one enqueued under its
    seq (no slot written over before it was consumed), acted by the
    parameters published as its stamped version: the actor's model then
    equals that publish bitwise, and the batch's log-probabilities,
    recomputed from its observations under that version, agree within
    1e-5 (and not under the next version). A wrong slot or a wrong
    snapshot in the handoff would only slow learning; this names it."""
    params, ppo = CASES[case]
    per_iter = ppo.n_steps * 4 * params.num_agents
    sebulba = make_sebulba(tmp_path, case, fused_chunk=2,
                           total_timesteps=10 * per_iter)
    published = {0: _params(sebulba)}
    acted, checked = {}, []
    publish, learn, put = (sebulba._publish, sebulba._learn,
                           sebulba.transfer_queue.put)

    def rows(slot):
        return (slot.data.obs.clone(), slot.data.actions.clone(),
                slot.data.old_log_probs.clone())

    def recording_publish(version):
        published[version] = _params(sebulba)
        return publish(version)

    def recording_put(payload, version, timeout_s=None):
        # One producer puts at a time, so this put assigns the queue's
        # next seq. It is recorded before the enqueue: the learner may
        # dequeue the item before put returns.
        seq = sebulba.transfer_queue._next_seq
        acted[seq] = (version,
                      [p.detach().clone()
                       for p in sebulba._actor_model.parameters()],
                      rows(payload))
        got = put(payload, version, timeout_s)
        assert got in (None, seq)
        return got

    def checking_learn(items):
        for item in items:
            version, _, stamped = acted[item.seq]
            assert item.params_version == version
            for a, b in zip(rows(item.payload), stamped):
                assert torch.equal(a, b), f"seq {item.seq}: slot overwritten"
            checked.append(item.seq)
        return learn(items)

    sebulba._publish = recording_publish
    sebulba.transfer_queue.put = recording_put
    sebulba._learn = checking_learn
    sebulba.train()
    assert len(checked) == len(sebulba.consumed_versions) >= 8
    assert len(set(sebulba.consumed_versions)) > 2

    model = _model(params)

    def log_probs(version, obs, actions):
        with torch.no_grad():
            for dst, src in zip(model.parameters(), published[version]):
                dst.copy_(src)
            mean, log_std, _ = model(obs)
            return distributions.log_prob(actions, mean, log_std)

    for seq in checked:
        version, actor, (obs, actions, old) = acted[seq]
        for a, b in zip(actor, published[version]):
            assert torch.equal(a, b), f"seq {seq}: acted off version {version}"
        np.testing.assert_allclose(log_probs(version, obs, actions).numpy(),
                                   old.numpy(), rtol=0, atol=1e-5)
        if version + 1 in published:
            assert (log_probs(version + 1, obs, actions) - old).abs().max() \
                > 1e-4


def test_staleness_gate_drops_and_counts(tmp_path):
    """A batch acted more than ``max_param_staleness`` updates ago is
    dropped at the learner (counted, its slot freed), never trained."""
    sebulba = make_sebulba(tmp_path, max_param_staleness=1)
    for _ in range(3):
        sebulba.run_lockstep_iteration()
    free = len(sebulba._free)
    slot = sebulba._free.popleft()
    assert not sebulba._consume(TransferItem(7, 1, slot))  # 3 - 1 = 2 > 1
    assert sebulba.stale_dropped == 1 and len(sebulba._free) == free
    assert sebulba.staleness_p95() >= 0.0
    assert list(sebulba.staleness_samples)[-1] == 2
    assert max(sebulba.consumed_staleness) == 0


# ---------------------------------------------------------------------------
# The continuous adversary feeds the schedule, nothing rebuilds
# ---------------------------------------------------------------------------


def test_continuous_adversary_feeds_schedule_with_zero_rebuilds(
    tmp_path, monkeypatch
):
    from marl_distributedformation_tpu_torch.obs import (
        MetricsRegistry,
        get_registry,
        set_registry,
    )

    monkeypatch.setattr(preg, "_REGISTRY", dict(preg._REGISTRY))
    previous = set_registry(MetricsRegistry())
    try:
        sebulba = make_sebulba(tmp_path, scenario=clean_schedule(),
                               checkpoint=True)
        sebulba.run_lockstep_iteration()
        sebulba.run_lockstep_iteration()
        assert sebulba.actor_guard.count == 1
        assert sebulba.save() is not None
        pushed = []

        def on_schedule(schedule):
            pushed.append(schedule)
            sebulba.request_scenario_schedule(schedule)

        lane = ContinuousAdversary(
            sebulba.log_dir, ENV, AdversaryConfig(
                scenarios=("wind",), grid=3, generations=3, num_formations=4,
                drop_tolerance=0.02, resolution=0.001),
            device="cpu", on_schedule=on_schedule, feedback_rollouts=4,
            **jax_hooks(4))
        report = lane.poll_once()
        assert report is not None and not lane.errors
        assert report["falsifiers"], "an untrained policy breaks under wind"
        assert pushed and lane.schedules_pushed == 1
        assert lane.poll_once() is None
        snap = get_registry().snapshot()
        assert snap["adversary_continuous_searches_total"] == 1.0
        assert snap["adversary_continuous_falsifiers"] == float(
            len(report["falsifiers"]))
        # Applied at the next actor dispatch, on the thread that owns it.
        assert sebulba._scenario_schedule.names == ("clean",)
        sebulba.run_lockstep_iteration()
        assert any(n.startswith("adv:wind")
                   for n in sebulba._scenario_schedule.names)
        sebulba.run_lockstep_iteration()
        assert sebulba.actor_guard.count == 1
        assert sebulba.learner_guard.count == 1
    finally:
        set_registry(previous)


def test_schedule_feedback_without_scenario_seam_fails_fast(
    tmp_path, monkeypatch
):
    # from_falsifiers registers its adv: scenario; it is taken back after.
    monkeypatch.setattr(preg, "_REGISTRY", dict(preg._REGISTRY))
    sebulba = make_sebulba(tmp_path)
    with pytest.raises(ValueError, match="scenarios=\\['clean'\\]"):
        sebulba.request_scenario_schedule(from_falsifiers(
            [{"scenario": "wind", "severity": 0.5}], rollouts=2))


# ---------------------------------------------------------------------------
# Chaos seams
# ---------------------------------------------------------------------------


def test_enqueue_drop_is_a_seq_gap_never_a_duplicate(plane):
    queue = TransferQueue(depth=2)
    plane.arm(FaultSchedule([FaultSpec("sebulba.enqueue", "raise", 1)]))
    assert queue.put({"x": 1}, params_version=0) is None
    assert queue.dropped_total == 1
    assert queue.put({"x": 2}, params_version=0) == 1  # seq 0 was spent
    item = queue.get(timeout_s=1.0)
    assert item.seq == 1
    assert list(queue.consumed_seqs) == [1]
    assert not check_no_duplicate_consume(list(queue.consumed_seqs))


def test_dequeue_redelivery_absorbed_by_seq_guard(plane):
    queue = TransferQueue(depth=4)
    plane.arm(FaultSchedule([FaultSpec("sebulba.dequeue", "raise", 1)]))
    queue.put({"x": 1}, params_version=0)
    queue.put({"x": 2}, params_version=0)
    assert queue.get(timeout_s=1.0).seq == 0  # delivered and re-queued
    assert queue.get(timeout_s=1.0).seq == 1  # the replay absorbed
    assert queue.duplicates_absorbed == 1
    assert list(queue.consumed_seqs) == [0, 1]


def test_dropped_publish_keeps_previous_version_latest_wins(plane):
    plane.arm(FaultSchedule([FaultSpec("sebulba.param_publish", "raise", 2)]))
    bus = ParamBus()
    assert bus.publish({"w": 0.0}, 0)
    assert not bus.publish({"w": 1.0}, 1)
    assert bus.publishes_dropped == 1
    assert bus.latest() == (0, {"w": 0.0})
    assert bus.publish({"w": 2.0}, 2)
    assert not bus.publish({"w": 1.0}, 1)
    assert bus.version == 2
    assert not check_params_version_monotone(bus.versions_published)


def test_lockstep_enqueue_drop_is_a_skipped_update(plane, tmp_path):
    sebulba = make_sebulba(tmp_path)
    per_iter = PPO.n_steps * 4 * ENV.num_agents
    # One drop more than there are trajectory slots: a dropped batch's
    # slot must go back to the pool, or the last round waits for a slot
    # that never comes.
    n_slots = (sebulba.config.transfer_queue_depth
               + sebulba._learner_chunk_k + 1)
    drops = n_slots + 1
    plane.arm(FaultSchedule([FaultSpec("sebulba.enqueue", "raise", hit)
                             for hit in range(1, drops + 1)]))
    before = _params(sebulba)
    for i in range(drops):
        assert sebulba.run_lockstep_iteration() == {}
        assert sebulba.num_timesteps == (i + 1) * per_iter
    assert sebulba.transfer_queue.dropped_total == drops
    assert sebulba.consumed_versions == []
    assert len(sebulba._slots) == n_slots
    assert len(sebulba._free) == n_slots
    for a, b in zip(before, sebulba.model.parameters()):
        assert torch.equal(a, b)
    assert sebulba.run_lockstep_iteration()
    assert list(sebulba.transfer_queue.consumed_seqs) == [drops]
    assert sebulba.consumed_versions == [0]
    assert len(sebulba._free) == n_slots
    assert any(not torch.equal(a, b)
               for a, b in zip(before, sebulba.model.parameters()))


def test_dropped_publish_on_the_driver_keeps_acting_on_the_old_version(
    plane, tmp_path
):
    """The driver's double buffer under a dropped publish: the actor acts
    on the version the bus holds, and the next publish lands beside it."""
    # Hits: the initial publish of version 0, then one a lockstep round.
    plane.arm(FaultSchedule([FaultSpec("sebulba.param_publish", "raise",
                                       3)]))
    sebulba = make_sebulba(tmp_path)
    sebulba.run_lockstep_iteration()  # publishes version 1
    sebulba.run_lockstep_iteration()  # acts on 1; publish of 2 dropped
    sebulba.run_lockstep_iteration()  # acts on 1 again; publishes 3
    assert sebulba.consumed_versions == [0, 1, 1]
    assert sebulba.param_bus.version == 3
    version, snap = sebulba.param_bus.latest()
    for a, b in zip(snap.tensors, sebulba.model.parameters()):
        assert torch.equal(a, b)
