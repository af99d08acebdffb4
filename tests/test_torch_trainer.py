"""The port's trainer and its ``train`` CLI against the JAX package on the
CPU: configs and their defaults, one whole iteration with the JAX package's
noise, resets and permutations injected, two scenario-training iterations
of the ``Trainer`` with the JAX trainer's sampled scenario mixes and layer
draws injected too, the CLI's outputs, the knobs it refuses, and a short
learning run of the port alone.

Tolerances: after the injected iteration, params within
``tests/adam_budget.py::adam_parity_atol`` and ``mu``/``nu`` within the same
budget relative to each leaf's largest value, ``count`` exact; the
iteration's scalar metrics within ``trajectory_rtol`` (they feel the
parameter drift through the minibatches), the rollout's own metrics within
``rtol=1e-4``.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch
from flax import serialization
from flax.training.train_state import TrainState

from adam_budget import adam_parity_atol, trajectory_rtol
from marl_distributedformation_tpu.algo import PPOConfig as JaxPPOConfig
from marl_distributedformation_tpu.env.formation import (
    compute_obs as jax_compute_obs,
    reset_batch as jax_reset_batch,
)
from marl_distributedformation_tpu.train import TrainConfig as JaxTrainConfig
from marl_distributedformation_tpu.train import Trainer as JaxTrainer
from marl_distributedformation_tpu.train.trainer import (
    default_total_timesteps as jax_default_total_timesteps,
    fill_ent_schedule as jax_fill_ent_schedule,
    make_ppo_iteration as jax_make_ppo_iteration,
)
from marl_distributedformation_tpu.utils.config import (
    load_config as jax_load_config,
)
from marl_distributedformation_tpu_torch.algo import PPOConfig, adam_init
from marl_distributedformation_tpu_torch.compat.convert import (
    opt_state_to_jax,
    params_from_jax,
    params_to_jax,
)
from marl_distributedformation_tpu_torch.env import EnvParams
from marl_distributedformation_tpu_torch.models import MLPActorCritic
from marl_distributedformation_tpu_torch.train import (
    TrainConfig,
    Trainer,
    default_total_timesteps,
    fill_ent_schedule,
    make_ppo_iteration,
)
from marl_distributedformation_tpu_torch.train import cli as train_cli
from marl_distributedformation_tpu_torch.utils.config import load_config
from test_torch_algo import (
    GNN_K,
    GNN_N,
    _configs,
    _jax_permutations,
    _pair,
    assert_tree_close,
    injected_env_step,
    jax_rollout_noise,
    t,
)
from test_torch_env import jax_params, to_port
from test_torch_models import np_tree
from test_torch_scenarios import (
    JaxStreams,
    injected_scenario_step,
    jax_episode_draws,
)

LR = 1e-3


def _defaults(cls):
    return {f.name: f.default for f in dataclasses.fields(cls)}


def test_ppo_config_fields_and_defaults_equal_jax():
    assert _defaults(PPOConfig) == _defaults(JaxPPOConfig)


def test_train_config_ported_fields_have_jax_defaults():
    jax_fields = _defaults(JaxTrainConfig)
    port = _defaults(TrainConfig)
    assert set(port) == {
        "num_formations", "total_timesteps", "seed", "save_freq",
        "checkpoint", "name", "log_dir", "use_wandb", "use_tensorboard",
        "resume", "log_interval", "iters_per_dispatch", "fused_chunk",
        "health", "health_grad_norm_max", "health_param_drift_max",
        "recovery", "recovery_breach_iters", "recovery_max_rollbacks",
        "recovery_lr_backoff", "recovery_severity_backoff", "keep_last_n",
        "profile", "profile_iterations", "architecture", "actor_devices",
        "transfer_queue_depth", "max_param_staleness", "guard_retraces",
        "guard_transfers", "guard_nans",
    }
    for name, default in port.items():
        assert jax_fields[name] == default, name


@pytest.mark.parametrize("total", [None, 12345])
def test_budget_and_schedule_horizon_match_jax(total):
    params = EnvParams(num_agents=7)
    cfg, jcfg = TrainConfig(num_formations=13, total_timesteps=total), \
        JaxTrainConfig(num_formations=13, total_timesteps=total)
    assert default_total_timesteps(cfg) == jax_default_total_timesteps(jcfg)
    sched = dict(ent_coef_final=0.0)
    got = fill_ent_schedule(PPOConfig(**sched), params, cfg)
    want = jax_fill_ent_schedule(JaxPPOConfig(**sched),
                                 jax_params(params), jcfg)
    assert got.total_iterations == want.total_iterations > 0
    assert fill_ent_schedule(PPOConfig(), params, cfg) == PPOConfig()


def test_presets_as_jax():
    for overrides in (["preset=tpu"], ["preset=tpu", "batch_size=4096"], []):
        assert load_config(overrides) == jax_load_config(overrides)
    assert load_config(["preset=tpu"]).batch_size == 16384
    assert load_config(["preset=tpu", "batch_size=4096"]).batch_size == 4096
    with pytest.raises(ValueError, match="unknown preset"):
        load_config(["preset=gpu"])


ITERATION_CASES = {
    # 200 agent rows of 64: three minibatches, eight rows dropped.
    "ring_mlp": (EnvParams(num_agents=5, max_steps=4), "mlp", 64),
    # 40 formation rows, 40 // N = 4 formations a minibatch.
    "knn_gnn": (EnvParams(num_agents=GNN_N, obs_mode="knn", knn_k=GNN_K,
                          max_steps=4), "gnn", 40),
}


@pytest.mark.parametrize("case", sorted(ITERATION_CASES))
def test_make_ppo_iteration_injected_matches(case):
    params, kind, batch_size = ITERATION_CASES[case]
    per_formation = kind == "gnn"
    jp = jax_params(params)
    jmodel, jvars, model, policy = _pair(kind)
    jcfg, cfg = _configs(n_epochs=2, batch_size=batch_size)
    m, n = 4, params.num_agents
    jstate = jax_reset_batch(jax.random.PRNGKey(21), jp, m)
    jobs = jax_compute_obs(jstate.agents, jstate.goal, jp)
    ts = TrainState.create(apply_fn=jmodel.apply, params=jvars,
                           tx=jcfg.make_optimizer())
    key = jax.random.PRNGKey(22)
    iteration = jax.jit(jax_make_ppo_iteration(jp, jcfg, per_formation))
    ts, jend, jlast_obs, _, jmetrics = iteration(ts, jstate, jobs, key)

    _, k_roll, k_update = jax.random.split(key, 3)
    rows = cfg.n_steps * m * (1 if per_formation else n)
    mb = batch_size // n if per_formation else batch_size
    used = rows // mb * mb
    state = adam_init(dict(model.named_parameters()))
    port_iteration = make_ppo_iteration(
        params, cfg, per_formation, env_step_fn=injected_env_step(jstate,
                                                                  params))
    step, end, last_obs, metrics = port_iteration(
        model, state, 0, to_port(jstate), t(jobs), None,
        noise=jax_rollout_noise(k_roll, cfg.n_steps, (m, n, 2)),
        permutations=_jax_permutations(k_update, 2, rows, used),
    )
    updates = 2 * (rows // mb)
    assert step == updates == int(ts.step)
    atol = adam_parity_atol(LR, updates)
    got, ref = params_to_jax(dict(model.named_parameters()), policy), \
        np_tree(ts.params)
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(ref)):
        np.testing.assert_allclose(a, b, rtol=0, atol=atol)
    jopt = serialization.to_state_dict(ts.opt_state)["1"]["0"]
    popt = opt_state_to_jax(vars(state), policy)["1"]["0"]
    assert int(popt["count"]) == int(jopt["count"]) == updates
    for moment in ("mu", "nu"):
        assert_tree_close(popt[moment], np_tree(jopt[moment]), rtol=0,
                          floor=atol, what=moment)
    np.testing.assert_array_equal(end.steps.numpy(), np.asarray(jend.steps))
    assert set(metrics) == set(jmetrics)
    rollout_keys = {"reward", "episode_dones", "avg_dist_to_goal",
                    "ave_dist_to_neighbor", "std_dist_to_neighbor",
                    "close_to_goal_reward", "reward_dist",
                    "reward_right_neighbor", "reward_left_neighbor"}
    assert rollout_keys <= set(metrics)
    assert float(metrics["episode_dones"]) == float(jmetrics["episode_dones"])
    for k in jmetrics:
        rtol = 1e-4 if k in rollout_keys else trajectory_rtol(LR, updates)
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]),
                                   rtol=rtol, atol=1e-6, err_msg=k)


SCENARIO_SCHEDULE = ("[{rollouts: 1, scenarios: [storm, comm_dropout, "
                     "moving_goal], severity: 0.9}, {rollouts: 1, scenarios: "
                     "[actuator_fault, sensor_noise, goal_switch], "
                     "severity: 1.0}]")


def test_scenario_trainer_two_iterations_match_jax(tmp_path):
    """The knn GNN trainer under a 2-stage scenario schedule against the
    JAX trainer for 2 host-loop iterations (the stage changes between
    them), with the JAX trainer's initial state, sampled scenario mixes,
    layer draws, resets, action noise and permutations injected: params
    within the Adam budget, env steps bitwise, scenario severities and
    the rollout metrics as the JAX trainer's."""
    from marl_distributedformation_tpu.scenarios import (
        schedule_from_cfg as jax_schedule_from_cfg,
    )
    from marl_distributedformation_tpu_torch.scenarios import (
        ScenarioParams,
        schedule_from_cfg,
    )
    from marl_distributedformation_tpu_torch.scenarios.params import FIELDS
    from marl_distributedformation_tpu_torch.models import GNNActorCritic

    params = EnvParams(num_agents=GNN_N, obs_mode="knn", knn_k=GNN_K,
                       max_steps=4)
    jp = jax_params(params)
    m, n, batch_size = 4, GNN_N, 40
    jcfg, cfg = _configs(n_epochs=2, batch_size=batch_size, n_steps=5)
    jmodel, _, _, policy = _pair("gnn")
    jt = JaxTrainer(
        jp, ppo=jcfg, model=jmodel,
        config=JaxTrainConfig(num_formations=m, seed=4, checkpoint=False,
                              log_dir=str(tmp_path / "jax")),
        scenario_schedule=jax_schedule_from_cfg(SCENARIO_SCHEDULE),
    )
    model = GNNActorCritic(k=GNN_K)
    model.load_state_dict(params_from_jax(np_tree(jt.train_state.params),
                                          policy))
    trainer = Trainer(
        params, cfg, TrainConfig(num_formations=m, seed=4, checkpoint=False,
                                 log_dir=str(tmp_path / "port")),
        model=model, device="cpu",
        scenario_schedule=schedule_from_cfg(SCENARIO_SCHEDULE),
    )
    it = trainer._iteration
    # Host copies: the JAX trainer donates its carry to each dispatch.
    js = jax.tree_util.tree_map(np.array, jt.env_state)
    episode = jax_episode_draws(js.key, params)
    with torch.no_grad():
        for f in ("agents", "goal", "obstacles", "steps"):
            getattr(it.env, f).copy_(getattr(to_port(js), f))
        for f in it.env_fields[4:]:
            getattr(it.env, f).copy_(getattr(episode, f))
        it.obs.copy_(t(jt.obs))
    streams = JaxStreams(js.key, js.steps, params)
    it.env_step_fn = injected_scenario_step(streams, params,
                                            lambda: it.scenario_params)
    rows = cfg.n_steps * m
    mb = batch_size // n
    used = rows // mb * mb
    for i in range(2):
        _, k_roll, k_update = jax.random.split(jt.key, 3)
        jsp = jax.tree_util.tree_map(np.array, jt.scenario_params)
        severity = jt.scenario_severity
        assert trainer.scenario_severity == severity
        injected = (jax_rollout_noise(k_roll, cfg.n_steps, (m, n, 2)),
                    _jax_permutations(k_update, 2, rows, used))
        trainer._phases[0].fn = lambda inj=injected: it.rollout(*inj)
        trainer._scenario_rows = lambda r, d, k, jsp=jsp, s=severity: (
            ScenarioParams(**{f: t(getattr(jsp, f))[None] for f in FIELDS}),
            [s])
        jmetrics = jt.run_iteration()
        metrics = trainer.run_iteration()
        for f in FIELDS:
            np.testing.assert_array_equal(
                getattr(it.scenario_params, f).numpy(),
                np.asarray(getattr(jsp, f)), err_msg=f)
        np.testing.assert_array_equal(it.env.steps.numpy(),
                                      np.asarray(jt.env_state.steps))
        assert float(metrics["episode_dones"]) == float(
            jmetrics["episode_dones"])
        updates = trainer.step
        for k in ("reward", "avg_dist_to_goal", "ave_dist_to_neighbor"):
            np.testing.assert_allclose(
                float(metrics[k]), float(jmetrics[k]),
                rtol=1e-4 if i == 0 else trajectory_rtol(LR, updates),
                err_msg=k)
    assert trainer.scenario_severity == jt.scenario_severity == 1.0
    atol = adam_parity_atol(LR, updates)
    got = params_to_jax(dict(model.named_parameters()), policy)
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(np_tree(jt.train_state.params))):
        np.testing.assert_allclose(a, b, rtol=0, atol=atol)


def test_port_learns_on_cpu(tmp_path):
    """Ring/MLP, M=8, six iterations from a fixed seed (deterministic on the
    CPU): the mean reward of the last two iterations beats the first two."""
    params = EnvParams()
    trainer = Trainer(
        params,
        config=TrainConfig(num_formations=8, total_timesteps=6 * 400,
                           seed=3, log_dir=str(tmp_path), checkpoint=False),
        model=MLPActorCritic(params.obs_dim, params.act_dim,
                             generator=torch.Generator().manual_seed(3)),
        device="cpu",
    )
    rewards = []
    while trainer.num_timesteps < trainer.total_timesteps:
        rewards.append(float(trainer.run_iteration()["reward"]))
    assert np.mean(rewards[-2:]) > np.mean(rewards[:2]), rewards


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------

TINY = ["num_formation=2", "total_timesteps=200", "n_epochs=2",
        "ent_coef_final=0.0", "log_std_final=-1.0"]


def _records(path):
    return [json.loads(line) for line in path.read_text().splitlines()]


def test_train_cli_writes_jax_trainers_outputs(tmp_path, monkeypatch):
    monkeypatch.setattr(train_cli, "repo_root", lambda: tmp_path)
    trainer = train_cli.main(["name=tiny", "device=cpu", *TINY])
    run = tmp_path / "logs" / "tiny"
    records = _records(run / "metrics.jsonl")
    assert len(records) == 2 and trainer.num_timesteps == 200
    assert [r["step"] for r in records] == [100, 200]
    assert (run / "rl_model_200_steps.msgpack").exists()
    snap = json.loads((run / "config.json").read_text())
    assert snap["resolved_platform"] == "cpu" and snap["n_epochs"] == 2

    # The JAX trainer at the same config writes the same keys.
    cfg = jax_load_config(TINY)
    from train import ppo_from_config as jax_ppo_from_config

    jax_run = tmp_path / "jax"
    JaxTrainer(
        jax_params(EnvParams()), ppo=jax_ppo_from_config(cfg),
        config=JaxTrainConfig(num_formations=2, total_timesteps=200,
                              log_dir=str(jax_run), checkpoint=False),
    ).train()
    want = _records(jax_run / "metrics.jsonl")
    assert len(want) == 2
    assert set(records[0]) == set(want[0])
    assert {"ent_coef", "log_std_ceiling", "grad_norm"} <= set(records[0])


def _other(value):
    """An override value different from a YAML default."""
    if isinstance(value, bool):
        return str(not value).lower()
    if isinstance(value, (int, float)):
        return str(value + 1)
    if value is None:
        return "1"
    return "sebulba"


@pytest.mark.parametrize("key", sorted(train_cli.UNPORTED))
def test_train_cli_refuses_unported_knobs(key):
    default = {**train_cli._UNLISTED_DEFAULTS,
               **load_config([])}.get(key)
    item = train_cli.UNPORTED[key].split()[0]
    with pytest.raises(SystemExit, match=f"ROADMAP {item}"):
        train_cli.main([f"{key}={_other(default)}", "device=cpu"])
    # The default itself passes the check.
    train_cli.refuse_unported(load_config([f"{key}={default}"]
                                          if default is not None else []))


PORTED_KNOBS = {
    "fused_chunk": 2, "iters_per_dispatch": 3, "health": True,
    "health_grad_norm_max": 5.0e5, "health_param_drift_max": 4.0,
    "recovery": True, "recovery_breach_iters": 2,
    "recovery_max_rollbacks": 5, "recovery_lr_backoff": 0.5,
    "recovery_severity_backoff": 0.25, "keep_last_n": 4,
    # The population knobs build a SweepTrainer, as the root train.py does.
    "num_seeds": 3, "learning_rates": "[3e-4,1e-3]",
    # Scenario training: a schedule built at config time.
    "scenarios": "[wind,storm]", "scenario_severity": 0.25,
    # Profile windows and Sebulba reach the trainer's config.
    "profile": True, "profile_iterations": 2, "architecture": "sebulba",
    "actor_devices": 2, "transfer_queue_depth": 3, "max_param_staleness": 1,
    # The registry's and the ledger's knobs are main()'s.
    "telemetry": False, "telemetry_port": 0, "telemetry_reservoir": 64,
    "ledger": False, "ledger_reservoir": 32,
}
POPULATION_KNOBS = ("num_seeds", "learning_rates")
SCENARIO_KNOBS = ("scenarios", "scenario_severity")
OBS_KNOBS = ("telemetry", "telemetry_port", "telemetry_reservoir", "ledger",
             "ledger_reservoir")


@pytest.mark.parametrize("key", sorted(PORTED_KNOBS))
def test_train_cli_accepts_ported_knobs(key, tmp_path, monkeypatch):
    """The knobs of fused dispatch, the health word, the recovery ladder,
    the retention ring and populations reach the trainer from the command
    line, as the JAX package's ``train.py`` passes them; a population
    member i is initialised from ``seed + i``."""
    monkeypatch.setattr(train_cli, "repo_root", lambda: tmp_path)
    value = PORTED_KNOBS[key]
    extra = {"recovery": ["health=true"],
             "learning_rates": ["num_seeds=2"],
             "scenario_severity": ["scenarios=[wind]"]}.get(key, [])
    trainer = train_cli.build_trainer([
        f"{key}={str(value).lower() if isinstance(value, bool) else value}",
        "device=cpu", "num_formation=2", *extra,
    ])
    assert key not in train_cli.UNPORTED
    if key in OBS_KNOBS:
        assert isinstance(trainer, Trainer)
        return
    if key in SCENARIO_KNOBS:
        schedule = trainer._scenario_schedule
        names = ("wind", "storm") if key == "scenarios" else ("wind",)
        severity = 0.25 if key == "scenario_severity" else 0.5
        assert schedule.names == names
        assert schedule.severity_at(0) == severity
        assert trainer.scenario_params.wind.shape == (2, 2)
        return
    if key not in POPULATION_KNOBS:
        assert getattr(trainer.config, key) == value
        return
    from marl_distributedformation_tpu_torch.train.sweep import SweepTrainer

    assert isinstance(trainer, SweepTrainer)
    if key == "num_seeds":
        assert trainer.num_seeds == 3 and trainer.learning_rates is None
        cfg = load_config(["num_formation=2"])
        for i in range(3):
            member = train_cli.build_model(cfg, trainer.env_params, "mlp",
                                           seed=i)
            for k, p in member.named_parameters():
                assert torch.equal(trainer.model.params[k][i], p)
    else:  # YAML leaves "3e-4" a string; each is taken as a float
        np.testing.assert_array_equal(trainer.learning_rates,
                                      np.float32([3e-4, 1e-3]))
        np.testing.assert_array_equal(trainer._iteration.lr.numpy(),
                                      np.float32([3e-4, 1e-3]))


CURRICULUM = "curriculum=[{rollouts: 2, agent_counts: [3]}]"


@pytest.mark.parametrize("override,match", [
    ("platform=cpu", "device=cuda"),
    ("backend=torch", "device=cuda"),
    ("num_formations=4", "did you mean 'num_formation'"),
    ("policy=transformer", "not implemented"),
    # As the root train.py: a population knob alone.
    ("learning_rates=[1e-3,3e-3]", "learning_rates is a population knob"),
    # The curriculum's refusals, in the JAX package's words
    # (train.py::build_hetero_trainer, HeteroTrainer, HeteroSweepTrainer).
    (f"policy=gnn obs_mode=knn {CURRICULUM}",
     "curriculum training supports policy=mlp"),
    (f"obs_mode=knn {CURRICULUM}",
     "curriculum training uses the ring observation model"),
    (f"env=pursuit_evasion {CURRICULUM}",
     "curriculum training is formation-only"),
    (f"num_seeds=2 learning_rates=[1e-3,3e-3] {CURRICULUM}",
     "learning_rates does not compose with curriculum populations"),
    (f"fused_chunk=2 {CURRICULUM}",
     "iters_per_dispatch > 1 / fused_chunk do not compose with curriculum"),
    (f"iters_per_dispatch=2 {CURRICULUM}",
     "iters_per_dispatch > 1 / fused_chunk do not compose with curriculum"),
    (f"num_seeds=2 iters_per_dispatch=2 {CURRICULUM}",
     "iters_per_dispatch is retired for population sweeps .*chunks clip "
     "at curriculum stage boundaries"),
    # Scenario training's refusals, in the root train.py's words.
    (f"scenarios=[wind] {CURRICULUM}",
     "scenarios do not compose with curriculum training yet"),
    ("scenarios=[wind] num_seeds=2",
     "scenarios do not compose with num_seeds>1 population sweeps yet"),
    ("scenarios=[wnd]", "unknown scenario 'wnd' .did you mean 'wind'.."),
])
def test_train_cli_refuses(override, match):
    words = override.split(" ")
    # The curriculum's YAML is one override with spaces in it.
    at = next((i for i, w in enumerate(words) if w.startswith("curriculum=")),
              len(words))
    argv = words[:at] + ([" ".join(words[at:])] if at < len(words) else [])
    with pytest.raises(SystemExit, match=match):
        train_cli.main([*argv, "device=cpu", "total_timesteps=0"])


def test_metrics_logger_as_jax(tmp_path, capsys):
    """JSONL records of ``{step, time, **metrics}``, a brief stderr line on
    the 1st, 11th, ... record, and a notice for an optional backend that is
    missing, as the JAX package's logger does."""
    import importlib.util

    from marl_distributedformation_tpu_torch.utils.logging import (
        MetricsLogger,
        Throughput,
    )

    logger = MetricsLogger(tmp_path, use_wandb=True)
    for i in range(12):
        logger.log({"reward": -float(i), "loss": 2.0}, step=100 * (i + 1))
    logger.close()
    records = _records(tmp_path / "metrics.jsonl")
    assert len(records) == 12 and list(records[0]) == [
        "step", "time", "reward", "loss"]
    err = capsys.readouterr()
    assert err.err.count("[metrics] step=") == 2
    if importlib.util.find_spec("wandb") is None:
        assert "wandb unavailable" in err.out
    meter = Throughput(window=2)
    assert meter.rate() == 0.0
    for _ in range(4):
        meter.tick(10)
    assert meter.rate() > 0.0


def _tiny(tmp_path, **cfg):
    from marl_distributedformation_tpu_torch.models import MLPActorCritic

    env = EnvParams(num_agents=3, max_steps=20)
    return Trainer(
        env, PPOConfig(n_steps=4, batch_size=24, n_epochs=2),
        TrainConfig(num_formations=4, checkpoint=False,
                    log_dir=str(tmp_path), **cfg),
        model=MLPActorCritic(env.obs_dim,
                             generator=torch.Generator().manual_seed(0)),
        device="cpu")


def test_profile_breakdown_times_the_phases_and_leaves_no_trace(tmp_path):
    """The JAX trainer's keys (``tests/test_trainer.py``), the fractions
    summing to 1; the timed iterations are undone, so the next iteration
    equals a fresh trainer's first bitwise."""
    profiled, fresh = _tiny(tmp_path / "a"), _tiny(tmp_path / "b")
    bd = profiled.profile_breakdown(iters=2)
    for k in ("total", "rollout", "env", "update", "policy"):
        assert bd[k] >= 0.0, bd
    assert bd["total"] > 0.0 and bd["rollout"] > 0.0
    np.testing.assert_allclose(
        bd["frac_env"] + bd["frac_policy"] + bd["frac_update"], 1.0,
        rtol=1e-6)
    got, want = profiled.run_iteration(), fresh.run_iteration()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    for p, q in zip(profiled.model.parameters(), fresh.model.parameters()):
        assert torch.equal(p, q)
    assert profiled.num_timesteps == fresh.num_timesteps


def test_host_tree_is_a_copy_on_the_cpu(tmp_path):
    """A host tree (the ladder's rollback anchor) keeps the values it was
    taken at: on the CPU ``numpy()`` would alias the live tensors."""
    trainer = _tiny(tmp_path)
    tree = trainer._host_tree()
    flat = jax.tree_util.tree_leaves(tree["params"])
    before = [np.array(leaf) for leaf in flat]
    trainer.run_iteration()
    for leaf, value in zip(flat, before):
        np.testing.assert_array_equal(leaf, value)
    live = jax.tree_util.tree_leaves(params_to_jax(
        {k: p.detach().numpy() for k, p in trainer.model.named_parameters()},
        trainer.policy))
    assert any(not np.array_equal(a, b) for a, b in zip(flat, live))
