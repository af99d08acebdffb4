"""The port's pursuit-evasion env against the JAX package on the CPU.

Inputs are made with numpy and handed to both packages; resets are injected
from JAX's own uniform draws, as in ``test_torch_env.py``. Tolerances:
positions, ``steps``, ``done``, the capture mask and the knn neighbor
indices bitwise; every other float (the pursuer, reward terms, metrics,
observations) within ``rtol=1e-6`` plus ``atol=1e-6`` near 0 (XLA may
contract a norm's ``x*x + y*y`` into an FMA). A mixed reward is a sum of
terms as large as the capture penalty (50) and the evade reward at the
world's diagonal (36), so where they cancel toward 0 it keeps their
absolute rounding: rewards are held within ``rtol=1e-6`` plus ``atol`` of
1e-6 times that scale (``reward_atol``). Severity 0 against the
clean env, fused against the host loop, and the trainers' env state are
compared bitwise within the port.
"""

import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marl_distributedformation_tpu.env.formation import (
    reset_batch as jax_reset_batch,
)
from marl_distributedformation_tpu.envs import (
    PURSUIT_SPEC as JAX_PURSUIT_SPEC,
    PursuitParams as JaxPursuitParams,
)
from marl_distributedformation_tpu.envs.pursuit import (
    pursuer_update as jax_pursuer_update,
    pursuit_reward as jax_pursuit_reward,
    pursuit_step_batch as jax_pursuit_step_batch,
)
from marl_distributedformation_tpu.utils import config as jconfig
from marl_distributedformation_tpu_torch import envs
from marl_distributedformation_tpu_torch import evaluate as evaluate_cli
from marl_distributedformation_tpu_torch.algo import PPOConfig
from marl_distributedformation_tpu_torch.env import (
    EnvParams,
    reset_batch,
)
from marl_distributedformation_tpu_torch.envs import (
    PURSUIT_SPEC,
    PursuitParams,
    formation_obs_layout,
    spec_for_params,
)
from marl_distributedformation_tpu_torch.envs.pursuit import (
    nearest_index,
    pursuer_update,
    pursuit_reward,
)
from marl_distributedformation_tpu_torch.eval import evaluate, zero_act_fn
from marl_distributedformation_tpu_torch.models import (
    GNNActorCritic,
    MLPActorCritic,
)
from marl_distributedformation_tpu_torch.scenarios import (
    ScenarioStreams,
    broadcast_params,
    init_scenario_state,
    registered_scenarios,
    scenario_params_for,
    scenario_step_batch,
)
from marl_distributedformation_tpu_torch.train import TrainConfig, Trainer
from marl_distributedformation_tpu_torch.train import cli as train_cli
from marl_distributedformation_tpu_torch.train.sweep import SweepTrainer
from marl_distributedformation_tpu_torch.utils import config
from test_torch_env import jax_reset_uniforms, to_port

RTOL = ATOL = 1e-6


def jax_pursuit(params: PursuitParams) -> JaxPursuitParams:
    fields = dataclasses.asdict(params)
    fields["knn_impl"] = "xla"
    return JaxPursuitParams(**fields)


def close(port, ref, what, atol=ATOL):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=atol, err_msg=what)


def reward_atol(params: PursuitParams) -> float:
    """1e-6 of the largest reward term's magnitude (module docstring)."""
    diag = float(np.hypot(params.width, params.height))
    return ATOL * max(params.capture_penalty,
                      params.evade_reward_scale * diag)


def same(port, ref, what):
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref),
                                  err_msg=what)


def t(x):
    return torch.from_numpy(np.array(x, np.float32))


# ---------------------------------------------------------------------------
# The scripted pursuer and the reward
# ---------------------------------------------------------------------------


def test_pursuer_chases_nearest_without_overshoot_as_jax():
    """JAX ``test_envs.py``'s cases (far gap: exactly ``pursuer_speed``
    toward the nearest evader; a gap below it: onto the evader), with ties
    (the first of equal distances, as ``jnp.argmin``) and a batch of
    random states, against the JAX package."""
    params = PursuitParams(num_agents=3, pursuer_speed=7.0)
    jp = jax_pursuit(params)
    agents = np.array([[100.0, 100.0], [400.0, 400.0], [500.0, 100.0]],
                      np.float32)
    tie = np.array([[90.0, 50.0], [110.0, 50.0], [100.0, 60.0]],
                   np.float32)  # evaders 0 and 1 both 10 px away
    cases = [(agents, [100.0, 50.0], [100.0, 57.0]),
             (agents, [100.0, 98.0], [100.0, 100.0]),
             (tie, [100.0, 50.0], [93.0, 50.0])]
    for a, p, want in cases:
        got = pursuer_update(t(a)[None], t(p)[None], params)[0]
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
        ref = jax_pursuer_update(jnp.asarray(a), jnp.asarray(p, jnp.float32),
                                 jp)
        close(got, ref, "pursuer")
    rng = np.random.default_rng(0)
    a = rng.uniform(0, 1, (16, 7, 2)).astype(np.float32) * [400, 600]
    p = rng.uniform(0, 1, (16, 2)).astype(np.float32) * [400, 600]
    a[:4] = np.round(a[:4] / 50) * 50  # lattice points: exact ties
    p[:4] = np.round(p[:4] / 50) * 50 + 25
    params = PursuitParams(num_agents=7)
    ref = jax.vmap(jax_pursuer_update, in_axes=(0, 0, None))(
        jnp.asarray(a, jnp.float32), jnp.asarray(p, jnp.float32),
        jax_pursuit(params))
    close(pursuer_update(t(a), t(p), params), ref, "pursuer batch")


def test_nearest_index_takes_the_first_minimum_as_jnp_argmin():
    rng = np.random.default_rng(1)
    d = np.round(rng.uniform(0, 4, (64, 9))).astype(np.float32)  # ties
    d[0, 3] = d[1, 0] = np.nan  # jnp.argmin takes the first NaN
    d[1, 5] = np.nan
    same(nearest_index(t(d)), jnp.argmin(jnp.asarray(d), axis=-1),
         "nearest index")


def test_pursuit_reward_matches_jax():
    """JAX's capture case (agent 0 inside ``capture_radius`` only) and a
    random batch with out-of-bounds and obstacle flags: mixed rewards and
    every term."""
    params = PursuitParams(num_agents=5, share_reward_ratio=0.3)
    jp = jax_pursuit(params)
    rng = np.random.default_rng(2)
    agents = rng.uniform(0, 1, (6, 5, 2)).astype(np.float32) * [400, 600]
    pursuer = rng.uniform(0, 1, (6, 2)).astype(np.float32) * [400, 600]
    agents[0, 0] = pursuer[0] + [0.0, 10.0]  # caught
    oob = rng.uniform(size=(6, 5)) < 0.2
    obst = rng.uniform(size=(6, 5)) < 0.2
    got, terms = pursuit_reward(t(agents), t(pursuer), torch.from_numpy(oob),
                                torch.from_numpy(obst), params)
    ref, ref_terms = jax.vmap(jax_pursuit_reward,
                              in_axes=(0, 0, 0, 0, None))(
        jnp.asarray(agents), jnp.asarray(pursuer), jnp.asarray(oob),
        jnp.asarray(obst), jp)
    close(got, ref, "reward", reward_atol(params))
    assert set(terms) == set(ref_terms)
    for key in ref_terms:
        close(terms[key], ref_terms[key], key)
    assert terms["capture_penalty"][0, 0] == -params.capture_penalty
    assert bool((terms["capture_penalty"][0, 1:] == 0).all())


# ---------------------------------------------------------------------------
# The batched step, ring and knn
# ---------------------------------------------------------------------------

STEP_CONFIGS = {
    "ring": PursuitParams(num_agents=6, num_obstacles=2, max_steps=20),
    "knn": PursuitParams(num_agents=12, obs_mode="knn", knn_k=3,
                         max_steps=20, pursuer_speed=9.0),
    "nonstrict": PursuitParams(num_agents=5, strict_parity=False,
                               max_steps=20, capture_radius=80.0),
}


@pytest.mark.parametrize("name", sorted(STEP_CONFIGS))
def test_pursuit_step_batch_matches_jax(name):
    params = STEP_CONFIGS[name]
    jp = jax_pursuit(params)
    m = 6
    rng = np.random.default_rng(len(name))
    state = jax_reset_batch(jax.random.PRNGKey(3), jp, m)
    agents = rng.uniform(0, 1, (m, params.num_agents, 2)) * [400, 600]
    agents[0, 1] = np.asarray(state.goal)[0] + [5.0, 0.0]  # near the pursuer
    steps = rng.integers(0, params.max_steps, m)
    steps[:2] = [params.max_steps + 1, params.max_steps - 1]
    state = state.replace(agents=jnp.asarray(agents, jnp.float32),
                          steps=jnp.asarray(steps, jnp.int32))
    vel = rng.uniform(-12, 12, (m, params.num_agents, 2)).astype(np.float32)
    ref_state, ref = jax.jit(jax_pursuit_step_batch, static_argnums=2)(
        state, jnp.asarray(vel), jp)
    fresh = reset_batch(params, m,
                        uniforms=jax_reset_uniforms(state.key, params))
    port_state, port = PURSUIT_SPEC.step_batch(
        to_port(state), torch.from_numpy(vel), params, fresh=fresh)
    assert np.asarray(ref.done).any()
    same(port.done, ref.done, "done")
    for field in ("agents", "steps"):
        same(getattr(port_state, field), getattr(ref_state, field), field)
    for field in ("goal", "obstacles"):
        close(getattr(port_state, field), getattr(ref_state, field), field)
    close(port.reward, ref.reward, "reward", reward_atol(params))
    assert set(port.metrics) == set(ref.metrics)
    for key in ref.metrics:
        close(port.metrics[key], ref.metrics[key], key,
              reward_atol(params) if key == "reward" else ATOL)
    if params.obs_mode == "knn":
        k = params.knn_k
        same(port.obs[..., -k:], ref.obs[..., -k:], "obs neighbor indices")
        close(port.obs[..., :-k], ref.obs[..., :-k], "obs")
    else:
        close(port.obs, ref.obs, "obs")


def test_pursuit_layout_and_require_goal_as_jax():
    params = PursuitParams(num_agents=3)
    layout = PURSUIT_SPEC.obs_layout(params)
    ref = JAX_PURSUIT_SPEC.obs_layout(jax_pursuit(params))
    assert layout.names() == ref.names() == ("self", "neighbor", "pursuer")
    assert layout.blocks == ref.blocks
    assert layout.require("pursuer") == formation_obs_layout(
        EnvParams(num_agents=3)).require("goal")
    knn = PursuitParams(num_agents=9, obs_mode="knn", knn_k=3)
    assert (PURSUIT_SPEC.obs_layout(knn).blocks
            == JAX_PURSUIT_SPEC.obs_layout(jax_pursuit(knn)).blocks)
    with pytest.raises(ValueError) as ours:
        layout.require("goal", needed_by="moving-goal layer")
    with pytest.raises(ValueError) as theirs:
        ref.require("goal", needed_by="moving-goal layer")
    assert str(ours.value) == str(theirs.value)
    assert "moving-goal layer" in str(ours.value)


def test_pursuit_params_validate_as_jax():
    for bad in ({"pursuer_speed": -1.0}, {"capture_radius": -2.0}):
        with pytest.raises(AssertionError):
            PursuitParams(**bad)
        with pytest.raises(AssertionError):
            JaxPursuitParams(**bad)
    assert ({f.name for f in dataclasses.fields(PursuitParams)}
            == {f.name for f in dataclasses.fields(JaxPursuitParams)})
    assert envs.registered_envs() == ("formation", "pursuit_evasion")
    assert spec_for_params(PursuitParams()) is PURSUIT_SPEC


def test_pursuit_metric_keys_match_formation():
    form = evaluate(zero_act_fn(), EnvParams(num_agents=3, max_steps=5), 2,
                    device="cpu")
    purs = evaluate(zero_act_fn(), PursuitParams(num_agents=3, max_steps=5),
                    2, device="cpu")
    assert set(form) == set(purs)
    assert all(np.isfinite(v) for v in purs.values())


# ---------------------------------------------------------------------------
# Scenario layers on pursuit
# ---------------------------------------------------------------------------

PURSUIT_SCEN = PursuitParams(num_agents=4, max_steps=5, num_obstacles=4)
SCENARIOS = tuple(n for n in registered_scenarios() if not n.startswith("adv:"))


def _drive(params, sp, m=16, steps=9):
    """Each step's state, obs, reward and done, clean (``sp`` None) or
    through the scenario step, from one seed (through a reset)."""
    gen = torch.Generator().manual_seed(0)
    state = PURSUIT_SPEC.reset_batch(params, m, gen, "cpu")
    streams = ScenarioStreams(torch.Generator().manual_seed(1))
    if sp is not None:
        state = init_scenario_state(state, params, streams)
        sp = broadcast_params(sp, m)
    vel = torch.randn((steps, m, params.num_agents, 2),
                      generator=torch.Generator().manual_seed(2)) * 5
    out = []
    for v in vel:
        if sp is None:
            state, tr = PURSUIT_SPEC.step_batch(state, v, params, gen)
        else:
            state, tr = scenario_step_batch(state, v, sp, params, gen,
                                            streams)
        out.append((state.agents, state.goal, state.obstacles, tr.obs,
                    tr.reward, tr.done))
    return out


@pytest.mark.parametrize("name", SCENARIOS)
def test_pursuit_severity_zero_is_bitwise_clean(name):
    clean = _drive(PURSUIT_SCEN, None)
    got = _drive(PURSUIT_SCEN, scenario_params_for(name, 0.0))
    for c_row, s_row in zip(clean, got):
        for c, s in zip(c_row, s_row):
            assert torch.equal(c, s), name


@pytest.mark.parametrize("name", [n for n in SCENARIOS if n != "clean"])
def test_pursuit_severity_one_perturbs(name):
    clean = _drive(PURSUIT_SCEN, None)
    got = _drive(PURSUIT_SCEN, scenario_params_for(name, 1.0))
    assert any(not torch.equal(c, s)
               for c_row, s_row in zip(clean, got)
               for c, s in zip(c_row, s_row)), name


# ---------------------------------------------------------------------------
# Training and the entry points
# ---------------------------------------------------------------------------

TRAIN_PARAMS = PursuitParams(num_agents=4, max_steps=12)
M = 4


def _trainer(tmp_path, name, **cfg):
    gen = torch.Generator().manual_seed(7)
    per_iter = 10 * M * TRAIN_PARAMS.num_agents
    config = dict(num_formations=M, total_timesteps=3 * per_iter, seed=7,
                  log_dir=str(tmp_path / name))
    config.update(cfg)
    return Trainer(TRAIN_PARAMS, PPOConfig(n_epochs=2, batch_size=80),
                   TrainConfig(**config),
                   model=MLPActorCritic(TRAIN_PARAMS.obs_dim, generator=gen),
                   device="cpu")


def test_pursuit_fused_chunk_equals_the_host_loop(tmp_path):
    host = _trainer(tmp_path, "host")
    host.train()
    fused = _trainer(tmp_path, "fused", fused_chunk=3)
    fused.train()

    def records(trainer):
        out = []
        for line in (Path(trainer.log_dir) / "metrics.jsonl").read_text(
                ).splitlines():
            r = json.loads(line)
            del r["time"], r["env_steps_per_sec"]
            out.append(r)
        return out

    assert records(fused) == records(host)
    assert "evade_reward" in records(host)[0]  # the pursuit step trained
    for a, b in zip(host.model.parameters(), fused.model.parameters()):
        assert torch.equal(a, b)
    assert torch.equal(host.obs, fused.obs)


def test_trainers_build_the_pursuit_state(tmp_path):
    """``Trainer`` and ``SweepTrainer`` resolve the env from the params
    type: their first carry is a pursuit reset with the pursuit spec's
    observation, and their rollout steps the pursuit env (its reward terms
    are in the records)."""
    trainer = _trainer(tmp_path, "single")
    assert trainer.env_spec is PURSUIT_SPEC
    models = [MLPActorCritic(TRAIN_PARAMS.obs_dim,
                             generator=torch.Generator().manual_seed(i))
              for i in range(2)]
    sweep = SweepTrainer(TRAIN_PARAMS, PPOConfig(n_epochs=1, batch_size=80),
                         TrainConfig(num_formations=M, seed=7,
                                     log_dir=str(tmp_path / "sweep"),
                                     total_timesteps=160),
                         2, models=models, device="cpu")
    for t_ in (trainer, sweep):
        env = t_._iteration.env
        assert env.agents.shape[-2] == TRAIN_PARAMS.num_agents
        assert torch.equal(PURSUIT_SPEC.obs(env, TRAIN_PARAMS), t_.obs)
    sweep.train()
    record = json.loads((Path(sweep.log_dir) / "metrics.jsonl").read_text()
                        .splitlines()[-1])
    assert "evade_reward" in record and "capture_penalty" in record


def test_train_and_evaluate_clis_accept_pursuit(tmp_path, monkeypatch):
    monkeypatch.setattr(train_cli, "repo_root", lambda: tmp_path)
    trainer = train_cli.main([
        "env=pursuit_evasion", "pursuer_speed=9.0", "capture_radius=25",
        "num_formation=4", "num_agents_per_formation=4", "max_steps=8",
        "total_timesteps=160", "device=cpu", "name=chase",
    ])
    assert type(trainer.env_params) is PursuitParams
    assert trainer.env_params.pursuer_speed == 9.0
    assert trainer.env_spec is PURSUIT_SPEC
    ckpt = max((tmp_path / "logs" / "chase").glob("rl_model_*.msgpack"))
    res = evaluate_cli.main([
        f"checkpoint={ckpt}", "env=pursuit_evasion", "pursuer_speed=9.0",
        "num_agents_per_formation=4", "eval_formations=2", "max_steps=8",
        "device=cpu",
    ])
    assert all(np.isfinite(v) for v in res.values()
               if isinstance(v, float))


def test_config_selects_pursuit_and_validates_env_aware():
    """``env=pursuit_evasion`` builds ``PursuitParams`` with its knobs, as
    the JAX package's config does; its knobs validate only under it."""
    cfg = config.load_config(["env=pursuit_evasion", "pursuer_speed=9.0"])
    params = config.env_params_from_config(cfg)
    want = jconfig.env_params_from_config(jconfig.load_config(
        ["env=pursuit_evasion", "pursuer_speed=9.0"]))
    assert type(params) is PursuitParams
    assert dataclasses.asdict(params) == dataclasses.asdict(want)
    config.validate_override_keys(["env=pursuit_evasion",
                                   "capture_radius=25"])
    with pytest.raises(SystemExit, match="capture_radius"):
        config.validate_override_keys(["capture_radius=25"])
    with pytest.raises(SystemExit, match="pursuit_evasion"):
        config.validate_override_keys(["env=pursuit_evsion"])


def test_pursuit_gnn_episode_is_finite_through_the_knn_obs():
    params = PursuitParams(num_agents=10, obs_mode="knn", knn_k=3,
                           max_steps=6)
    from marl_distributedformation_tpu_torch.eval import policy_act_fn

    model = GNNActorCritic(k=3, generator=torch.Generator().manual_seed(0))
    out = evaluate(policy_act_fn(model, params), params, 3, device="cpu")
    assert out["episodes"] == 3 and all(np.isfinite(v) for v in out.values())
