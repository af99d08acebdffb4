"""The port's curriculum (``train/curriculum.py``) and its populations
(``train/hetero_sweep.py``) on the CPU: the stage dataclasses against the
JAX package's, one curriculum iteration per policy against the JAX
package's ``make_hetero_iteration`` with its resets, noise and
permutations injected, the trainer's records and checkpoints against the
JAX trainer's, resume, and members against single runs (fused dispatch,
mid-stage resume, identity refusals, JAX anchors and files, and both
published commands through the CLIs are in
``test_torch_curriculum_runs.py``).

Tolerances, and why:

- the injected iteration: ``tests/test_torch_trainer.py``'s (params
  within ``tests/adam_budget.py::adam_parity_atol``, ``mu``/``nu`` within
  it relative to each leaf's largest value, Adam ``count``, env steps,
  counts and ``episode_dones`` exact, the rollout's metrics ``rtol=1e-4``,
  the update's ``trajectory_rtol``);
- a population of one against ``HeteroTrainer``, fused against the host
  loop, and resumes: bitwise (the same operations in the same order);
- a member of K = 2 against ``HeteroTrainer(seed + i)``: ``tests/
  test_torch_sweep.py``'s (params within ``adam_parity_atol``, generators,
  counters and counts exact; the population runs each layer once for both
  members, which rounds differently in the last bit);
- records and checkpoints against the JAX trainer's: keys and step stamps
  exact.
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.training.train_state import TrainState

from adam_budget import adam_parity_atol, trajectory_rtol, updates_per_run
from marl_distributedformation_tpu.compat.policy import load_checkpoint_raw
from marl_distributedformation_tpu.env.hetero import (
    hetero_compute_obs as jax_hetero_compute_obs,
)
from marl_distributedformation_tpu.train import TrainConfig as JaxTrainConfig
from marl_distributedformation_tpu.train.curriculum import (
    Curriculum as JaxCurriculum,
    CurriculumStage as JaxStage,
    HeteroTrainer as JaxHeteroTrainer,
    curriculum_from_cfg as jax_curriculum_from_cfg,
    make_hetero_iteration as jax_make_hetero_iteration,
)
from marl_distributedformation_tpu_torch.algo import PPOConfig, adam_init
from marl_distributedformation_tpu_torch.compat.convert import (
    opt_state_to_jax,
    params_to_jax,
)
from marl_distributedformation_tpu_torch.env import (
    EnvParams,
    hetero_step_batch,
    reset_batch,
)
from marl_distributedformation_tpu_torch.models import (
    CTDEActorCritic,
    MLPActorCritic,
)
from marl_distributedformation_tpu_torch.train import TrainConfig
from marl_distributedformation_tpu_torch.train.curriculum import (
    Curriculum,
    CurriculumStage,
    HeteroTrainer,
    curriculum_from_cfg,
    make_hetero_iteration,
    sample_stage_counts,
)
from marl_distributedformation_tpu_torch.train.hetero_sweep import (
    HeteroSweepTrainer,
)
from test_torch_algo import (
    _configs,
    _jax_permutations,
    _pair,
    assert_tree_close,
    jax_rollout_noise,
    t,
)
from test_torch_ctde import ctde_pair
from test_torch_env import jax_params, jax_reset_uniforms
from test_torch_hetero import _jax_reset, to_port_hetero
from test_torch_models import np_tree
from test_torch_sweep import _records

LR = 1e-3
POLICIES = {"mlp": "MLPActorCritic", "ctde": "CTDEActorCritic"}
# Stage 0 of 3-agent formations, stage 1 mixing 3 and 5 with 2 obstacles:
# N_max = 5, K_max = 2; stage 0 has a fixed active count.
CUR = Curriculum((CurriculumStage(3, (3,)),
                  CurriculumStage(2, (3, 5), num_obstacles=2)))
PPO = PPOConfig(n_steps=4, batch_size=20, n_epochs=2)
M = 4
STAGE0_ITER = PPO.n_steps * M * 3  # active agent-transitions an iteration


def _model(kind, seed):
    gen = torch.Generator().manual_seed(seed)
    if kind == "mlp":
        return MLPActorCritic(8, generator=gen)
    return CTDEActorCritic(8, generator=gen)


def _config(tmp_path, name, **kw):
    base = dict(num_formations=M, seed=0, checkpoint=False, name=name,
                log_dir=str(tmp_path / name))
    base.update(kw)
    return TrainConfig(**base)


def _single(tmp_path, kind="mlp", seed=0, name=None, cur=CUR, **kw):
    return HeteroTrainer(cur, EnvParams(num_agents=3), PPO,
                         _config(tmp_path, name or f"single{seed}", seed=seed,
                                 **kw),
                         model=_model(kind, seed), device="cpu")


def _sweep(tmp_path, kind="mlp", k=2, name="pop", cur=CUR, **kw):
    seed = kw.get("seed", 0)
    return HeteroSweepTrainer(
        cur, EnvParams(num_agents=3), PPO, _config(tmp_path, name, **kw), k,
        models=[_model(kind, seed + i) for i in range(k)], device="cpu")


# ---------------------------------------------------------------------------
# Stages and counts
# ---------------------------------------------------------------------------

SPEC = ("[{rollouts: 30, agent_counts: [5]},\n"
        " {rollouts: 40, agent_counts: [5, 5, 20]},\n"
        " {rollouts: 30, agent_counts: [5, 5, 20], num_obstacles: 4},\n"
        " {rollouts: 100, agent_counts: [5, 20], probs: [0.75, 0.25],"
        " num_obstacles: 4}]")


def test_curriculum_and_its_yaml_as_jax():
    cur, jcur = curriculum_from_cfg(SPEC), jax_curriculum_from_cfg(SPEC)
    assert [dataclasses.astuple(s) for s in cur.stages] == [
        dataclasses.astuple(s) for s in jcur.stages]
    for c, j in ((cur, jcur), (Curriculum(), JaxCurriculum())):
        assert (c.max_agents, c.max_obstacles, c.total_rollouts) == (
            j.max_agents, j.max_obstacles, j.total_rollouts)
    assert cur.stage_ends() == (30, 70, 100, 200)
    # The parsed list the CLI hands over, as the quoted YAML text.
    import yaml

    assert curriculum_from_cfg(yaml.safe_load(SPEC)) == cur
    for bad in (dict(rollouts=0, agent_counts=(3,)),
                dict(rollouts=1, agent_counts=()),
                dict(rollouts=1, agent_counts=(1, 3)),
                dict(rollouts=1, agent_counts=(3,), probs=(0.5, 0.5))):
        with pytest.raises(AssertionError):
            JaxStage(**bad)
        with pytest.raises(ValueError):
            CurriculumStage(**bad)


def test_stage_counts_from_the_generator():
    gen = torch.Generator().manual_seed(1)
    stage = CurriculumStage(1, (3, 5, 20), num_obstacles=2)
    n, k = sample_stage_counts(gen, stage, 600, "cpu")
    assert n.dtype == k.dtype == torch.int32
    assert set(n.tolist()) == {3, 5, 20} and set(k.tolist()) == {2}
    # Uniform over the entries: a repeated count doubles its share.
    n, _ = sample_stage_counts(gen, CurriculumStage(1, (5, 5, 20)), 3000,
                               "cpu")
    assert abs(float((n == 5).float().mean()) - 2 / 3) < 0.05
    n, _ = sample_stage_counts(gen, CurriculumStage(
        1, (5, 20), probs=(0.9, 0.1)), 3000, "cpu")
    assert abs(float((n == 5).float().mean()) - 0.9) < 0.03
    n, _ = sample_stage_counts(gen, CurriculumStage(
        1, (5, 20), probs=(0.0, 2.0)), 50, "cpu")
    assert set(n.tolist()) == {20}
    again = torch.Generator().manual_seed(1)
    first = sample_stage_counts(again, stage, 600, "cpu")[0]
    assert torch.equal(first, sample_stage_counts(
        torch.Generator().manual_seed(1), stage, 600, "cpu")[0])


# ---------------------------------------------------------------------------
# One curriculum iteration against the JAX package's
# ---------------------------------------------------------------------------


def injected_hetero_step(jstate, params):
    """An ``env_step_fn`` that resets done formations to the states the JAX
    package draws from their keys (``test_torch_algo.injected_env_step``
    for padded formations)."""
    keys = [jstate.key]
    m = jstate.key.shape[0]

    def step(state, velocity):
        fresh = reset_batch(params, m, uniforms=jax_reset_uniforms(
            keys[0], params))
        state, tr = hetero_step_batch(state, velocity, params, fresh=fresh)
        new = jax.vmap(lambda k: jax.random.split(k, 4)[0])(keys[0])
        keys[0] = jnp.where(jnp.asarray(tr.done.numpy())[:, None], new,
                            keys[0])
        return state, tr

    return step


@pytest.mark.parametrize("kind", sorted(POLICIES))
def test_curriculum_iteration_injected_matches_jax(kind):
    params = EnvParams(num_agents=5, num_obstacles=2, max_steps=4)
    jp = jax_params(params)
    per_formation = kind == "ctde"
    jmodel, jvars, model, policy = (ctde_pair(8) if per_formation
                                    else _pair("mlp"))
    counts = np.array([3, 5, 2, 4], np.int32)
    obstacles = np.array([0, 2, 1, 2], np.int32)
    batch_size = 20
    jcfg, cfg = _configs(n_epochs=2, batch_size=batch_size)
    jstate = _jax_reset(jax.random.PRNGKey(41), params, counts, obstacles)
    jobs = jax.vmap(jax_hetero_compute_obs, in_axes=(0, None))(jstate, jp)
    ts = TrainState.create(apply_fn=jmodel.apply, params=jvars,
                           tx=jcfg.make_optimizer())
    key = jax.random.PRNGKey(42)
    iteration = jax.jit(jax_make_hetero_iteration(jp, jcfg, per_formation))
    ts, jend, jlast_obs, _, jmetrics = iteration(ts, jstate, jobs, key)

    _, k_roll, k_update = jax.random.split(key, 3)
    m, n = len(counts), params.num_agents
    rows = cfg.n_steps * m * (1 if per_formation else n)
    mb = batch_size // n if per_formation else batch_size
    state = adam_init(dict(model.named_parameters()))
    step, end, last_obs, metrics = make_hetero_iteration(
        params, cfg, per_formation,
        env_step_fn=injected_hetero_step(jstate, params))(
        model, state, 0, to_port_hetero(jstate), t(jobs), None,
        noise=jax_rollout_noise(k_roll, cfg.n_steps, (m, n, 2)),
        permutations=_jax_permutations(k_update, 2, rows, rows // mb * mb),
    )
    updates = 2 * (rows // mb)
    assert step == updates == int(ts.step)
    atol = adam_parity_atol(LR, updates)
    got = params_to_jax(dict(model.named_parameters()), policy)
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(np_tree(ts.params))):
        np.testing.assert_allclose(a, b, rtol=0, atol=atol)
    from flax import serialization

    jopt = serialization.to_state_dict(ts.opt_state)["1"]["0"]
    popt = opt_state_to_jax(vars(state), policy)["1"]["0"]
    assert int(popt["count"]) == int(jopt["count"]) == updates
    for moment in ("mu", "nu"):
        assert_tree_close(popt[moment], np_tree(jopt[moment]), rtol=0,
                          floor=atol, what=moment)
    for field in ("steps", "n_agents", "n_obstacles"):
        np.testing.assert_array_equal(getattr(end, field).numpy(),
                                      np.asarray(getattr(jend, field)))
    np.testing.assert_array_equal(
        (last_obs.numpy() == 0).all(-1), (np.asarray(jlast_obs) == 0).all(-1))
    assert set(metrics) == set(jmetrics)
    assert float(metrics["episode_dones"]) == float(jmetrics["episode_dones"])
    assert float(jmetrics["episode_dones"]) == m  # one reset each, not x N
    update_keys = {"loss", "policy_loss", "value_loss", "entropy",
                   "approx_kl", "clip_fraction", "grad_norm"}
    for k in jmetrics:
        rtol = (trajectory_rtol(LR, updates) if k in update_keys else 1e-4)
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]),
                                   rtol=rtol, atol=1e-6, err_msg=k)


# ---------------------------------------------------------------------------
# The single curriculum run
# ---------------------------------------------------------------------------


def _state(trainer):
    """A trainer's learner, generators, env carry and counts as tensors."""
    it = trainer._iteration
    gens = getattr(trainer, "generators", None) or [trainer.generator]
    named = (trainer.model.params.items() if hasattr(trainer.model, "params")
             else trainer.model.named_parameters())
    return {
        **{f"p {k}": v.detach().clone() for k, v in named},
        **{f"mu {k}": v.clone() for k, v in trainer.opt_state.mu.items()},
        "count": trainer.opt_state.count.clone(), "step": it.step.clone(),
        "agents": it.env.agents.clone(), "obstacles": it.env.obstacles.clone(),
        "obs": it.obs.clone(), "n_agents": it.layout.n_agents.clone(),
        "gens": torch.stack([g.get_state() for g in gens]),
    }


def test_records_and_checkpoints_carry_the_jax_trainers_keys(tmp_path):
    """The same curriculum (fixed counts a stage, so the step stamps are
    exact) through the JAX package's ``HeteroTrainer`` and the port's:
    record keys, ``num_timesteps`` stamps of active agents,
    ``curriculum_stage``, and the checkpoint's keys."""
    cur = Curriculum((CurriculumStage(2, (3,)),
                      CurriculumStage(1, (4,), num_obstacles=1)))
    jcur = JaxCurriculum(tuple(JaxStage(**dataclasses.asdict(s))
                               for s in cur.stages))
    trainer = _single(tmp_path, cur=cur, checkpoint=True)
    trainer.train()
    from marl_distributedformation_tpu.algo import PPOConfig as JaxPPOConfig

    jdir = tmp_path / "jax"
    JaxHeteroTrainer(jcur, jax_params(EnvParams(num_agents=3)),
                     JaxPPOConfig(**dataclasses.asdict(PPO)),
                     JaxTrainConfig(num_formations=M, log_dir=str(jdir),
                                    checkpoint=True)).train()
    ours, theirs = _records(trainer.log_dir), _records(jdir)
    steps = [4 * M * 3, 8 * M * 3, 8 * M * 3 + 4 * M * 4]
    assert [r["step"] for r in ours] == [r["step"] for r in theirs] == steps
    assert [r["curriculum_stage"] for r in ours] == [0.0, 0.0, 1.0]
    assert set(ours[0]) == set(theirs[0])
    assert [r["num_active_agents"] for r in ours] == [3.0, 3.0, 4.0]
    name = f"rl_model_{steps[-1]}_steps.msgpack"
    raw, jraw = (load_checkpoint_raw(Path(d) / name)
                 for d in (trainer.log_dir, jdir))
    assert set(jraw) - set(raw) == {"key"}  # the port's stream is torch_
    assert raw["completed_rollouts"] == jraw["completed_rollouts"] == 3
    assert raw["policy"] == jraw["policy"] == "MLPActorCritic"


def test_resume_past_a_stage_equals_the_uninterrupted_run(tmp_path):
    """A run stopped by its cap at the end of stage 0 and resumed skips
    the stage and equals the uninterrupted run bitwise; a run stopped
    mid-stage restarts the partial stage afresh (new counts, new reset),
    as the JAX package's trainer does."""
    full = _single(tmp_path, "ctde", name="full", checkpoint=True)
    full.train()
    part = _single(tmp_path, "ctde", name="part", checkpoint=True,
                   total_timesteps=3 * STAGE0_ITER)
    part.train()
    assert part.completed_rollouts == 3
    resumed = _single(tmp_path, "ctde", name="part", checkpoint=True,
                      resume=True)
    assert resumed.completed_rollouts == 3
    assert resumed.num_timesteps == 3 * STAGE0_ITER
    resumed.train()
    assert resumed.completed_rollouts == full.completed_rollouts == 5
    a, b = _state(full), _state(resumed)
    for key in a:
        assert torch.equal(a[key], b[key]), key
    assert resumed.num_timesteps == full.num_timesteps

    mid = _single(tmp_path, "ctde", name="mid", checkpoint=True,
                  total_timesteps=STAGE0_ITER)
    mid.train()
    again = _single(tmp_path, "ctde", name="mid", checkpoint=True,
                    resume=True)
    again.train()
    assert again.completed_rollouts == 5
    assert not torch.equal(_state(again)["gens"], a["gens"])


def test_single_run_refuses_fusion_as_jax(tmp_path):
    from marl_distributedformation_tpu.algo import PPOConfig as JaxPPOConfig

    for kw in (dict(fused_chunk=2), dict(iters_per_dispatch=2)):
        with pytest.raises(SystemExit) as jerr:
            JaxHeteroTrainer(JaxCurriculum(), jax_params(EnvParams()),
                             JaxPPOConfig(), JaxTrainConfig(checkpoint=False,
                                                            **kw))
        with pytest.raises(SystemExit) as err:
            _single(tmp_path, **kw)
        assert str(err.value) == str(jerr.value)


# ---------------------------------------------------------------------------
# Populations of the curriculum
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", sorted(POLICIES))
def test_population_of_one_is_the_single_run_bitwise(tmp_path, kind):
    single = _single(tmp_path, kind)
    single.train()
    sweep = _sweep(tmp_path, kind, k=1)
    sweep.train()
    a, b = _state(single), _state(sweep)
    for key in a:
        assert torch.equal(a[key].reshape(b[key].shape), b[key]), key
    assert sweep.num_timesteps_members.tolist() == [single.num_timesteps]
    assert sweep.completed_rollouts == single.completed_rollouts == 5
    assert single.last_record["reward"] == sweep.last_record["reward"]


@pytest.mark.parametrize("kind", sorted(POLICIES))
def test_member_equals_the_single_run(tmp_path, kind):
    sweep = _sweep(tmp_path, kind, k=2)
    sweep.train()
    per_formation = kind == "ctde"
    rows = PPO.n_steps * M * (1 if per_formation else 5)
    batch = PPO.batch_size // 5 if per_formation else PPO.batch_size
    updates = updates_per_run(dataclasses.replace(PPO, batch_size=batch),
                              rows, 5)
    atol = adam_parity_atol(LR, updates)
    for i in range(2):
        single = _single(tmp_path, kind, seed=i)
        single.train()
        assert torch.equal(sweep.generators[i].get_state(),
                           single.generator.get_state())
        assert sweep.num_timesteps_members[i] == single.num_timesteps
        own = slice(i * M, (i + 1) * M)
        assert torch.equal(sweep.layout.n_agents[own],
                           single.layout.n_agents)
        for k, p in single.model.named_parameters():
            np.testing.assert_allclose(sweep.model.params[k][i].detach(),
                                       p.detach(), rtol=0, atol=atol,
                                       err_msg=k)
        assert int(sweep.opt_state.count[i]) == int(single.opt_state.count)
    # The members drew their own mixes.
    assert sweep.num_timesteps_members[0] != sweep.num_timesteps_members[1]
    assert sweep.num_timesteps == int(sweep.num_timesteps_members.max())
