"""The port's CTDE actor-critic (``models/ctde.py``) against the JAX package
on the CPU: forward and gradients with and without a padding mask, the
deep set's permutation equivariance, padded agents' values, parameter
names both ways, checkpoints both ways, the population's stacked CTDE and
one training iteration with the JAX package's draws injected.

Tolerances, and why:

- forward ``(mean, log_std, value)``: ``atol=1e-6`` plus ``rtol=1e-5``
  (PyTorch and XLA sum the matmuls and the pool in different orders);
- gradients: ``rtol=1e-5`` plus ``1e-6`` of each leaf's largest gradient;
- permutation equivariance and padded values: exact where the math is
  exact (a padded agent's value is 0, a padded agent's inputs do not reach
  the others), ``atol=1e-6`` for the pool of a permuted formation (its sum
  runs in another order);
- a population of one: bitwise its single model; of two: each member
  within the forward tolerance (one batched matmul for both members);
- the injected iteration: ``tests/test_torch_trainer.py``'s tolerances
  (params within ``adam_parity_atol``, rollout metrics ``rtol=1e-4``, the
  update's ``trajectory_rtol``);
- checkpoints: trees bitwise; the JAX package's eval of a port-written
  checkpoint within ``tests/test_torch_eval.py``'s ``FREE_RUN_RTOL``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.training.train_state import TrainState

from adam_budget import adam_parity_atol, trajectory_rtol
from marl_distributedformation_tpu.compat.policy import (
    LoadedPolicy as JaxLoadedPolicy,
    load_checkpoint_raw,
)
from marl_distributedformation_tpu.env.formation import (
    compute_obs as jax_compute_obs,
    reset_batch as jax_reset_batch,
)
from marl_distributedformation_tpu.eval import (
    evaluate_checkpoint as jax_evaluate_checkpoint,
    policy_act_fn as jax_policy_act_fn,
)
from marl_distributedformation_tpu.models import CTDEActorCritic as JaxCTDE
from marl_distributedformation_tpu.train.trainer import (
    make_ppo_iteration as jax_make_ppo_iteration,
)
from marl_distributedformation_tpu.utils.checkpoint import (
    save_checkpoint as jax_save_checkpoint,
)
from marl_distributedformation_tpu_torch.algo import PPOConfig, adam_init
from marl_distributedformation_tpu_torch.compat.convert import (
    opt_state_to_jax,
    params_from_jax,
    params_to_jax,
)
from marl_distributedformation_tpu_torch.compat.policy import (
    LoadedPolicy,
    build_model,
    infer_hidden,
)
from marl_distributedformation_tpu_torch.env import EnvParams
from marl_distributedformation_tpu_torch.eval import policy_act_fn
from marl_distributedformation_tpu_torch.models import CTDEActorCritic
from marl_distributedformation_tpu_torch.models.population import (
    PopulationModel,
)
from marl_distributedformation_tpu_torch.train import (
    TrainConfig,
    Trainer,
    make_ppo_iteration,
)
from marl_distributedformation_tpu_torch.utils.checkpoint import (
    checkpoint_path,
)
from test_torch_algo import (
    _configs,
    _jax_permutations,
    assert_tree_close,
    injected_env_step,
    jax_rollout_noise,
    t,
)
from test_torch_checkpoint import assert_trees_equal
from test_torch_env import jax_params, to_port
from test_torch_eval import _free_run
from test_torch_models import np_tree

ATOL, RTOL = 1e-6, 1e-5
N, OBS_DIM = 6, 8
POLICY = "CTDEActorCritic"


def ctde_pair(seed=1, **kwargs):
    """A JAX CTDE model with its variables and the port's holding them."""
    jmodel = JaxCTDE(**kwargs)
    jvars = jmodel.init(jax.random.PRNGKey(seed), jnp.zeros((1, N, OBS_DIM)))
    model = CTDEActorCritic(obs_dim=OBS_DIM, **kwargs)
    model.load_state_dict(params_from_jax(np_tree(jvars), POLICY))
    return jmodel, jvars, model, POLICY


def ctde_rows(b, seed):
    """Minibatch rows of ``b`` whole formations of N agents."""
    rng = np.random.default_rng(seed)
    lead = (b, N)
    return dict(
        obs=rng.normal(size=(b, N, OBS_DIM)).astype(np.float32),
        actions=rng.normal(size=(*lead, 2)).astype(np.float32),
        old_log_probs=(rng.normal(size=lead) - 2.5).astype(np.float32),
        advantages=(rng.normal(size=lead) * 3).astype(np.float32),
        returns=(rng.normal(size=lead) * 20).astype(np.float32),
    )


def _mask(m, seed=3):
    counts = np.random.default_rng(seed).integers(2, N + 1, m)
    counts[0] = N
    return np.arange(N)[None] < counts[:, None]


def _outputs_close(port, ref):
    for p, r, name in zip(port, ref, ("mean", "log_std", "value")):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(r),
                                   atol=ATOL, rtol=RTOL, err_msg=name)


CASES = {
    "default": {},
    "narrow": {"hidden": (32,), "embed_dim": 16, "log_std_init": -0.5},
}


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_and_gradients_match_jax(case, masked):
    kwargs = CASES[case]
    jmodel, jvars, model, _ = ctde_pair(2, **kwargs)
    obs = ctde_rows(4, seed=5)["obs"]
    mask = _mask(4) if masked else None
    jmask = None if mask is None else jnp.asarray(mask)
    ref = jmodel.apply(jvars, jnp.asarray(obs), jmask)
    pmask = None if mask is None else torch.from_numpy(mask)
    port = model(t(obs), pmask)
    _outputs_close(port, ref)

    # Gradients of a scalar that reads every output.
    rng = np.random.default_rng(6)
    cm = rng.normal(size=(4, N, 2)).astype(np.float32)
    cv = rng.normal(size=(4, N)).astype(np.float32)

    def jscalar(v):
        mean, log_std, value = jmodel.apply(v, jnp.asarray(obs), jmask)
        return (mean * cm).sum() + (value * cv).sum() + log_std.sum()

    jgrads = jax.grad(jscalar)(jvars)
    mean, log_std, value = port
    scalar = (mean * t(cm)).sum() + (value * t(cv)).sum() + log_std.sum()
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(scalar, list(model.parameters()))
    assert_tree_close(params_to_jax(dict(zip(names, grads)), POLICY),
                      np_tree(jgrads), rtol=RTOL, floor=ATOL, what="grads")


def test_permutation_equivariance_and_padded_values():
    _, _, model, _ = ctde_pair(3)
    obs = t(ctde_rows(3, seed=7)["obs"])
    mask = torch.from_numpy(_mask(3, seed=8))
    mean, _, value = model(obs, mask)
    # Padded agents' values are exactly 0.
    assert bool((value[~mask] == 0).all())
    assert bool((value[mask] != 0).all())
    # Whatever a padded agent observes reaches no active agent.
    junk = obs.clone()
    junk[~mask] = 1e3
    mean2, _, value2 = model(junk, mask)
    assert torch.equal(value2[mask], value[mask])
    assert torch.equal(mean2[mask], mean[mask])
    # Relabelling the agents relabels the outputs (a deep set: the pool is
    # invariant, the rest per agent).
    perm = torch.randperm(N, generator=torch.Generator().manual_seed(0))
    pm, _, pv = model(obs[:, perm], mask[:, perm])
    np.testing.assert_allclose(pm.detach().numpy(),
                               mean[:, perm].detach().numpy(), atol=ATOL)
    np.testing.assert_allclose(pv.detach().numpy(),
                               value[:, perm].detach().numpy(), atol=ATOL)
    # Centralized: moving another agent changes an agent's value, never its
    # action mean.
    moved = obs.clone()
    moved[:, 1] += 0.5
    mm, _, mv = model(moved, None)
    m0, _, v0 = model(obs, None)
    assert torch.equal(mm[:, 0], m0[:, 0])
    assert not torch.equal(mv[:, 0], v0[:, 0])


def test_names_round_trip_and_registry():
    jmodel, jvars, model, _ = ctde_pair(4, hidden=(32, 16), embed_dim=24)
    tree = np_tree(jvars)
    assert_trees_equal(params_to_jax(params_from_jax(tree, POLICY), POLICY),
                       tree)
    assert infer_hidden(tree["params"], POLICY) == (32, 16)
    built = build_model(POLICY, tree["params"])
    assert isinstance(built, CTDEActorCritic)
    obs = ctde_rows(2, seed=9)["obs"]
    with torch.no_grad():
        _outputs_close(built(t(obs)), jmodel.apply(jvars, jnp.asarray(obs)))
    with pytest.raises(ValueError, match="no layer"):
        params_from_jax({"params": {"pi_0": {}}}, POLICY)


def _ctde_trainer(tmp_path, **kw):
    params = EnvParams(num_agents=N)
    cfg = dict(num_formations=3, total_timesteps=3 * N * 10, seed=5,
               log_dir=str(tmp_path))
    cfg.update(kw)
    model = CTDEActorCritic(params.obs_dim,
                            generator=torch.Generator().manual_seed(5))
    return Trainer(params, PPOConfig(n_epochs=2, batch_size=2 * N),
                   TrainConfig(**cfg), model=model, device="cpu")


def test_jax_package_reads_a_port_ctde_checkpoint(tmp_path):
    trainer = _ctde_trainer(tmp_path)
    trainer.train()
    path = checkpoint_path(tmp_path, trainer.num_timesteps)
    raw = load_checkpoint_raw(path)
    assert raw["policy"] == POLICY
    assert_trees_equal(raw["params"], params_to_jax(
        dict(trainer.model.named_parameters()), POLICY))
    params = EnvParams(num_agents=N, max_steps=20)
    jpol = JaxLoadedPolicy.from_checkpoint(path)
    _free_run(
        params,
        jax_policy_act_fn(jpol.model, jpol.params, jax_params(params)),
        policy_act_fn(trainer.model.eval(), params),
        m=3,
    )
    # evaluate.py's path, at another N: a per-formation policy of any size.
    out = jax_evaluate_checkpoint(str(path), jax_params(
        EnvParams(num_agents=9, max_steps=20)), num_formations=2)
    assert all(np.isfinite(v) for v in out.values())


def test_port_reads_a_jax_ctde_checkpoint(tmp_path):
    jmodel, jvars, _, _ = ctde_pair(6)
    jax_save_checkpoint(tmp_path, 77, {"policy": POLICY, "params": jvars,
                                       "num_timesteps": 77})
    path = checkpoint_path(tmp_path, 77)
    pol = LoadedPolicy.from_checkpoint(path, device="cpu",
                                       env_params=EnvParams(num_agents=N))
    jpol = JaxLoadedPolicy.from_checkpoint(path)
    obs = ctde_rows(2, seed=10)["obs"].reshape(-1, OBS_DIM)
    got, _ = pol.predict(obs)
    ref, _ = jpol.predict(obs.reshape(2, N, OBS_DIM))
    np.testing.assert_allclose(got, np.asarray(ref).reshape(got.shape),
                               atol=ATOL, rtol=RTOL)


def test_population_of_ctde_members():
    """Stacked CTDE members under ``vmap`` (``MemberLinear`` dense layers,
    the masked pool per member): a population of one is its model
    bitwise, with and without the mask; of two, each member its own."""
    models = [CTDEActorCritic(OBS_DIM,
                              generator=torch.Generator().manual_seed(s))
              for s in (0, 1)]
    obs = t(ctde_rows(6, seed=11)["obs"]).reshape(2, 3, N, OBS_DIM)
    mask = torch.from_numpy(_mask(6, seed=12)).reshape(2, 3, N)
    one = PopulationModel(models[:1])
    for m in (None, mask[:1]):
        args = () if m is None else (m,)
        got = one(obs[:1], *args)
        want = models[0](obs[0], *(() if m is None else (m[0],)))
        for g, w in zip(got, want):
            assert torch.equal(g[0], w)
    pop = PopulationModel(models)
    got = pop(obs, mask)
    for i, model in enumerate(models):
        want = model(obs[i], mask[i])
        for g, w in zip(got, want):
            np.testing.assert_allclose(g[i].detach().numpy(),
                                       w.detach().numpy(), atol=ATOL,
                                       rtol=RTOL)
        assert bool((got[2][i][~mask[i]] == 0).all())
    # The rollout's forward over the members' formations, with the mask.
    mean, log_std, value = pop.rollout_forward(
        obs.reshape(6, N, OBS_DIM), mask.reshape(6, N))
    assert mean.shape == (6, N, 2) and value.shape == (6, N)
    assert torch.equal(value, got[2].reshape(6, N))


def test_ctde_iteration_injected_matches_jax():
    """One whole-formation iteration of the CTDE model on the homogeneous
    env (BASELINE config 3's path) with the JAX package's noise, resets and
    permutations injected."""
    params = EnvParams(num_agents=N, max_steps=4)
    jp = jax_params(params)
    jmodel, jvars, model, _ = ctde_pair(7)
    batch_size = 2 * N  # two formations a minibatch
    jcfg, cfg = _configs(n_epochs=2, batch_size=batch_size)
    m = 4
    jstate = jax_reset_batch(jax.random.PRNGKey(31), jp, m)
    jobs = jax_compute_obs(jstate.agents, jstate.goal, jp)
    ts = TrainState.create(apply_fn=jmodel.apply, params=jvars,
                           tx=jcfg.make_optimizer())
    key = jax.random.PRNGKey(32)
    iteration = jax.jit(jax_make_ppo_iteration(jp, jcfg, True))
    ts, jend, _, _, jmetrics = iteration(ts, jstate, jobs, key)

    _, k_roll, k_update = jax.random.split(key, 3)
    rows = cfg.n_steps * m
    mb = batch_size // N
    state = adam_init(dict(model.named_parameters()))
    step, end, _, metrics = make_ppo_iteration(
        params, cfg, True, env_step_fn=injected_env_step(jstate, params))(
        model, state, 0, to_port(jstate), t(jobs), None,
        noise=jax_rollout_noise(k_roll, cfg.n_steps, (m, N, 2)),
        permutations=_jax_permutations(k_update, 2, rows, rows // mb * mb),
    )
    updates = 2 * (rows // mb)
    assert step == updates == int(ts.step)
    atol = adam_parity_atol(cfg.learning_rate, updates)
    got = params_to_jax(dict(model.named_parameters()), POLICY)
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(np_tree(ts.params))):
        np.testing.assert_allclose(a, b, rtol=0, atol=atol)
    popt = opt_state_to_jax(vars(state), POLICY)["1"]["0"]
    assert int(popt["count"]) == updates
    np.testing.assert_array_equal(end.steps.numpy(), np.asarray(jend.steps))
    assert set(metrics) == set(jmetrics)
    update_keys = {"loss", "policy_loss", "value_loss", "entropy",
                   "approx_kl", "clip_fraction", "grad_norm"}
    for k in jmetrics:
        rtol = (trajectory_rtol(cfg.learning_rate, updates)
                if k in update_keys else 1e-4)
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]),
                                   rtol=rtol, atol=1e-6, err_msg=k)


def test_trainer_resume_of_a_ctde_run_is_bitwise(tmp_path):
    full = _ctde_trainer(tmp_path / "full", total_timesteps=2 * N * 30)
    full.train()
    part = _ctde_trainer(tmp_path / "part", total_timesteps=N * 30)
    part.train()
    resumed = _ctde_trainer(tmp_path / "part", total_timesteps=2 * N * 30,
                            resume=True)
    resumed.train()
    for (k, a), b in zip(full.model.named_parameters(),
                         resumed.model.parameters()):
        assert torch.equal(a, b), k
    assert torch.equal(full.generator.get_state(),
                       resumed.generator.get_state())


def test_cli_builds_ctde_runs_and_populations(tmp_path, monkeypatch):
    """``policy=ctde`` through the train CLI honours ``hidden_sizes`` (the
    JAX package's ``build_model``), and with ``num_seeds`` trains a
    population of CTDE members (stacked, with or without a curriculum),
    member i initialised from ``seed + i``."""
    from marl_distributedformation_tpu_torch.train import cli as train_cli
    from marl_distributedformation_tpu_torch.train.sweep import SweepTrainer
    from marl_distributedformation_tpu_torch.utils.config import load_config

    monkeypatch.setattr(train_cli, "repo_root", lambda: tmp_path)
    common = ["policy=ctde", "num_formation=2", "num_agents_per_formation=4",
              "device=cpu"]
    single = train_cli.build_trainer(["hidden_sizes=[32,16]", *common])
    assert isinstance(single.model, CTDEActorCritic)
    assert infer_hidden(params_to_jax(dict(single.model.named_parameters()),
                                      POLICY)["params"], POLICY) == (32, 16)
    assert single.model.critic.vf_0.out_features == 32
    pop = train_cli.build_trainer(["num_seeds=2", *common])
    assert isinstance(pop, SweepTrainer) and pop.policy == POLICY
    cfg = load_config(common[:-1])
    for i in range(2):
        member = train_cli.build_model(cfg, pop.env_params, "ctde", seed=i)
        for k, p in member.named_parameters():
            assert torch.equal(pop.model.params[k][i], p), k
    metrics = pop.run_iteration()
    assert bool(torch.isfinite(metrics["loss"]).all())
