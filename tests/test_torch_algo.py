"""The port's PPO pieces against the JAX package on the CPU: GAE, the clipped
Adam, the loss and its gradients, the update with the JAX package's
permutations injected, and rollout collection with its noise and resets
injected.

Tolerances, and why:

- GAE: ``rtol=1e-6`` with an absolute floor of ``1e-6`` of the largest
  value: ``r + gamma*V' - V`` cancels, and XLA may fuse its multiply-add
  where PyTorch rounds each operation.
- Optimizer, 20 steps on the same gradients: params, ``mu`` and ``nu``
  within ``rtol=1e-6`` plus ``1e-6`` of each leaf's largest magnitude
  (moments mix gradients of scales 5 and 0.01 and cancel), ``count``
  exact. The global norm sums in another order, and ``b**count`` may round
  differently in the last bit.
- The schedules' ``ent_coef`` and ``log_std_ceiling`` around step 2^24:
  within one float32 rounding of the schedule's span (XLA contracts
  ``a + p*(b-a)`` into one fused multiply-add; the port rounds twice).
- Loss, metrics and gradients on one minibatch: ``rtol=1e-5``, with an
  absolute floor of ``1e-5`` of the largest gradient of the leaf (sums over
  the minibatch run in another order).
- A whole update: params within ``tests/adam_budget.py::adam_parity_atol``
  (``lr`` a step once float noise flips a near-zero Adam step); ``mu`` and
  ``nu`` within the same budget relative to each leaf's largest value;
  ``count`` exact.
- Rollout: ``obs``, rewards and values as the models' outputs
  (``atol=1e-4``, ``rtol=1e-5``: a 1e-5 action difference moves agents by
  ``max_speed`` times it); the knn indices, dones and steps exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization
from flax.training.train_state import TrainState

from adam_budget import adam_parity_atol
from marl_distributedformation_tpu.algo import (
    MinibatchData as JaxMinibatchData,
    PPOConfig as JaxPPOConfig,
    collect_rollout as jax_collect_rollout,
    compute_gae as jax_compute_gae,
    ppo_loss as jax_ppo_loss,
    ppo_update as jax_ppo_update,
)
from marl_distributedformation_tpu.env.formation import (
    compute_obs as jax_compute_obs,
    reset_batch as jax_reset_batch,
)
from marl_distributedformation_tpu.models import GNNActorCritic as JaxGNN
from marl_distributedformation_tpu.models import MLPActorCritic as JaxMLP
from marl_distributedformation_tpu_torch.algo import (
    MinibatchData,
    PPOConfig,
    adam_init,
    collect_rollout,
    compute_gae,
    ppo_loss,
    ppo_update,
)
from marl_distributedformation_tpu_torch.algo.optim import (
    clip_by_global_norm,
    clipped_adam_step,
)
from marl_distributedformation_tpu_torch.algo.ppo import schedule_values
from marl_distributedformation_tpu_torch.compat.convert import (
    opt_state_to_jax,
    params_from_jax,
    params_to_jax,
)
from marl_distributedformation_tpu_torch.env import (
    EnvParams,
    reset_batch,
    step_batch,
)
from marl_distributedformation_tpu_torch.models import (
    GNNActorCritic,
    MLPActorCritic,
)
from test_torch_env import jax_params, jax_reset_uniforms, to_port
from test_torch_models import knn_obs, np_tree

LR = 1e-3


def t(x):
    return torch.from_numpy(np.array(x))


def assert_tree_close(port, ref, rtol, floor=0.0, what=""):
    """Leaves of two nested dicts of arrays within ``rtol`` plus ``floor``
    times the leaf's largest magnitude."""
    assert set(port) == set(ref), what
    for k in ref:
        if isinstance(ref[k], dict):
            assert_tree_close(port[k], ref[k], rtol, floor, f"{what}/{k}")
            continue
        r = np.asarray(ref[k])
        np.testing.assert_allclose(
            np.asarray(port[k]), r, rtol=rtol,
            atol=floor * float(np.abs(r).max(initial=0.0)), err_msg=f"{what}/{k}",
        )


# ---------------------------------------------------------------------------
# GAE
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
def test_compute_gae_matches(seed):
    rng = np.random.default_rng(seed)
    T, M, N = 9, 3, 4
    rewards = rng.normal(size=(T, M, N)).astype(np.float32) * 10
    values = rng.normal(size=(T, M, N)).astype(np.float32) * 50
    dones = (rng.random((T, M, 1)) < 0.25).repeat(N, -1).astype(np.float32)
    dones[T // 2] = 1.0  # a terminal step in every formation
    last = rng.normal(size=(M, N)).astype(np.float32)
    ref = jax_compute_gae(rewards, values, dones, last, 0.99, 0.95)
    got = compute_gae(t(rewards), t(values), t(dones), t(last), 0.99, 0.95)
    floor = 1e-6 * float(np.abs(values).max())
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6,
                                   atol=floor)


# ---------------------------------------------------------------------------
# Optimizer
# ---------------------------------------------------------------------------


def test_optimizer_matches_optax_chain():
    rng = np.random.default_rng(3)
    shapes = {"pi_0.weight": (16, 8), "pi_0.bias": (16,), "log_std": (2,)}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in
              shapes.items()}
    max_norm, eps = 0.5, 1e-5
    tx = optax.chain(optax.clip_by_global_norm(max_norm),
                     optax.adam(LR, eps=eps))
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = tx.init(jparams)
    port = {k: t(v) for k, v in params.items()}
    state = adam_init(port)
    clipped_steps = 0
    for step in range(20):
        # Alternate gradients below and above the clipping norm.
        scale = 0.01 if step % 2 else 5.0
        grads = {k: (rng.normal(size=s) * scale).astype(np.float32)
                 for k, s in shapes.items()}
        _, norm = clip_by_global_norm([t(g) for g in grads.values()],
                                      max_norm)
        clipped_steps += bool(norm >= max_norm)
        updates, jstate = tx.update(
            {k: jnp.asarray(v) for k, v in grads.items()}, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        raw = clipped_adam_step(list(port.values()),
                                [t(g) for g in grads.values()], state, LR,
                                max_norm, eps)
        np.testing.assert_allclose(float(raw), float(norm), rtol=1e-6)
    assert 0 < clipped_steps < 20
    adam = jstate[1][0]
    assert int(state.count) == int(adam.count) == 20
    got = {"params": port, "mu": state.mu, "nu": state.nu}
    ref = {"params": jparams, "mu": adam.mu, "nu": adam.nu}
    assert_tree_close(
        {g: {k: v.numpy() for k, v in got[g].items()} for g in got},
        {g: {k: np.asarray(v) for k, v in ref[g].items()} for g in ref},
        rtol=1e-6, floor=1e-6,
    )


# ---------------------------------------------------------------------------
# Models and minibatches shared by the loss and update tests
# ---------------------------------------------------------------------------

GNN_N, GNN_K = 10, 3
GNN_OBS_DIM = 2 + 3 * GNN_K + 2 + GNN_K


def _pair(kind):
    """A JAX model with its variables and the port's model holding them."""
    if kind == "mlp":
        jmodel = JaxMLP()
        jvars = jmodel.init(jax.random.PRNGKey(1), jnp.zeros((1, 8)))
        model = MLPActorCritic(obs_dim=8)
        policy = "MLPActorCritic"
    else:
        jmodel = JaxGNN(k=GNN_K)
        jvars = jmodel.init(jax.random.PRNGKey(2),
                            jnp.zeros((1, GNN_N, GNN_OBS_DIM)))
        model = GNNActorCritic(k=GNN_K)
        policy = "GNNActorCritic"
    model.load_state_dict(params_from_jax(np_tree(jvars), policy))
    return jmodel, jvars, model, policy


def _rows(kind, b, seed=0):
    """Minibatch rows from numpy: ``(b, 8)`` for the MLP, ``(b, N, obs)``
    formations for the GNN."""
    rng = np.random.default_rng(seed)
    lead = (b,) if kind == "mlp" else (b, GNN_N)
    if kind == "mlp":
        obs = rng.normal(size=(b, 8)).astype(np.float32)
    else:
        obs = knn_obs(b, GNN_N, GNN_K, seed=seed)
    return dict(
        obs=obs,
        actions=rng.normal(size=(*lead, 2)).astype(np.float32),
        old_log_probs=(rng.normal(size=lead) - 2.5).astype(np.float32),
        advantages=(rng.normal(size=lead) * 3).astype(np.float32),
        returns=(rng.normal(size=lead) * 20).astype(np.float32),
    )


def _configs(**kw):
    return JaxPPOConfig(**kw), PPOConfig(**kw)


@pytest.mark.parametrize("clip_range_vf", [None, 0.2])
@pytest.mark.parametrize("kind", ["mlp", "gnn"])
def test_ppo_loss_and_grads_match(kind, clip_range_vf):
    jmodel, jvars, model, policy = _pair(kind)
    rows = _rows(kind, 24 if kind == "mlp" else 5, seed=4)
    jcfg, cfg = _configs(clip_range_vf=clip_range_vf)
    (jloss, jmetrics), jgrads = jax.value_and_grad(jax_ppo_loss,
                                                   has_aux=True)(
        jvars, jmodel.apply, JaxMinibatchData(**rows), jcfg)
    loss, metrics = ppo_loss(model, MinibatchData(
        **{k: t(v) for k, v in rows.items()}), cfg)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in model.named_parameters()])
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert set(metrics) == set(jmetrics)
    for k in jmetrics:
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)
    assert_tree_close(params_to_jax(dict(zip(names, grads)), policy),
                      np_tree(jgrads), rtol=1e-5, floor=1e-5, what="grads")


def _jax_update(jmodel, jvars, rows, jcfg, key, start_step=0):
    ts = TrainState.create(apply_fn=jmodel.apply, params=jvars,
                           tx=optax.chain(
                               optax.clip_by_global_norm(jcfg.max_grad_norm),
                               optax.adam(jcfg.learning_rate,
                                          eps=jcfg.adam_eps)))
    ts = ts.replace(step=jnp.int32(start_step))
    update = jax.jit(jax_ppo_update, static_argnums=3)
    return update(ts, JaxMinibatchData(**rows), key, jcfg)


def _jax_permutations(key, n_epochs, total, used):
    return torch.stack([
        t(jax.random.permutation(k, total)[:used])
        for k in jax.random.split(key, n_epochs)
    ])


def _compare_update(model, state, policy, ts, metrics, jmetrics, updates):
    atol = adam_parity_atol(LR, updates)
    got = params_to_jax(dict(model.named_parameters()), policy)
    ref = np_tree(ts.params)
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(
        ref)
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(ref)):
        np.testing.assert_allclose(a, b, rtol=0, atol=atol)
    jopt = serialization.to_state_dict(ts.opt_state)
    popt = opt_state_to_jax(vars(state), policy)
    assert int(popt["1"]["0"]["count"]) == int(jopt["1"]["0"]["count"])
    for moment in ("mu", "nu"):
        assert_tree_close(popt["1"]["0"][moment],
                          np_tree(jopt["1"]["0"][moment]), rtol=0,
                          floor=atol, what=moment)
    assert set(metrics) == set(jmetrics)
    for k in jmetrics:
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]),
                                   rtol=1e-3, atol=1e-6, err_msg=k)


UPDATE_CASES = {
    # 100 rows of 32: three minibatches, four rows dropped each epoch.
    "mlp_remainder": dict(kind="mlp", rows=100, batch_size=32, step=0,
                          sched={}),
    # Whole formations, as the trainer minibatches a per-formation model.
    "gnn_per_formation": dict(kind="gnn", rows=12, batch_size=4, step=0,
                              sched={}),
    # Both schedules with the two-limb step just below 2^24, where a plain
    # float32 step would stall; the horizon puts progress near 0.6.
    "schedules_near_2_24": dict(
        kind="mlp", rows=64, batch_size=32, step=2**24 - 3,
        sched=dict(ent_coef_final=0.0, log_std_final=-1.0,
                   log_std_decay_start=0.2,
                   total_iterations=(2**24 * 10) // (6 * 2 * 2)),
    ),
}


@pytest.mark.parametrize("case", sorted(UPDATE_CASES))
def test_ppo_update_matches_with_injected_permutations(case):
    c = UPDATE_CASES[case]
    jmodel, jvars, model, policy = _pair(c["kind"])
    rows = _rows(c["kind"], c["rows"], seed=5)
    jcfg, cfg = _configs(n_epochs=2, batch_size=c["batch_size"], **c["sched"])
    key = jax.random.PRNGKey(9)
    ts, jmetrics = _jax_update(jmodel, jvars, rows, jcfg, key, c["step"])
    used = c["rows"] // c["batch_size"] * c["batch_size"]
    perms = _jax_permutations(key, 2, c["rows"], used)
    state = adam_init(dict(model.named_parameters()))
    step, metrics = ppo_update(
        model, state, c["step"], MinibatchData(
            **{k: t(v) for k, v in rows.items()}),
        None, cfg, permutations=perms,
    )
    updates = 2 * (c["rows"] // c["batch_size"])
    assert step == c["step"] + updates == int(ts.step)
    _compare_update(model, state, policy, ts, metrics, jmetrics, updates)
    if c["sched"]:
        assert float(model.log_std.max()) < 0.0  # the ceiling bit


def test_schedule_values_match_jax_around_2_24():
    """One minibatch a call, so the JAX package's metrics are the values at
    exactly the step it starts from."""
    jmodel, jvars, _, _ = _pair("mlp")
    rows = _rows("mlp", 16, seed=6)
    sched = dict(ent_coef_final=0.0, log_std_final=-2.0,
                 log_std_decay_start=0.1, total_iterations=2**24 + 7,
                 n_epochs=1, batch_size=16)
    jcfg, cfg = _configs(**sched)
    seen = set()
    for step in range(2**24 - 2, 2**24 + 3):
        _, jm = _jax_update(jmodel, jvars, rows, jcfg,
                            jax.random.PRNGKey(0), step)
        got = schedule_values(cfg, step, cfg.total_iterations)
        for k, span in (("ent_coef", 0.01), ("log_std_ceiling", 2.0)):
            np.testing.assert_allclose(got[k], np.float32(jm[k]), rtol=0,
                                       atol=span * 2.0**-23, err_msg=k)
        seen.add(float(got["ent_coef"]))
    assert len(seen) > 1  # the schedule moves across 2^24


# ---------------------------------------------------------------------------
# Rollout
# ---------------------------------------------------------------------------


def injected_env_step(jstate, params):
    """An ``env_step_fn`` for the port that resets done formations to the
    states the JAX package draws from its per-formation keys, tracking the
    keys as the JAX step does (a formation's key changes only at a reset)."""
    keys = [jstate.key]
    m = jstate.key.shape[0]

    def step(state, velocity):
        fresh = reset_batch(params, m, uniforms=jax_reset_uniforms(
            keys[0], params))
        state, tr = step_batch(state, velocity, params, fresh=fresh)
        new = jax.vmap(lambda k: jax.random.split(k, 4)[0])(keys[0])
        keys[0] = jnp.where(jnp.asarray(tr.done.numpy())[:, None], new,
                            keys[0])
        return state, tr

    return step


def jax_rollout_noise(key, n_steps, shape):
    """The normal draws the JAX rollout samples its actions from."""
    return torch.stack([
        t(jax.random.normal(k, shape, jnp.float32))
        for k in jax.random.split(key, n_steps)
    ])


ROLLOUT_CASES = {
    "ring_mlp": (EnvParams(num_agents=5, max_steps=3), "mlp", "xla"),
    "knn_gnn_xla": (EnvParams(num_agents=GNN_N, obs_mode="knn", knn_k=GNN_K,
                              max_steps=3), "gnn", "xla"),
    "knn_gnn_pallas_interpret": (
        EnvParams(num_agents=GNN_N, obs_mode="knn", knn_k=GNN_K,
                  max_steps=3), "gnn", "pallas_interpret"),
}


@pytest.mark.parametrize("case", sorted(ROLLOUT_CASES))
def test_collect_rollout_teacher_forced(case):
    params, kind, impl = ROLLOUT_CASES[case]
    jp = jax_params(params, impl)
    jmodel, jvars, model, _ = _pair(kind)
    m, T = 3, 7  # max_steps=3: every formation resets at step 5
    jstate = jax_reset_batch(jax.random.PRNGKey(11), jp, m)
    jobs = jax_compute_obs(jstate.agents, jstate.goal, jp)
    key = jax.random.PRNGKey(12)
    jend, jlast_obs, jbatch, jlast_value = jax_collect_rollout(
        jmodel.apply, jvars, jstate, jobs, key, jp, T)
    noise = jax_rollout_noise(key, T, (m, params.num_agents, 2))
    end, last_obs, batch, last_value = collect_rollout(
        model, to_port(jstate), t(jobs), None, params, T,
        env_step_fn=injected_env_step(jstate, params), noise=noise)

    def close(port, ref, what):
        np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-4, err_msg=what)

    for name in ("actions", "log_probs", "values", "rewards"):
        close(getattr(batch, name), getattr(jbatch, name), name)
    np.testing.assert_array_equal(batch.dones.numpy(), np.asarray(jbatch.dones))
    assert float(batch.dones.sum()) == m * params.num_agents
    close(batch.obs, jbatch.obs, "obs")
    close(last_obs, jlast_obs, "last_obs")
    close(last_value, jlast_value, "last_value")
    close(end.agents, jend.agents, "agents")
    np.testing.assert_array_equal(end.steps.numpy(), np.asarray(jend.steps))
    if params.obs_mode == "knn":
        k = params.knn_k
        np.testing.assert_array_equal(batch.obs[..., -k:].numpy(),
                                      np.asarray(jbatch.obs)[..., -k:])
    assert set(batch.metrics) == set(jbatch.metrics)
    for name, ref in jbatch.metrics.items():
        close(batch.metrics[name], ref, name)
    # The buffer holds the unclipped samples.
    assert float(batch.actions.abs().max()) > 1.0
