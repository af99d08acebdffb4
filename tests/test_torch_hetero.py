"""The port's padded heterogeneous env (``env/hetero.py``) and weighted PPO
loss against the JAX package on the CPU.

Inputs are made with numpy; the JAX package's reset draws are injected
into the port (``tests/test_torch_env.py``'s helpers). Tolerances, and why:

- ring indices, masks, counts, positions, steps and done: bitwise;
- everything else the env computes (goals and obstacles after a step, the
  chord target, observations, rewards, metrics): ``rtol=1e-6`` plus
  ``atol=1e-6`` near 0, the homogeneous env's tolerance (XLA contracts the
  reset's ``u * c + r`` into one FMA and may round a norm, a sine or a mean
  differently in the last bit);
- the weighted loss, its metrics and gradients on one minibatch:
  ``rtol=1e-5`` plus ``1e-5`` of each leaf's largest gradient (sums over
  the minibatch run in another order), the homogeneous loss's tolerance;
- ``weights=None`` and all-ones weights against the unweighted path, and
  zero-weight rows against the loss without them: within one rounding
  (``rtol=1e-6``), since a weighted sum divides by the weight sum where
  the plain mean divides by the count.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marl_distributedformation_tpu.algo import (
    MinibatchData as JaxMinibatchData,
    ppo_loss as jax_ppo_loss,
)
from marl_distributedformation_tpu.env.hetero import (
    agent_mask as jax_agent_mask,
    desired_neighbor_dist as jax_desired_neighbor_dist,
    hetero_compute_obs as jax_hetero_compute_obs,
    hetero_reset_batch as jax_hetero_reset_batch,
    hetero_step_batch as jax_hetero_step_batch,
    ring_gather_indices as jax_ring_gather_indices,
)
from marl_distributedformation_tpu_torch.algo import MinibatchData, ppo_loss
from marl_distributedformation_tpu_torch.compat.convert import params_to_jax
from marl_distributedformation_tpu_torch.env import (
    FAR_AWAY,
    EnvParams,
    HeteroLayout,
    HeteroState,
    hetero_compute_obs,
    hetero_reset_batch,
    hetero_step_batch,
    make_hetero_vec_env,
    reset_batch,
)
from marl_distributedformation_tpu_torch.env.hetero import (
    agent_mask,
    desired_neighbor_dist,
    ring_gather_indices,
)
from test_torch_algo import _configs, assert_tree_close, t
from test_torch_env import close, jax_params, jax_reset_uniforms, same
from test_torch_models import np_tree

N_MAX, K_MAX = 20, 4
PARAMS = EnvParams(num_agents=N_MAX, num_obstacles=K_MAX)
# Formations of 3, 5 and 20 active agents of N_max=20, with 0,
# 2 and 4 active obstacles.
COUNTS = np.array([3, 5, 20, 5, 3, 20], np.int32)
OBSTACLES = np.array([0, 2, 4, 4, 2, 0], np.int32)


def to_port_hetero(state) -> HeteroState:
    return HeteroState(**{
        f: torch.from_numpy(np.array(getattr(state, f)))
        for f in ("agents", "goal", "obstacles", "steps", "n_agents",
                  "n_obstacles")
    })


def _jax_reset(key, params, counts, obstacles):
    return jax_hetero_reset_batch(key, jax_params(params),
                                  jnp.asarray(counts), jnp.asarray(obstacles))


@pytest.mark.parametrize("n_max", [3, 5, 20])
def test_ring_indices_masks_and_target_match_jax(n_max):
    counts = np.array(sorted({2, min(3, n_max), min(5, n_max), n_max}),
                      np.int32)
    got_prev, got_next = ring_gather_indices(t(counts), n_max)
    ref_prev, ref_next = jax.vmap(jax_ring_gather_indices,
                                  in_axes=(0, None))(counts, n_max)
    same(got_prev, ref_prev, "prev")
    same(got_next, ref_next, "next")
    same(agent_mask(t(counts), n_max),
         jax.vmap(jax_agent_mask, in_axes=(0, None))(counts, n_max), "mask")
    params = EnvParams(num_agents=n_max)
    close(desired_neighbor_dist(t(counts), params),
          jax.vmap(jax_desired_neighbor_dist, in_axes=(0, None))(
              counts, jax_params(params)), "target")
    # The active ring of each formation is a ring: n steps of next return.
    for row, n in enumerate(counts):
        i = 0
        for _ in range(n):
            i = int(got_next[row, i])
        assert i == 0 and int(got_prev[row, int(got_next[row, 0])]) == 0


def test_reset_parks_inactive_obstacles_as_jax():
    key = jax.random.PRNGKey(4)
    ref = _jax_reset(key, PARAMS, COUNTS, OBSTACLES)
    m = len(COUNTS)
    port = hetero_reset_batch(
        PARAMS, t(COUNTS), t(OBSTACLES),
        uniforms=jax_reset_uniforms(jax.random.split(key, m), PARAMS),
    )
    for field in ("agents", "goal", "obstacles", "steps", "n_agents",
                  "n_obstacles"):
        same(getattr(port, field), getattr(ref, field), field)
    parked = port.obstacles[:, :, 0] == FAR_AWAY
    same(parked, np.arange(K_MAX)[None] >= OBSTACLES[:, None], "parked")
    close(hetero_compute_obs(port, PARAMS),
          jax.vmap(jax_hetero_compute_obs, in_axes=(0, None))(
              ref, jax_params(PARAMS)), "obs")


def _hetero_scene(params, seed, **replace):
    """A JAX padded state spread over the world (agents on obstacles, at
    the Q1 boundary, padded rows anywhere) and raw velocities."""
    rng = np.random.default_rng(seed)
    m = len(COUNTS)
    state = _jax_reset(jax.random.PRNGKey(seed), params, COUNTS, OBSTACLES)
    agents = rng.uniform(0, 1, (m, params.num_agents, 2)) * [400, 600]
    agents[:, 0] = np.asarray(state.obstacles)[:, 0] + 3.0  # parked: far
    agents[:, 1] = np.asarray(state.obstacles)[:, 1] - 2.0
    agents[1, 1] = np.asarray(state.obstacles)[1, 1] + 2.0  # inside
    agents[0, 2] = [0.0, 300.0]  # on the edge
    steps = rng.integers(0, params.max_steps, m)
    steps[:3] = [params.max_steps + 1, params.max_steps,
                 params.max_steps - 1]
    if not params.strict_parity:
        # Every active agent of formation 1 next to its goal.
        agents[1, :COUNTS[1]] = np.asarray(state.goal)[1] + 5.0
        steps[:3] = 0
    state = state.replace(agents=jnp.asarray(agents, jnp.float32),
                          steps=jnp.asarray(steps, jnp.int32), **replace)
    vel = rng.uniform(-12, 12, (m, params.num_agents, 2)).astype(np.float32)
    return state, vel


STEP_CONFIGS = {
    "parity": PARAMS,
    "fixed_boxes_shared_reward": EnvParams(
        num_agents=N_MAX, num_obstacles=K_MAX, obstacle_mode="fixed",
        share_reward_ratio=0.4),
    "nonstrict_goal_termination": EnvParams(
        num_agents=N_MAX, num_obstacles=K_MAX, strict_parity=False,
        goal_termination=True, max_steps=30),
}


@pytest.mark.parametrize("name", sorted(STEP_CONFIGS))
def test_step_obs_and_metrics_match_jax(name):
    params = STEP_CONFIGS[name]
    jp = jax_params(params)
    state, vel = _hetero_scene(params, seed=5 + len(name))
    ref_state, ref = jax.jit(jax_hetero_step_batch, static_argnums=2)(
        state, jnp.asarray(vel), jp)
    fresh = reset_batch(params, len(COUNTS),
                        uniforms=jax_reset_uniforms(state.key, params))
    port_state, port = hetero_step_batch(
        to_port_hetero(state), t(vel), params, fresh=fresh)
    done = np.asarray(ref.done)
    assert done.any() and not done.all()
    same(port.done, ref.done, "done")
    for field in ("agents", "steps", "n_agents", "n_obstacles"):
        same(getattr(port_state, field), getattr(ref_state, field), field)
    for field in ("goal", "obstacles"):
        close(getattr(port_state, field), getattr(ref_state, field), field)
    close(port.reward, ref.reward, "reward")
    close(port.obs, ref.obs, "obs")
    assert set(port.metrics) == set(ref.metrics)
    for key in ref.metrics:
        close(port.metrics[key], ref.metrics[key], key)
    pad = ~agent_mask(t(COUNTS), N_MAX)
    assert bool((port.reward[pad] == 0).all())
    assert bool((port.obs[pad] == 0).all())
    same(port.metrics["num_active_agents"], COUNTS.astype(np.float32),
         "num_active_agents")


def test_static_layout_set_in_place_equals_a_fresh_one():
    """A trainer's layout is rewritten in place at a stage reset: every
    tensor keeps its storage and equals the layout made for the counts."""
    layout = HeteroLayout(PARAMS, len(COUNTS), "cpu")
    ptrs = {k: v.data_ptr() for k, v in vars(layout).items()
            if isinstance(v, torch.Tensor)}
    for counts, obstacles in ((COUNTS, OBSTACLES),
                              (COUNTS[::-1].copy(), OBSTACLES * 0)):
        layout.set(t(counts), t(obstacles))
        fresh = HeteroLayout.of(t(counts), t(obstacles), PARAMS)
        for k, ptr in ptrs.items():
            assert getattr(layout, k).data_ptr() == ptr, k
            assert torch.equal(getattr(layout, k), getattr(fresh, k)), k
    with pytest.raises(ValueError, match="agent counts"):
        layout.set(t(np.array([1] * len(COUNTS), np.int32)), t(OBSTACLES))


def test_step_refuses_knn_obs_as_jax():
    params = EnvParams(num_agents=6, obs_mode="knn", knn_k=2)
    state = hetero_reset_batch(params, t(np.array([4, 6], np.int32)),
                               t(np.zeros(2, np.int32)), device="cpu")
    with pytest.raises(ValueError, match="heterogeneous formations use ring"):
        hetero_step_batch(state, torch.zeros(2, 6, 2), params)


def test_vec_env_keeps_counts_through_auto_resets():
    params = EnvParams(num_agents=8, num_obstacles=2, max_steps=3)
    gen = torch.Generator().manual_seed(0)
    reset_fn, step_fn = make_hetero_vec_env(params, "cpu", gen)
    counts = t(np.array([2, 8, 5], np.int32))
    state, obs = reset_fn(counts, t(np.array([0, 2, 1], np.int32)))
    assert obs.shape == (3, 8, params.obs_dim)
    dones = 0
    for _ in range(6):
        state, tr = step_fn(state, torch.ones(3, 8, 2))
        dones += int(tr.done.sum())
        assert torch.equal(state.n_agents, counts)
        assert bool((state.obstacles[0, :, 0] == FAR_AWAY).all())
        assert int((state.obstacles[2, :, 0] == FAR_AWAY).sum()) == 1
        assert bool(torch.isfinite(tr.obs).all())
    assert dones == 3  # every formation reset once (Q1: after 5 steps)


# ---------------------------------------------------------------------------
# The weighted PPO loss
# ---------------------------------------------------------------------------


def _weighted_rows(kind, b, seed):
    """Rows for the MLP ``(b,)`` or for CTDE formations ``(b, N)``, with
    the weights of padded formations (0 past each row's count)."""
    from test_torch_algo import _rows

    rows = _rows("mlp", b, seed) if kind == "mlp" else None
    rng = np.random.default_rng(seed + 100)
    if kind == "mlp":
        w = (rng.random(b) < 0.7).astype(np.float32)
    else:
        from test_torch_ctde import ctde_rows

        rows = ctde_rows(b, seed)
        counts = rng.integers(2, rows["obs"].shape[1] + 1, b)
        w = (np.arange(rows["obs"].shape[1])[None] < counts[:, None]).astype(
            np.float32)
    return rows, w


@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("kind", ["mlp", "ctde"])
def test_weighted_loss_and_grads_match_jax(kind, normalize):
    from test_torch_ctde import ctde_pair
    from test_torch_algo import _pair

    if kind == "mlp":
        jmodel, jvars, model, policy = _pair("mlp")
    else:
        jmodel, jvars, model, policy = ctde_pair()
    rows, w = _weighted_rows(kind, 24 if kind == "mlp" else 5, seed=8)
    jcfg, cfg = _configs(normalize_advantage=normalize)
    jmb = JaxMinibatchData(**rows, weights=w,
                           mask=w if kind == "ctde" else None)
    (jloss, jmetrics), jgrads = jax.value_and_grad(
        jax_ppo_loss, has_aux=True)(jvars, jmodel.apply, jmb, jcfg)
    mb = MinibatchData(**{k: t(v) for k, v in rows.items()}, weights=t(w),
                       mask=t(w) if kind == "ctde" else None)
    loss, metrics = ppo_loss(model, mb, cfg)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in model.named_parameters()])
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    assert set(metrics) == set(jmetrics)
    for k in jmetrics:
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)
    assert_tree_close(params_to_jax(dict(zip(names, grads)), policy),
                      np_tree(jgrads), rtol=1e-5, floor=1e-5, what="grads")


def _loss(model, rows, cfg, w=None):
    mb = MinibatchData(**{k: t(v) for k, v in rows.items()},
                       weights=None if w is None else t(w))
    loss, metrics = ppo_loss(model, mb, cfg)
    return loss, metrics, torch.autograd.grad(loss, list(model.parameters()))


def test_zero_weight_rows_leave_the_loss_unchanged():
    """Rows of weight 0 (padded agents) change neither the loss nor its
    gradients, whatever they hold; ``weights=None`` is the plain loss,
    bitwise the path it was, and all-ones weights agree with it."""
    from test_torch_algo import _pair, _rows

    _, _, model, _ = _pair("mlp")
    _, cfg = _configs()
    rows = _rows("mlp", 16, seed=3)
    junk = _rows("mlp", 8, seed=4)
    junk["advantages"] = junk["advantages"] * 1e4  # would move the moments
    both = {k: np.concatenate([rows[k], junk[k]]) for k in rows}
    w = np.concatenate([np.ones(16, np.float32), np.zeros(8, np.float32)])
    plain, pm, pg = _loss(model, rows, cfg)
    padded, wm, wg = _loss(model, both, cfg, w)
    ones, om, og = _loss(model, rows, cfg, np.ones(16, np.float32))
    for got, gm, gg in ((padded, wm, wg), (ones, om, og)):
        np.testing.assert_allclose(float(got), float(plain), rtol=1e-6)
        for k in pm:
            np.testing.assert_allclose(float(gm[k]), float(pm[k]),
                                       rtol=1e-5, atol=1e-7, err_msg=k)
        for a, b in zip(gg, pg):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                       atol=1e-6)
    # None is the unweighted code path, operation for operation.
    again, am, ag = _loss(model, rows, cfg, None)
    assert torch.equal(again, plain)
    assert all(torch.equal(a, b) for a, b in zip(ag, pg))
