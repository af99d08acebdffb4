"""The port's formation env and baseline controller against the JAX package.

Inputs are made with numpy and handed to both packages; resets are injected
from JAX's own uniform draws. Tolerances, per field:

- positions, steps, done and the knn neighbor indices in the observation:
  bitwise; goals and obstacles bitwise after a plain reset, and within
  ``rtol=1e-6`` after a step (XLA contracts the reset's ``u * c + r`` into
  one FMA when it compiles the step; PyTorch on the CPU rounds twice);
- every other float (obs, reward and its terms, metrics, baseline
  velocities): ``rtol=1e-6`` plus ``atol=1e-6`` for values near 0. XLA on
  the CPU may round a norm or a mean differently from PyTorch in the last
  bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marl_distributedformation_tpu.env import EnvParams as JaxEnvParams
from marl_distributedformation_tpu.env import control as jax_control
from marl_distributedformation_tpu.env.formation import (
    compute_obs as jax_compute_obs,
    reset_batch as jax_reset_batch,
    step_batch as jax_step_batch,
)
from marl_distributedformation_tpu_torch.env import (
    EnvParams,
    FormationState,
    compute_obs,
    control,
    reset_batch,
    step_batch,
)

RTOL = ATOL = 1e-6


def jax_params(params: EnvParams, knn_impl="xla") -> JaxEnvParams:
    fields = dataclasses.asdict(params)
    fields["knn_impl"] = knn_impl
    return JaxEnvParams(**fields)


def jax_reset_uniforms(keys, params: EnvParams):
    """The uniform draws ``env/formation.py::reset`` makes from each key."""

    def one(key):
        _, k_obs, k_agents, k_goal = jax.random.split(key, 4)
        return (
            jax.random.uniform(k_obs, (params.num_obstacles, 2), jnp.float32),
            jax.random.uniform(k_agents, (params.num_agents, 2), jnp.float32),
            jax.random.uniform(k_goal, (2,), jnp.float32),
        )

    return tuple(torch.from_numpy(np.array(u)) for u in jax.vmap(one)(keys))


def to_port(state) -> FormationState:
    return FormationState(
        agents=torch.from_numpy(np.array(state.agents)),
        goal=torch.from_numpy(np.array(state.goal)),
        obstacles=torch.from_numpy(np.array(state.obstacles)),
        steps=torch.from_numpy(np.array(state.steps)),
    )


def close(port, ref, what):
    np.testing.assert_allclose(
        port.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL, err_msg=what
    )


def same(port, ref, what):
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref), err_msg=what)


CONFIGS = {
    "ring": EnvParams(),
    "ring_obstacles_parity": EnvParams(num_agents=6, num_obstacles=3),
    "ring_obstacles_fixed": EnvParams(
        num_agents=7, num_obstacles=2, obstacle_mode="fixed",
        share_reward_ratio=0.4,
    ),
    "knn": EnvParams(num_agents=20, obs_mode="knn", knn_k=4),
    "knn_no_goal": EnvParams(
        num_agents=12, obs_mode="knn", knn_k=3, goal_in_obs=False
    ),
    "nonstrict_goal_termination": EnvParams(
        num_agents=5, strict_parity=False, goal_termination=True,
        max_steps=30,
    ),
}


def test_env_params_mirror_jax():
    jf = {f.name: f.default for f in dataclasses.fields(JaxEnvParams)}
    pf = {f.name: f.default for f in dataclasses.fields(EnvParams)}
    assert jf == pf
    for params in CONFIGS.values():
        jp = jax_params(params)
        assert params.obs_dim == jp.obs_dim
        assert params.desired_neighbor_dist == jp.desired_neighbor_dist
    with pytest.raises(ValueError):
        EnvParams(num_agents=1)
    with pytest.raises(ValueError):
        EnvParams(share_reward_ratio=0.6)
    with pytest.raises(ValueError):
        EnvParams(num_agents=4, obs_mode="knn", knn_k=4)
    with pytest.raises(ValueError):
        EnvParams(knn_impl="pallas")


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_reset_from_jax_draws(name):
    params = CONFIGS[name]
    key = jax.random.PRNGKey(3)
    ref = jax_reset_batch(key, params=jax_params(params), num_formations=5)
    port = reset_batch(
        params, 5, uniforms=jax_reset_uniforms(jax.random.split(key, 5), params)
    )
    for field in ("agents", "goal", "obstacles", "steps"):
        same(getattr(port, field), getattr(ref, field), field)
    close(
        compute_obs(port.agents, port.goal, params),
        jax_compute_obs(ref.agents, ref.goal, jax_params(params)),
        "obs",
    )


def _scene(params: EnvParams, m: int, seed: int):
    """A JAX state spread over the whole world (some agents on obstacles,
    some at the Q1 boundary) and raw velocities, both from numpy."""
    rng = np.random.default_rng(seed)
    state = jax_reset_batch(jax.random.PRNGKey(seed), jax_params(params), m)
    agents = rng.uniform(0, 1, (m, params.num_agents, 2)) * [400, 600]
    if params.num_obstacles:
        agents[:, 0] = np.asarray(state.obstacles)[:, 0] + 3.0
        agents[:, 1] = np.asarray(state.obstacles)[:, -1] - 4.0
    agents[0, 2] = [0.0, 300.0]  # on the edge
    steps = rng.integers(0, params.max_steps, m)
    steps[: min(m, 3)] = [params.max_steps + 1, params.max_steps,
                          params.max_steps - 1][: min(m, 3)]
    if not params.strict_parity:
        agents[1] = np.asarray(state.goal)[1] + rng.uniform(-20, 20, agents[1].shape)
    state = state.replace(
        agents=jnp.asarray(agents, jnp.float32),
        steps=jnp.asarray(steps, jnp.int32),
    )
    vel = rng.uniform(-12, 12, (m, params.num_agents, 2)).astype(np.float32)
    return state, vel


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_step_batch_matches_jax(name):
    params = CONFIGS[name]
    jp = jax_params(params)
    state, vel = _scene(params, 6, seed=len(name))
    ref_state, ref = jax.jit(jax_step_batch, static_argnums=2)(
        state, jnp.asarray(vel), jp
    )
    # Formations that are done reset to what JAX draws from their key.
    fresh = reset_batch(params, 6, uniforms=jax_reset_uniforms(state.key, params))
    port_state, port = step_batch(
        to_port(state), torch.from_numpy(vel), params, fresh=fresh
    )
    done = np.asarray(ref.done)
    if params.strict_parity:
        assert done[0] and not done[1:3].any()
    else:
        assert done.any()
    same(port.done, ref.done, "done")
    for field in ("agents", "steps"):
        same(getattr(port_state, field), getattr(ref_state, field), field)
    for field in ("goal", "obstacles"):
        close(getattr(port_state, field), getattr(ref_state, field), field)
    close(port.reward, ref.reward, "reward")
    assert set(port.metrics) == set(ref.metrics)
    for key in ref.metrics:
        close(port.metrics[key], ref.metrics[key], key)
    if params.obs_mode == "knn":
        k = params.knn_k
        same(port.obs[..., -k:], ref.obs[..., -k:], "obs neighbor indices")
        close(port.obs[..., :-k], ref.obs[..., :-k], "obs")
    else:
        close(port.obs, ref.obs, "obs")


@pytest.mark.parametrize(
    "name", ["ring", "ring_obstacles_parity", "ring_obstacles_fixed"]
)
def test_baseline_control_matches_jax(name):
    params = CONFIGS[name]
    state, _ = _scene(params, 4, seed=11)
    ref = jax.vmap(jax_control, in_axes=(0, 0, 0, None))(
        state.agents, state.goal, state.obstacles, jax_params(params)
    )
    port_state = to_port(state)
    got = control(
        port_state.agents, port_state.goal, port_state.obstacles, params
    )
    close(got, ref, "velocity")


def test_reset_draws_from_generator():
    params = CONFIGS["ring_obstacles_parity"]
    a = reset_batch(params, 256, torch.Generator().manual_seed(1), "cpu")
    b = reset_batch(params, 256, torch.Generator().manual_seed(1), "cpu")
    assert torch.equal(a.agents, b.agents)
    x, y = a.agents[..., 0], a.agents[..., 1]
    assert 0 <= x.min() and x.max() <= params.width
    assert 0 <= y.min() and y.max() <= params.agent_spawn_band
    r = params.desired_radius
    assert r <= a.goal.min() and a.goal[:, 0].max() <= params.width - r
    ox, oy = a.obstacles[..., 0], a.obstacles[..., 1]
    assert params.obstacle_size <= ox.min()
    assert oy.min() >= params.obstacle_margin_band + params.obstacle_size
    assert not a.steps.any()
    # Uniform over the band: the mean sits near the middle.
    assert abs(float(x.mean()) - params.width / 2) < 10.0


def test_neighbor_arguments_keep_the_fixed_ring_bitwise():
    """``compute_reward``'s ``neighbors_fn``/``pos_neighbors``/
    ``neighbor_dist_target`` and ``compute_obs``'s ``pos_neighbors`` (the
    padded env's dynamic ring) leave existing callers as they were: passed
    the fixed ring explicitly they give the default's values bitwise; a
    gathered ring with a per-formation target matches the JAX package's
    ``compute_reward`` given the same."""
    from marl_distributedformation_tpu.env.formation import (
        compute_reward as jax_compute_reward,
    )
    from marl_distributedformation_tpu_torch.env.formation import (
        compute_reward,
        ring_neighbors,
    )

    params = CONFIGS["ring_obstacles_parity"]
    state, _ = _scene(params, 4, seed=2)
    agents = torch.from_numpy(np.array(state.agents))
    goal = torch.from_numpy(np.array(state.goal))
    oob = agents[..., 0] > 350.0
    inside = agents[..., 1] < 50.0
    plain = compute_reward(agents, goal, oob, inside, params)
    same_ring = compute_reward(
        agents, goal, oob, inside, params, neighbors_fn=ring_neighbors,
        pos_neighbors=ring_neighbors(agents, -2),
        neighbor_dist_target=torch.full((4, 1),
                                        params.desired_neighbor_dist),
    )
    assert torch.equal(plain[0], same_ring[0])
    for k in plain[1]:
        assert torch.equal(plain[1][k], same_ring[1][k]), k
    assert torch.equal(
        compute_obs(agents, goal, params),
        compute_obs(agents, goal, params,
                    pos_neighbors=ring_neighbors(agents, -2)),
    )
    # Reversed ring order and a per-formation target, both packages.
    def flipped(x, dim):
        prev, nxt = ring_neighbors(x, dim)
        return nxt, prev

    target = np.float32([[11.0], [23.0], [37.0], [5.0]])
    got = compute_reward(agents, goal, oob, inside, params,
                         neighbors_fn=flipped,
                         neighbor_dist_target=torch.from_numpy(target))

    def jax_flipped(x, axis):
        return jnp.roll(x, -1, axis=axis), jnp.roll(x, 1, axis=axis)

    ref = jax.vmap(
        lambda a, g, o, i, tg: jax_compute_reward(
            a, g, o, i, jax_params(params), neighbors_fn=jax_flipped,
            neighbor_dist_target=tg[0]),
    )(state.agents, state.goal, jnp.asarray(oob.numpy()),
      jnp.asarray(inside.numpy()), jnp.asarray(target))
    close(got[0], ref[0], "reward")
    for k in ref[1]:
        close(got[1][k], ref[1][k], k)
