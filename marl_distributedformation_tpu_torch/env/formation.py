"""Formation-control environment, batched over M formations, and its
single-formation API.

Counterpart of the JAX package's ``env/formation.py``, written on ``(M, N, 2)``
tensors with the formation axis explicit. It keeps the reference's step order
and quirks: integrate and clip, obstacle containment, reward on the
pre-reset state, the Q1 timeout (``done = steps > max_steps`` under strict
parity), auto-reset *before* metrics and observation, ``std`` with
``ddof=1``, and metrics per formation ``(M,)``.

``reset`` and ``step`` act on one formation (``agents (N, 2)``, ``goal
(2,)``, ``steps ()``), as the JAX package's do: they run the batched
functions on a batch of one and return its row, so a formation's step
equals its row of ``step_batch`` bitwise, the observation included (with
``obs_mode=knn`` one ``knn_batch`` over ``(1, N, 2)``, the kernel on the
card). ``compute_obs`` on one formation's ``(N, 2)`` takes the plain
``ops.knn``, as the JAX package's single-formation branch does.

Resets draw from a ``torch.Generator``. ``reset_batch`` and ``reset`` also
take the uniform draws themselves, and ``step_batch`` and ``step`` a ready
``fresh`` state, so that tests can inject the JAX package's draws.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Dict, Optional, Tuple

import torch

from marl_distributedformation_tpu_torch.device import (
    DeviceLike,
    Streams,
    draw,
    resolve_device,
)
from marl_distributedformation_tpu_torch.env.types import (
    EnvParams,
    FormationState,
    Transition,
    batch_of_one,
    formation_row,
)
from marl_distributedformation_tpu_torch.ops.knn import knn, knn_batch, knn_local

Tensor = torch.Tensor


def _const(values, like: Tensor) -> Tensor:
    """A float32 constant ``(len(values),)`` on ``like``'s device."""
    return _const_on(tuple(values), like.device)


@functools.lru_cache(maxsize=None)
def _const_on(values: Tuple[float, ...], device: torch.device) -> Tensor:
    # Built once per device: a host-to-device copy every step would stall
    # the stream. Never 0-d, so that a division by it is a true division
    # (PyTorch turns division by a scalar into multiplication by its
    # reciprocal on CUDA, which rounds differently). Callers never write
    # to it.
    return torch.tensor(values, dtype=torch.float32, device=device)


def _norm(v: Tensor) -> Tensor:
    """Euclidean norm over the last axis of size 2, as ``sqrt(x*x + y*y)``."""
    return torch.sqrt((v * v).sum(-1))


def ring_neighbors(x: Tensor, dim: int) -> Tuple[Tensor, Tensor]:
    """``(prev, next)`` along ``dim``, as ``jnp.roll`` by +1 and -1."""
    return torch.roll(x, 1, dims=dim), torch.roll(x, -1, dims=dim)


# ``(x, dim) -> (prev, next)`` along the agent axis ``dim``.
NeighborsFn = Callable[[Tensor, int], Tuple[Tensor, Tensor]]


def integrate(
    agents: Tensor, velocity: Tensor, params: EnvParams
) -> Tuple[Tensor, Tensor]:
    """Single-integrator step, boundary flag and clip to the world box
    (reference simulate.py:80-90). Returns ``(agents, out_of_bounds)``."""
    agents = agents + velocity
    out_of_bounds = (
        (agents[..., 0] <= 0.0)
        | (agents[..., 1] <= 0.0)
        | (agents[..., 0] >= params.width)
        | (agents[..., 1] >= params.height)
    )
    agents = torch.minimum(
        torch.clamp_min(agents, 0.0), _const([params.width, params.height], agents)
    )
    return agents, out_of_bounds


def reset_uniforms(
    params: EnvParams,
    num_formations: int,
    generator: Streams,
    device: torch.device,
) -> Tuple[Tensor, Tensor, Tensor]:
    """The uniform [0, 1) draws of one reset: ``(obstacles (M, K, 2),
    agents (M, N, 2), goal (M, 2))``. With a population's generators the
    M formations are the members' in turn, each member's drawn from its
    own generator as its single run draws them (``device.draw``)."""
    m = num_formations

    def uniform(*shape):
        return draw(torch.rand, generator, shape, device)

    return (
        uniform(m, params.num_obstacles, 2), uniform(m, params.num_agents, 2),
        uniform(m, 2),
    )


def reset_batch(
    params: EnvParams,
    num_formations: int,
    generator: Streams = None,
    device: DeviceLike = None,
    uniforms: Optional[Tuple[Tensor, Tensor, Tensor]] = None,
) -> FormationState:
    """Fresh states for ``num_formations`` formations (reference
    simulate.py:120-147): agents uniform over the bottom
    ``agent_spawn_band``, the goal uniform with a ``desired_radius`` margin,
    obstacles uniform over the middle band.

    ``uniforms`` replaces the generator's draws (see ``reset_uniforms``);
    the scaling is the same float32 arithmetic as the JAX package's.
    """
    if uniforms is None:
        dev = resolve_device(device)
        uniforms = reset_uniforms(params, num_formations, generator, dev)
    u_obs, u_agents, u_goal = uniforms
    p = params
    obstacles = u_obs * _const(
        [
            p.width - 2.0 * p.obstacle_size,
            p.height - 2.0 * p.obstacle_margin_band - 2.0 * p.obstacle_size,
        ],
        u_obs,
    ) + _const([p.obstacle_size, p.obstacle_margin_band + p.obstacle_size], u_obs)
    agents = u_agents * _const([p.width, p.agent_spawn_band], u_agents)
    goal = u_goal * _const(
        [p.width - 2.0 * p.desired_radius, p.height - 2.0 * p.desired_radius],
        u_goal,
    ) + p.desired_radius
    steps = torch.zeros(
        (u_agents.shape[0],), dtype=torch.int32, device=u_agents.device
    )
    return FormationState(
        agents=agents, goal=goal, obstacles=obstacles, steps=steps
    )


def reset(
    params: EnvParams,
    generator: Optional[torch.Generator] = None,
    device: DeviceLike = None,
    uniforms: Optional[Tuple[Tensor, Tensor, Tensor]] = None,
) -> FormationState:
    """A fresh state of one formation (the JAX package's ``reset``,
    ``env/formation.py:72``): ``reset_batch`` of one, so it draws what a
    batch of one draws from ``generator``. ``uniforms`` are one
    formation's ``(obstacles (K, 2), agents (N, 2), goal (2,))``."""
    if uniforms is not None:
        uniforms = tuple(u[None] for u in uniforms)
    return formation_row(reset_batch(params, 1, generator, device, uniforms))


def compute_obs(
    agents: Tensor,
    goal: Tensor,
    params: EnvParams,
    pos_neighbors: Optional[Tuple[Tensor, Tensor]] = None,
) -> Tensor:
    """Per-agent observation ``(M, N, obs_dim)``, or ``(N, obs_dim)`` for
    one formation's ``agents (N, 2)`` and ``goal (2,)``.

    ``ring`` (reference simulate.py:150-174): ``[own/WH, prev/WH - own/WH,
    next/WH - own/WH, (goal - own)/WH]``, the ring neighbors' positions
    ``pos_neighbors`` (``(prev, next)``, each ``(M, N, 2)``) when given
    (the padded formations' dynamic ring, ``env/hetero.py``), else the
    fixed ring's. ``knn``: see ``compute_obs_knn``.
    """
    if params.obs_mode == "knn":
        if pos_neighbors is not None:
            raise ValueError("knn observations take no ring neighbors")
        return compute_obs_knn(agents, goal, params)
    wh = _const([params.width, params.height], agents)
    if pos_neighbors is None:
        pos_neighbors = ring_neighbors(agents, -2)
    prev_pos, next_pos = pos_neighbors
    normalized = agents / wh
    parts = [normalized, prev_pos / wh - normalized, next_pos / wh - normalized]
    if params.goal_in_obs:
        parts.append((goal[..., None, :] - agents) / wh)
    return torch.cat(parts, dim=-1)


def compute_obs_knn(agents: Tensor, goal: Tensor, params: EnvParams) -> Tensor:
    """k-NN observation: one ``knn_batch`` over a batch ``(M, N, 2)``
    (the kernels on the card), the plain ``knn`` over one formation
    ``(N, 2)``, then ``_assemble_knn_obs``."""
    if agents.dim() == 2:
        idx, offsets, dists = knn(agents, params.knn_k)
    else:
        idx, offsets, dists = knn_batch(agents, params.knn_k,
                                        impl=params.knn_impl)
    return _assemble_knn_obs(agents, goal, idx, offsets, dists, params)


def compute_obs_knn_sharded(
    local_agents: Tensor,
    all_agents: Tensor,
    goal: Tensor,
    params: EnvParams,
    agent_offset: int,
) -> Tensor:
    """k-NN observations of an agent-sharded slab (the JAX package's
    ``env/formation.py:221``): ``local_agents (M, n_local, 2)`` are global
    rows ``agent_offset .. agent_offset + n_local`` of ``all_agents (M, N,
    2)``. Neighbor indices stay global, so the rows equal those of
    ``compute_obs_knn`` on the whole formation (``ops.knn_local``)."""
    idx, offsets, dists = knn_local(local_agents, all_agents, params.knn_k,
                                    agent_offset)
    return _assemble_knn_obs(local_agents, goal, idx, offsets, dists, params)


def _assemble_knn_obs(
    agents: Tensor,
    goal: Tensor,
    idx: Tensor,
    offsets: Tensor,
    dists: Tensor,
    params: EnvParams,
) -> Tensor:
    """``[own/WH (2), offsets/WH (2k), dists/diag (k), (goal-own)/WH (2),
    idx as float32 (k)]`` — indices are exact in float32 (N < 2^24)."""
    k = idx.shape[-1]
    wh = _const([params.width, params.height], agents)
    diag = _const([math.hypot(params.width, params.height)], agents)
    parts = [
        agents / wh,
        (offsets / wh).reshape(*agents.shape[:-1], 2 * k),
        dists / diag,
    ]
    if params.goal_in_obs:
        parts.append((goal[..., None, :] - agents) / wh)
    parts.append(idx.to(torch.float32))
    return torch.cat(parts, dim=-1)


def _in_obstacle(agents: Tensor, obstacles: Tensor, params: EnvParams) -> Tensor:
    """Per-agent obstacle containment ``(M, N)``. ``parity``: the point is
    the lower-left corner of an ``obstacle_size`` box (Q2); ``fixed``: the
    center of a ``2*obstacle_size`` box."""
    if params.num_obstacles == 0:
        return torch.zeros(agents.shape[:2], dtype=torch.bool, device=agents.device)
    lo = obstacles[:, :, None, :]
    hi = lo + params.obstacle_size
    if params.obstacle_mode == "fixed":
        lo = lo - params.obstacle_size
    a = agents[:, None, :, :]
    inside = (lo <= a) & (a <= hi)  # (M, K, N, 2)
    return inside.all(dim=-1).any(dim=1)


def compute_reward(
    agents: Tensor,
    goal: Tensor,
    out_of_bounds: Tensor,
    in_obstacle: Tensor,
    params: EnvParams,
    neighbors_fn: NeighborsFn = ring_neighbors,
    pos_neighbors: Optional[Tuple[Tensor, Tensor]] = None,
    neighbor_dist_target: Optional[Tensor] = None,
) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Neighbor-mixed per-agent rewards ``(M, N)`` and the per-agent reward
    terms (reference simulate.py:176-229).

    ``neighbors_fn(x, dim)`` gives ``(prev, next)`` along the agent axis
    ``dim`` (the fixed ring by default); ``pos_neighbors`` the neighbors'
    positions when already gathered; ``neighbor_dist_target`` replaces the
    static chord target, broadcast against ``(M, N)`` (the padded
    formations' per-formation ``2*R*sin(pi/n)``, ``env/hetero.py``).
    """
    dist_to_goal = _norm(agents - goal[:, None, :])
    close_to_goal = dist_to_goal < params.close_goal_dist
    close_to_goal_reward = params.close_goal_bonus * close_to_goal
    reward_dist = -params.reward_dist_scale * dist_to_goal

    if pos_neighbors is None:
        pos_neighbors = neighbors_fn(agents, -2)
    prev_pos, next_pos = pos_neighbors
    dist_right = _norm(agents - next_pos)
    dist_left = _norm(agents - prev_pos)
    target = (params.desired_neighbor_dist if neighbor_dist_target is None
              else neighbor_dist_target)
    right_diff = dist_right - target
    left_diff = dist_left - target
    reward_right = -params.neighbor_penalty_scale * torch.where(
        right_diff < 0, right_diff * right_diff, right_diff
    )
    reward_left = -params.neighbor_penalty_scale * torch.where(
        left_diff < 0, left_diff * left_diff, left_diff
    )

    individual = (
        reward_dist
        + close_to_goal_reward
        + reward_right
        + reward_left
        - params.oob_penalty * out_of_bounds
        - params.obstacle_penalty * in_obstacle
    )

    # (1-2p) r_i + p (r_{i-1} + r_{i+1}) (simulate.py:222-229).
    rho = params.share_reward_ratio
    prev_r, next_r = neighbors_fn(individual, -1)
    mixed = (1.0 - 2.0 * rho) * individual + rho * (prev_r + next_r)
    terms = {
        "close_to_goal_reward": close_to_goal_reward,
        "reward_dist": reward_dist,
        "reward_right_neighbor": reward_right,
        "reward_left_neighbor": reward_left,
    }
    return mixed, terms


def compute_metrics(
    agents: Tensor, goal: Tensor, params: EnvParams
) -> Dict[str, Tensor]:
    """Per-formation progress metrics ``(M,)`` (reference
    simulate.py:238-254); the spacing spread is the unbiased ``n-1``
    estimator, as ``torch.Tensor.std`` in the reference."""
    _, next_pos = ring_neighbors(agents, -2)
    dist_to_goal = _norm(agents - goal[:, None, :])
    dist_right = _norm(agents - next_pos)
    return {
        "avg_dist_to_goal": dist_to_goal.mean(-1),
        "ave_dist_to_neighbor": dist_right.mean(-1),
        "std_dist_to_neighbor": dist_right.std(-1, correction=1),
    }


def _where(done: Tensor, a: Tensor, b: Tensor) -> Tensor:
    return torch.where(done.reshape(-1, *([1] * (a.dim() - 1))), a, b)


def step_batch(
    state: FormationState,
    velocity: Tensor,
    params: EnvParams,
    generator: Streams = None,
    fresh: Optional[FormationState] = None,
) -> Tuple[FormationState, Transition]:
    """Advance M formations one step with raw velocities ``(M, N, 2)``.

    Formations that are done auto-reset to ``fresh`` — drawn from
    ``generator`` when not given — before metrics and observation are
    computed, as in the reference (simulate.py:113-118). Fresh states are
    drawn for the whole batch every step, so that the step needs no
    host round trip to learn whether any formation is done.
    """
    agents, out_of_bounds = integrate(state.agents, velocity, params)
    in_obstacle = _in_obstacle(agents, state.obstacles, params)
    reward, terms = compute_reward(
        agents, state.goal, out_of_bounds, in_obstacle, params
    )

    if params.strict_parity:
        done = state.steps > params.max_steps  # Q1: pre-increment check
    else:
        done = state.steps + 1 >= params.max_steps
        if params.goal_termination:
            dist_to_goal = _norm(agents - state.goal[:, None, :])
            done = done | (dist_to_goal < params.close_goal_dist).all(-1)

    if fresh is None:
        fresh = reset_batch(
            params, agents.shape[0], generator, device=agents.device
        )
    next_state = FormationState(
        agents=_where(done, fresh.agents, agents),
        goal=_where(done, fresh.goal, state.goal),
        obstacles=_where(done, fresh.obstacles, state.obstacles),
        steps=torch.where(done, fresh.steps, state.steps + 1),
    )

    obs = compute_obs(next_state.agents, next_state.goal, params)
    metrics = compute_metrics(next_state.agents, next_state.goal, params)
    metrics.update({k: v.mean(-1) for k, v in terms.items()})
    metrics["reward"] = reward.mean(-1)
    return next_state, Transition(
        obs=obs, reward=reward, done=done, metrics=metrics
    )


def step_one_formation(
    step_batch_fn: Callable,
    state,
    velocity: Tensor,
    params: EnvParams,
    generator: Optional[torch.Generator] = None,
    with_obs: bool = True,
    fresh=None,
):
    """One formation's step through a batched env step ``step_batch_fn(
    state, velocity, params, generator, fresh)``: its row of the step on a
    batch of one, the observation included (with ``obs_mode=knn`` one
    ``knn_batch`` over ``(1, N, 2)``: ``knn_fused`` on the card).
    ``with_obs=False`` drops the observation after the row (zero-width)."""
    if fresh is not None:
        fresh = batch_of_one(fresh)
    next_state, tr = step_batch_fn(batch_of_one(state), velocity[None],
                                   params, generator, fresh)
    next_state, tr = formation_row(next_state), formation_row(tr)
    if not with_obs:
        tr.obs = tr.obs[:, :0]
    return next_state, tr


def step(
    state: FormationState,
    velocity: Tensor,
    params: EnvParams,
    generator: Optional[torch.Generator] = None,
    with_obs: bool = True,
    fresh: Optional[FormationState] = None,
) -> Tuple[FormationState, Transition]:
    """Advance one formation one step with raw velocities ``(N, 2)`` (the
    JAX package's ``step``, ``env/formation.py:360``): ``step_batch`` on a
    batch of one, in the reference step order, the auto-reset drawn from
    ``generator`` (or ``fresh``), so every output equals that batch's row
    bitwise (``step_one_formation``). ``reward`` is ``(N,)``, ``done`` and
    the metrics 0-d."""
    return step_one_formation(step_batch, state, velocity, params,
                              generator, with_obs, fresh)


def make_vec_env(
    params: EnvParams,
    num_formations: int,
    device: DeviceLike = None,
    generator: Optional[torch.Generator] = None,
) -> Tuple[
    Callable[[], Tuple[FormationState, Tensor]],
    Callable[[FormationState, Tensor], Tuple[FormationState, Transition]],
]:
    """``(reset_fn, step_fn)`` over ``num_formations`` formations on
    ``device``: ``reset_fn() -> (state, obs)``; ``step_fn(state, actions)``
    scales policy actions in [-1, 1] by ``max_speed`` (reference
    vectorized_env.py:68-82). Both draw from ``generator``."""
    dev = resolve_device(device)

    def reset_fn() -> Tuple[FormationState, Tensor]:
        state = reset_batch(params, num_formations, generator, dev)
        return state, compute_obs(state.agents, state.goal, params)

    def step_fn(
        state: FormationState, actions: Tensor
    ) -> Tuple[FormationState, Transition]:
        return step_batch(state, params.max_speed * actions, params, generator)

    return reset_fn, step_fn
