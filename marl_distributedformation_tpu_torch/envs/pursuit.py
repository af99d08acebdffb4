"""Pursuit-evasion: N evaders (the learning agents) flee one scripted
pursuer while holding ring cohesion, batched over M formations.

Counterpart of the JAX package's ``envs/pursuit.py``. It reuses the
formation env's machinery:

- the state is ``FormationState`` with ``goal`` holding the pursuer's
  position, so resets, auto-reset, checkpoints and the captured training
  iteration carry it unchanged;
- observations are ``compute_obs``: the relative-goal block becomes the
  relative-pursuer block, declared as ``pursuer`` in the layout, so a
  scenario layer that needs a ``goal`` block fails fast here instead of
  masking the pursuer's columns. ``obs_mode="knn"`` runs the batch's
  neighbor search through ``ops.knn_batch`` (``knn_fused``/``knn_tiled`` on
  the card);
- physics, metrics and episode accounting are the formation env's
  (``integrate``, ``_in_obstacle``, ``compute_metrics``, the Q1 parity
  done rule), so the metric keys that eval and the trainers read hold for
  both envs (``avg_dist_to_goal`` is the distance to the pursuer).

The pursuer moves ``pursuer_speed`` toward the nearest evader each step (no
overshoot), clipped to the world box. The reward pays evaders for distance
from the pursuer, penalizes them inside ``capture_radius``, and keeps the
neighbor-spacing, out-of-bounds and obstacle terms and the ring reward
mixing, so the task is to flee together in formation.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from marl_distributedformation_tpu_torch.device import Streams
from marl_distributedformation_tpu_torch.env.formation import (
    _const,
    _in_obstacle,
    _norm,
    _where,
    compute_metrics,
    compute_obs,
    integrate,
    reset_batch,
    ring_neighbors,
)
from marl_distributedformation_tpu_torch.env.types import (
    EnvParams,
    FormationState,
    Transition,
)
from marl_distributedformation_tpu_torch.envs.spec import EnvSpec, ObsLayout

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class PursuitParams(EnvParams):
    """Formation params and the pursuit knobs. A subclass of ``EnvParams``,
    so every call site that takes ``EnvParams`` takes these, and
    ``envs.spec_for_params`` dispatches on the most-derived registered
    type."""

    pursuer_speed: float = 7.0  # px/step, < max_speed so evasion is possible
    capture_radius: float = 30.0  # px: within this the evader is "caught"
    capture_penalty: float = 50.0  # per-step penalty while caught
    evade_reward_scale: float = 0.05  # reward per px of pursuer distance

    def __post_init__(self) -> None:
        super().__post_init__()
        assert self.pursuer_speed >= 0.0
        assert self.capture_radius >= 0.0


def nearest_index(dists: Tensor) -> Tensor:
    """Index of the first minimum over the last axis, as ``jnp.argmin``
    takes it: the lowest index among equal distances, and the first NaN
    when there is one. Written as a min and an integer min over the
    positions that hold it, so the order of ties does not rest on the
    device's argmin."""
    n = dists.shape[-1]
    is_min = (dists == dists.amin(-1, keepdim=True)) | torch.isnan(dists)
    pos = torch.arange(n, device=dists.device).expand_as(dists)
    return torch.where(is_min, pos, n).amin(-1)


def pursuer_update(
    agents: Tensor, pursuer: Tensor, params: PursuitParams
) -> Tensor:
    """The pursuer ``(M, 2)`` after one move of ``pursuer_speed`` toward
    the nearest of ``agents (M, N, 2)`` (no overshoot), clipped to the
    world box."""
    dists = _norm(agents - pursuer[:, None, :])
    idx = nearest_index(dists)
    nearest = agents[torch.arange(agents.shape[0], device=agents.device), idx]
    delta = nearest - pursuer
    gap = _norm(delta)[:, None]
    direction = delta / torch.clamp_min(gap, 1e-6)
    moved = pursuer + torch.clamp_max(gap, params.pursuer_speed) * direction
    return torch.minimum(
        torch.clamp_min(moved, 0.0),
        _const([params.width, params.height], moved),
    )


def pursuit_reward(
    agents: Tensor,
    pursuer: Tensor,
    out_of_bounds: Tensor,
    in_obstacle: Tensor,
    params: PursuitParams,
) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Neighbor-mixed per-agent evade rewards ``(M, N)`` and the reward
    terms: ``compute_reward``'s structure, with the distance to the
    pursuer paid instead of the distance to the goal penalized, and the
    ring mixing ``(1-2p) r_i + p (r_prev + r_next)``."""
    dist_to_pursuer = _norm(agents - pursuer[:, None, :])
    evade_reward = params.evade_reward_scale * dist_to_pursuer
    caught = dist_to_pursuer < params.capture_radius
    capture_penalty = -params.capture_penalty * caught

    prev_pos, next_pos = ring_neighbors(agents, -2)
    target = params.desired_neighbor_dist
    right_diff = _norm(agents - next_pos) - target
    left_diff = _norm(agents - prev_pos) - target
    reward_right = -params.neighbor_penalty_scale * torch.where(
        right_diff < 0, right_diff * right_diff, right_diff
    )
    reward_left = -params.neighbor_penalty_scale * torch.where(
        left_diff < 0, left_diff * left_diff, left_diff
    )

    individual = (
        evade_reward
        + capture_penalty
        + reward_right
        + reward_left
        - params.oob_penalty * out_of_bounds
        - params.obstacle_penalty * in_obstacle
    )

    rho = params.share_reward_ratio
    prev_r, next_r = ring_neighbors(individual, -1)
    mixed = (1.0 - 2.0 * rho) * individual + rho * (prev_r + next_r)
    terms = {
        "evade_reward": evade_reward,
        "capture_penalty": capture_penalty,
        "reward_right_neighbor": reward_right,
        "reward_left_neighbor": reward_left,
    }
    return mixed, terms


def pursuit_step_batch(
    state: FormationState,
    velocity: Tensor,
    params: PursuitParams,
    generator: Streams = None,
    fresh: Optional[FormationState] = None,
) -> Tuple[FormationState, Transition]:
    """Advance M formations of evaders one step, in the formation step's
    order: integrate, bounds and obstacle flags, the pursuer moves on the
    evaders' new positions, the reward on the pre-reset state, the parity
    done rule, auto-reset to ``fresh`` (drawn from ``generator`` when not
    given), then observation and metrics on the next state."""
    agents, out_of_bounds = integrate(state.agents, velocity, params)
    in_obstacle = _in_obstacle(agents, state.obstacles, params)
    pursuer = pursuer_update(agents, state.goal, params)
    reward, terms = pursuit_reward(agents, pursuer, out_of_bounds,
                                   in_obstacle, params)

    if params.strict_parity:
        done = state.steps > params.max_steps
    else:
        done = state.steps + 1 >= params.max_steps

    if fresh is None:
        fresh = reset_batch(params, agents.shape[0], generator,
                            device=agents.device)
    next_state = FormationState(
        agents=_where(done, fresh.agents, agents),
        goal=_where(done, fresh.goal, pursuer),
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


def pursuit_obs(state: FormationState, params: PursuitParams) -> Tensor:
    """The observation of a batched state (the pursuer in the goal slot)."""
    return compute_obs(state.agents, state.goal, params)


def pursuit_obs_layout(params: PursuitParams) -> ObsLayout:
    """The formation env's column geometry with the relative-goal block
    named ``pursuer``."""
    dim = params.obs_dim
    if params.obs_mode == "knn":
        k = params.knn_k
        blocks = [
            ("self", ((0, 2),)),
            ("neighbor", ((2, 2 + 3 * k), (dim - k, dim))),
        ]
        if params.goal_in_obs:
            blocks.append(("pursuer", ((2 + 3 * k, 2 + 3 * k + 2),)))
    else:
        blocks = [("self", ((0, 2),)), ("neighbor", ((2, 6),))]
        if params.goal_in_obs:
            blocks.append(("pursuer", ((6, 8),)))
    return ObsLayout(
        dim=dim, topology=params.obs_mode, blocks=tuple(blocks)
    )


PURSUIT_SPEC = EnvSpec(
    name="pursuit_evasion",
    description=(
        "pursuit-evasion: N evaders flee one scripted pursuer (moves "
        "pursuer_speed toward the nearest evader each step) while "
        "holding ring cohesion — formation machinery reused, goal slot "
        "carries the pursuer"
    ),
    params_cls=PursuitParams,
    reset_batch=reset_batch,
    step_batch=pursuit_step_batch,
    obs=pursuit_obs,
    obs_layout=pursuit_obs_layout,
)
