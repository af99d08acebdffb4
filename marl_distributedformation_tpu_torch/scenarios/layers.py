"""Composable disturbance layers around the clean env step, batched over M
formations.

Counterpart of the JAX package's ``scenarios/layers.py``:

- ``perturb_goal`` (pre-step): the goal drifts along a per-episode heading,
  and at ``max_steps // 2`` jumps ``goal_jump`` of the way to a fresh
  target;
- ``perturb_obstacles`` (pre-step): each obstacle drifts along its own
  per-episode heading, clipped to the world box;
- ``perturb_velocity`` (pre-step): per-episode frozen agents, Gaussian and
  constant-bias actuator noise, constant wind with per-step gusts;
- ``perturb_obs`` (post-step): Gaussian and constant-bias sensor noise, comm
  dropout of the neighbor block per agent per step, and obstacle occlusion
  (``occlude_obs``) of the same block near obstacles.

The layers take their random draws as tensors (``engine.EpisodeDraws`` and
``engine.StepDraws``, made by ``engine.ScenarioStreams``), so that tests can
hand them the JAX package's draws. A Bernoulli draw is ``uniform < p``, as
``jax.random.bernoulli`` makes it. ``params`` (``ScenarioParams``) carry a
leading ``(M,)`` axis here (``engine.scenario_step_batch`` broadcasts).

Every layer is guarded by ``torch.where(magnitude > 0, perturbed, clean)``,
never by arithmetic with a zero magnitude (``x + 0.0`` turns ``-0.0`` into
``0.0``, and ``0 * noise`` carries a NaN), so at zero magnitude the output
is the clean value bitwise. Columns that observation layers blank come from
the env's declared layout (``neighbor_obs_columns``), never hard-coded.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from marl_distributedformation_tpu_torch.env.formation import _const, _norm
from marl_distributedformation_tpu_torch.env.types import (
    EnvParams,
    FormationState,
)
from marl_distributedformation_tpu_torch.scenarios.params import (
    ScenarioParams,
)

Tensor = torch.Tensor


def _lead(mag: Tensor, like: Tensor) -> Tensor:
    """``mag (M,)`` shaped to broadcast against ``like (M, ...)``."""
    return mag.reshape(-1, *([1] * (like.dim() - 1)))


def _guard(on: Tensor, perturbed: Tensor, clean: Tensor) -> Tensor:
    """``perturbed`` where the formation's layer is on, else ``clean``."""
    return torch.where(_lead(on, clean), perturbed, clean)


def unit_heading(theta: Tensor) -> Tensor:
    """``(..., 2)`` unit vectors at angles ``theta``."""
    return torch.stack([torch.cos(theta), torch.sin(theta)], dim=-1)


def _clip_to_world(x: Tensor, params: EnvParams) -> Tensor:
    return torch.minimum(torch.clamp_min(x, 0.0),
                         _const([params.width, params.height], x))


def perturb_goal(
    state: FormationState, sp: ScenarioParams, params: EnvParams,
    goal_theta: Tensor, switch_u: Tensor,
) -> Tensor:
    """The goal the step consumes ``(M, 2)``: drift along the episode
    heading ``goal_theta (M,)``, then at ``max_steps // 2`` a jump
    ``goal_jump`` of the way to the target of the uniforms ``switch_u (M,
    2)`` (a ``desired_radius`` margin from the walls)."""
    goal = state.goal
    moved = _clip_to_world(
        goal + sp.goal_speed[:, None] * unit_heading(goal_theta), params
    )
    goal = _guard(sp.goal_speed > 0, moved, goal)
    margin = params.desired_radius
    wh = _const([params.width, params.height], goal)
    fresh = switch_u * (wh - 2.0 * margin) + margin
    at_switch = state.steps == params.max_steps // 2
    switched = goal + sp.goal_jump[:, None] * (fresh - goal)
    return _guard(at_switch & (sp.goal_jump > 0), switched, goal)


def perturb_obstacles(
    state: FormationState, sp: ScenarioParams, params: EnvParams,
    obstacle_theta: Tensor,
) -> Tensor:
    """The obstacles the step consumes ``(M, K, 2)``: each drifts
    ``obstacle_speed`` px along its episode heading ``obstacle_theta (M,
    K)``, clipped to the world. The moved positions carry forward through
    the episode. The identity without obstacles."""
    if params.num_obstacles == 0:
        return state.obstacles
    moved = _clip_to_world(
        state.obstacles + sp.obstacle_speed[:, None, None]
        * unit_heading(obstacle_theta),
        params,
    )
    return _guard(sp.obstacle_speed > 0, moved, state.obstacles)


def perturb_velocity(
    velocity: Tensor, sp: ScenarioParams, fault_u: Tensor,
    act_noise: Tensor, act_theta: Tensor, gust: Tensor,
) -> Tensor:
    """Fault, then actuator noise, then wind, on raw velocities ``(M, N,
    2)``: agents whose episode uniform ``fault_u (M, N)`` is below
    ``fault_prob`` are frozen; the normals ``act_noise (M, N, 2)`` scaled
    by ``act_noise_sigma`` plus ``act_bias`` along the episode heading
    ``act_theta (M,)``; ``wind`` plus ``gust_sigma`` times the normals
    ``gust (M, 2)``, the same for the whole formation."""
    frozen = fault_u < torch.clamp(sp.fault_prob, 0.0, 1.0)[:, None]
    faulted = torch.where(frozen[..., None], 0.0, velocity)
    velocity = _guard(sp.fault_prob > 0, faulted, velocity)

    noisy = (
        velocity
        + _lead(sp.act_noise_sigma, velocity) * act_noise
        + (sp.act_bias[:, None] * unit_heading(act_theta))[:, None, :]
    )
    velocity = _guard((sp.act_noise_sigma > 0) | (sp.act_bias > 0), noisy,
                      velocity)

    blown = (velocity + sp.wind[:, None, :]
             + (sp.gust_sigma[:, None] * gust)[:, None, :])
    windy = (torch.abs(sp.wind).sum(-1) > 0) | (sp.gust_sigma > 0)
    return _guard(windy, blown, velocity)


def neighbor_obs_columns(
    params: EnvParams, needed_by: str = "comm dropout"
) -> np.ndarray:
    """Static ``(obs_dim,)`` mask of the env's declared ``neighbor``
    observation block, what comm dropout and occlusion blank; an env that
    declares none raises naming the blocks it has. Own position and the
    goal stay visible: dropped comm, not a dead sensor."""
    from marl_distributedformation_tpu_torch.envs import spec_for_params

    layout = spec_for_params(params).obs_layout(params)
    return layout.columns("neighbor", needed_by=needed_by)


@functools.lru_cache(maxsize=None)
def _columns_on(params: EnvParams, needed_by: str,
                device: torch.device) -> Tensor:
    # Made once per device, outside any captured graph's replays (the
    # phase's eager warm-up makes it); callers never write to it.
    return torch.as_tensor(neighbor_obs_columns(params, needed_by),
                           device=device)


def occlude_obs(
    obs: Tensor, state: FormationState, sp: ScenarioParams,
    params: EnvParams,
) -> Tensor:
    """Agents within ``obstacle_occlusion`` px of an obstacle lose their
    neighbor block (geometry, no draw). The identity without obstacles."""
    if params.num_obstacles == 0:
        return obs
    dists = _norm(state.agents[:, :, None, :] - state.obstacles[:, None, :, :])
    occluded = dists.min(dim=-1).values < sp.obstacle_occlusion[:, None]
    cols = _columns_on(params, "obstacle occlusion", obs.device)
    masked = torch.where(occluded[..., None] & cols, 0.0, obs)
    return _guard(sp.obstacle_occlusion > 0, masked, obs)


def perturb_obs(
    obs: Tensor, state: FormationState, sp: ScenarioParams,
    params: EnvParams, obs_noise: Tensor, obs_bias: Tensor, comm_u: Tensor,
) -> Tensor:
    """Sensor noise, then comm dropout, then occlusion, on the observation
    ``(M, N, obs_dim)`` of the post-step ``state``: the normals
    ``obs_noise`` scaled by ``obs_noise_sigma`` plus ``obs_bias`` times the
    episode's per-column normals ``obs_bias (M, obs_dim)``; the neighbor
    block blanked for agents whose uniform ``comm_u (M, N)`` is below
    ``comm_drop_prob``. Only what is observed changes; rewards, metrics
    and the state stay exact."""
    noisy = (
        obs
        + _lead(sp.obs_noise_sigma, obs) * obs_noise
        + (sp.obs_bias[:, None] * obs_bias)[:, None, :]
    )
    obs = _guard((sp.obs_noise_sigma > 0) | (sp.obs_bias > 0), noisy, obs)

    cols = _columns_on(params, "comm dropout", obs.device)
    dropped = comm_u < torch.clamp(sp.comm_drop_prob, 0.0, 1.0)[:, None]
    masked = torch.where(dropped[..., None] & cols, 0.0, obs)
    obs = _guard(sp.comm_drop_prob > 0, masked, obs)
    return occlude_obs(obs, state, sp, params)
