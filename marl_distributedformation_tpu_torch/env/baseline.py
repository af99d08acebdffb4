"""Scripted potential-field controller, batched over M formations.

Counterpart of the JAX package's ``env/baseline.py`` (reference
simulate.py:256-319): springs to both ring neighbors and to the opposite
agent, obstacle repulsion and goal attraction. It keeps that module's
deviations from the reference: distances are clamped to ``eps`` before
normalising, and odd N rolls by ``N // 2``. Eval compares learned policies
against it.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from marl_distributedformation_tpu_torch.env.types import EnvParams

CONTROL_DESIRED_RADIUS = 40.0  # reference simulate.py:259
FORMATION_GAIN = 0.02  # simulate.py:290-292
OBSTACLE_GAIN = 0.3  # simulate.py:304
GOAL_GAIN = 0.01  # simulate.py:315


def _unit(vec: torch.Tensor, eps: float = 1e-8) -> Tuple[torch.Tensor, torch.Tensor]:
    dist = torch.sqrt((vec * vec).sum(-1))
    return vec / torch.clamp_min(dist, eps)[..., None], dist


def control(
    agents: torch.Tensor,
    goal: torch.Tensor,
    obstacles: torch.Tensor,
    params: EnvParams,
) -> torch.Tensor:
    """Raw velocity commands ``(M, N, 2)`` for ``agents (M, N, 2)``,
    ``goal (M, 2)`` and ``obstacles (M, K, 2)``."""
    num_agents = agents.shape[1]
    dir_a, dist_a = _unit(torch.roll(agents, -1, dims=1) - agents)
    dir_b, dist_b = _unit(torch.roll(agents, 1, dims=1) - agents)
    dir_opp, dist_opp = _unit(
        torch.roll(agents, num_agents // 2, dims=1) - agents
    )
    desired_dist = math.pi * CONTROL_DESIRED_RADIUS / num_agents

    f_formation = (
        FORMATION_GAIN * (dist_a - desired_dist)[..., None] * dir_a
        + FORMATION_GAIN * (dist_b - desired_dist)[..., None] * dir_b
        + FORMATION_GAIN
        * (dist_opp - 2.0 * CONTROL_DESIRED_RADIUS)[..., None]
        * dir_opp
    )
    f_formation = torch.clamp(f_formation, -1.0, 1.0)

    if obstacles.shape[1] > 0:
        offsets = agents[:, None, :, :] - obstacles[:, :, None, :]  # (M, K, N, 2)
        dists = torch.sqrt((offsets * offsets).sum(-1))
        dirs = offsets / torch.clamp_min(dists, 1e-8)[..., None]
        avoid_dist = params.obstacle_size * 2.0
        repel = torch.clamp_min(-OBSTACLE_GAIN * (dists - avoid_dist), 0.0)
        f_obstacle = (repel[..., None] * dirs).sum(dim=1)
    else:
        f_obstacle = torch.zeros_like(f_formation)

    goal_dir, goal_dist = _unit(agents - goal[:, None, :])
    f_goal = -(GOAL_GAIN * (goal_dist - CONTROL_DESIRED_RADIUS))[..., None] * goal_dir
    f_goal = torch.clamp(f_goal, -1.0, 1.0)
    return f_formation + f_obstacle + f_goal
