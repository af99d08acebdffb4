"""The formation environment in plain PyTorch, batched over M formations.

Written from the reference simulator's rules (integrate and clip to the
world box, obstacle boxes with the point as their lower-left corner, the
reward on the moved state, the ring of neighbors, the timeout ``done =
steps > max_steps``), for the steps a check follows. It never resets: a
formation that is done ends what the check can follow, and the caller
stops there.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Tuple

import torch

from benchmark.reference.knn import knn

Tensor = torch.Tensor


class State(NamedTuple):
    agents: Tensor  # (M, N, 2)
    goal: Tensor  # (M, 2)
    obstacles: Tensor  # (M, K, 2)
    steps: Tensor  # (M,) int


def _norm(v: Tensor) -> Tensor:
    return torch.sqrt((v * v).sum(-1))


def observe(agents: Tensor, goal: Tensor, env: Dict) -> Tensor:
    """Each agent's observation ``(M, N, obs_dim)``: ring (self and the two
    ring neighbors, each relative to self) or k-NN (self, the k nearest
    neighbors' offsets and distances, and their indices as floats), with
    the goal relative to self when ``goal_in_obs``; positions over the
    world's width and height, distances over its diagonal."""
    wh = torch.tensor([env["width"], env["height"]], dtype=agents.dtype,
                      device=agents.device)
    own = agents / wh
    to_goal = [(goal[:, None, :] - agents) / wh] if env["goal_in_obs"] else []
    if env["obs_mode"] == "ring":
        prev = torch.roll(agents, 1, dims=1) / wh
        nxt = torch.roll(agents, -1, dims=1) / wh
        return torch.cat([own, prev - own, nxt - own, *to_goal], dim=-1)
    k = env["knn_k"]
    idx, offsets, dists = knn(agents, k)
    diag = torch.tensor([math.hypot(env["width"], env["height"])],
                        dtype=agents.dtype, device=agents.device)
    m, n = agents.shape[:2]
    return torch.cat([own, (offsets / wh).reshape(m, n, 2 * k), dists / diag,
                      *to_goal, idx.to(agents.dtype)], dim=-1)


def _penalty(diff: Tensor, scale: float) -> Tensor:
    """Too close costs the squared shortfall, too far the excess."""
    return -scale * torch.where(diff < 0, diff * diff, diff)


def step(state: State, velocity: Tensor, env: Dict
         ) -> Tuple[State, Tensor, Tensor, Dict[str, Tensor]]:
    """One step with raw velocities ``(M, N, 2)``: ``(next state, reward
    (M, N), done (M,), metrics)``, the reward mixed over ring neighbors
    with ``share_reward_ratio``."""
    w, h = env["width"], env["height"]
    agents = state.agents + velocity
    oob = ((agents[..., 0] <= 0) | (agents[..., 1] <= 0)
           | (agents[..., 0] >= w) | (agents[..., 1] >= h))
    agents = torch.minimum(
        agents.clamp_min(0.0),
        torch.tensor([w, h], dtype=agents.dtype, device=agents.device))
    if state.obstacles.shape[1]:
        lo = state.obstacles[:, :, None, :]
        a = agents[:, None]
        inside = ((lo <= a) & (a <= lo + env["obstacle_size"])).all(-1)
        in_obstacle = inside.any(1)
    else:
        in_obstacle = torch.zeros_like(oob)
    dist_goal = _norm(agents - state.goal[:, None, :])
    nxt = torch.roll(agents, -1, dims=1)
    prev = torch.roll(agents, 1, dims=1)
    dist_right = _norm(agents - nxt)
    dist_left = _norm(agents - prev)
    target = 2.0 * env["desired_radius"] * math.sin(
        math.pi / env["num_agents"])
    scale = env["neighbor_penalty_scale"]
    own = (-env["reward_dist_scale"] * dist_goal
           + env["close_goal_bonus"] * (dist_goal < env["close_goal_dist"])
           + _penalty(dist_right - target, scale)
           + _penalty(dist_left - target, scale)
           - env["oob_penalty"] * oob
           - env["obstacle_penalty"] * in_obstacle)
    rho = env["share_reward_ratio"]
    reward = (1.0 - 2.0 * rho) * own + rho * (
        torch.roll(own, 1, dims=1) + torch.roll(own, -1, dims=1))
    done = state.steps > env["max_steps"]
    metrics = {"avg_dist_to_goal": dist_goal.mean(-1),
               "ave_dist_to_neighbor": dist_right.mean(-1)}
    return (State(agents, state.goal, state.obstacles, state.steps + 1),
            reward, done, metrics)
