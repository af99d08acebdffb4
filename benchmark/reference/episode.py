"""One deterministic evaluation episode in plain PyTorch, reduced as the
evaluate CLI reports it."""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

from benchmark.reference import env as ref_env
from benchmark.reference.policy import forward

Tensor = torch.Tensor


def episode_length(env: Dict) -> int:
    """Steps of one episode from a fresh start: done fires when the step
    count before the step exceeds ``max_steps``, so ``max_steps + 2``."""
    return env["max_steps"] + 2


@torch.no_grad()
def run(config: Dict, weights: Dict[str, Tensor], state: ref_env.State,
        precision: str = "float32", at: Sequence[int] = ()
        ) -> Tuple[Dict[str, float], Dict[int, Tensor]]:
    """The episode's summary: the return per agent (the sum over steps of
    the mean reward), the mean step reward, the formations' mean distance
    to the goal and to the next ring neighbor at the last step before the
    reset and over the last 100 such steps, and the episodes finished; and
    the agents after ``t`` steps for each ``t`` of ``at``. The action is
    the policy's mean, clipped to [-1, 1] and scaled by ``max_speed``."""
    env = config["env"]
    steps = episode_length(env)
    obs = ref_env.observe(state.agents, state.goal, env)
    reward, goal_d, nbr_d, done = [], [], [], []
    kept = {}
    for t in range(steps):
        if t in at:
            kept[t] = state.agents.clone()
        mean, _, _ = forward(weights, config["model"], obs, precision)
        state, r, d, metrics = ref_env.step(
            state, env["max_speed"] * mean.clamp(-1.0, 1.0), env)
        reward.append(r.mean())
        goal_d.append(metrics["avg_dist_to_goal"].mean())
        nbr_d.append(metrics["ave_dist_to_neighbor"].mean())
        done.append(d.sum())
        obs = ref_env.observe(state.agents, state.goal, env)
    reward, goal_d, nbr_d = (torch.stack(x).double()
                             for x in (reward, goal_d, nbr_d))
    last = steps - 2
    return {
        "episode_return_per_agent": float(reward.sum()),
        "mean_step_reward": float(reward.mean()),
        "final_avg_dist_to_goal": float(goal_d[last]),
        "last100_avg_dist_to_goal": float(goal_d[last - 99:last + 1].mean()),
        "final_ave_dist_to_neighbor": float(nbr_d[last]),
        "episodes": float(torch.stack(done).sum()),
    }, kept
