"""Plug your own policy network into the trainer.

    python -m marl_distributedformation_tpu_torch.examples.custom_policy
    python -m marl_distributedformation_tpu_torch.examples.custom_policy \\
        device=cpu

``Trainer(model=...)`` takes any ``nn.Module`` with the actor-critic
contract the built-in models follow (``models/mlp.py``):

- ``forward(obs) -> (action_mean, log_std, value)``, ``obs`` with any
  leading batch axes, ``action_mean``'s last axis ``act_dim``, ``log_std``
  the Gaussian's state-independent log-scale, ``value`` without the last
  axis;
- a class attribute ``per_formation``: False applies the model to each
  agent's row (the reference's parameter sharing, vectorized_env.py:32),
  True hands it whole ``(M, N, obs_dim)`` formations (as the CTDE critic).

This example defines a residual LayerNorm actor-critic, which the built-in
models do not include, trains it briefly and compares it with the scripted
baseline controller on held-out formations. ``EXAMPLE_TOTAL_TIMESTEPS``
(default 320000) and ``EXAMPLE_LOG_DIR`` (default
``logs/example_custom_policy``) set the budget and the metrics' directory.
"""

from __future__ import annotations

import os
import sys
from typing import Dict, Tuple

import torch
from torch import nn


class ResidualActorCritic(nn.Module):
    """Pre-LayerNorm residual MLP actor-critic, shared by every agent."""

    per_formation = False

    def __init__(self, obs_dim: int, act_dim: int = 2, width: int = 64,
                 blocks: int = 2, log_std_init: float = 0.0) -> None:
        super().__init__()
        self.towers = nn.ModuleDict({
            tag: nn.ModuleDict({
                "inp": nn.Linear(obs_dim, width),
                "norms": nn.ModuleList(
                    nn.LayerNorm(width) for _ in range(blocks)),
                "fcs": nn.ModuleList(
                    nn.Linear(width, width) for _ in range(blocks)),
            })
            for tag in ("pi", "vf")
        })
        self.pi_head = nn.Linear(width, act_dim)
        self.vf_head = nn.Linear(width, 1)
        nn.init.orthogonal_(self.pi_head.weight, 0.01)
        nn.init.orthogonal_(self.vf_head.weight, 1.0)
        nn.init.zeros_(self.pi_head.bias)
        nn.init.zeros_(self.vf_head.bias)
        self.log_std = nn.Parameter(torch.full((act_dim,), log_std_init))

    def _trunk(self, x: torch.Tensor, tag: str) -> torch.Tensor:
        tower = self.towers[tag]
        x = tower["inp"](x)
        for norm, fc in zip(tower["norms"], tower["fcs"]):
            x = x + torch.tanh(fc(norm(x)))  # residual: healthy gradients
        return x

    def forward(self, obs: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        mean = self.pi_head(self._trunk(obs, "pi"))
        value = self.vf_head(self._trunk(obs, "vf"))[..., 0]
        return mean, self.log_std, value


def main(argv=None) -> Dict[str, float]:
    """Train and compare; returns both episode returns per agent."""
    from marl_distributedformation_tpu_torch.algo import PPOConfig
    from marl_distributedformation_tpu_torch.env import EnvParams
    from marl_distributedformation_tpu_torch.eval import (
        baseline_act_fn,
        evaluate,
        policy_act_fn,
    )
    from marl_distributedformation_tpu_torch.train import (
        TrainConfig,
        Trainer,
    )
    from marl_distributedformation_tpu_torch.utils.config import (
        Config,
        apply_overrides,
    )

    cfg = Config(device=None)
    apply_overrides(cfg, sys.argv[1:] if argv is None else argv)

    env = EnvParams(num_agents=5)
    torch.manual_seed(0)
    model = ResidualActorCritic(env.obs_dim, act_dim=env.act_dim)
    trainer = Trainer(
        env,
        # 1600 divides the rollout (64 formations x 5 agents x 10 steps =
        # 3200 transitions), so every collected transition trains.
        ppo=PPOConfig(batch_size=1600),
        config=TrainConfig(
            num_formations=64,
            total_timesteps=int(
                os.environ.get("EXAMPLE_TOTAL_TIMESTEPS", 320_000)),
            name="example_custom_policy",
            log_dir=os.environ.get(
                "EXAMPLE_LOG_DIR", "logs/example_custom_policy"),
            # The demo's output is the comparison below: no checkpoints.
            checkpoint=False,
        ),
        model=model,
        device=cfg.device,
    )
    last = trainer.train()
    print(f"final training reward: {last['reward']:.2f}")

    model.eval()
    with torch.no_grad():
        ours = evaluate(policy_act_fn(model, env), env, num_formations=256,
                        device=trainer.device)
        base = evaluate(baseline_act_fn(env), env, num_formations=256,
                        device=trainer.device)
    print(
        f"episode return/agent: custom policy "
        f"{ours['episode_return_per_agent']:.1f} vs scripted baseline "
        f"{base['episode_return_per_agent']:.1f}"
    )
    return {"custom": ours["episode_return_per_agent"],
            "baseline": base["episode_return_per_agent"]}


if __name__ == "__main__":
    main()
