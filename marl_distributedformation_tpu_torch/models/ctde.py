"""Centralized training, decentralized execution (CTDE) actor-critic.

Counterpart of the JAX package's ``models/ctde.py`` (BASELINE config 3): a
per-agent tanh-MLP actor on local observations, shared by every agent, and
a centralized critic, a deep set over the formation: each agent's
``tanh(vf_embed(obs))`` joined with the formation's (masked) mean
embedding, a tanh tower and a value per agent. Deployment needs only the
actor, so execution stays decentralized; the critic's parameters do not
depend on N, and a padded formation's masked agents leave the pool and get
value 0. Inputs are whole formations, ``obs (..., N, obs_dim)``, so the
trainer minibatches by formation (``per_formation``).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from marl_distributedformation_tpu_torch.models.common import (
    HIDDEN_GAIN,
    PolicyHead,
    PooledValueHead,
    dense,
)


class CTDEActorCritic(nn.Module):
    """``forward(obs (..., N, obs_dim), mask=None) -> (mean (..., N,
    act_dim), log_std, value (..., N))``; ``mask (..., N)`` marks the valid
    agents of padded formations."""

    per_formation = True

    def __init__(
        self,
        obs_dim: int,
        act_dim: int = 2,
        hidden: Sequence[int] = (64, 64),
        embed_dim: int = 64,
        log_std_init: float = 0.0,
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        self.actor = PolicyHead(obs_dim, act_dim, hidden, generator)
        self.vf_embed = dense(obs_dim, embed_dim, HIDDEN_GAIN, generator)
        self.critic = PooledValueHead(embed_dim, hidden, generator)
        self.log_std = nn.Parameter(torch.full((act_dim,), float(log_std_init)))

    def forward(
        self, obs: torch.Tensor, mask: Optional[torch.Tensor] = None
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        mean = self.actor(obs)
        value = self.critic(torch.tanh(self.vf_embed(obs)), mask)
        return mean, self.log_std, value
