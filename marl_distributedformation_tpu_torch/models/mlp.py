"""MLP actor-critic, the reference's SB3 ``'MlpPolicy'`` shape.

Counterpart of the JAX package's ``models/mlp.py``: separate tanh towers for
policy and value (default [64, 64]), orthogonal init, and a learned
state-independent ``log_std``. Every agent of every formation shares it.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from marl_distributedformation_tpu_torch.models.common import (
    HIDDEN_GAIN,
    POLICY_GAIN,
    VALUE_GAIN,
    dense,
)


class MLPActorCritic(nn.Module):
    """``forward(obs (..., obs_dim)) -> (mean, log_std, value)``."""

    per_formation = False

    def __init__(
        self,
        obs_dim: int,
        act_dim: int = 2,
        hidden: Sequence[int] = (64, 64),
        log_std_init: float = 0.0,
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        self.depth = len(hidden)
        for prefix in ("pi", "vf"):
            width = obs_dim
            for i, out in enumerate(hidden):
                self.add_module(
                    f"{prefix}_{i}", dense(width, out, HIDDEN_GAIN, generator)
                )
                width = out
        self.pi_head = dense(width, act_dim, POLICY_GAIN, generator)
        self.vf_head = dense(width, 1, VALUE_GAIN, generator)
        self.log_std = nn.Parameter(torch.full((act_dim,), float(log_std_init)))

    def _tower(self, prefix: str, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.depth):
            x = torch.tanh(getattr(self, f"{prefix}_{i}")(x))
        return x

    def forward(
        self, obs: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        mean = self.pi_head(self._tower("pi", obs))
        value = self.vf_head(self._tower("vf", obs)).squeeze(-1)
        return mean, self.log_std, value
