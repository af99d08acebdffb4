"""Shared building blocks of the actor-critics.

Counterpart of the JAX package's ``models/common.py``. Layers are named as
the flax modules name them (``pi_0``, ``pi_head``, ``vf_0``, ``vf_head``), so
that ``compat.convert.params_from_jax`` maps parameters by name. Dense
weights use orthogonal init with gains sqrt(2) (hidden), 0.01 (action head)
and 1.0 (value head), biases zero.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

HIDDEN_GAIN = math.sqrt(2.0)
POLICY_GAIN = 0.01
VALUE_GAIN = 1.0


def dense(
    in_dim: int, out_dim: int, gain: float, generator: Optional[torch.Generator]
) -> nn.Linear:
    """``nn.Linear`` with orthogonal weight of ``gain`` and zero bias."""
    layer = nn.Linear(in_dim, out_dim)
    with torch.no_grad():
        nn.init.orthogonal_(layer.weight, gain=gain, generator=generator)
        layer.bias.zero_()
    return layer


def masked_mean_pool(
    x: torch.Tensor, mask: Optional[torch.Tensor]
) -> torch.Tensor:
    """Mean over the agent axis (-2), ignoring masked agents, keepdim:
    ``x (..., N, E)``, ``mask (..., N)`` -> ``(..., 1, E)``."""
    if mask is None:
        return x.mean(dim=-2, keepdim=True)
    m = mask.to(x.dtype)[..., None]
    return (x * m).sum(dim=-2, keepdim=True) / torch.clamp_min(
        m.sum(dim=-2, keepdim=True), 1.0
    )


class PolicyHead(nn.Module):
    """Per-agent action-mean tower: tanh MLP and an orthogonal(0.01) head."""

    def __init__(
        self,
        in_dim: int,
        act_dim: int,
        hidden: Sequence[int],
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        self.depth = len(hidden)
        width = in_dim
        for i, out in enumerate(hidden):
            self.add_module(f"pi_{i}", dense(width, out, HIDDEN_GAIN, generator))
            width = out
        self.pi_head = dense(width, act_dim, POLICY_GAIN, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.depth):
            x = torch.tanh(getattr(self, f"pi_{i}")(x))
        return self.pi_head(x)


class PooledValueHead(nn.Module):
    """Centralized per-agent value head: each agent's features joined with
    the masked formation mean, a tanh tower, values of masked agents 0."""

    def __init__(
        self,
        in_dim: int,
        hidden: Sequence[int],
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        self.depth = len(hidden)
        width = 2 * in_dim
        for i, out in enumerate(hidden):
            self.add_module(f"vf_{i}", dense(width, out, HIDDEN_GAIN, generator))
            width = out
        self.vf_head = dense(width, 1, VALUE_GAIN, generator)

    def forward(
        self, x: torch.Tensor, mask: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        pooled = masked_mean_pool(x, mask)
        vf = torch.cat([x, pooled.expand_as(x)], dim=-1)
        for i in range(self.depth):
            vf = torch.tanh(getattr(self, f"vf_{i}")(vf))
        value = self.vf_head(vf).squeeze(-1)
        if mask is not None:
            value = value * mask.to(value.dtype)
        return value
