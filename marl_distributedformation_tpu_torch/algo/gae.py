"""Generalized Advantage Estimation.

Counterpart of the JAX package's ``algo/gae.py``: the same recursion, run as
a reverse Python loop over the ``T`` rollout steps on the device (the JAX
package scans it). Terminal steps do not bootstrap: the reference's VecEnv
gives no ``terminal_observation``, so ``non_terminal = 1 - dones`` zeroes
both the next value and the carried advantage there.
"""

from __future__ import annotations

from typing import Tuple

import torch

Tensor = torch.Tensor


def compute_gae(
    rewards: Tensor,
    values: Tensor,
    dones: Tensor,
    last_value: Tensor,
    gamma: float,
    gae_lambda: float,
) -> Tuple[Tensor, Tensor]:
    """``(advantages, returns)`` of time-major ``(T, ...)`` rollout tensors;
    ``dones[t]`` marks a transition that ended an episode, ``last_value``
    ``(...)`` is the value of the observation after the last step.
    ``returns = advantages + values`` (TD(lambda) targets, as in SB3)."""
    next_values = torch.cat([values[1:], last_value[None]], dim=0)
    non_terminal = 1.0 - dones.to(values.dtype)
    deltas = rewards + gamma * next_values * non_terminal - values
    advantages = torch.empty_like(deltas)
    adv = torch.zeros_like(last_value)
    for t in reversed(range(deltas.shape[0])):
        adv = deltas[t] + gamma * gae_lambda * non_terminal[t] * adv
        advantages[t] = adv
    return advantages, advantages + values
