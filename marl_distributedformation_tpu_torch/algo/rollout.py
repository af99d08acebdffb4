"""On-policy rollout collection.

Counterpart of the JAX package's ``algo/rollout.py``: policy forward, action
sampling, env step and buffer write for ``n_steps`` steps, here a Python
loop under ``torch.no_grad()`` that never reads back from the device.

As in SB3, the buffer keeps the *unclipped* sample and its log-prob; the env
is stepped with ``max_speed * clip(action, -1, 1)`` (reference
vectorized_env.py:69-70), and each formation's ``done`` is broadcast to its
agents.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from marl_distributedformation_tpu_torch.device import Streams
from marl_distributedformation_tpu_torch.env.types import (
    EnvParams,
    FormationState,
    Transition,
)
from marl_distributedformation_tpu_torch.envs import spec_for_params
from marl_distributedformation_tpu_torch.models import distributions

Tensor = torch.Tensor
EnvStepFn = Callable[[FormationState, Tensor], Tuple[FormationState, Transition]]


@dataclasses.dataclass
class RolloutBatch:
    """Time-major rollout storage."""

    obs: Tensor  # (T, M, N, obs_dim)
    actions: Tensor  # (T, M, N, act_dim), unclipped samples
    log_probs: Tensor  # (T, M, N)
    values: Tensor  # (T, M, N)
    rewards: Tensor  # (T, M, N)
    dones: Tensor  # (T, M, N) float32
    metrics: Dict[str, Tensor]  # per-step env metrics, each (T, M)


def policy_forward(
    model: torch.nn.Module, obs: Tensor, mask: Optional[Tensor] = None
) -> Tuple[Tensor, Tensor, Tensor]:
    """``(mean (M, N, act_dim), log_std, value (M, N))`` for ``obs (M, N,
    obs_dim)``: whole formations for a per-formation model (with the agent
    mask ``(M, N)`` of padded formations when given), the flattened agent
    rows for an agent-factored one."""
    if model.per_formation:
        return model(obs) if mask is None else model(obs, mask)
    if mask is not None:
        raise ValueError("an agent-factored model takes no agent mask")
    lead = obs.shape[:-1]
    mean, log_std, value = model(obs.reshape(-1, obs.shape[-1]))
    return mean.reshape(*lead, -1), log_std, value.reshape(lead)


@torch.no_grad()
def collect_rollout(
    model: torch.nn.Module,
    env_state: FormationState,
    obs: Tensor,
    generator: Streams,
    env_params: EnvParams,
    n_steps: int,
    env_step_fn: Optional[EnvStepFn] = None,
    noise: Optional[Tensor] = None,
    forward: Optional[Callable[..., Tuple[Tensor, Tensor, Tensor]]] = None,
    mask: Optional[Tensor] = None,
    block: Any = None,
) -> Tuple[FormationState, Tensor, RolloutBatch, Tensor]:
    """Roll ``n_steps`` steps of M formations under the current policy.

    ``env_step_fn(state, velocity)`` defaults to the ``step_batch`` of the
    params' env (``envs.spec_for_params``) with resets drawn from
    ``generator`` (padded formations pass
    ``env.hetero.hetero_step_batch``); ``noise (T, M, N, act_dim)``
    replaces the generator's action draws. ``forward(model, obs[, mask])``
    defaults to ``policy_forward``; a population (``models/population.py``)
    passes its own, over its members' formations in turn, with their
    generators. ``mask (M, N)``, the agent mask of padded formations, goes
    to a per-formation model's every forward; it holds for the whole
    rollout, since an auto-reset keeps each formation's agent count.
    ``block`` (a ``parallel.mesh.Mesh``) makes the formations a rank's
    block of a mesh: each step draws the whole batch's action noise
    (``block.whole_shape``) as the single run does and keeps the block's
    (``block.take``); injected ``noise`` is the whole batch's too.
    Returns ``(env_state, last_obs, batch, last_value)``.
    """
    forward = forward or policy_forward
    masked = () if mask is None else (mask,)
    if env_step_fn is None:
        step_batch = spec_for_params(env_params).step_batch

        def env_step_fn(state, velocity):
            return step_batch(state, velocity, env_params, generator)

    rows = {k: [] for k in ("obs", "actions", "log_probs", "values",
                            "rewards", "dones")}
    metrics: Dict[str, list] = {}
    for t in range(n_steps):
        mean, log_std, value = forward(model, obs, *masked)
        if block is not None:
            eps = noise[t] if noise is not None else torch.randn(
                block.whole_shape(mean.shape), generator=generator,
                device=mean.device, dtype=mean.dtype)
            action = mean + torch.exp(log_std) * block.take(eps)
        elif noise is None:
            action = distributions.sample(generator, mean, log_std)
        else:
            action = mean + torch.exp(log_std) * noise[t]
        log_p = distributions.log_prob(action, mean, log_std)
        clipped = torch.clamp(action, -1.0, 1.0)
        env_state, tr = env_step_fn(env_state, env_params.max_speed * clipped)
        done = tr.done[:, None].expand_as(tr.reward).to(torch.float32)
        for k, v in (("obs", obs), ("actions", action), ("log_probs", log_p),
                     ("values", value), ("rewards", tr.reward),
                     ("dones", done)):
            rows[k].append(v)
        for k, v in tr.metrics.items():
            metrics.setdefault(k, []).append(v)
        obs = tr.obs
    _, _, last_value = forward(model, obs, *masked)
    batch = RolloutBatch(
        **{k: torch.stack(v) for k, v in rows.items()},
        metrics={k: torch.stack(v) for k, v in metrics.items()},
    )
    return env_state, obs, batch, last_value
