"""Proximal Policy Optimization: clipped surrogate, minibatch epochs.

Counterpart of the JAX package's ``algo/ppo.py`` with the same config, loss,
metrics and quirks:

- when the rollout size is not a multiple of ``batch_size`` the remainder is
  dropped from each epoch's shuffled pass (SB3 runs a last, smaller
  minibatch); ``batch_size`` is clamped to the rollout size;
- advantages are normalised per minibatch with the unbiased std;
- the ``ent_coef_final`` and ``log_std_final`` schedules take their progress
  from the optimizer step as two float32 limbs (``step // 4096``,
  ``step % 4096``), so it stays monotone past 2^24;
- the ``log_std`` ceiling is computed from the step before the optimizer
  step and applied after it, one step behind (ADVICE.md); kept as it is.

The JAX package scans the minibatches inside one program; here they are a
Python loop whose metrics stay on the device until the end of the update.
The schedules are computed on the host in float32 from the host's step
counter, so no minibatch waits for the device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from marl_distributedformation_tpu_torch.algo.optim import (
    AdamState,
    clipped_adam_step,
)
from marl_distributedformation_tpu_torch.models import distributions

Tensor = torch.Tensor

LOSS_METRICS = (
    "loss", "policy_loss", "value_loss", "entropy", "approx_kl",
    "clip_fraction",
)


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    """Static PPO hyperparameters, fields and defaults as the JAX package's:
    SB3's defaults with the reference's overrides (``n_steps=10``,
    ``learning_rate=1e-3``, ``ent_coef=0.01``). ``ent_coef_final`` anneals
    the entropy bonus linearly over the run; ``log_std_final`` clamps the
    ``log_std`` parameter under a ceiling that decays from ``log_std_init``
    after ``log_std_decay_start`` of the run. ``total_iterations`` is the
    schedules' horizon, filled by the trainer."""

    n_steps: int = 10
    learning_rate: float = 1e-3
    ent_coef: float = 0.01
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_range: float = 0.2
    clip_range_vf: Optional[float] = None
    n_epochs: int = 10
    batch_size: int = 64
    vf_coef: float = 0.5
    max_grad_norm: float = 0.5
    adam_eps: float = 1e-5
    normalize_advantage: bool = True
    log_std_init: float = 0.0
    ent_coef_final: Optional[float] = None
    log_std_final: Optional[float] = None
    log_std_decay_start: float = 0.0
    total_iterations: int = 0


@dataclasses.dataclass
class MinibatchData:
    """Flat rollout rows: ``(b, obs_dim)`` for agent-factored models,
    ``(b, N, obs_dim)`` for per-formation ones. ``weights`` and ``mask``
    (padded formations) stay None until the hetero slice."""

    obs: Tensor
    actions: Tensor
    old_log_probs: Tensor
    advantages: Tensor
    returns: Tensor
    weights: Optional[Tensor] = None
    mask: Optional[Tensor] = None

    def take(self, idx: Tensor) -> "MinibatchData":
        return MinibatchData(**{
            f.name: None if getattr(self, f.name) is None
            else getattr(self, f.name)[idx]
            for f in dataclasses.fields(self)
        })


def ppo_loss(
    model: torch.nn.Module,
    mb: MinibatchData,
    config: PPOConfig,
    ent_coef: Optional[float] = None,
) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Clipped-surrogate PPO loss on one minibatch (SB3 semantics) and its
    metrics (detached). ``ent_coef`` overrides ``config.ent_coef`` when the
    entropy coefficient is scheduled."""
    if mb.weights is not None:
        raise NotImplementedError(
            "weighted PPO loss (padded formations) is not ported yet "
            "(ROADMAP A9)"
        )
    if mb.mask is not None:
        mean, log_std, values = model(mb.obs, mb.mask)
    else:
        mean, log_std, values = model(mb.obs)
    log_probs = distributions.log_prob(mb.actions, mean, log_std)
    ent = distributions.entropy(log_std)

    advantages = mb.advantages
    if config.normalize_advantage:
        advantages = (advantages - advantages.mean()) / (
            advantages.std(correction=1) + 1e-8
        )

    ratio = torch.exp(log_probs - mb.old_log_probs)
    unclipped = advantages * ratio
    clipped = advantages * torch.clamp(
        ratio, 1.0 - config.clip_range, 1.0 + config.clip_range
    )
    policy_loss = -torch.minimum(unclipped, clipped).mean()

    if config.clip_range_vf is not None:
        # SB3's value clipping around the rollout-time values, recovered
        # from GAE's identity returns = advantages + values.
        old_values = mb.returns - mb.advantages
        values = old_values + torch.clamp(
            values - old_values, -config.clip_range_vf, config.clip_range_vf
        )
    value_loss = ((mb.returns - values) ** 2).mean()
    entropy_loss = -ent

    coef = config.ent_coef if ent_coef is None else ent_coef
    loss = policy_loss + coef * entropy_loss + config.vf_coef * value_loss
    with torch.no_grad():
        metrics = {
            "loss": loss.detach(),
            "policy_loss": policy_loss.detach(),
            "value_loss": value_loss.detach(),
            "entropy": ent.detach(),
            "approx_kl": (mb.old_log_probs - log_probs).mean(),
            "clip_fraction": (
                (ratio - 1.0).abs() > config.clip_range
            ).to(torch.float32).mean(),
        }
    return loss, metrics


def schedule_values(
    config: PPOConfig, step: int, expected_total: int
) -> Dict[str, np.float32]:
    """``ent_coef`` and ``log_std_ceiling`` at optimizer step ``step``, in
    float32 as the JAX package computes them (only the scheduled ones)."""
    out: Dict[str, np.float32] = {}
    f32 = np.float32
    hi = f32(step // 4096)
    lo = f32(step % 4096)
    progress = np.clip(
        hi * f32(4096.0 / expected_total) + lo / f32(expected_total),
        f32(0.0), f32(1.0),
    )
    if config.ent_coef_final is not None:
        out["ent_coef"] = f32(config.ent_coef) + progress * f32(
            config.ent_coef_final - config.ent_coef
        )
    if config.log_std_final is not None:
        start = config.log_std_decay_start
        sprog = np.clip(
            (progress - f32(start)) / f32(max(1.0 - start, 1e-8)),
            f32(0.0), f32(1.0),
        )
        out["log_std_ceiling"] = f32(config.log_std_init) + sprog * f32(
            config.log_std_final - config.log_std_init
        )
    return out


def _check_schedules(model: torch.nn.Module, config: PPOConfig) -> None:
    if config.ent_coef_final is None and config.log_std_final is None:
        return
    if config.total_iterations <= 0:
        raise ValueError(
            "ent_coef_final/log_std_final need total_iterations > 0 (the "
            "trainer fills it; pass the planned iteration count when "
            "building PPOConfig by hand)"
        )
    if config.log_std_final is not None:
        names = {n.split(".")[-1] for n, _ in model.named_parameters()}
        if "log_std" not in names:
            raise ValueError(
                "log_std_final needs a 'log_std' parameter; the model has "
                f"{sorted(names)}"
            )
        if not 0.0 <= config.log_std_decay_start < 1.0:
            raise ValueError(
                "log_std_decay_start is the fraction of the run to hold the "
                f"ceiling and must be in [0, 1), got "
                f"{config.log_std_decay_start}"
            )


def ppo_update(
    model: torch.nn.Module,
    opt_state: AdamState,
    step: int,
    data: MinibatchData,
    generator: Optional[torch.Generator],
    config: PPOConfig,
    permutations: Optional[Tensor] = None,
) -> Tuple[int, Dict[str, object]]:
    """``n_epochs`` of shuffled minibatch steps over flat rollout rows.

    Updates ``model``'s parameters and ``opt_state`` in place and returns
    ``(step after the update, metrics)``: 0-d device tensors averaged over
    the minibatches of each epoch and then over the epochs, plus the
    schedules' host floats. Each epoch's permutation is
    ``torch.randperm(total, generator)[:used]``; ``permutations``
    ``(n_epochs, used)`` replaces them (tests feed the JAX package's).
    """
    _check_schedules(model, config)
    total = data.obs.shape[0]
    batch_size = min(config.batch_size, total)
    num_minibatches = total // batch_size
    used = num_minibatches * batch_size
    expected_total = config.total_iterations * config.n_epochs * num_minibatches

    named = list(model.named_parameters())
    params = [p for _, p in named]
    log_std = [p for n, p in named if n.split(".")[-1] == "log_std"]
    device = data.obs.device
    names = LOSS_METRICS + ("grad_norm",)
    buf = torch.empty(
        (config.n_epochs, num_minibatches, len(names)), device=device
    )
    sched = {}
    for epoch in range(config.n_epochs):
        if permutations is None:
            perm = torch.randperm(
                total, generator=generator, device=device
            )[:used]
        else:
            perm = permutations[epoch].to(device)
        idx = perm.reshape(num_minibatches, batch_size)
        for i in range(num_minibatches):
            mb = data.take(idx[i])
            values = {}
            if expected_total > 0:
                values = schedule_values(config, step, expected_total)
            ent_coef = values.get("ent_coef")
            loss, metrics = ppo_loss(
                model, mb, config,
                None if ent_coef is None else float(ent_coef),
            )
            grads = torch.autograd.grad(loss, params)
            metrics["grad_norm"] = clipped_adam_step(
                params, grads, opt_state, config.learning_rate,
                config.max_grad_norm, config.adam_eps,
            )
            step += 1
            if "log_std_ceiling" in values:
                with torch.no_grad():
                    for p in log_std:
                        p.clamp_(max=float(values["log_std_ceiling"]))
            buf[epoch, i] = torch.stack([metrics[n] for n in names])
            for k, v in values.items():
                sched.setdefault(k, []).append(v)
    means = buf.mean(dim=1).mean(dim=0)
    out: Dict[str, object] = {n: means[j] for j, n in enumerate(names)}
    for k, v in sched.items():
        per_epoch = np.asarray(v, np.float32).reshape(config.n_epochs, -1)
        out[k] = float(per_epoch.mean(axis=1).mean())
    return step, out
