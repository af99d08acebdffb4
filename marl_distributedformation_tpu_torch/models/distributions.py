"""Diagonal Gaussian with a state-independent ``log_std``.

Counterpart of the JAX package's ``models/distributions.py`` (SB3's
``DiagGaussianDistribution``, reference vectorized_env.py:126). ``sample``
draws from an explicit ``torch.Generator`` (or a population's).
"""

from __future__ import annotations

import math

import torch

from marl_distributedformation_tpu_torch.device import Streams, draw

_LOG_2PI = math.log(2.0 * math.pi)


def sample(
    generator: Streams,
    mean: torch.Tensor,
    log_std: torch.Tensor,
) -> torch.Tensor:
    """Reparameterized draw: ``mean + exp(log_std) * eps``; with a
    population's generators, member i's leading rows of ``eps`` from its
    own (``device.draw``)."""
    eps = draw(torch.randn, generator, mean.shape, mean.device, mean.dtype)
    return mean + torch.exp(log_std) * eps


def log_prob(
    actions: torch.Tensor, mean: torch.Tensor, log_std: torch.Tensor
) -> torch.Tensor:
    """Log density summed over the action dimension."""
    z = (actions - mean) * torch.exp(-log_std)
    per_dim = -0.5 * (z * z + _LOG_2PI) - log_std
    return per_dim.sum(-1)


def entropy(log_std: torch.Tensor) -> torch.Tensor:
    """Differential entropy, shape ``()``."""
    return (log_std + 0.5 * (1.0 + _LOG_2PI)).sum()


def mode(mean: torch.Tensor) -> torch.Tensor:
    """Deterministic action (``predict(deterministic=True)``)."""
    return mean
