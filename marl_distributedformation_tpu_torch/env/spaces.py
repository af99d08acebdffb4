"""Space metadata for the formation environment.

A copy of the JAX package's ``env/spaces.py``: the reference's VecEnv
adapter declares gymnasium ``spaces.Box`` metadata (vectorized_env.py:34-35),
a per-agent action ``(2,)`` in [-1, 1] and an observation ``(obs_dim,)``
nominally in [-1, 1] (declared, not enforced: SURVEY.md Q10). ``Box`` holds
the same metadata in numpy; ``to_gymnasium`` converts it for a frontend and
is the only place that imports gymnasium.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from marl_distributedformation_tpu_torch.env.types import EnvParams


@dataclasses.dataclass(frozen=True)
class Box:
    low: float
    high: float
    shape: Tuple[int, ...]
    dtype: type = np.float32

    def sample(self, rng: np.random.Generator) -> np.ndarray:
        return rng.uniform(self.low, self.high, self.shape).astype(self.dtype)

    def to_gymnasium(self):
        try:
            from gymnasium import spaces
        except ImportError as e:
            raise ImportError(
                "Box.to_gymnasium needs the gymnasium package"
            ) from e
        return spaces.Box(
            low=self.low, high=self.high, shape=self.shape, dtype=self.dtype
        )


def action_space(params: EnvParams) -> Box:
    """Per-agent action space (reference vectorized_env.py:34)."""
    return Box(low=-1.0, high=1.0, shape=(params.act_dim,))


def observation_space(params: EnvParams) -> Box:
    """Per-agent observation space (reference vectorized_env.py:35)."""
    return Box(low=-1.0, high=1.0, shape=(params.obs_dim,))
