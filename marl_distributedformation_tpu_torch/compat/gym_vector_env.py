"""M formations as a ``gymnasium.vector.VectorEnv``.

Counterpart of the JAX package's ``compat/gym_vector_env.py``: the batched
half of ``compat.gym_env``, each sub-env a whole formation under
centralized control, the M formations stepped as one batch on the device
(``compat.vec_env.FormationVecEnv``), with no per-env Python loop.

Autoreset is ``SAME_STEP`` (``metadata["autoreset_mode"]``): a finished
formation's step returns the next episode's first observation with the
terminal reward, the SB3 convention the reference trains under
(simulate.py:113-116). That convention discards the final observation
(SURVEY.md Q4), so ``infos`` has no ``final_obs``; ``infos["steps"]`` has
each formation's episode step counter.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np

from marl_distributedformation_tpu_torch.compat.vec_env import FormationVecEnv
from marl_distributedformation_tpu_torch.device import DeviceLike
from marl_distributedformation_tpu_torch.env import EnvParams

try:
    import gymnasium as gym
    from gymnasium.vector.utils import batch_space
except ImportError as e:
    raise ImportError(
        "compat.gym_vector_env needs the gymnasium package"
    ) from e

from marl_distributedformation_tpu_torch.compat.gym_env import (  # noqa: E402
    episode_end,
    observation_high,
)


class FormationVectorEnv(gym.vector.VectorEnv):
    """M formations as a ``gymnasium.vector.VectorEnv``."""

    metadata = {
        "autoreset_mode": gym.vector.AutoresetMode.SAME_STEP,
        "render_modes": [],
    }

    def __init__(
        self,
        params: Optional[EnvParams] = None,
        num_envs: int = 16,
        device: DeviceLike = None,
    ) -> None:
        self.params = params or EnvParams()
        self.num_envs = int(num_envs)
        n, d = self.params.num_agents, self.params.obs_dim
        self.single_observation_space = gym.spaces.Box(
            low=-1.0, high=observation_high(self.params), shape=(n, d),
            dtype=np.float32,
        )
        self.single_action_space = gym.spaces.Box(
            low=-1.0, high=1.0, shape=(n, 2), dtype=np.float32
        )
        self.observation_space = batch_space(
            self.single_observation_space, self.num_envs
        )
        self.action_space = batch_space(
            self.single_action_space, self.num_envs
        )
        self._venv = FormationVecEnv(self.params, self.num_envs, seed=0,
                                     device=device)
        self._steps = np.zeros(self.num_envs, np.int64)

    # -- gymnasium.vector API -----------------------------------------

    def reset(
        self,
        *,
        seed: Optional[int] = None,
        options: Optional[dict] = None,
    ) -> Tuple[np.ndarray, Dict[str, Any]]:
        self._venv.seed(seed)
        obs = self._venv.reset()
        self._steps[:] = 0
        return obs.reshape(self.num_envs, self.params.num_agents, -1), {}

    def step(
        self, actions: np.ndarray
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, dict]:
        obs, rewards, done, metrics = self._venv.step_arrays(actions)
        self._steps += 1
        terminated, truncated = episode_end(done, self._steps, self.params)
        infos: Dict[str, Any] = {"steps": self._steps.copy(), **metrics}
        self._steps[done] = 0  # those formations auto-reset (module doc)
        return obs, rewards.mean(axis=-1), terminated, truncated, infos

    def close_extras(self, **kwargs: Any) -> None:
        pass
