"""One formation as a ``gymnasium.Env`` (centralized control view).

Counterpart of the JAX package's ``compat/gym_env.py``; ``compat.vec_env``
is the SB3 half of interop, this is the Gymnasium half:

- observation: ``(N, obs_dim)`` Box, every agent's local view (with
  ``obs_mode=knn`` its envelope widens to ``N-1``: the rows carry raw
  neighbor indices);
- action: ``(N, 2)`` Box in [-1, 1], scaled by ``max_speed`` inside
  (vectorized_env.py:69-70);
- reward: the mean per-agent reward;
- episodes end by truncation at the step limit (the reference's
  timeout-only episodes, SURVEY.md Q3); ``terminated`` fires only with
  ``goal_termination`` and ``strict_parity=False``, told apart from the
  timeout by the step counter.

The env auto-resets on episode end and returns the next episode's first
observation with the terminal reward, the SB3 convention the reference
trains under (simulate.py:113-116); ``info["steps"]`` carries the episode's
step counter so a caller can tell. It steps a ``compat.vec_env.
FormationVecEnv`` of one formation (one copy each way a step).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np

from marl_distributedformation_tpu_torch.compat.vec_env import FormationVecEnv
from marl_distributedformation_tpu_torch.device import DeviceLike
from marl_distributedformation_tpu_torch.env import EnvParams

try:
    import gymnasium as gym
except ImportError as e:
    raise ImportError("compat.gym_env needs the gymnasium package") from e


def observation_high(params: EnvParams) -> float:
    """The declared observation envelope's upper bound: 1, or ``N-1``
    under ``obs_mode=knn`` (raw neighbor indices; ``check_env`` holds the
    observations to it)."""
    return float(max(1, params.num_agents - 1)) if (
        params.obs_mode == "knn") else 1.0


def episode_end(done, steps, params: EnvParams):
    """``(terminated, truncated)`` bool arrays from the env's ``done`` and
    the episode step counters: a done is a goal termination only off
    parity with ``goal_termination``, and never at the step limit (the env
    ORs the two conditions)."""
    done = np.asarray(done, bool)
    timeout = np.asarray(steps) >= params.max_steps
    goal_ends = (not params.strict_parity) and params.goal_termination
    terminated = done & ~timeout & goal_ends
    return terminated, done & ~terminated


class FormationGymEnv(gym.Env):
    """One formation as a ``gymnasium.Env``."""

    metadata = {"render_modes": ["human", "rgb_array"], "render_fps": 10}

    def __init__(
        self,
        params: Optional[EnvParams] = None,
        render_mode: Optional[str] = None,
        device: DeviceLike = None,
    ) -> None:
        self.params = params or EnvParams()
        n, d = self.params.num_agents, self.params.obs_dim
        self.observation_space = gym.spaces.Box(
            low=-1.0, high=observation_high(self.params), shape=(n, d),
            dtype=np.float32,
        )
        self.action_space = gym.spaces.Box(
            low=-1.0, high=1.0, shape=(n, 2), dtype=np.float32
        )
        if render_mode not in (None, *self.metadata["render_modes"]):
            raise ValueError(f"unknown render_mode {render_mode!r}")
        self.render_mode = render_mode
        self._renderer = None
        self._venv = FormationVecEnv(self.params, 1, seed=0, device=device)
        self._steps = 0

    # -- gymnasium API ------------------------------------------------

    def reset(
        self,
        *,
        seed: Optional[int] = None,
        options: Optional[dict] = None,
    ) -> Tuple[np.ndarray, Dict[str, Any]]:
        super().reset(seed=seed)
        self._venv.seed(seed)
        obs = self._venv.reset()
        self._steps = 0
        return obs.reshape(self.params.num_agents, -1), {}

    def step(
        self, action: np.ndarray
    ) -> Tuple[np.ndarray, float, bool, bool, Dict[str, Any]]:
        obs, rewards, done, metrics = self._venv.step_arrays(action)
        self._steps += 1
        terminated, truncated = episode_end(done[0], self._steps,
                                            self.params)
        info: Dict[str, Any] = {
            "steps": self._steps,
            **{k: float(v[0]) for k, v in metrics.items()},
        }
        if done[0]:
            self._steps = 0  # the env auto-reset (module doc)
        if self.render_mode == "human":
            self.render()
        return (obs[0], float(rewards[0].mean()), bool(terminated),
                bool(truncated), info)

    def render(self):
        if self.render_mode is None:
            return None
        if self._venv.state is None:
            raise RuntimeError("call reset() before render()")
        if self._renderer is None:
            if self.render_mode == "rgb_array":
                import matplotlib

                matplotlib.use("Agg")
            from marl_distributedformation_tpu_torch.compat.render import (
                FormationRenderer,
            )

            self._renderer = FormationRenderer(
                self.params, title="FormationGymEnv"
            )
        venv = self._venv
        self._renderer.update(venv.agents_np(), venv.goal_np(),
                              venv.obstacles_np())
        fig = self._renderer.fig
        if self.render_mode == "rgb_array":
            fig.canvas.draw()
            return np.asarray(fig.canvas.buffer_rgba())[..., :3].copy()
        # human: update() only moves artists; plt.pause runs the GUI event
        # loop one tick to show them.
        from marl_distributedformation_tpu_torch.compat.render import pyplot

        fig.canvas.draw_idle()
        pyplot().pause(0.001)
        return None

    def close(self) -> None:
        if self._renderer is not None:
            from marl_distributedformation_tpu_torch.compat.render import (
                pyplot,
            )

            pyplot().close(self._renderer.fig)
            self._renderer = None
