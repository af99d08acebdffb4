"""Host-side vectorized-env adapter: numpy in, numpy out.

Counterpart of the JAX package's ``compat/vec_env.py``: the reference's
``FormationEnv`` VecEnv contract (vectorized_env.py:16-109), the SB3
surface the paper trained under. M formations of N agents are flattened to
``num_envs = M*N`` rows, actions in [-1, 1] are scaled by ``max_speed``
(vectorized_env.py:69-70), and ``done``/``infos`` are broadcast per
formation (vectorized_env.py:75-79). The compute path is the port's
``make_vec_env`` on the env's device (``knn_fused``/``knn_tiled`` on the
card with ``obs_mode=knn``); this class only converts at the host boundary.
Each step copies the actions to the device once and the whole transition
back once (obs, rewards, dones and every metric in one buffer), not once a
field.

Unlike the reference, ``seed`` works (SURVEY.md Q9: it reseeds the env's
``torch.Generator``) and ``close`` is a no-op instead of raising (Q4).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from marl_distributedformation_tpu_torch.device import (
    DeviceLike,
    resolve_device,
)
from marl_distributedformation_tpu_torch.env import (
    EnvParams,
    Transition,
    action_space,
    make_vec_env,
    observation_space,
)

# One step's transition on the host: obs (M, N, obs_dim), rewards (M, N),
# done (M,) and the per-formation metrics, each (M,).
HostTransition = Tuple[np.ndarray, np.ndarray, np.ndarray,
                       Dict[str, np.ndarray]]


class FormationVecEnv:
    def __init__(
        self,
        params: EnvParams,
        num_formations: int,
        seed: int = 0,
        device: DeviceLike = None,
    ) -> None:
        self.params = params
        self.device = resolve_device(device)
        self.num_formations = num_formations
        self.num_agents = params.num_agents
        self.num_envs = num_formations * params.num_agents
        self.observation_space = observation_space(params)
        self.action_space = action_space(params)
        self._generator = torch.Generator(device=self.device).manual_seed(seed)
        self._reset_fn, self._step_fn = make_vec_env(
            params, num_formations, self.device, self._generator
        )
        self._state = None
        self.last_metrics: Dict[str, float] = {}

    # -- VecEnv surface (reference vectorized_env.py:52-82) ---------------

    def seed(self, seed: Optional[int] = None) -> None:
        if seed is not None:
            self._generator.manual_seed(seed)

    def reset(self) -> np.ndarray:
        self._state, obs = self._reset_fn()
        return obs.reshape(self.num_envs, -1).cpu().numpy()

    def step(
        self, actions: np.ndarray
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, List[dict]]:
        """``actions``: ``(num_envs, 2)`` in [-1, 1] (policy space)."""
        obs, rewards, done, _ = self.step_arrays(actions)
        infos: List[dict] = [{} for _ in range(self.num_envs)]  # Q4 parity
        return (
            obs.reshape(self.num_envs, -1),
            rewards.reshape(self.num_envs),
            np.repeat(done, self.num_agents),
            infos,
        )

    def close(self) -> None:
        pass

    # -- per-formation arrays (the Gymnasium adapters' view) ---------------

    def step_arrays(self, actions: np.ndarray) -> HostTransition:
        """One step from policy-space actions (any shape holding ``M*N*2``
        values): the transition per formation on the host; sets
        ``last_metrics`` to each metric's mean over the formations."""
        if self._state is None:
            raise RuntimeError("call reset() first")
        self._state, tr = self._step_fn(self._state, self._to_device(actions))
        obs, rewards, done, metrics = self._fetch(tr)
        self.last_metrics = {k: float(v.mean()) for k, v in metrics.items()}
        return obs, rewards, done, metrics

    def _to_device(self, actions: np.ndarray) -> torch.Tensor:
        """The actions as ``(M, N, 2)`` float32 on the env's device: one
        host-to-device copy."""
        host = np.asarray(actions, np.float32).reshape(
            self.num_formations, self.num_agents, 2)
        return torch.from_numpy(host).to(self.device)

    def _fetch(self, tr: Transition) -> HostTransition:
        """``tr`` on the host in one device-to-host copy: its fields are
        packed into one float32 buffer on the device first (``done`` as
        0/1, exact), then split."""
        names = list(tr.metrics)
        parts = [tr.obs.reshape(-1), tr.reward.reshape(-1),
                 tr.done.to(torch.float32)]
        parts += [tr.metrics[k].to(torch.float32) for k in names]
        host = torch.cat(parts).cpu().numpy()
        m, n = self.num_formations, self.num_agents
        sizes = [p.numel() for p in parts]
        chunks = np.split(host, np.cumsum(sizes)[:-1])
        obs = chunks[0].reshape(m, n, -1)
        rewards = chunks[1].reshape(m, n)
        done = chunks[2] > 0.5
        return obs, rewards, done, dict(zip(names, chunks[3:]))

    # -- host views for renderers and controllers --------------------------

    @property
    def state(self):
        return self._state

    def agents_np(self, formation: int = 0) -> np.ndarray:
        return self._state.agents[formation].cpu().numpy()

    def goal_np(self, formation: int = 0) -> np.ndarray:
        return self._state.goal[formation].cpu().numpy()

    def obstacles_np(self, formation: int = 0) -> np.ndarray:
        return self._state.obstacles[formation].cpu().numpy()

    def step_velocities(self, velocity: np.ndarray):
        """The L0 contract: drive with raw velocities (simulate.py:70), as
        the reference's teleop and baseline-controller frontends do
        (SURVEY.md Q8)."""
        return self.step(
            np.asarray(velocity, np.float32) / self.params.max_speed
        )
