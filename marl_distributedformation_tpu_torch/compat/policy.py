"""Checkpoint-backed policy: SB3's ``PPO.load`` / ``predict`` (reference
visualize_policy.py:35,16).

Counterpart of the JAX package's ``compat/policy.py``. The registry holds the
MLP, the CTDE model and the GNN. A per-formation model (CTDE, GNN) acts on
whole formations of any N; ``predict`` reshapes flat SB3-style rows by
``num_agents``.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from marl_distributedformation_tpu_torch.compat.convert import params_from_jax
from marl_distributedformation_tpu_torch.device import DeviceLike, resolve_device
from marl_distributedformation_tpu_torch.models import (
    CTDEActorCritic,
    GNNActorCritic,
    MLPActorCritic,
    distributions,
)
from marl_distributedformation_tpu_torch.utils.checkpoint import (
    CorruptCheckpointError,
    msgpack_restore_file,
    quarantine_checkpoint,
)

# Checkpoints record the architecture by its class name.
POLICY_REGISTRY = {
    "MLPActorCritic": MLPActorCritic,
    "CTDEActorCritic": CTDEActorCritic,
    "GNNActorCritic": GNNActorCritic,
}


def model_kwargs_for(policy: str, env_params=None) -> dict:
    """Constructor arguments beyond ``act_dim`` that a policy takes from the
    environment configuration."""
    if policy == "GNNActorCritic":
        if env_params is None:
            raise ValueError(
                "GNNActorCritic playback needs env_params (for knn_k / "
                "goal_in_obs); pass env_params to from_checkpoint"
            )
        return {"k": env_params.knn_k, "goal_in_obs": env_params.goal_in_obs}
    return {}


def infer_hidden(params: dict, policy: str) -> Optional[tuple]:
    """Policy-tower widths from checkpoint parameters: the ``pi_{i}`` layers
    at the top level (MLP) or under ``actor`` (CTDE, GNN). None when there
    is no tower."""
    p = params
    if policy in ("CTDEActorCritic", "GNNActorCritic"):
        p = params.get("actor", {})
    widths = []
    i = 0
    while f"pi_{i}" in p:
        kernel = p[f"pi_{i}"].get("kernel")
        if kernel is None:
            return None
        widths.append(int(np.shape(kernel)[-1]))
        i += 1
    return tuple(widths) or None


def build_model(
    policy: str, params: dict, act_dim: int = 2, env_params=None
) -> torch.nn.Module:
    """The port's ``policy`` model holding the JAX package's ``params``
    (the inner ``params`` dict of a checkpoint), on the CPU."""
    if policy not in POLICY_REGISTRY:
        raise ValueError(
            f"unknown policy {policy!r} in checkpoint; known: "
            f"{sorted(POLICY_REGISTRY)}"
        )
    kwargs = model_kwargs_for(policy, env_params)
    hidden = infer_hidden(params, policy)
    if hidden:
        kwargs["hidden"] = hidden
    if policy == "MLPActorCritic":
        kwargs["obs_dim"] = int(np.shape(params["pi_0"]["kernel"])[0])
    elif policy == "CTDEActorCritic":
        embed = np.shape(params["vf_embed"]["kernel"])
        kwargs["obs_dim"], kwargs["embed_dim"] = int(embed[0]), int(embed[1])
    model = POLICY_REGISTRY[policy](act_dim=act_dim, **kwargs)
    model.load_state_dict(params_from_jax(params, policy))
    return model.eval()


def load_checkpoint_raw(path: str | Path) -> dict:
    """A checkpoint file as nested dicts of numpy arrays, without a
    template. The footer is validated: a corrupt or truncated file is
    quarantined (``utils.checkpoint.quarantine_checkpoint``) and raises
    ``CorruptCheckpointError``, so damaged parameters never reach an
    evaluation."""
    try:
        return msgpack_restore_file(path)
    except CorruptCheckpointError as e:
        quarantine_checkpoint(path, str(e))
        raise


class LoadedPolicy:
    """``predict(obs, deterministic)`` over a restored model."""

    def __init__(
        self,
        model: torch.nn.Module,
        num_agents: int | None = None,
        seed: int = 0,
    ) -> None:
        self.model = model
        self.device = next(model.parameters()).device
        self.per_formation = model.per_formation
        self.num_agents = num_agents
        self._generator = torch.Generator(device=self.device).manual_seed(seed)

    @classmethod
    def from_checkpoint(
        cls,
        path: str | Path,
        act_dim: int = 2,
        num_agents: int | None = None,
        env_params=None,
        device: DeviceLike = None,
    ) -> "LoadedPolicy":
        dev = resolve_device(device)
        raw = load_checkpoint_raw(path)
        if "params" not in raw:
            raise ValueError(
                f"{path} does not look like a trainer checkpoint "
                f"(keys: {sorted(raw)})"
            )
        policy = raw.get("policy", "MLPActorCritic")
        if num_agents is None and env_params is not None:
            num_agents = env_params.num_agents
        model = build_model(
            policy, raw["params"]["params"], act_dim, env_params
        ).to(dev)
        return cls(model, num_agents=num_agents)

    @property
    def params(self) -> dict:
        """The model's parameters by name (``state_dict``), the form the
        robustness matrix and the falsifier search take a candidate in."""
        return self.model.state_dict()

    @torch.no_grad()
    def predict(
        self, obs: np.ndarray, deterministic: bool = True
    ) -> Tuple[np.ndarray, Optional[tuple]]:
        """SB3 ``predict``: ``(actions clipped to [-1, 1], None)``."""
        x = torch.as_tensor(np.array(obs, np.float32), device=self.device)
        flat_in = None
        if self.per_formation and self.num_agents and x.dim() == 2:
            # Flat SB3-style (M*N, obs_dim) rows -> (M, N, obs_dim).
            flat_in = x.shape
            x = x.reshape(-1, self.num_agents, x.shape[-1])
        mean, log_std, _ = self.model(x)
        if flat_in is not None:
            mean = mean.reshape(flat_in[0], -1)
        if deterministic:
            actions = distributions.mode(mean)
        else:
            actions = distributions.sample(self._generator, mean, log_std)
        return torch.clamp(actions, -1.0, 1.0).cpu().numpy(), None
