"""State and parameter types for the formation environment.

A copy of the JAX package's ``env/types.py``: ``EnvParams`` keeps the same
fields, defaults, validation and derived widths, so a configuration means the
same thing in both packages. State is a dataclass of tensors: batched, with
the formation axis M written out (no vmap), or one formation's, without it
(``batch_of_one`` and ``formation_row`` convert).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import torch

KNN_IMPLS = ("auto", "torch", "cuda", "cuda_big")


@dataclasses.dataclass(frozen=True)
class EnvParams:
    """Static environment configuration.

    Defaults mirror the reference simulator (``simulate.py:13-31``): a
    400x600 world, desired formation radius 60, 1000-step episode budget,
    reward-sharing ratio 0.25.
    """

    num_agents: int = 5
    num_obstacles: int = 0
    width: float = 400.0
    height: float = 600.0
    obstacle_size: float = 10.0
    max_steps: int = 1000
    desired_radius: float = 60.0
    share_reward_ratio: float = 0.25
    goal_in_obs: bool = True
    max_speed: float = 10.0

    # Reward constants (reference simulate.py:183-215).
    close_goal_dist: float = 100.0
    close_goal_bonus: float = 10.0
    reward_dist_scale: float = 0.1
    neighbor_penalty_scale: float = 0.01
    oob_penalty: float = 100.0
    obstacle_penalty: float = 100.0

    # Reset distribution constants (reference simulate.py:124-143).
    agent_spawn_band: float = 100.0
    obstacle_margin_band: float = 100.0

    strict_parity: bool = True
    """Q1: episodes last ``max_steps + 2`` steps (done when the
    pre-increment step counter exceeds ``max_steps``); Q3: timeout-only
    termination. When False, episodes last ``max_steps`` steps and
    ``goal_termination`` may end them early."""

    goal_termination: bool = False

    obs_mode: str = "ring"
    """``"ring"``: self + two ring neighbors (+ goal). ``"knn"``: self
    (+ goal) plus offsets, distances and indices of the ``knn_k`` nearest
    neighbors, recomputed every step (ops/knn.py)."""

    knn_k: int = 4

    knn_impl: str = "auto"
    """Neighbor search for knn observations: ``"auto"`` (the CUDA kernels
    on a CUDA tensor — fused for N <= 640, tiled above — and the plain
    PyTorch version on a CPU tensor), ``"torch"`` (the plain version on any
    device), ``"cuda"`` (fused kernel) or ``"cuda_big"`` (tiled kernel)."""

    obstacle_mode: str = "parity"
    """``"parity"``: the reference's collision box has the obstacle point as
    its lower-left corner (Q2). ``"fixed"``: the point is the box center."""

    def __post_init__(self) -> None:
        if self.num_agents < 2:
            raise ValueError("ring topology needs at least 2 agents")
        if not 0.0 <= self.share_reward_ratio <= 0.5:
            raise ValueError(
                "share_reward_ratio must be in [0, 0.5] (reference "
                "simulate.py:28)"
            )
        if self.obstacle_mode not in ("parity", "fixed"):
            raise ValueError(f"unknown obstacle_mode {self.obstacle_mode!r}")
        if self.obs_mode not in ("ring", "knn"):
            raise ValueError(f"unknown obs_mode {self.obs_mode!r}")
        if self.obs_mode == "knn" and not 1 <= self.knn_k < self.num_agents:
            raise ValueError(
                f"knn_k={self.knn_k} must be in [1, num_agents)"
            )
        if self.knn_impl not in KNN_IMPLS:
            raise ValueError(
                f"unknown knn_impl {self.knn_impl!r}; one of {KNN_IMPLS}"
            )

    @property
    def desired_neighbor_dist(self) -> float:
        """Chord of a regular ``num_agents``-gon of radius
        ``desired_radius`` (reference simulate.py:26)."""
        return float(
            2.0 * self.desired_radius * math.sin(math.pi / self.num_agents)
        )

    @property
    def obs_dim(self) -> int:
        """Per-agent observation width: ring 6 (+2 goal); knn
        ``2 + 3k (+2 goal) + k`` (own pos, offsets, distances, goal,
        neighbor indices carried as float32)."""
        if self.obs_mode == "knn":
            base = 2 + 3 * self.knn_k + (2 if self.goal_in_obs else 0)
            return base + self.knn_k
        return 8 if self.goal_in_obs else 6

    @property
    def act_dim(self) -> int:
        return 2

    def replace(self, **changes: Any) -> "EnvParams":
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass
class FormationState:
    """Dynamic state of M formations.

    The JAX package carries a PRNG key per formation; here resets draw from a
    ``torch.Generator`` that the caller passes to ``step_batch``.
    """

    agents: torch.Tensor  # (M, N, 2) float32 positions
    goal: torch.Tensor  # (M, 2) float32
    obstacles: torch.Tensor  # (M, K, 2) float32 (K may be 0)
    steps: torch.Tensor  # (M,) int32 — steps completed since reset


@dataclasses.dataclass
class Transition:
    """What ``step_batch`` returns besides the next state. ``metrics``
    values are per formation, shape ``(M,)``."""

    obs: torch.Tensor  # (M, N, obs_dim) float32
    reward: torch.Tensor  # (M, N) float32 — neighbor-mixed rewards
    done: torch.Tensor  # (M,) bool
    metrics: Dict[str, torch.Tensor]


def batch_of_one(state: Any) -> Any:
    """One formation's state (a dataclass of tensors) as a batch of one:
    a leading axis of size 1 on every field."""
    return type(state)(**{f.name: getattr(state, f.name)[None]
                          for f in dataclasses.fields(state)})


def formation_row(tree: Any, i: int = 0) -> Any:
    """Formation ``i`` of a batched state or ``Transition``: every field
    (and every metric) indexed at ``i`` on its leading axis."""
    if isinstance(tree, dict):
        return {k: formation_row(v, i) for k, v in tree.items()}
    if dataclasses.is_dataclass(tree):
        return type(tree)(**{f.name: formation_row(getattr(tree, f.name), i)
                             for f in dataclasses.fields(tree)})
    return tree[i]
