"""Scenario parameters: the data that is the scenario.

Counterpart of the JAX package's ``scenarios/params.py``. Every disturbance
layer (``layers.py``) reads its magnitudes from a ``ScenarioParams`` of
float32 tensors, never from Python constants, so one step (and one captured
CUDA graph) serves every scenario at every severity: switching scenario or
severity changes values, never shapes or code.

Shapes: each leaf is ``()`` for one formation, or has a leading ``(M,)``
axis for a batch of formations (``(2,)`` and ``(M, 2)`` for ``wind``), so a
batch can mix scenarios. ``ScenarioParams.zeros()`` is the identity: every
layer is a bitwise no-op at all-zero parameters.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

Tensor = torch.Tensor


@dataclasses.dataclass
class ScenarioParams:
    """Per-formation disturbance magnitudes. Layers apply in a fixed order:
    goal and obstacle transforms, actuator transforms, env step,
    observation transforms."""

    fault_prob: Tensor  # in [0,1]: per-agent per-episode freeze probability
    act_noise_sigma: Tensor  # px/step: Gaussian actuator noise
    act_bias: Tensor  # px/step: constant per-episode actuator bias
    wind: Tensor  # (2,) px/step: constant wind velocity
    gust_sigma: Tensor  # px/step: per-step formation-wide gust
    goal_speed: Tensor  # px/step: goal drift along an episode heading
    goal_jump: Tensor  # in [0,1]: mid-episode goal switch fraction
    obs_noise_sigma: Tensor  # obs units: Gaussian sensor noise
    obs_bias: Tensor  # obs units: constant per-episode sensor bias
    comm_drop_prob: Tensor  # in [0,1]: per-step neighbor-block dropout
    obstacle_speed: Tensor  # px/step: obstacle drift
    obstacle_occlusion: Tensor  # px: neighbor-obs blackout radius around
    #   obstacles

    @classmethod
    def zeros(cls, device=None) -> "ScenarioParams":
        """The identity scenario (the clean env, bitwise)."""

        def z(*shape):
            return torch.zeros(shape, dtype=torch.float32, device=device)

        return cls(**{f: z(2) if f == "wind" else z() for f in FIELDS})

    @property
    def batched(self) -> bool:
        """Whether the leaves carry a leading formation axis."""
        return self.fault_prob.dim() > 0

    def map(self, fn: Callable[[Tensor], Tensor]) -> "ScenarioParams":
        """``fn`` applied to every leaf."""
        return ScenarioParams(**{f: fn(getattr(self, f)) for f in FIELDS})

    def to(self, device) -> "ScenarioParams":
        return self.map(lambda leaf: leaf.to(device))

    def copy_(self, other: "ScenarioParams") -> None:
        """Write ``other``'s values into these leaves, in place."""
        with torch.no_grad():
            for f in FIELDS:
                getattr(self, f).copy_(getattr(other, f))


FIELDS = tuple(f.name for f in dataclasses.fields(ScenarioParams))


def broadcast_params(
    sp: ScenarioParams, num_formations: int, device: Optional[torch.device] = None
) -> ScenarioParams:
    """One formation's params tiled to an ``(M,)``-leading batch (every
    formation runs the same scenario)."""
    if device is not None:
        sp = sp.to(device)
    return sp.map(lambda leaf: leaf.expand(num_formations, *leaf.shape)
                  .clone())


def stack_params(batches) -> ScenarioParams:
    """Batches of params stacked along a new leading axis."""
    batches = list(batches)
    return ScenarioParams(**{
        f: torch.stack([getattr(b, f) for b in batches]) for f in FIELDS
    })
