"""ScenarioSpec registry: named, severity-parameterized disturbance recipes.

Counterpart of the JAX package's ``scenarios/registry.py``. A
``ScenarioSpec`` records the layer magnitudes at severity 1.0 as Python
floats; ``spec.build(severity)`` scales them by the severity into a
``ScenarioParams`` of float32 tensors, rounding as the JAX package does
(``float32(base) * float32(severity)``, then the probabilities clipped to
[0, 1]). The registry names the scenarios for training (domain
randomization over a stage's set), evaluation (``evaluate scenario=...``)
and every lookup fails fast on an unknown name with the registry's
listing, never a silent clean env.
"""

from __future__ import annotations

import dataclasses
import difflib
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from marl_distributedformation_tpu_torch.scenarios.params import (
    FIELDS,
    ScenarioParams,
)

Tensor = torch.Tensor


def _validate_severity(severity, where: str) -> None:
    """Raise on a severity that is negative or non-finite: a negative one
    would flip every perturbation's sign through the linear scaling (wind
    blowing backwards is another scenario, not a milder one), and NaN or
    inf poisons every result."""
    value = np.asarray(
        severity.detach().cpu() if isinstance(severity, Tensor) else severity
    )
    if not np.all(np.isfinite(value)):
        raise ValueError(
            f"{where}: severity must be finite, got {value!r}"
        )
    if np.any(value < 0.0):
        raise ValueError(
            f"{where}: severity must be >= 0, got {value!r} — a negative "
            "severity flips perturbation signs via the linear magnitude "
            "scaling instead of weakening them"
        )


@dataclasses.dataclass(frozen=True)
class ScenarioSpec:
    """Layer magnitudes at severity 1.0 (units as in ``ScenarioParams``)."""

    name: str
    description: str = ""
    fault_prob: float = 0.0
    act_noise_sigma: float = 0.0
    act_bias: float = 0.0
    wind_x: float = 0.0
    wind_y: float = 0.0
    gust_sigma: float = 0.0
    goal_speed: float = 0.0
    goal_jump: float = 0.0
    obs_noise_sigma: float = 0.0
    obs_bias: float = 0.0
    comm_drop_prob: float = 0.0
    obstacle_speed: float = 0.0
    obstacle_occlusion: float = 0.0

    def build(self, severity) -> ScenarioParams:
        """The magnitudes scaled by ``severity`` (a float or a 0-d
        tensor), probabilities clipped to [0, 1]; a negative or non-finite
        severity raises naming the scenario. The leaves are on the
        severity's device (the CPU for a float)."""
        _validate_severity(severity, f"scenario {self.name!r}")
        s = torch.as_tensor(severity, dtype=torch.float32)

        def scaled(base: float) -> Tensor:
            return torch.tensor(base, dtype=torch.float32,
                                device=s.device) * s

        def prob(base: float) -> Tensor:
            return torch.clamp(scaled(base), 0.0, 1.0)

        return ScenarioParams(
            fault_prob=prob(self.fault_prob),
            act_noise_sigma=scaled(self.act_noise_sigma),
            act_bias=scaled(self.act_bias),
            wind=torch.stack([scaled(self.wind_x), scaled(self.wind_y)]),
            gust_sigma=scaled(self.gust_sigma),
            goal_speed=scaled(self.goal_speed),
            goal_jump=prob(self.goal_jump),
            obs_noise_sigma=scaled(self.obs_noise_sigma),
            obs_bias=scaled(self.obs_bias),
            comm_drop_prob=prob(self.comm_drop_prob),
            obstacle_speed=scaled(self.obstacle_speed),
            obstacle_occlusion=scaled(self.obstacle_occlusion),
        )


# Magnitudes are sized against the env's own scale (400x600 world,
# max_speed 10 px/step, observations normalized to ~[-1, 1]): severity 1.0
# is "hard but not hopeless" for the trained north-star policy.
_DEFAULT_SPECS: Tuple[ScenarioSpec, ...] = (
    ScenarioSpec("clean", "the unperturbed environment (identity stack)"),
    ScenarioSpec(
        "actuator_fault",
        "per-episode frozen agents (actuator dropout): each agent dead "
        "with prob 0.4*severity — neighbors must absorb the gap",
        fault_prob=0.4,
    ),
    ScenarioSpec(
        "actuator_noise",
        "miscalibrated thrusters: Gaussian velocity jitter + a constant "
        "per-episode drift direction",
        act_noise_sigma=5.0,
        act_bias=2.0,
    ),
    ScenarioSpec(
        "sensor_noise",
        "noisy observations: Gaussian jitter + a constant per-episode "
        "per-column bias on everything each agent sees",
        obs_noise_sigma=0.1,
        obs_bias=0.05,
    ),
    ScenarioSpec(
        "wind",
        "constant wind field plus per-step formation-wide gusts",
        wind_x=4.0,
        wind_y=2.0,
        gust_sigma=3.0,
    ),
    ScenarioSpec(
        "moving_goal",
        "the formation target drifts along a per-episode heading",
        goal_speed=5.0,
    ),
    ScenarioSpec(
        "goal_switch",
        "mid-episode target switch: at max_steps/2 the goal jumps "
        "severity of the way to a fresh target",
        goal_jump=1.0,
    ),
    ScenarioSpec(
        "comm_dropout",
        "lossy comms: each agent's neighbor observation blocks blank "
        "with prob 0.5*severity per step",
        comm_drop_prob=0.5,
    ),
    # The obstacle layers are the identity when the env has no obstacles
    # (num_obstacles is a shape): train or evaluate with num_obstacles > 0.
    ScenarioSpec(
        "obstacle_field",
        "static obstacle field as a sensing hazard: agents within "
        "80*severity px of an obstacle lose their neighbor obs blocks "
        "(avoidance pressure comes from the env's obstacle penalty; "
        "needs num_obstacles > 0)",
        obstacle_occlusion=80.0,
    ),
    ScenarioSpec(
        "moving_obstacles",
        "obstacles drift 3*severity px/step along per-episode headings "
        "(clipped to the world) — moving obstacle avoidance; needs "
        "num_obstacles > 0",
        obstacle_speed=3.0,
    ),
    ScenarioSpec(
        "storm",
        "3-layer stress stack: wind + actuator noise + sensor noise",
        wind_x=3.0,
        wind_y=1.5,
        gust_sigma=2.0,
        act_noise_sigma=2.0,
        obs_noise_sigma=0.05,
    ),
)

_REGISTRY: Dict[str, ScenarioSpec] = {s.name: s for s in _DEFAULT_SPECS}


def registered_scenarios() -> Tuple[str, ...]:
    """Registered scenario names, registration order."""
    return tuple(_REGISTRY)


def register_scenario(spec: ScenarioSpec, overwrite: bool = False) -> None:
    """Add a scenario. Overwriting a name is opt-in, so that a mistyped
    registration cannot shadow a stock scenario."""
    if spec.name in _REGISTRY and not overwrite:
        raise ValueError(
            f"scenario {spec.name!r} is already registered; pass "
            "overwrite=True to replace it"
        )
    _REGISTRY[spec.name] = spec


def get_scenario(name: str) -> ScenarioSpec:
    """The named spec; an unknown name raises with a did-you-mean and the
    registered names."""
    spec = _REGISTRY.get(name)
    if spec is None:
        close = difflib.get_close_matches(str(name), _REGISTRY, n=1)
        hint = f" (did you mean {close[0]!r}?)" if close else ""
        raise ValueError(
            f"unknown scenario {name!r}{hint}; registered scenarios: "
            f"{', '.join(registered_scenarios())}"
        )
    return spec


def scenario_params_for(name: str, severity) -> ScenarioParams:
    """``get_scenario(name).build(severity)``."""
    return get_scenario(name).build(severity)


def choice_indices(uniforms: Tensor, probs: Tensor) -> Tensor:
    """Indices drawn from the distribution ``probs`` by inverting its
    cumulative sum at ``1 - u`` for each uniform ``u`` in [0, 1), as
    ``jax.random.choice(..., p=probs)`` draws them."""
    cum = torch.cumsum(probs.to(torch.float32), 0)
    r = cum[-1] * (1.0 - uniforms)
    return torch.searchsorted(cum, r)


def sample_scenario_batch(
    generator: torch.Generator,
    severity,
    probs,
    specs: Sequence[ScenarioSpec],
    num_formations: int,
) -> ScenarioParams:
    """Domain randomization: one scenario per formation, drawn from
    ``probs`` over ``specs`` (a stage's active subset, zeros elsewhere)
    with ``generator``'s uniforms, every spec built at ``severity``.
    Returns ``ScenarioParams`` with a leading ``(M,)`` axis on the CPU. A
    negative or non-finite severity raises naming the spec set."""
    _validate_severity(
        severity,
        f"scenario batch over [{', '.join(s.name for s in specs)}]",
    )
    built = [spec.build(severity) for spec in specs]
    stacked = {f: torch.stack([getattr(b, f) for b in built]) for f in FIELDS}
    u = torch.rand((num_formations,), generator=generator,
                   dtype=torch.float32)
    idx = choice_indices(u, torch.as_tensor(probs, dtype=torch.float32))
    return ScenarioParams(**{f: v[idx] for f, v in stacked.items()})
