"""Scenario engine: the registered env's batched step wrapped in the
disturbance stack, with the layers' own random streams.

Counterpart of the JAX package's ``scenarios/engine.py``. ``scenario_step_batch``
applies the layers (``layers.py``) around the env's ``step_batch``
(resolved from the params type, ``envs.spec_for_params``) in a fixed order:
goal, obstacles, actuators, the clean step, observation. The env's step
computes the observation once over the whole batch, so with
``obs_mode=knn`` the batch's neighbor search is one ``ops.knn_batch`` call
(``knn_fused``/``knn_tiled`` on the card) and ``perturb_obs`` runs on its
result, the route of the JAX package's ``engine.py:84-95``.
``scenario_step`` is one formation's step: the stack on a batch of one.

Random streams. The JAX package derives every layer's draws from the
formation's own key (``fold_in(state.key, salt)`` an episode, folded with
``state.steps`` a step) and never advances the env's stream. The port's env
has no per-formation key, so the layers draw from a ``ScenarioStreams``
(its own ``torch.Generator``) and keep the same four properties:

a. the env's and the policy's generators are never drawn from, so at
   severity 0 (and in a ``clean`` stage) the trajectory is bitwise the clean
   run's;
b. the per-episode draws (fault uniforms, the actuator-bias, goal and
   obstacle headings, the switch target, the observation-bias normals) ride
   in the state (``ScenarioState``) and stay constant within an episode;
c. on auto-reset they are replaced by fresh ones before the observation
   layer runs (the JAX package's ``perturb_obs`` reads the next state's
   key); the pre-step layers read the old ones;
d. the per-step draws are fresh every step.

Each step draws its step draws, then a whole batch of fresh episode draws
(kept where a formation is done, ``torch.where``), so the generator moves
the same amount every step and a step needs no host read.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Tuple

import torch

from marl_distributedformation_tpu_torch.device import draw
from marl_distributedformation_tpu_torch.env.types import (
    EnvParams,
    FormationState,
    Transition,
    batch_of_one,
    formation_row,
)
from marl_distributedformation_tpu_torch.envs import spec_for_params
from marl_distributedformation_tpu_torch.scenarios.layers import (
    perturb_goal,
    perturb_obs,
    perturb_obstacles,
    perturb_velocity,
)
from marl_distributedformation_tpu_torch.scenarios.params import (
    ScenarioParams,
    broadcast_params,
)

Tensor = torch.Tensor

ENV_FIELDS = ("agents", "goal", "obstacles", "steps")


@dataclasses.dataclass
class EpisodeDraws:
    """One episode's draws for M formations (property b)."""

    fault_u: Tensor  # (M, N) uniforms: an agent is frozen below fault_prob
    act_theta: Tensor  # (M,) actuator-bias heading, radians in [0, 2pi)
    goal_theta: Tensor  # (M,) goal drift heading
    switch_u: Tensor  # (M, 2) uniforms of the switch target
    obstacle_theta: Tensor  # (M, K) obstacle drift headings
    obs_bias: Tensor  # (M, obs_dim) normals of the sensor bias


EPISODE_FIELDS = tuple(f.name for f in dataclasses.fields(EpisodeDraws))


@dataclasses.dataclass
class StepDraws:
    """One step's draws for M formations (property d)."""

    act_noise: Tensor  # (M, N, 2) normals
    gust: Tensor  # (M, 2) normals, one gust a formation
    obs_noise: Tensor  # (M, N, obs_dim) normals
    comm_u: Tensor  # (M, N) uniforms: the neighbor block drops below p


@dataclasses.dataclass
class ScenarioState(FormationState):
    """The env state of M formations with their episode draws."""

    fault_u: Tensor
    act_theta: Tensor
    goal_theta: Tensor
    switch_u: Tensor
    obstacle_theta: Tensor
    obs_bias: Tensor


SCENARIO_FIELDS = ENV_FIELDS + EPISODE_FIELDS


class ScenarioStreams:
    """The layers' draws, from their own generator (``None``: the default
    generator of the device). Tests override ``episode`` and ``step`` to
    hand the layers the JAX package's draws."""

    def __init__(self, generator: Optional[torch.Generator] = None) -> None:
        self.generator = generator

    def _rand(self, device, *shape) -> Tensor:
        return draw(torch.rand, self.generator, shape, device)

    def _randn(self, device, *shape) -> Tensor:
        return draw(torch.randn, self.generator, shape, device)

    def episode(self, params: EnvParams, m: int,
                device: torch.device) -> EpisodeDraws:
        n, k = params.num_agents, params.num_obstacles
        two_pi = 2.0 * math.pi
        return EpisodeDraws(
            fault_u=self._rand(device, m, n),
            act_theta=self._rand(device, m) * two_pi,
            goal_theta=self._rand(device, m) * two_pi,
            switch_u=self._rand(device, m, 2),
            obstacle_theta=self._rand(device, m, k) * two_pi,
            obs_bias=self._randn(device, m, params.obs_dim),
        )

    def step(self, params: EnvParams, m: int,
             device: torch.device) -> StepDraws:
        n = params.num_agents
        return StepDraws(
            act_noise=self._randn(device, m, n, 2),
            gust=self._randn(device, m, 2),
            obs_noise=self._randn(device, m, n, params.obs_dim),
            comm_u=self._rand(device, m, n),
        )


def tile(x: Tensor, copies: int) -> Tensor:
    """``copies`` copies of ``x`` along its leading axis, in turn."""
    return x.repeat(copies, *([1] * (x.dim() - 1)))


class TiledStreams(ScenarioStreams):
    """The draws of ``inner`` for M formations, repeated ``copies`` times
    along the formation axis: a batch of ``copies`` x M formations whose
    parts see the same draws (the falsifier search's population of
    candidates, ``adversary.py``, as the JAX package's vmap over one key
    gives them)."""

    def __init__(self, inner: ScenarioStreams, copies: int) -> None:
        super().__init__(inner.generator)
        self.inner = inner
        self.copies = copies

    def _tiled(self, draws, cls):
        return cls(**{f.name: tile(getattr(draws, f.name), self.copies)
                      for f in dataclasses.fields(cls)})

    def episode(self, params, m, device):
        return self._tiled(
            self.inner.episode(params, m // self.copies, device),
            EpisodeDraws)

    def step(self, params, m, device):
        return self._tiled(
            self.inner.step(params, m // self.copies, device), StepDraws)


def init_scenario_state(
    state: FormationState, params: EnvParams, streams: ScenarioStreams
) -> ScenarioState:
    """``state`` with its first episode's draws."""
    episode = streams.episode(params, state.agents.shape[0],
                              state.agents.device)
    return ScenarioState(
        **{f: getattr(state, f) for f in ENV_FIELDS},
        **{f: getattr(episode, f) for f in EPISODE_FIELDS},
    )


def _where(done: Tensor, a: Tensor, b: Tensor) -> Tensor:
    return torch.where(done.reshape(-1, *([1] * (a.dim() - 1))), a, b)


def scenario_step_batch(
    state: ScenarioState,
    velocity: Tensor,
    sp: ScenarioParams,
    params: EnvParams,
    generator=None,
    streams: Optional[ScenarioStreams] = None,
    fresh: Optional[FormationState] = None,
) -> Tuple[ScenarioState, Transition]:
    """One step of M formations through the disturbance stack.

    ``sp`` is one formation's params (every formation runs that scenario)
    or a batch with a leading ``(M,)`` axis (a mixed batch). ``generator``
    is the env's (its resets), ``streams`` the layers'; ``fresh`` replaces
    the env's reset draws (tests).
    """
    m = velocity.shape[0]
    device = velocity.device
    if streams is None:
        streams = ScenarioStreams()
    if not sp.batched:
        sp = broadcast_params(sp, m, device)
    step = streams.step(params, m, device)
    new_episode = streams.episode(params, m, device)

    stepped = FormationState(
        agents=state.agents,
        goal=perturb_goal(state, sp, params, state.goal_theta,
                          state.switch_u),
        obstacles=perturb_obstacles(state, sp, params, state.obstacle_theta),
        steps=state.steps,
    )
    velocity = perturb_velocity(velocity, sp, state.fault_u, step.act_noise,
                                state.act_theta, step.gust)
    extra = {} if fresh is None else {"fresh": fresh}
    next_env, tr = spec_for_params(params).step_batch(
        stepped, velocity, params, generator, **extra
    )
    episode = {
        f: _where(tr.done, getattr(new_episode, f), getattr(state, f))
        for f in EPISODE_FIELDS
    }
    next_state = ScenarioState(
        **{f: getattr(next_env, f) for f in ENV_FIELDS}, **episode
    )
    obs = perturb_obs(tr.obs, next_state, sp, params, step.obs_noise,
                      episode["obs_bias"], step.comm_u)
    return next_state, dataclasses.replace(tr, obs=obs)


def scenario_step(
    state: ScenarioState,
    velocity: Tensor,
    sp: ScenarioParams,
    params: EnvParams,
    generator=None,
    streams: Optional[ScenarioStreams] = None,
    with_obs: bool = True,
    fresh: Optional[FormationState] = None,
) -> Tuple[ScenarioState, Transition]:
    """One formation, one step, through the disturbance stack (the JAX
    package's ``scenario_step``, ``scenarios/engine.py:47``): its row of
    ``scenario_step_batch`` on a batch of one, drawing what a batch of one
    draws; ``with_obs=False`` drops the observation after the row
    (zero-width). ``sp`` is one formation's params, ``state`` and
    ``fresh`` one formation's."""
    if fresh is not None:
        fresh = batch_of_one(fresh)
    next_state, tr = scenario_step_batch(batch_of_one(state), velocity[None],
                                         sp, params, generator, streams,
                                         fresh)
    next_state, tr = formation_row(next_state), formation_row(tr)
    if not with_obs:
        tr.obs = tr.obs[:, :0]
    return next_state, tr


def make_scenario_step(
    params: EnvParams,
    streams: ScenarioStreams,
    generator=None,
) -> Callable[[ScenarioState, Tensor, ScenarioParams],
              Tuple[ScenarioState, Transition]]:
    """``(state, velocity, scenario_params) -> (state, transition)`` over
    the env params, the env's generator and the layers' streams; the
    scenario params stay an argument, so a severity or stage change only
    changes values."""

    def step_fn(state, velocity, sp):
        return scenario_step_batch(state, velocity, sp, params, generator,
                                   streams)

    return step_fn
