"""Policy evaluation: full episodes on M formations, reduced on the device.

Counterpart of the JAX package's ``eval.py``. The JAX package scans the
episode inside one compiled program; here it is a Python loop over the
``T`` steps whose per-step scalars stay on the device until the end, so the
loop never waits for the device. A learned policy is compared with the
scripted baseline (``env/baseline.py``) and with zero actions on the same
initial states. The env is resolved from the params type
(``envs.spec_for_params``); ``scenario_params`` evaluates under a
disturbance scenario (``scenarios/``), with the layers' draws from their own
stream.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from marl_distributedformation_tpu_torch.algo.rollout import policy_forward
from marl_distributedformation_tpu_torch.device import DeviceLike, resolve_device
from marl_distributedformation_tpu_torch.env.baseline import control
from marl_distributedformation_tpu_torch.env.types import EnvParams, FormationState
from marl_distributedformation_tpu_torch.envs import spec_for_params
from marl_distributedformation_tpu_torch.models import distributions

Tensor = torch.Tensor

# act_fn(agents (M,N,2), goal (M,2), obstacles (M,K,2), obs (M,N,obs_dim),
#        generator) -> raw velocities (M,N,2). Deterministic controllers
# ignore the generator; a stochastic policy samples its noise from it.
ActFn = Callable[[Tensor, Tensor, Tensor, Tensor, torch.Generator], Tensor]

# The action-noise stream is seeded apart from the reset stream, so that
# the seed -> initial-state mapping does not depend on the controller.
_ACT_SEED_OFFSET = 1 << 32
# The scenario layers' stream is seeded apart from both.
_SCENARIO_SEED_OFFSET = 2 << 32


def episode_length(params: EnvParams) -> int:
    """Steps that cover one full episode from reset: ``max_steps + 2`` under
    strict parity (the reference's off-by-one, Q1)."""
    return params.max_steps + (2 if params.strict_parity else 0)


@torch.no_grad()
def run_episode_metrics(
    act_fn: ActFn,
    params: EnvParams,
    num_formations: int,
    seed: int = 1234,
    device: DeviceLike = None,
    initial_state: Optional[FormationState] = None,
    scenario_params=None,
    scenario_streams=None,
) -> Dict[str, Tensor]:
    """Roll ``episode_length(params)`` steps and reduce them to 0-d tensors.

    ``initial_state`` replaces the reset drawn from ``seed`` (tests start
    both packages from the same states); the run is then on its device.
    ``scenario_params`` (``scenarios.ScenarioParams``, one formation's or a
    batch's) routes the step through the disturbance stack, the layers
    drawing from ``scenario_streams`` (default: a stream seeded from
    ``seed``); None is the clean env. The rows reduce as
    ``episode_summary`` says.
    """
    if initial_state is not None:
        dev = initial_state.agents.device
    else:
        dev = resolve_device(device)
    reset_gen = torch.Generator(device=dev).manual_seed(seed)
    act_gen = torch.Generator(device=dev).manual_seed(seed + _ACT_SEED_OFFSET)
    env = spec_for_params(params)
    state = initial_state
    if state is None:
        state = env.reset_batch(params, num_formations, reset_gen, dev)
    obs = env.obs(state, params)
    if scenario_params is None:
        def env_step(state, vel):
            return env.step_batch(state, vel, params, reset_gen)
    else:
        from marl_distributedformation_tpu_torch.scenarios import (
            ScenarioStreams,
            broadcast_params,
            init_scenario_state,
            scenario_step_batch,
        )

        streams = scenario_streams or ScenarioStreams(
            torch.Generator(device=dev).manual_seed(
                seed + _SCENARIO_SEED_OFFSET)
        )
        m = state.agents.shape[0]
        sp = scenario_params.to(dev)
        if not sp.batched:
            sp = broadcast_params(sp, m)
        state = init_scenario_state(state, params, streams)

        def env_step(state, vel):
            return scenario_step_batch(state, vel, sp, params, reset_gen,
                                       streams)
    T = episode_length(params)
    rows = {name: torch.zeros(T, dtype=torch.float32, device=dev)
            for name in ROW_NAMES}
    for t in range(T):
        vel = act_fn(state.agents, state.goal, state.obstacles, obs, act_gen)
        state, tr = env_step(state, vel)
        for name, value in step_row(tr).items():
            rows[name][t] = value
        obs = tr.obs
    return episode_summary(rows, T)


# The per-step row of an episode's metrics, reduced by ``episode_summary``.
ROW_NAMES = ("reward", "avg_dist_to_goal", "ave_dist_to_neighbor", "done")


def step_row(tr, copies: int = 1) -> Dict[str, Tensor]:
    """One step's row: the mean reward over formations and agents, the
    mean distances over formations and the formations done, 0-d; with
    ``copies`` > 1 the batch is that many equal parts (a population of
    candidates, ``scenarios/adversary.py``) and each value is ``(copies,)``,
    one a part."""

    def reduce(x: Tensor, op: str) -> Tensor:
        if copies == 1:
            return getattr(x, op)()
        return getattr(x.reshape(copies, -1), op)(-1)

    return {
        "reward": reduce(tr.reward, "mean"),
        "avg_dist_to_goal": reduce(tr.metrics["avg_dist_to_goal"], "mean"),
        "ave_dist_to_neighbor": reduce(tr.metrics["ave_dist_to_neighbor"],
                                       "mean"),
        "done": reduce(tr.done, "sum"),
    }


def episode_summary(rows: Dict[str, Tensor], T: int) -> Dict[str, Tensor]:
    """The episode's metrics from its rows (the last axis is the step).
    The step where done fires resets before its metrics are taken, so the
    last in-episode metrics row is ``T - 2``; rewards are taken on the
    pre-reset state, so every row counts toward the return."""
    last = T - 2
    return {
        "episode_return_per_agent": rows["reward"].sum(-1),
        "mean_step_reward": rows["reward"].mean(-1),
        "final_avg_dist_to_goal": rows["avg_dist_to_goal"][..., last],
        "last100_avg_dist_to_goal": rows["avg_dist_to_goal"][
            ..., last - 99 : last + 1
        ].mean(-1),
        "final_ave_dist_to_neighbor": rows["ave_dist_to_neighbor"][..., last],
        "episodes": rows["done"].sum(-1),
    }


def evaluate(
    act_fn: ActFn,
    params: EnvParams,
    num_formations: int = 1024,
    seed: int = 1234,
    device: DeviceLike = None,
    initial_state: Optional[FormationState] = None,
    scenario_params=None,
) -> Dict[str, float]:
    """One full episode on M formations; host-side floats.
    ``scenario_params`` evaluates under a disturbance scenario
    (``scenarios.scenario_params_for(name, severity)``)."""
    out = run_episode_metrics(
        act_fn, params, num_formations, seed, device, initial_state,
        scenario_params,
    )
    return {k: float(v) for k, v in out.items()}


def evaluate_scenario(
    act_fn: ActFn,
    params: EnvParams,
    scenario: str,
    severity: float,
    num_formations: int = 1024,
    seed: int = 1234,
    device: DeviceLike = None,
) -> Dict[str, float]:
    """``evaluate`` under a registered scenario by name; an unknown name
    raises with the registry's listing."""
    from marl_distributedformation_tpu_torch.scenarios import (
        scenario_params_for,
    )

    return evaluate(
        act_fn, params, num_formations, seed, device,
        scenario_params=scenario_params_for(scenario, severity),
    )


def baseline_act_fn(params: EnvParams) -> ActFn:
    """The scripted potential-field controller as an ``ActFn``."""

    def act(agents, goal, obstacles, obs, generator):
        return control(agents, goal, obstacles, params)

    return act


def policy_act_fn(
    model: torch.nn.Module, params: EnvParams, deterministic: bool = True
) -> ActFn:
    """A trained actor-critic as an ``ActFn``: the mode action, or
    (``deterministic=False``) a draw from its Gaussian; clipped to [-1, 1]
    and scaled by ``max_speed`` (reference vectorized_env.py:69-70)."""

    def act(agents, goal, obstacles, obs, generator):
        mean, log_std, _ = policy_forward(model, obs)
        a = mean
        if not deterministic:
            a = distributions.sample(generator, mean, log_std)
        return params.max_speed * torch.clamp(a, -1.0, 1.0)

    return act


def zero_act_fn() -> ActFn:
    """Do-nothing control, the floor any learned policy must clear."""

    def act(agents, goal, obstacles, obs, generator):
        return torch.zeros_like(agents)

    return act


def evaluate_checkpoint(
    checkpoint_path: str,
    params: EnvParams,
    num_formations: int = 1024,
    seed: int = 1234,
    deterministic: bool = True,
    device: DeviceLike = None,
    initial_state: Optional[FormationState] = None,
    scenario_params=None,
) -> Dict[str, float]:
    """Restore a trainer checkpoint and evaluate its policy;
    ``scenario_params`` evaluates under a disturbance scenario."""
    from marl_distributedformation_tpu_torch.compat.policy import LoadedPolicy

    if initial_state is not None:
        device = initial_state.agents.device
    pol = LoadedPolicy.from_checkpoint(
        checkpoint_path, act_dim=params.act_dim, env_params=params,
        device=device,
    )
    act = policy_act_fn(pol.model, params, deterministic)
    return evaluate(
        act, params, num_formations, seed, pol.device, initial_state,
        scenario_params,
    )
