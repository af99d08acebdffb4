"""Evaluation traffic: deterministic full episodes through the program's
``eval.run_episode_metrics`` with ``policy_act_fn(deterministic=True)``,
each from its own seeded start states, one after another.

Set-up builds the policy as the train CLI builds it, loads the
benchmark's seeded weights and runs a short episode of the same shapes.
Every episode of the window keeps a copy of its agents at two steps; once
the window has closed, one finished episode drawn from the seed is run
again by the reference, and its summary and every formation's agents at
those steps are compared.
"""

from __future__ import annotations

import gc
import math
import random
import time
from typing import Dict

import torch

from benchmark import check, inputs, roofline
from benchmark.readings import Outcome, Readings
from benchmark.reference import episode as ref_episode
from benchmark.trace import Profile

WARM_STEPS = 4  # a short episode's max_steps: the same shapes, few steps
SNAPSHOT = 100  # the check's agents after this many steps, and the last
# The traced segment: steps [TRACE_FROM, TRACE_TO) of an episode whose
# max_steps is TRACE_EPISODE, with the window's shapes and step; its
# start and its summary stay outside.
TRACE_EPISODE, TRACE_FROM, TRACE_TO = 200, 50, 150


class Steps:
    """The program's act function, counting its calls: before call ``t``
    (on the state after ``t`` steps) it runs ``at[t](agents)``."""

    def __init__(self, act, at) -> None:
        self.act, self.at, self.t = act, at, 0

    def __call__(self, agents, goal, obstacles, obs, generator):
        hook = self.at.get(self.t)
        if hook is not None:
            hook(agents)
        self.t += 1
        return self.act(agents, goal, obstacles, obs, generator)


def keeping(act, steps, kept: Dict):
    """``act`` keeping a copy of its agents in ``kept`` at each of
    ``steps``."""
    return Steps(act, {t: (lambda a, t=t: kept.__setitem__(t, a.clone()))
                       for t in steps})


def build(config: Dict, weights: Dict, seed: int, device: str):
    """The program's policy and env params for ``config``, from the train
    CLI's config loader and model builder, with the seeded weights."""
    from marl_distributedformation_tpu_torch.device import resolve_device
    from marl_distributedformation_tpu_torch.train import cli
    from marl_distributedformation_tpu_torch.utils.config import (
        env_params_from_config,
        load_config,
    )

    dev = resolve_device(device)
    cfg = load_config([*config["overrides"], f"seed={int(seed)}"])
    params = env_params_from_config(cfg)
    model = cli.build_model(cfg, params, cfg.get("policy")).to(dev)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(weights[name])
    return model, params


def _state(config, m, seed, episode, device):
    from marl_distributedformation_tpu_torch.env.types import FormationState

    s = inputs.make_states(config["env"], m, seed, f"episode{episode}",
                           device)
    return FormationState(agents=s.agents, goal=s.goal,
                          obstacles=s.obstacles, steps=s.steps)


def drive(config: Dict, mix: Dict, seed: int, seconds: float, trace: bool,
          device: str, t0: float) -> Outcome:
    from marl_distributedformation_tpu_torch import eval as program_eval

    m = int(mix["num_formations"])
    marks = {"start": time.perf_counter() - t0}
    weights = inputs.make_weights(config, seed, device)
    model, params = build(config, weights, seed, device)
    marks["built"] = time.perf_counter() - t0
    act = program_eval.policy_act_fn(model, params, deterministic=True)
    warm = params.replace(max_steps=WARM_STEPS)
    program_eval.evaluate(act, warm, m, seed=seed,
                          initial_state=_state(config, m, seed, -1, device))
    steps = program_eval.episode_length(params)
    at = (SNAPSHOT, steps - 1)
    marks["warm"] = time.perf_counter() - t0

    start = time.perf_counter()
    setup_s = start - t0
    results, agents, episode_s = [], [], []
    # Episodes until one more would end farther from ``seconds`` than
    # stopping here.
    while True:
        agents.append({})
        results.append(program_eval.evaluate(
            keeping(act, at, agents[-1]), params, m, seed=seed,
            initial_state=_state(config, m, seed, len(results), device)))
        episode_s.append(time.perf_counter() - start - sum(episode_s))
        elapsed = sum(episode_s)
        if elapsed + 0.5 * elapsed / len(results) >= seconds:
            break
    window_s = time.perf_counter() - start

    n = config["env"]["num_agents"]
    episodes = len(results)
    readings = Readings(
        config=config, window_s=window_s,
        flops=roofline.eval_step_flops(config, m) * steps * episodes,
        knn_shape=((m, n, config["env"]["knn_k"])
                   if config["env"]["obs_mode"] == "knn" else None))
    if torch.device(device).type == "cuda":
        readings.peak_bytes = torch.cuda.max_memory_allocated()
        if trace:
            segment = Profile()
            program_eval.evaluate(
                Steps(act, {TRACE_FROM: lambda a: segment.start(),
                            TRACE_TO: lambda a: segment.stop()}),
                params.replace(max_steps=TRACE_EPISODE), m, seed=seed,
                initial_state=_state(config, m, seed, -1, device))
            readings.profile = segment
    del model, act
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()

    pick = random.Random(int(seed)).randrange(episodes)
    state = inputs.make_states(config["env"], m, seed, f"episode{pick}",
                               device)
    t_reference = time.perf_counter()
    reference = ref_episode.run(config, weights, state, at=at)
    failed = sum(not all(math.isfinite(v) for v in r.values())
                 for r in results)
    return Outcome(
        e2e={"eval_agent_steps_per_s": episodes * steps * m * n / window_s,
             "setup_s": setup_s},
        numbers=check.eval_numbers((results[pick], agents[pick]), reference,
                                   state.agents),
        attempted=episodes, failed=failed, readings=readings,
        notes={"setup_marks_s": marks, "episode_s": episode_s,
               "reference_s": time.perf_counter() - t_reference})
