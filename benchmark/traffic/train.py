"""Training traffic: PPO iterations through the program's trainer, as its
CLI builds it, dispatched a chunk at a time with ``Trainer.run_chunk()``
and drained one chunk late, as the trainer's own fused loop does.

Set-up builds the trainer, loads the benchmark's seeded weights and start
states into it, and runs its first chunk, which captures the graphs. It
then puts the trainer back to those inputs through the program's own
restore (``_host_tree`` and ``_load_tree``, as its rollback does) and runs
a second chunk, of graph replays only, as the window's are; the first
``check_iterations`` iterations of that chunk are recorded through the
trainer's ``phase_hook`` (their rollout rows, sampled actions and
permutations, Adam's first moment after the first, the parameters after
the last) for the reference to follow once the window has closed.

The traced run profiles, after the window, the segment its ``traced``
parameter names: ``epoch``, one rollout and one epoch's minibatch steps
replayed; or ``chunk``, one whole chunk as the window runs it, with its
drain.
"""

from __future__ import annotations

import dataclasses
import gc
import math
import time
from typing import Dict

import torch

from benchmark import check, inputs, roofline
from benchmark.readings import Outcome, Readings
from benchmark.reference import ppo as ref_ppo
from benchmark.trace import PhaseClock, Profile


def build(config: Dict, seed: int, device: str):
    """The program's trainer for ``config``, built by its CLI's
    ``build_trainer`` from the configuration's overrides; refuses one whose
    environment, PPO settings or sizes differ from the configuration's."""
    from marl_distributedformation_tpu_torch.train import cli

    trainer = cli.build_trainer(
        [*config["overrides"], f"seed={int(seed)}", f"device={device}"])
    env = dataclasses.asdict(trainer.env_params)
    ppo = dataclasses.asdict(trainer.ppo)
    wrong = {k: (env.get(k), v) for k, v in config["env"].items()
             if env.get(k) != v}
    wrong.update({k: (ppo.get(k), v) for k, v in config["ppo"].items()
                  if ppo.get(k) != v})
    for key, have in (("num_formations", trainer.config.num_formations),
                      ("fused_chunk", trainer.config.fused_chunk)):
        if have != config[key]:
            wrong[key] = (have, config[key])
    if wrong:
        raise SystemExit(f"the program's trainer differs from the "
                         f"configuration (program, configuration): {wrong}")
    return trainer


def load_inputs(trainer, weights, state) -> None:
    """The seeded weights into the model and the start states into the
    env carry, with the program's own observation of them."""
    with torch.no_grad():
        named = dict(trainer.model.named_parameters())
        if set(named) != set(weights):
            raise SystemExit(f"parameters differ: program {sorted(named)}, "
                             f"benchmark {sorted(weights)}")
        for name, p in named.items():
            p.copy_(weights[name])
        carry = trainer.env_state
        for field in ("agents", "goal", "obstacles", "steps"):
            getattr(carry, field).copy_(getattr(state, field))
        trainer.obs.copy_(trainer.env_spec.obs(carry, trainer.env_params))


class Recorder:
    """``phase_hook`` of the first ``iterations`` iterations: device copies
    of what the check compares, queued behind each phase."""

    def __init__(self, trainer, iterations: int, weights) -> None:
        self.trainer = trainer
        self.iterations = iterations
        self.it = -1
        self.record = ref_ppo.Record(
            start={k: v.clone() for k, v in weights.items()})

    def __call__(self, phase: str) -> None:
        if phase == "rollout":
            self.it += 1
            return
        if self.it >= self.iterations:
            return
        t = self.trainer
        update = t._iteration.update
        rec = self.record
        if phase == "update":
            m, n = t.config.num_formations, t.env_params.num_agents
            data = update.data
            rec.actions.append(
                data.actions.reshape(t.ppo.n_steps, m, n, -1).clone())
            rec.rows.append({f: getattr(data, f).clone()
                             for f in ref_ppo.ROW_FIELDS})
            rec.perms.append(update.perms.reshape(t.ppo.n_epochs, -1)
                             .clone())
        elif phase == "end":
            if self.it == 0:
                rec.mu1 = {k: v.clone() for k, v in t.opt_state.mu.items()}
            if self.it == self.iterations - 1:
                rec.params = {k: p.detach().clone()
                              for k, p in t.model.named_parameters()}


def traced_segment(trainer, segment: str):
    """The call the traced run profiles (see the module's docstring)."""
    if segment == "chunk":
        return lambda: trainer.run_chunk().to_host()
    if segment != "epoch":
        raise SystemExit(f"unknown traced segment {segment!r}")
    rollout, minibatch, _ = trainer._phases
    steps = trainer._iteration.num_minibatch_steps // trainer.ppo.n_epochs

    def window():
        rollout()
        for _ in range(steps):
            minibatch()

    return window


def restart(trainer, anchor, weights) -> None:
    """The trainer back at the set-up's inputs: ``anchor`` (its
    ``_host_tree()`` taken once they were loaded) restored into its
    static carry, which the captured graphs read; refuses a restore that
    leaves a parameter other than the seeded one."""
    trainer._load_tree(anchor, "the benchmark's seeded inputs")
    for name, p in trainer.model.named_parameters():
        if not torch.equal(p.detach(), weights[name]):
            raise SystemExit(f"the restore left {name} unlike its seeded "
                             "weights")


def finite_rows(host: Dict) -> list:
    """Per iteration of a drained chunk, whether every metric is finite."""
    names = sorted(host)
    return [all(math.isfinite(float(host[k][i])) for k in names)
            for i in range(len(host[names[0]]))]


def drive(config: Dict, mix: Dict, seed: int, seconds: float, trace: bool,
          device: str, t0: float) -> Outcome:
    checked = int(mix["check_iterations"])
    marks = {"start": time.perf_counter() - t0}
    trainer = build(config, seed, device)
    marks["built"] = time.perf_counter() - t0
    weights = inputs.make_weights(config, seed, device)
    state = inputs.make_states(config["env"], config["num_formations"],
                               seed, "train", device)
    load_inputs(trainer, weights, state)
    marks["inputs"] = time.perf_counter() - t0
    if trainer.config.fused_chunk < checked:
        raise SystemExit("the first chunk holds fewer iterations than the "
                         "check follows")
    anchor = trainer._host_tree()
    trainer.run_chunk().to_host()
    marks["capture_chunk"] = time.perf_counter() - t0
    restart(trainer, anchor, weights)
    recorder = Recorder(trainer, checked, weights)
    trainer.phase_hook = recorder
    first = trainer.run_chunk().to_host()
    marks["checked_chunk"] = time.perf_counter() - t0
    record = recorder.record
    record.losses = [float(x) for x in first["loss"][:checked]]
    on_card = torch.device(device).type == "cuda"
    clock = PhaseClock() if trace and on_card else None
    trainer.phase_hook = clock

    # The window: whole chunks, each drained as it ends (a dispatch waits
    # for the device once the launch queue is full, so the host runs
    # little ahead anyway), until one more would end farther from
    # ``seconds`` than stopping here.
    start = time.perf_counter()
    setup_s = start - t0
    iterations = failed = 0
    chunk_s = []
    while True:
        chunk = trainer.run_chunk()
        ok = finite_rows(chunk.to_host())
        iterations += len(ok)
        failed += ok.count(False)
        chunk_s.append(time.perf_counter() - start - sum(chunk_s))
        elapsed = sum(chunk_s)
        if elapsed + 0.5 * elapsed / len(chunk_s) >= seconds:
            break
    if on_card:
        torch.cuda.synchronize()
    window_s = time.perf_counter() - start
    trainer.phase_hook = None

    env, ppo = config["env"], config["ppo"]
    m, n = config["num_formations"], env["num_agents"]
    readings = Readings(
        config=config, window_s=window_s,
        flops=roofline.train_iteration_flops(config) * iterations,
        knn_shape=((m, n, env["knn_k"]) if env["obs_mode"] == "knn"
                   else None))
    if on_card:
        readings.peak_bytes = torch.cuda.max_memory_allocated()
        if trace:
            readings.phases = clock.phase_ms()
            readings.profile = Profile.of(
                traced_segment(trainer, mix.get("traced", "epoch")))
    del trainer, chunk, first
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    t_reference = time.perf_counter()
    reference = ref_ppo.run(config, weights, state, checked, follow=record)
    return Outcome(
        e2e={"train_agent_steps_per_s":
             iterations * ppo["n_steps"] * m * n / window_s,
             "setup_s": setup_s},
        numbers=check.train_numbers(record, reference),
        attempted=iterations, failed=failed, readings=readings,
        notes={"setup_marks_s": marks, "chunk_s": chunk_s,
               "reference_s": time.perf_counter() - t_reference,
               "still_leaves": sorted(set(reference.mu1) - set(
                   check.moving_leaves(reference.mu1)))})
