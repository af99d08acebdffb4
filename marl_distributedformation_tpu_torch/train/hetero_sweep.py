"""K candidate seeds of the curriculum trained together: the curriculum's
population.

Counterpart of the JAX package's ``train/hetero_sweep.py``
(``HeteroSweepTrainer``) on one device. The quality of a curriculum run's
mode action varies with its seed (``docs/acceptance/hetero5/README.md``,
"Seed variance": about 1/3 to 1/5 of candidates beat the baseline), so K
candidates of the full curriculum train as one program and held-out
evaluation (the ``evaluate`` CLI's sweep mode) picks the winner.

It is ``train/sweep.py``'s ``SweepTrainer`` over padded formations
(``env/hetero.py``) with ``train/curriculum.py``'s stage walk: the members'
formations are folded into one env batch of K*M padded formations with one
``HeteroLayout``; member i is ``HeteroTrainer(seed + i)``: its model
initialised from ``seed + i``, and its stage counts, resets, action noise
and permutations drawn, in the single run's order, from its own generator.
A stage reset draws every member's counts and reset and writes them into
the static carry between iterations, so the same captured graphs serve
every stage. As in the JAX package:

- ``num_timesteps`` is the largest of the members' active
  agent-transition counts (members draw their own mixes), and an explicit
  ``total_timesteps`` stops the whole population when it binds, checked
  before a stage reset;
- ``fused_chunk=C`` dispatches chunks of C iterations clipped at stage
  boundaries, drains each chunk's per-member metrics one chunk late and
  writes the population's checkpoints on a background writer;
  ``iters_per_dispatch`` is refused; there are no learning-rate sweeps;
- ``health=true`` guards every member on its own;
- member files are ``seed{i}/rl_model_{steps_i}_steps`` (with
  ``completed_rollouts``), the anchor ``sweep_state_*`` carries the
  curriculum cursor (``completed_rollouts``, the members' counters) and
  the identity fields, ``curriculum_spec`` among them; ``resume=true``
  continues from the anchor exactly, mid-stage included. An anchor the JAX
  package wrote restores the learner and the counters; the streams start
  afresh and the partial stage starts again.

The member-axis mesh and multi-host parts of the JAX package's trainer are
not ported (ROADMAP A12).
"""

from __future__ import annotations

import functools
import json
from pathlib import Path
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from marl_distributedformation_tpu_torch.algo import PPOConfig
from marl_distributedformation_tpu_torch.device import DeviceLike
from marl_distributedformation_tpu_torch.env.hetero import (
    HeteroLayout,
    HeteroState,
    hetero_compute_obs,
    hetero_reset_batch,
)
from marl_distributedformation_tpu_torch.env.types import EnvParams
from marl_distributedformation_tpu_torch.train.curriculum import (
    Curriculum,
    CurriculumStage,
    empty_hetero_state,
    padded_env_params,
    sample_stage_counts,
)
from marl_distributedformation_tpu_torch.train.iteration import ENV_FIELDS
from marl_distributedformation_tpu_torch.train.recovery import (
    nonfinite_flag_count,
)
from marl_distributedformation_tpu_torch.train.sweep import (
    SweepTrainer,
    population_aggregate,
    write_sweep_summary,
)
from marl_distributedformation_tpu_torch.train.trainer import (
    ChunkMetrics,
    TrainConfig,
    fill_ent_schedule,
)
from marl_distributedformation_tpu_torch.utils.checkpoint import (
    AsyncCheckpointWriter,
    checkpoint_path,
    device_snapshot,
    latest_sweep_state,
    msgpack_restore_file,
    save_checkpoint,
    save_sweep_state,
    sweep_state_path,
    tree_to_host,
    write_atomic,
)
from marl_distributedformation_tpu_torch.utils.logging import (
    MetricsLogger,
    Throughput,
)

Tensor = torch.Tensor


class HeteroSweepTrainer(SweepTrainer):
    """K candidate seeds of ``curriculum`` in one population; see the
    module docstring. ``models`` are the K members' freshly initialised
    modules (member i from ``seed + i``), built for the padded
    ``env_params``' ``obs_dim``."""

    ledger_subsystem = "hetero_sweep"

    def __init__(
        self,
        curriculum: Curriculum = Curriculum(),
        env_params: Optional[EnvParams] = None,
        ppo: PPOConfig = PPOConfig(),
        config: TrainConfig = TrainConfig(),
        num_seeds: int = 4,
        *,
        models: Sequence[torch.nn.Module],
        device: DeviceLike = None,
        capture: bool = True,
    ) -> None:
        if int(config.iters_per_dispatch) > 1:
            raise SystemExit(
                "iters_per_dispatch is retired for population sweeps — "
                "set fused_chunk=K instead (chunks clip at curriculum "
                "stage boundaries, so staged training now composes with "
                "scan fusion)"
            )
        self.curriculum = curriculum
        env_params = padded_env_params(curriculum, env_params)
        ppo = fill_ent_schedule(ppo, env_params, config,
                                iterations=curriculum.total_rollouts)
        self.num_timesteps_members = np.zeros(num_seeds, np.int64)
        self.completed_rollouts = 0
        self._active_agents = np.zeros(num_seeds, np.int64)
        # False until a stage reset (or an exact resume) fills the carry.
        self._stage_ready = False
        super().__init__(env_params, ppo, config, num_seeds, models=models,
                         device=device, capture=capture)

    def _initial_env(self) -> Tuple[HeteroState, Tensor]:
        return empty_hetero_state(
            self.env_params, self.num_seeds * self.config.num_formations,
            self.device)

    def _iteration_options(self) -> Dict[str, Any]:
        return {"layout": HeteroLayout(
            self.env_params, self.num_seeds * self.config.num_formations,
            self.device)}

    @property
    def layout(self) -> HeteroLayout:
        return self._iteration.layout

    @property
    def total_timesteps(self) -> int:
        """A member's budget: the explicit cap, else an upper bound over
        the curriculum."""
        if self.config.total_timesteps is not None:
            return self.config.total_timesteps
        return (self.curriculum.total_rollouts * self.ppo.n_steps
                * self.config.num_formations * self.env_params.num_agents)

    # ------------------------------------------------------------------
    # Stages and dispatch
    # ------------------------------------------------------------------

    def start_stage(self, stage: CurriculumStage) -> None:
        """Every member draws its stage counts and then its reset from its
        own generator; both go into the carry (outside the graphs)."""
        m = self.config.num_formations
        counts = [sample_stage_counts(g, stage, m, self.device)
                  for g in self.generators]
        n_agents = torch.cat([c[0] for c in counts])
        n_obstacles = torch.cat([c[1] for c in counts])
        state = hetero_reset_batch(self.env_params, n_agents, n_obstacles,
                                   self.generators, self.device)
        self._iteration.reset_env(
            state, hetero_compute_obs(state, self.env_params))
        self._refresh_active_agents()
        self._stage_ready = True

    def _refresh_active_agents(self) -> None:
        """The members' active agents, one read of the counts."""
        counts = self.layout.n_agents.reshape(self.num_seeds, -1)
        self._active_agents = counts.sum(-1).cpu().numpy().astype(np.int64)

    def _advance(self, rollouts: int) -> None:
        self.num_timesteps_members += (
            rollouts * self.ppo.n_steps * self._active_agents)
        self.num_timesteps = int(self.num_timesteps_members.max(initial=0))
        self.completed_rollouts += rollouts
        self._vec_steps_since_save += rollouts * self.ppo.n_steps

    def run_chunk(self, r: Optional[int] = None) -> ChunkMetrics:
        """``r`` population iterations (``fused_chunk`` by default; the
        trainer clips ``r`` at stage boundaries), queued; their ``(r, K)``
        metrics stay on the device until drained."""
        if not self._fused_chunk:
            raise RuntimeError("run_chunk() needs fused_chunk > 0")
        return self._dispatch(self._fused_chunk if r is None else int(r))

    def _stages_left(self):
        """``(stage index, stage, first rollout, end)`` of the stages not
        completed, and whether each needs a stage reset first."""
        start = 0
        for idx, (stage, end) in enumerate(
            zip(self.curriculum.stages, self.curriculum.stage_ends())
        ):
            if self.completed_rollouts < end:
                fresh = (self.completed_rollouts == start
                         or not self._stage_ready)
                yield idx, stage, end, fresh
            start = end

    def _budget_spent(self) -> bool:
        cap = self.config.total_timesteps
        return cap is not None and self.num_timesteps >= cap

    # ------------------------------------------------------------------
    # Training
    # ------------------------------------------------------------------

    def train(self) -> Dict[str, float]:
        """The whole curriculum for every member: a population record an
        iteration (with ``curriculum_stage``), checkpoints every
        ``save_freq``, and at the end the final checkpoint and
        ``sweep_summary.json`` ranked on the final iteration's rewards."""
        if self._fused_chunk:
            return self._train_fused()
        logger = self._logger()
        meter = Throughput()
        # log_interval counts the global rollout, so a resumed run logs
        # the rollouts an uninterrupted one would.
        iteration = self.completed_rollouts
        metrics = None
        try:
            for stage_idx, stage, end, fresh in self._stages_left():
                if self._budget_spent():
                    break  # before the stage reset: no draw is spent
                if fresh:
                    self.start_stage(stage)
                while self.completed_rollouts < end:
                    if self._budget_spent():
                        break
                    metrics = self.run_iteration()
                    iteration += 1
                    meter.tick(self._formation_steps(1))
                    if iteration % self.config.log_interval == 0:
                        record = population_aggregate(
                            self._host_metrics(metrics), self.config.seed)
                        record["env_steps_per_sec"] = meter.rate()
                        record["curriculum_stage"] = float(stage_idx)
                        self.last_record = record
                        logger.log(record, self.num_timesteps)
                    if (self.config.checkpoint and self._vec_steps_since_save
                            >= self.config.save_freq):
                        self.save()
            if metrics is not None and self.config.checkpoint:
                final = tree_to_host(dict(metrics))
                self.save()
                self._write_summary(np.asarray(final["reward"]))
        finally:
            self.trace_window.close()
            logger.close()
        return self.last_record

    def _train_fused(self) -> Dict[str, float]:
        """The stage walk with chunks of ``min(fused_chunk, rollouts left
        in the stage)`` iterations: chunk N+1 (or the next stage's first)
        is queued before chunk N drains; checkpoints at chunk boundaries
        on a background writer."""
        logger = self._logger()
        meter = Throughput()
        writer = AsyncCheckpointWriter() if self.config.checkpoint else None
        final_rewards = None
        pending = None  # the chunk in flight, drained a dispatch later
        try:
            for stage_idx, stage, end, fresh in self._stages_left():
                if self._budget_spent():
                    break
                if fresh:
                    self.start_stage(stage)
                while self.completed_rollouts < end:
                    if self._budget_spent():
                        break
                    r = min(self._fused_chunk, end - self.completed_rollouts)
                    before = (self.completed_rollouts,
                              self.num_timesteps_members.copy(),
                              self._active_agents.copy(), stage_idx)
                    chunk = self.run_chunk(r)
                    if pending is not None:
                        final_rewards = self._drain_stage_chunk(
                            logger, meter, *pending)
                    pending = (chunk, r, *before)
                    if (writer is not None and self._vec_steps_since_save
                            >= self.config.save_freq):
                        self.save_async(writer)
            if pending is not None:
                final_rewards = self._drain_stage_chunk(logger, meter,
                                                        *pending)
            if writer is not None:
                self.save_async(writer)
                writer.close()  # the last write is on disk before the summary
                writer = None
                if final_rewards is not None:
                    self._write_summary(final_rewards)
        finally:
            self.trace_window.close()
            if writer is not None:
                writer.close_quietly()
            logger.close()
        return self.last_record

    def _drain_stage_chunk(
        self, logger: MetricsLogger, meter: Throughput, chunk: ChunkMetrics,
        r: int, first_iteration: int, steps_before: np.ndarray,
        active: np.ndarray, stage_idx: int,
    ) -> np.ndarray:
        """One transfer for a chunk's ``(r, K)`` metrics, the skip count,
        then a population record an iteration at the host loop's steps
        (from the members' counters before the chunk and the stage's
        active agents); returns the last iteration's member rewards."""
        host = chunk.to_host()
        self.skipped_updates += nonfinite_flag_count(host)
        meter.tick(self._formation_steps(r))
        for i in range(r):
            if (first_iteration + i + 1) % self.config.log_interval:
                continue
            record = population_aggregate(
                {name: host[name][i] for name in sorted(host)},
                self.config.seed)
            record["env_steps_per_sec"] = meter.rate()
            record["curriculum_stage"] = float(stage_idx)
            step = int((steps_before
                        + (i + 1) * self.ppo.n_steps * active).max())
            logger.log(record, step)
            self.last_record = record
        return np.asarray(host["reward"][-1])

    def _write_summary(self, rewards: np.ndarray) -> None:
        write_sweep_summary(
            self.log_dir, self.config.seed, self.num_seeds, rewards,
            {"curriculum_rollouts": self.curriculum.total_rollouts},
        )

    # ------------------------------------------------------------------
    # Checkpoints
    # ------------------------------------------------------------------

    def _checkpoint_state(self) -> Dict[str, Any]:
        state = super()._checkpoint_state()
        state["env"].update(n_agents=self.layout.n_agents,
                            n_obstacles=self.layout.n_obstacles)
        return state

    def _identity(self) -> Dict[str, Any]:
        return {**super()._identity(),
                "curriculum_spec": self.curriculum.spec()}

    def _files(self, host: Dict[str, Any], members: np.ndarray,
               rollouts: int) -> Tuple[list, Dict[str, Any]]:
        """``[(member dir, steps, tree)]`` and the anchor's tree."""
        trees = []
        for i in range(self.num_seeds):
            tree = self.member_state(i, host, int(members[i]))
            tree["completed_rollouts"] = int(rollouts)
            trees.append((self._member_dir(i), int(members[i]), tree))
        anchor = self._population_tree(host, int(members.max(initial=0)))
        anchor.update({
            "curriculum_spec": self.curriculum.spec(),
            "num_timesteps_members": np.asarray(members, np.int64),
            "completed_rollouts": int(rollouts),
        })
        return trees, anchor

    def save(self) -> None:
        """Every member's file, then the anchor, from one host copy."""
        members = self.num_timesteps_members.copy()
        trees, anchor = self._files(tree_to_host(self._checkpoint_state()),
                                    members, self.completed_rollouts)
        for member_dir, steps, tree in trees:
            save_checkpoint(member_dir, steps, tree)
        save_sweep_state(self.log_dir, int(members.max(initial=0)), anchor)
        self._vec_steps_since_save = 0

    def _write_population_files(self, snapshot: Any, members: np.ndarray,
                                rollouts: int) -> None:
        trees, anchor = self._files(snapshot.result(), members, rollouts)
        for member_dir, steps, tree in trees:
            write_atomic(checkpoint_path(member_dir, steps), tree)
        write_atomic(sweep_state_path(self.log_dir,
                                      int(members.max(initial=0))), anchor)

    def save_async(self, writer: AsyncCheckpointWriter) -> None:
        """``save``'s files from a device snapshot, on ``writer``'s
        thread; the counters are taken now, with the snapshot."""
        writer.submit_write(functools.partial(
            self._write_population_files,
            device_snapshot(self._checkpoint_state()),
            self.num_timesteps_members.copy(), self.completed_rollouts,
        ))
        self._vec_steps_since_save = 0

    def _try_resume(self) -> None:
        """Restore the newest anchor: the learner, the members' counters
        and the cursor; with the port's ``torch_`` keys also the
        generators, the env carry with its counts, the observation and the
        steps, so that the run continues exactly, mid-stage included."""
        path = latest_sweep_state(self.log_dir)
        if path is None:
            print("[hetero-sweep] resume=true but no sweep_state_* "
                  f"population checkpoint under {self.log_dir}; starting "
                  "fresh")
            return
        raw = msgpack_restore_file(path)
        for field, want in self._identity().items():
            got = raw.get(field)
            if got != want and str(got) != str(want):
                raise SystemExit(
                    f"hetero-sweep resume mismatch: {path} was written "
                    f"with {field}={got!r} but this run uses {want!r} — "
                    "candidate identities would silently change"
                )
        for name in ("params", "opt_state", "num_timesteps_members",
                     "completed_rollouts"):
            if name not in raw:
                raise SystemExit(
                    f"hetero-sweep resume: {path} is missing {name!r} — "
                    "truncated or foreign file"
                )
        self._load_learner(raw, path)
        self.num_timesteps_members = np.array(raw["num_timesteps_members"],
                                              np.int64)
        self.num_timesteps = int(self.num_timesteps_members.max(initial=0))
        self.completed_rollouts = int(raw["completed_rollouts"])
        it = self._iteration
        if "torch_generators" in raw:
            env = raw["torch_env_state"]
            with torch.no_grad():
                for g, state in zip(self.generators,
                                    np.array(raw["torch_generators"])):
                    g.set_state(torch.from_numpy(state))
                it.reset_env(
                    HeteroState(**{f: torch.from_numpy(np.array(env[f]))
                                   for f in (*ENV_FIELDS, "n_agents",
                                             "n_obstacles")}),
                    torch.from_numpy(np.array(raw["torch_obs"])),
                )
                it.step.copy_(torch.from_numpy(np.array(raw["torch_step"])))
            self._refresh_active_agents()
            self._stage_ready = True
        # The interrupted run logged past the anchor: drop those records,
        # which the resumed run logs again.
        metrics = Path(self.log_dir) / "metrics.jsonl"
        if metrics.exists():
            kept = [line for line in metrics.read_text().splitlines()
                    if line.strip()
                    and json.loads(line).get("step", 0) <= self.num_timesteps]
            metrics.write_text("".join(line + "\n" for line in kept))
        print(f"[hetero-sweep] resumed {self.num_seeds}-candidate block "
              f"from {path} at rollout {self.completed_rollouts}/"
              f"{self.curriculum.total_rollouts}")
