"""A curriculum over formation size and obstacle count, and its trainer.

Counterpart of the JAX package's ``train/curriculum.py`` (BASELINE config
5): PPO over padded heterogeneous formations (``env/hetero.py``), walking
the stages of a ``Curriculum``. Every formation is padded to the
curriculum's largest agent count (N_max) and obstacle count (K_max), so a
stage boundary changes data, not shapes: the trainer draws each
formation's counts for the stage, resets every formation and writes the
counts' layout, the env state and the observation into the iteration's
static carry, between iterations. On the card the iteration's three CUDA
graphs are captured once and serve every stage (``graph_count`` stays
3), as the JAX package compiles its iteration once for the whole
curriculum.

``HeteroTrainer`` is ``train/trainer.py``'s ``Trainer`` with these
differences, each the JAX package's:

- the model of a per-formation policy (CTDE) sees the ``(M, N_max)`` agent
  mask in every forward, rollout and update, so padded agents leave the
  pooled critic and their values are 0; padded agents weigh 0 in the loss
  and in the ``reward`` metric;
- ``num_timesteps`` counts *active* agent-transitions; ``total_timesteps``
  is an early-stop cap on top of the curriculum;
- the schedules' horizon (``ent_coef_final``, ``log_std_final``) is the
  curriculum's ``total_rollouts``;
- ``fused_chunk`` and ``iters_per_dispatch`` are refused (stage boundaries
  are the host's), and the health word and recovery ladder are not run;
- records carry ``curriculum_stage``; checkpoints carry
  ``completed_rollouts``, and a resume skips the completed stages and
  starts the partial one afresh (new counts, new reset).

Randomness: a stage draws its counts (``sample_stage_counts``) and then
its reset from the run's device generator, which the iterations then draw
from as a ``Trainer``'s do. Populations of the curriculum are
``train/hetero_sweep.py``'s.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Any, Dict, Optional, Tuple

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
from marl_distributedformation_tpu_torch.train.iteration import (
    PhasedIteration,
)
from marl_distributedformation_tpu_torch.train.trainer import (
    RESUME_KEYS,
    Trainer,
    TrainConfig,
    fill_ent_schedule,
    metrics_to_host,
)
from marl_distributedformation_tpu_torch.utils.logging import Throughput

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class CurriculumStage:
    """One stage: ``rollouts`` iterations in which each formation keeps an
    agent count drawn from ``agent_counts`` (uniformly, or by ``probs``)
    and ``num_obstacles`` active obstacles."""

    rollouts: int
    agent_counts: Tuple[int, ...]
    probs: Optional[Tuple[float, ...]] = None
    num_obstacles: int = 0

    def __post_init__(self) -> None:
        if self.rollouts <= 0:
            raise ValueError(f"a stage needs rollouts > 0, got "
                             f"{self.rollouts}")
        if not self.agent_counts or min(self.agent_counts) < 2:
            raise ValueError("a stage needs agent_counts, each >= 2 (a "
                             f"ring), got {self.agent_counts}")
        if self.probs is not None and len(self.probs) != len(
            self.agent_counts
        ):
            raise ValueError("probs needs one entry an agent count")
        if self.num_obstacles < 0:
            raise ValueError("num_obstacles must be >= 0")


@dataclasses.dataclass(frozen=True)
class Curriculum:
    """The stages in order. The default is the JAX package's: 5-agent
    formations, then a 5/20 mix, then the mix with 4 obstacles."""

    stages: Tuple[CurriculumStage, ...] = (
        CurriculumStage(rollouts=40, agent_counts=(5,)),
        CurriculumStage(rollouts=40, agent_counts=(5, 20)),
        CurriculumStage(rollouts=20, agent_counts=(5, 20), num_obstacles=4),
    )

    @property
    def max_agents(self) -> int:
        return max(max(s.agent_counts) for s in self.stages)

    @property
    def max_obstacles(self) -> int:
        return max(s.num_obstacles for s in self.stages)

    @property
    def total_rollouts(self) -> int:
        return sum(s.rollouts for s in self.stages)

    def stage_ends(self) -> Tuple[int, ...]:
        """The global rollout index at which each stage ends."""
        return tuple(np.cumsum([s.rollouts for s in self.stages]).tolist())

    def spec(self) -> str:
        """The stages as a canonical string (a population anchor's
        identity; the JAX package's ``_curriculum_spec``)."""
        return repr([
            (s.rollouts, tuple(s.agent_counts),
             None if s.probs is None else tuple(s.probs), s.num_obstacles)
            for s in self.stages
        ])


def padded_env_params(curriculum: Curriculum,
                      env_params: Optional[EnvParams]) -> EnvParams:
    """``env_params`` padded to the curriculum: N_max and K_max."""
    env_params = env_params or EnvParams()
    return env_params.replace(
        num_agents=max(curriculum.max_agents, env_params.num_agents),
        num_obstacles=max(curriculum.max_obstacles,
                          env_params.num_obstacles),
    )


def sample_stage_counts(
    generator: Optional[torch.Generator],
    stage: CurriculumStage,
    num_formations: int,
    device: DeviceLike,
) -> Tuple[Tensor, Tensor]:
    """Each formation's ``(n_agents, n_obstacles)``, ``(M,)`` int32, for
    ``stage``: an index into ``agent_counts`` drawn from ``generator``,
    uniformly (``randint``) or by ``probs`` (a uniform draw against their
    cumulative sum, normalised as ``jax.random.choice`` normalises them)."""
    dev = torch.device(device)
    counts = torch.tensor(stage.agent_counts, dtype=torch.int32, device=dev)
    shape = (num_formations,)
    if stage.probs is None:
        idx = torch.randint(0, counts.shape[0], shape, generator=generator,
                            device=dev)
    else:
        cdf = torch.cumsum(torch.tensor(stage.probs, dtype=torch.float32,
                                        device=dev), 0)
        u = torch.rand(shape, generator=generator, device=dev) * cdf[-1]
        idx = torch.searchsorted(cdf, u, right=True).clamp_max(
            counts.shape[0] - 1)
    n_obstacles = torch.full(shape, stage.num_obstacles, dtype=torch.int32,
                             device=dev)
    return counts[idx], n_obstacles


def empty_hetero_state(params: EnvParams, num_formations: int,
                       device: torch.device) -> Tuple[HeteroState, Tensor]:
    """A zero carry of padded formations, all agents active, and a zero
    observation: what a run holds before its first stage draws anything."""
    m, n, k = num_formations, params.num_agents, params.num_obstacles

    def zeros(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    state = HeteroState(
        agents=zeros(m, n, 2), goal=zeros(m, 2), obstacles=zeros(m, k, 2),
        steps=zeros(m, dtype=torch.int32),
        n_agents=torch.full((m,), n, dtype=torch.int32, device=device),
        n_obstacles=zeros(m, dtype=torch.int32),
    )
    return state, zeros(m, n, params.obs_dim)


def make_hetero_iteration(
    env_params: EnvParams,
    ppo: PPOConfig,
    per_formation: bool = False,
    env_step_fn: Any = None,
):
    """One curriculum iteration as a function, run eagerly: ``(model,
    opt_state, step, env_state, obs, generator, noise=None,
    permutations=None) -> (step, env_state, last_obs, metrics)`` over
    padded formations (``env_state`` a ``HeteroState``), updating ``model``
    and ``opt_state`` in place; the counterpart of the JAX package's
    ``make_hetero_iteration``. ``noise``, ``permutations`` and
    ``env_step_fn`` let tests inject the JAX package's draws."""

    def iteration(model, opt_state, step, env_state, obs, generator,
                  noise=None, permutations=None):
        if bool(model.per_formation) != per_formation:
            raise ValueError(
                f"per_formation={per_formation} but the model's is "
                f"{model.per_formation}"
            )
        layout = HeteroLayout.of(env_state.n_agents, env_state.n_obstacles,
                                 env_params)
        it = PhasedIteration(
            env_params, ppo, model, opt_state, generator, env_state, obs,
            step=int(step), env_step_fn=env_step_fn, layout=layout,
        )
        it.run(noise, permutations)
        return int(it.step), it.env, it.obs, it.metrics(it.ring.take(1)[0])

    return iteration


class HeteroTrainer(Trainer):
    """PPO over padded heterogeneous formations, walking a curriculum; see
    the module docstring. ``model`` is the shared per-agent MLP or a
    per-formation CTDE model, built for the padded ``env_params``'
    ``obs_dim``."""

    resume_keys = RESUME_KEYS + ("completed_rollouts",)

    def __init__(
        self,
        curriculum: Curriculum = Curriculum(),
        env_params: Optional[EnvParams] = None,
        ppo: PPOConfig = PPOConfig(),
        config: TrainConfig = TrainConfig(),
        *,
        model: torch.nn.Module,
        device: DeviceLike = None,
        capture: bool = True,
    ) -> None:
        if int(config.iters_per_dispatch) > 1 or int(config.fused_chunk) > 0:
            raise SystemExit(
                "iters_per_dispatch > 1 / fused_chunk do not compose with "
                "curriculum training (stage boundaries are host-driven); "
                "unset them or drop the curriculum"
            )
        if config.health or config.recovery:
            print("[hetero] health/recovery: the single curriculum run "
                  "carries no health word or recovery ladder (as the JAX "
                  "package's HeteroTrainer); a curriculum population "
                  "(num_seeds > 1) guards each member", file=sys.stderr)
            config = dataclasses.replace(config, health=False,
                                         recovery=False)
        self.curriculum = curriculum
        env_params = padded_env_params(curriculum, env_params)
        ppo = fill_ent_schedule(ppo, env_params, config,
                                iterations=curriculum.total_rollouts)
        self.completed_rollouts = 0  # the global rollout index
        self._active_agents = 0  # active agents of the stage's formations
        self.stage_index: Optional[int] = None
        super().__init__(env_params, ppo, config, model=model, device=device,
                         capture=capture)

    def _initial_env(self) -> Tuple[HeteroState, Tensor]:
        return empty_hetero_state(self.env_params,
                                  self.config.num_formations, self.device)

    def _iteration_options(self) -> Dict[str, Any]:
        return {"layout": HeteroLayout(self.env_params,
                                       self.config.num_formations,
                                       self.device)}

    @property
    def layout(self) -> HeteroLayout:
        return self._iteration.layout

    @property
    def total_timesteps(self) -> int:
        """The explicit ``total_timesteps`` cap, else an upper bound over
        the curriculum (every formation at N_max)."""
        if self.config.total_timesteps is not None:
            return self.config.total_timesteps
        return (self.curriculum.total_rollouts * self.ppo.n_steps
                * self.config.num_formations * self.env_params.num_agents)

    def start_stage(self, stage: CurriculumStage) -> None:
        """Draw the stage's counts and a reset of every formation, and
        write them into the carry (outside the graphs)."""
        m = self.config.num_formations
        n_agents, n_obstacles = sample_stage_counts(
            self.generator, stage, m, self.device)
        state = hetero_reset_batch(self.env_params, n_agents, n_obstacles,
                                   self.generator, self.device)
        self._iteration.reset_env(
            state, hetero_compute_obs(state, self.env_params))
        self._active_agents = int(n_agents.sum())

    def _advance(self, rollouts: int) -> None:
        self.num_timesteps += rollouts * self.ppo.n_steps * self._active_agents
        self.completed_rollouts += rollouts
        self._vec_steps_since_save += rollouts * self.ppo.n_steps

    def train(self) -> Dict[str, float]:
        """The whole curriculum (from the resumed stage on); returns the
        last record."""
        logger = self._logger()
        meter = Throughput()
        cap = self.config.total_timesteps
        iteration = 0
        try:
            ends = self.curriculum.stage_ends()
            for stage_idx, stage in enumerate(self.curriculum.stages):
                if self.completed_rollouts >= ends[stage_idx]:
                    continue  # resumed past this stage
                if cap is not None and self.num_timesteps >= cap:
                    break
                self.stage_index = stage_idx
                self.start_stage(stage)
                while self.completed_rollouts < ends[stage_idx]:
                    if cap is not None and self.num_timesteps >= cap:
                        break
                    metrics = self.run_iteration()
                    iteration += 1
                    meter.tick(self.ppo.n_steps * self.config.num_formations)
                    if iteration % self.config.log_interval == 0:
                        record = metrics_to_host(metrics)
                        record["env_steps_per_sec"] = meter.rate()
                        record["curriculum_stage"] = float(stage_idx)
                        self.last_record = record
                        logger.log(record, self.num_timesteps)
                    if (self.config.checkpoint and self._vec_steps_since_save
                            >= self.config.save_freq):
                        self.save()
            if self.config.checkpoint:
                self.save()
        finally:
            self.trace_window.close()
            logger.close()
        return self.last_record

    # ------------------------------------------------------------------
    # Checkpoints: the Trainer's, with the counts and the cursor
    # ------------------------------------------------------------------

    def _checkpoint_state(self) -> Dict[str, Any]:
        state = super()._checkpoint_state()
        state["env"].update(n_agents=self.layout.n_agents,
                            n_obstacles=self.layout.n_obstacles)
        state["completed_rollouts"] = int(self.completed_rollouts)
        return state

    def _checkpoint_tree(self, host: Dict[str, Any]) -> Dict[str, Any]:
        tree = super()._checkpoint_tree(host)
        tree["completed_rollouts"] = int(host["completed_rollouts"])
        return tree

    def _load_tree(self, raw: Dict[str, Any], origin: Any) -> None:
        super()._load_tree(raw, origin)
        self.completed_rollouts = int(raw.get("completed_rollouts", 0))
        env = raw.get("torch_env_state")
        if env is not None and "n_agents" in env:
            self.layout.set(torch.from_numpy(np.array(env["n_agents"])),
                            torch.from_numpy(np.array(env["n_obstacles"])))
        print(f"[hetero] resumed at {self.num_timesteps} steps "
              f"({self.completed_rollouts} rollouts)")


def curriculum_from_cfg(cfg: Any) -> Curriculum:
    """A ``Curriculum`` from the config's ``curriculum`` list (each entry
    ``{rollouts, agent_counts, probs?, num_obstacles?}``), or from its YAML
    text (a quoted command-line override)."""
    if isinstance(cfg, str):
        import yaml

        cfg = yaml.safe_load(cfg)
    return Curriculum(stages=tuple(
        CurriculumStage(
            rollouts=int(entry["rollouts"]),
            agent_counts=tuple(int(n) for n in entry["agent_counts"]),
            probs=(tuple(float(p) for p in entry["probs"])
                   if entry.get("probs") is not None else None),
            num_obstacles=int(entry.get("num_obstacles", 0)),
        )
        for entry in cfg
    ))
