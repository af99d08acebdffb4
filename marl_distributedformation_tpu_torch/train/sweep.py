"""Population training: K PPO runs advanced together in one set of captured
CUDA graphs.

Counterpart of the JAX package's ``train/sweep.py`` (``SweepTrainer``,
``population_aggregate``, ``write_sweep_summary``) on one device. The JAX
package ``vmap``s its iteration over a leading member axis and compiles
one program; here the iteration is ``train/iteration.py``'s
``PopulationIteration``: the members' parameters are stacked
(``models/population.py``), their formations are folded into one env batch
of K*M formations (one env step and one k-NN launch a step for the whole
population), and its three phases are captured as CUDA graphs on the card
as the single run's are (``train/capture.py``), with every member's
generator registered.

Member i is the port's single run at ``seed + i``: its model is initialised
from the CPU generator seeded with ``seed + i`` (the caller builds the K
models, as ``train/cli.py`` does), and it draws its resets, action noise
and permutations, in the single run's order, from its own generator on the
device, seeded with ``seed + i + 2**32``. Every member trains the full
single-run budget; ``num_timesteps`` counts one member's
agent-transitions. ``learning_rates`` gives every member its own rate, a
``(K,)`` device ``lr`` (optax's ``inject_hyperparams`` in the JAX package).

``health=true`` gives every member its own health word and skip-update
guard: a diverged member keeps its state from before the iteration while
the others train on, and the drain counts the skips. As in the JAX
package, a population runs no recovery ladder. ``fused_chunk`` fuses
iterations into a dispatch whose per-member metrics drain a chunk late;
``iters_per_dispatch`` is refused.

A logical checkpoint is every member's ``seed{i}/rl_model_{steps}_steps``
file (the single-run layout, which the JAX package's tools read; a
learning-rate sweep's member files carry no optimizer state) and then the
``sweep_state_{steps}_steps`` anchor: the stacked learner in the JAX
layout, the identity fields, and the port's generators, env state and
observation under ``torch_`` keys. ``resume=true`` continues from the
newest anchor exactly; an anchor the JAX package wrote restores the
learner, and the streams start afresh.

``mesh`` (a ``parallel.Mesh`` of one 'dp' axis) splits the seed axis over
the ranks: rank r builds and trains only its contiguous member block
(``member_block``; the caller builds those members' models), with no
collective in the iteration, since members are independent. The host
seams gather: each record aggregates every member's metrics, and a
checkpoint gathers the population's host state to the coordinator, which
alone writes the member files, the anchor and the summary. A resume is
read and checked by the coordinator and broadcast; every rank takes its
block of the anchor.
"""

from __future__ import annotations

import functools
import json
import sys
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from marl_distributedformation_tpu_torch.algo import PPOConfig
from marl_distributedformation_tpu_torch.algo.optim import (
    population_adam_init,
)
from marl_distributedformation_tpu_torch.compat.convert import (
    inject_hyperparams,
    member_slice,
    opt_state_from_jax,
    opt_state_to_jax,
    params_from_jax,
    params_to_jax,
)
from marl_distributedformation_tpu_torch.device import DeviceLike, resolve_device
from marl_distributedformation_tpu_torch.env.types import EnvParams
from marl_distributedformation_tpu_torch.envs import spec_for_params
from marl_distributedformation_tpu_torch.models.population import (
    PopulationModel,
)
from marl_distributedformation_tpu_torch.parallel.distributed import (
    all_gather_object,
    from_coordinator,
    is_coordinator,
    local_formation_slice,
    stack_rows,
    world_size,
)
from marl_distributedformation_tpu_torch.train.capture import (
    PhaseGraph,
    own_stream,
)
from marl_distributedformation_tpu_torch.train.iteration import (
    ENV_FIELDS,
    PopulationIteration,
)
from marl_distributedformation_tpu_torch.train.recovery import (
    nonfinite_flag_count,
    wrap_health,
)
from marl_distributedformation_tpu_torch.train.trainer import (
    RUN_SEED_OFFSET,
    ChunkMetrics,
    TrainConfig,
    default_total_timesteps,
    fill_ent_schedule,
)
from marl_distributedformation_tpu_torch.utils.checkpoint import (
    AsyncCheckpointWriter,
    checkpoint_path,
    device_snapshot,
    latest_checkpoint,
    latest_sweep_state,
    msgpack_restore_file,
    save_checkpoint,
    save_sweep_state,
    sweep_state_path,
    tree_to_host,
    write_atomic,
)
from marl_distributedformation_tpu_torch.utils.config import repo_root
from marl_distributedformation_tpu_torch.utils.logging import (
    MetricsLogger,
    Throughput,
    run_logger,
)
from marl_distributedformation_tpu_torch.utils.profiling import TraceWindow

Tensor = torch.Tensor


def member_block(num_seeds: int, mesh: Any = None) -> range:
    """The members a rank of ``mesh`` trains: its contiguous block of the
    seed axis over 'dp' (every member without a mesh)."""
    if mesh is None:
        return range(num_seeds)
    start, count = local_formation_slice(
        num_seeds, mesh.index("dp"), mesh.axis_size("dp"))
    return range(start, start + count)


def check_member_mesh(mesh: Any, num_seeds: int) -> None:
    """The JAX package's checks of a population's mesh: the seed axis
    over 'dp' only, and a member count every rank can share evenly."""
    if mesh is None:
        return
    assert set(mesh.axis_names) == {"dp"}, (
        f"sweep meshes shard the SEED axis over 'dp' only; got "
        f"axes {tuple(mesh.axis_names)} — an 'sp' axis would "
        "replicate every member redundantly across it"
    )
    dp = int(mesh.shape["dp"])
    assert num_seeds % dp == 0, (
        f"num_seeds={num_seeds} must be divisible by the mesh dp "
        f"axis ({dp}) so every device holds the same member count"
    )


class SweepTrainer:
    """K-member population PPO on one device; see the module docstring.

    ``models`` are the K members' freshly initialised modules (member i
    from ``seed + i``); ``learning_rates`` (length K) the members' rates,
    None for every member at ``ppo.learning_rate``. On CUDA the
    iteration's phases run as captured graphs; ``capture=False`` runs them
    eagerly (comparisons only).
    """

    # The phases' subsystem in the program ledger (JAX: ledgered_jit's).
    ledger_subsystem = "sweep"

    def __init__(
        self,
        env_params: EnvParams,
        ppo: PPOConfig = PPOConfig(),
        config: TrainConfig = TrainConfig(),
        num_seeds: int = 4,
        *,
        models: Sequence[torch.nn.Module],
        learning_rates: Any = None,
        device: DeviceLike = None,
        capture: bool = True,
        mesh: Any = None,
    ) -> None:
        models = list(models)
        check_member_mesh(mesh, num_seeds)
        self.mesh = mesh
        self.members = member_block(num_seeds, mesh)
        if num_seeds < 1 or len(models) != len(self.members):
            raise ValueError(f"num_seeds={num_seeds} needs one model a "
                             f"member of the block {self.members}, got "
                             f"{len(models)}")
        self._fused_chunk = max(0, int(config.fused_chunk))
        if int(config.iters_per_dispatch) > 1:
            raise SystemExit(
                "iters_per_dispatch is retired for population sweeps — "
                "set fused_chunk=K instead (the Anakin mode: K vmapped "
                "iterations per lax.scan dispatch, per-member metrics "
                "stacked per iteration, async population checkpoints)"
            )
        self.device = resolve_device(device)
        ppo = fill_ent_schedule(ppo, env_params, config)
        self.env_params = env_params
        self.ppo = ppo
        self.config = config
        self.num_seeds = num_seeds
        self._lrs_host: Optional[np.ndarray] = None
        if learning_rates is not None:
            # YAML keeps dotless scientific notation ("3e-4") as strings.
            lrs = np.asarray(
                [float(x) for x in np.ravel(learning_rates)], np.float32
            )
            if lrs.shape != (num_seeds,):
                raise ValueError(
                    f"learning_rates must have one entry per member: got "
                    f"{lrs.shape[0]} for num_seeds={num_seeds}"
                )
            self._lrs_host = lrs
        self.model = PopulationModel(models).to(self.device)
        self.policy = self.model.policy
        self.per_formation = self.model.per_formation
        m = config.num_formations
        self.num_envs = m * env_params.num_agents

        self.generators = [
            torch.Generator(device=self.device).manual_seed(
                config.seed + i + RUN_SEED_OFFSET
            )
            for i in self.members
        ]
        env_state, obs = self._initial_env()
        self.opt_state = population_adam_init(self.model.params)
        self._iteration = wrap_health(PopulationIteration(
            env_params, ppo, self.model, self.opt_state, self.generators,
            env_state, obs,
            lr=None if self._lrs_host is None else self._local_lrs(),
            ring_rows=2 * max(self._fused_chunk, 1),
            **self._iteration_options(),
        ), config)
        self.capture = capture and self.device.type == "cuda"
        it = self._iteration
        # The population's own capture stream (train/capture.py: C6).
        self.capture_stream = own_stream(self, self.device)
        self._phases = tuple(
            PhaseGraph(name, fn, self.generators, self.capture,
                       subsystem=self.ledger_subsystem,
                       program=f"{self.ledger_subsystem}_{name}",
                       stream=self.capture_stream)
            for name, fn in (("rollout", it.rollout),
                             ("minibatch", it.minibatch), ("end", it.end))
        )
        self.num_timesteps = 0  # one member's agent-transitions
        self._vec_steps_since_save = 0
        self.skipped_updates = 0  # members' updates the guard skipped
        self.log_dir = config.log_dir or str(
            repo_root() / "logs" / config.name
        )
        # profile=true's window over whole dispatches (Trainer's).
        self.trace_window = TraceWindow(self.log_dir, config.profile,
                                        config.profile_iterations, skip=2)
        self.last_record: Dict[str, float] = {}
        # Called with "rollout", "update" and "end" at each iteration's
        # phase boundaries (chip_smoke.py records CUDA events there).
        self.phase_hook: Optional[Callable[[str], None]] = None
        if config.recovery:
            print("[sweep] recovery=true: a population runs no recovery "
                  "ladder (as the JAX package's SweepTrainer); with "
                  "health=true each member's guard skips its own "
                  "diverged updates", file=sys.stderr)
        if config.resume:
            self._try_resume()

    # ------------------------------------------------------------------
    # The carry
    # ------------------------------------------------------------------

    def _initial_env(self) -> Tuple[Any, Tensor]:
        """The env carry the population starts from: every member's reset
        of the run's env drawn from its own generator, and the
        observation."""
        spec = spec_for_params(self.env_params)
        state = spec.reset_batch(
            self.env_params, len(self.members) * self.config.num_formations,
            self.generators, self.device)
        return state, spec.obs(state, self.env_params)

    def _local_lrs(self) -> List[float]:
        """This rank's members' learning rates."""
        return self._lrs_host[self.members.start:self.members.stop].tolist()

    def _gather_members(self, tree: Any) -> Any:
        """A host tree of this rank's members (member-leading leaves) as
        the whole population's, gathered from every rank in member
        order."""
        if self.mesh is None or world_size() == 1:
            return tree
        return stack_rows(all_gather_object(tree))

    def _iteration_options(self) -> Dict[str, Any]:
        """Further arguments of the population's ``PopulationIteration``."""
        return {}

    @property
    def total_timesteps(self) -> int:
        return default_total_timesteps(self.config)

    @property
    def learning_rates(self) -> Optional[np.ndarray]:
        return self._lrs_host

    @property
    def env_state(self):
        return self._iteration.env

    @property
    def obs(self) -> Tensor:
        return self._iteration.obs

    @property
    def step(self) -> int:
        """Member 0's optimizer steps so far (reads the device)."""
        return int(self._iteration.step[0])

    @property
    def metric_names(self) -> Tuple[str, ...]:
        return self._iteration.metric_names()

    def graph_stats(self) -> List[Dict[str, object]]:
        """Nodes, capture seconds and calls of each phase's graph."""
        return [phase.stats() for phase in self._phases]

    # ------------------------------------------------------------------
    # Dispatch
    # ------------------------------------------------------------------

    def _dispatch(self, rollouts: int) -> ChunkMetrics:
        """``rollouts`` population iterations, queued without reading the
        device; returns their metric rows ``(rollouts, K, names)``."""
        self.trace_window.before_dispatch()
        try:
            for _ in range(rollouts):
                self._iteration.run(mark=self.phase_hook,
                                    phases=self._phases)
        except BaseException:
            self.trace_window.close()
            raise
        self.trace_window.after_dispatch()
        self._advance(rollouts)
        ready = None
        if self.device.type == "cuda":
            ready = torch.cuda.Event()
            ready.record()
        return ChunkMetrics(
            self.metric_names, self._iteration.ring.take(rollouts), ready
        )

    def _advance(self, rollouts: int) -> None:
        """The host's counters after ``rollouts`` iterations."""
        self.num_timesteps += rollouts * self.ppo.n_steps * self.num_envs
        self._vec_steps_since_save += rollouts * self.ppo.n_steps

    def graph_count(self) -> int:
        """CUDA graphs captured so far (0 eagerly): one a phase."""
        return sum(phase.graph is not None for phase in self._phases)

    def run_iteration(self) -> Dict[str, Tensor]:
        """One population iteration; every metric a ``(K,)`` device
        tensor."""
        if self._fused_chunk:
            raise RuntimeError(
                "a fused_chunk sweep dispatches with run_chunk() (stacked "
                "per-iteration metrics)"
            )
        chunk = self._dispatch(1)
        return self._iteration.metrics(chunk.rows[0])

    def run_chunk(self) -> ChunkMetrics:
        """One chunk of ``fused_chunk`` population iterations, queued; its
        ``(fused_chunk, K)`` metrics stay on the device until drained."""
        if not self._fused_chunk:
            raise RuntimeError("run_chunk() needs fused_chunk > 0")
        return self._dispatch(self._fused_chunk)

    # ------------------------------------------------------------------
    # Training
    # ------------------------------------------------------------------

    def _logger(self) -> MetricsLogger:
        return run_logger(self.config, self.log_dir)

    def _formation_steps(self, iterations: int) -> int:
        """The population's formation-steps in ``iterations``."""
        return (iterations * self.ppo.n_steps * self.config.num_formations
                * self.num_seeds)

    def _host_metrics(self, metrics: Dict[str, Tensor]) -> Dict[str, Any]:
        """One transfer of a host-loop iteration's ``(K,)`` metrics, and
        the drain's count of skipped updates."""
        names = sorted(metrics)
        values = tree_to_host(
            {"v": torch.stack([metrics[n] for n in names])}
        )["v"]
        host = self._gather_members(dict(zip(names, values)))
        self.skipped_updates += nonfinite_flag_count(host)
        return host

    def train(self) -> Dict[str, float]:
        """The full sweep: population records per iteration, member
        checkpoints and anchors every ``save_freq``, and at the end the
        final checkpoint and ``sweep_summary.json`` ranked on the final
        iteration's rewards. Returns the last record."""
        if self._fused_chunk:
            return self._train_fused()
        logger = self._logger()
        meter = Throughput()
        iteration = 0
        metrics = None
        try:
            while self.num_timesteps < self.total_timesteps:
                metrics = self.run_iteration()
                iteration += 1
                meter.tick(self._formation_steps(1))
                if iteration % self.config.log_interval == 0:
                    record = population_aggregate(
                        self._host_metrics(metrics), self.config.seed
                    )
                    record["env_steps_per_sec"] = meter.rate()
                    self.last_record = record
                    logger.log(record, self.num_timesteps)
                if (
                    self.config.checkpoint
                    and self._vec_steps_since_save >= self.config.save_freq
                ):
                    self.save()
            if metrics is not None:
                # Rank on the final iteration, whatever log_interval read.
                final = self._host_metrics(dict(metrics))
                self.last_record = population_aggregate(
                    final, self.config.seed
                )
                self.last_record["env_steps_per_sec"] = meter.rate()
                if self.config.checkpoint:
                    self.save()
                    self._write_summary(np.asarray(final["reward"]))
        finally:
            self.trace_window.close()
            logger.close()
        return self.last_record

    def _train_fused(self) -> Dict[str, float]:
        """Dispatch chunk N+1, then drain chunk N; checkpoint the
        population at chunk boundaries on a background writer from a
        device snapshot. Records are per iteration, as the host loop's."""
        logger = self._logger()
        meter = Throughput()
        writer = AsyncCheckpointWriter() if self.config.checkpoint else None
        final_rewards = None
        k = self._fused_chunk
        iteration = 0
        pending = None  # the chunk in flight, drained a dispatch later
        try:
            while self.num_timesteps < self.total_timesteps:
                steps_before = self.num_timesteps
                chunk = self.run_chunk()
                if pending is not None:
                    final_rewards = self._drain_chunk(logger, meter,
                                                      *pending)
                pending = (chunk, iteration, steps_before)
                iteration += k
                if (
                    writer is not None
                    and self._vec_steps_since_save >= self.config.save_freq
                ):
                    self.save_async(writer)
            if pending is not None:
                final_rewards = self._drain_chunk(logger, meter, *pending)
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

    def _drain_chunk(
        self, logger: MetricsLogger, meter: Throughput, chunk: ChunkMetrics,
        first_iteration: int, steps_before: int,
    ) -> np.ndarray:
        """One transfer for a chunk's ``(fused_chunk, K)`` metrics, the
        skip count, then a population record an iteration at the host
        loop's steps; returns the last iteration's member rewards."""
        # (fused_chunk, K) after the gather: members on the second axis.
        host = {k: v.T for k, v in self._gather_members(
            {k: np.ascontiguousarray(v.T)
             for k, v in chunk.to_host().items()}).items()}
        self.skipped_updates += nonfinite_flag_count(host)
        meter.tick(self._formation_steps(self._fused_chunk))
        per_iter = self.ppo.n_steps * self.num_envs
        for i in range(self._fused_chunk):
            if (first_iteration + i + 1) % self.config.log_interval:
                continue
            record = population_aggregate(
                {name: host[name][i] for name in sorted(host)},
                self.config.seed,
            )
            record["env_steps_per_sec"] = meter.rate()
            logger.log(record, steps_before + (i + 1) * per_iter)
            self.last_record = record
        return np.asarray(host["reward"][-1])

    def _write_summary(self, rewards: np.ndarray) -> None:
        if not is_coordinator():
            return
        extra = None
        if self._lrs_host is not None:
            extra = {"learning_rates": [float(r) for r in self._lrs_host]}
        write_sweep_summary(self.log_dir, self.config.seed, self.num_seeds,
                            rewards, extra)

    # ------------------------------------------------------------------
    # Checkpoints
    # ------------------------------------------------------------------

    def _checkpoint_state(self) -> Dict[str, Any]:
        """What a logical checkpoint holds, as device tensors and host
        values."""
        it = self._iteration
        state = {
            "params": {k: p.detach() for k, p in self.model.params.items()},
            "opt": {"count": self.opt_state.count,
                    "mu": dict(self.opt_state.mu),
                    "nu": dict(self.opt_state.nu)},
            "generators": torch.stack([g.get_state()
                                       for g in self.generators]),
            "env": {f: getattr(it.env, f) for f in ENV_FIELDS},
            "obs": it.obs,
            "step": it.step,
        }
        if self._lrs_host is not None:
            state["lr"] = it.lr
        return state

    def _members_rows(self, x: np.ndarray, i: int) -> np.ndarray:
        """Member ``i``'s formations of a folded ``(K*M, ...)`` array."""
        m = self.config.num_formations
        return np.array(x[i * m:(i + 1) * m])

    def member_state(
        self, i: int, host: Optional[Dict[str, Any]] = None,
        steps: Optional[int] = None,
    ) -> Dict[str, Any]:
        """Member ``i``'s checkpoint tree (the single-run layout) from a
        host copy of ``_checkpoint_state`` (taken now when None), at
        ``steps`` (the live count when None). A learning-rate sweep's
        member carries no optimizer state, as the JAX package's does."""
        if host is None:
            host = tree_to_host(self._checkpoint_state())
        lr = (self.ppo.learning_rate if self._lrs_host is None
              else self._lrs_host[i])
        state = {
            "policy": self.policy,
            "params": params_to_jax(member_slice(host["params"], i),
                                    self.policy),
            "num_timesteps": int(self.num_timesteps if steps is None
                                 else steps),
            "learning_rate": float(lr),
            "torch_generator": np.array(host["generators"][i]),
            "torch_env_state": {f: self._members_rows(v, i)
                                for f, v in host["env"].items()},
            "torch_obs": self._members_rows(host["obs"], i),
            "torch_step": int(host["step"][i]),
        }
        if self._lrs_host is None:
            state["opt_state"] = opt_state_to_jax(
                member_slice(host["opt"], i), self.policy
            )
        return state

    def _population_tree(
        self, host: Dict[str, Any], steps: Optional[int] = None
    ) -> Dict[str, Any]:
        """The resume anchor: the stacked learner in the JAX layout (with
        the members' rates in optax's ``inject_hyperparams`` layout for a
        learning-rate sweep), the identity fields resume checks, and the
        port's streams and env carry under ``torch_`` keys."""
        hyper = None
        if self._lrs_host is not None:
            hyper = inject_hyperparams(host["lr"], self.ppo.adam_eps)
        tree = {
            "policy": self.policy,
            "num_seeds": self.num_seeds,
            "seed": int(self.config.seed),
            "num_formations": int(self.config.num_formations),
            "num_timesteps": int(self.num_timesteps if steps is None
                                 else steps),
            "params": params_to_jax(host["params"], self.policy),
            "opt_state": opt_state_to_jax(host["opt"], self.policy, hyper),
            "torch_generators": host["generators"],
            "torch_env_state": dict(host["env"]),
            "torch_obs": host["obs"],
            "torch_step": np.asarray(host["step"], np.int64),
        }
        if self._lrs_host is not None:
            tree["learning_rates"] = np.asarray(host["lr"], np.float32)
        return tree

    def _member_dir(self, i: int) -> Path:
        return Path(self.log_dir) / f"seed{i}"

    def _population_host(self) -> Dict[str, Any]:
        """One host copy of the whole population's state (gathered from
        every rank on a mesh)."""
        return self._gather_members(tree_to_host(self._checkpoint_state()))

    def save(self) -> None:
        """Every member's checkpoint under ``seed{i}/`` and then the
        anchor, from one host copy of the state, written by the
        coordinator. A state the non-finite gate refuses is skipped with a
        notice."""
        host = self._population_host()
        if is_coordinator():
            for i in range(self.num_seeds):
                save_checkpoint(self._member_dir(i), self.num_timesteps,
                                self.member_state(i, host), barrier=False)
        # The anchor's barrier covers the member files too.
        save_sweep_state(self.log_dir, self.num_timesteps,
                         self._population_tree(host))
        self._vec_steps_since_save = 0

    def _write_population_files(self, snapshot: Any, steps: int) -> None:
        """One logical checkpoint from a device snapshot, on the writer's
        thread: the member files, then the anchor last, so that a crash
        mid-checkpoint never leaves an anchor whose members are
        missing."""
        host = snapshot.result() if hasattr(snapshot, "result") else snapshot
        for i in range(self.num_seeds):
            write_atomic(checkpoint_path(self._member_dir(i), steps),
                         self.member_state(i, host, steps))
        write_atomic(sweep_state_path(self.log_dir, steps),
                     self._population_tree(host, steps))

    def save_async(self, writer: AsyncCheckpointWriter) -> None:
        """A logical checkpoint that does not stall the dispatch loop: a
        device snapshot queued behind the chunk that produced the state,
        written by ``writer``'s thread. The same bytes as ``save``."""
        if self.mesh is not None and world_size() > 1:
            # The gather is a collective: on this thread, for every rank;
            # the coordinator's writer thread writes what it gathered.
            host = self._population_host()
            if is_coordinator():
                writer.submit_write(functools.partial(
                    self._write_population_files, host, self.num_timesteps))
        else:
            writer.submit_write(functools.partial(
                self._write_population_files,
                device_snapshot(self._checkpoint_state()),
                self.num_timesteps,
            ))
        self._vec_steps_since_save = 0

    def _identity(self) -> Dict[str, Any]:
        return {
            "policy": self.policy,
            "num_seeds": self.num_seeds,
            "seed": int(self.config.seed),
            # A changed M would corrupt the step accounting silently.
            "num_formations": int(self.config.num_formations),
        }

    def _try_resume(self) -> None:
        """Restore the newest anchor in ``log_dir``: the learner (with the
        members' rates of a learning-rate sweep) and ``num_timesteps``;
        the generators, env carry, observation and steps from the port's
        ``torch_`` keys, which an anchor the JAX package wrote lacks (its
        streams then start afresh, as a single run's do from a JAX
        file). On a mesh of several processes the coordinator reads and
        checks the anchor, every rank receives it (an error too, raised
        everywhere) and takes its member block."""
        found = from_coordinator(self._read_anchor)
        if found is None:
            return
        path, raw = found
        self._load_learner(self._member_rows_of(raw), path)
        stored_lrs = raw.get("learning_rates")
        if stored_lrs is not None:
            self._adopt_lrs(np.asarray(stored_lrs, np.float32))
        self.num_timesteps = int(raw["num_timesteps"])
        it = self._iteration
        if "torch_generators" in raw:
            raw = self._member_rows_of(raw, ("torch_generators",
                                             "torch_env_state", "torch_obs",
                                             "torch_step"))
            with torch.no_grad():
                for g, state in zip(self.generators,
                                    np.array(raw["torch_generators"])):
                    g.set_state(torch.from_numpy(state))
                env = raw["torch_env_state"]
                for f in ENV_FIELDS:
                    getattr(it.env, f).copy_(
                        torch.from_numpy(np.array(env[f]))
                    )
                it.obs.copy_(torch.from_numpy(np.array(raw["torch_obs"])))
                it.step.copy_(torch.from_numpy(np.array(raw["torch_step"])))
        print(f"[sweep] resumed {self.num_seeds}-member population from "
              f"{path} at {self.num_timesteps} steps")

    def _read_anchor(self) -> Optional[Tuple[Path, Dict[str, Any]]]:
        """The newest anchor and its checked contents, or None."""
        path = latest_sweep_state(self.log_dir)
        if path is None:
            if latest_checkpoint(self._member_dir(0)) is not None:
                print(
                    "[sweep] resume=true but no sweep_state_* population "
                    f"checkpoint under {self.log_dir}; starting fresh — "
                    "resume individual members via their seed{i}/ dirs "
                    "instead"
                )
            return None
        raw = msgpack_restore_file(path)
        for field, want in self._identity().items():
            got = raw.get(field)
            if got != want and str(got) != str(want):
                raise SystemExit(
                    f"sweep resume mismatch: checkpoint {path} was written "
                    f"with {field}={got!r} but this run uses {want!r} — "
                    "member identities would silently change"
                )
        stored_lrs = raw.get("learning_rates")
        if (stored_lrs is None) != (self._lrs_host is None):
            raise SystemExit(
                f"sweep resume mismatch: checkpoint {path} was written "
                f"{'with' if stored_lrs is not None else 'without'} "
                "learning_rates but this run is the opposite — the "
                "optimizer state trees are incompatible; pass the same "
                "learning_rates the sweep was started with"
            )
        for name in ("params", "opt_state", "num_timesteps"):
            if name not in raw:
                raise SystemExit(
                    f"sweep resume: checkpoint {path} is missing {name!r} "
                    "— truncated or foreign file"
                )
        return path, raw

    def _member_rows_of(self, raw: Dict[str, Any],
                        keys: Sequence[str] = ("params", "opt_state")
                        ) -> Dict[str, Any]:
        """``raw`` with the ``keys`` cut to this rank's member block: the
        leading axis of a member-stacked leaf, the block's formations of a
        folded ``(K*M, ...)`` one (the whole anchor without a mesh)."""
        if self.mesh is None:
            return raw
        k, m = self.num_seeds, self.config.num_formations
        lo, hi = self.members.start, self.members.stop

        def cut(x: Any) -> Any:
            if isinstance(x, dict):
                return {n: cut(v) for n, v in x.items()}
            arr = np.asarray(x) if isinstance(x, np.ndarray) else x
            if isinstance(arr, np.ndarray) and arr.ndim:
                if arr.shape[0] == k:
                    return arr[lo:hi]
                if arr.shape[0] == k * m:
                    return arr[lo * m:hi * m]
            return x

        return {n: cut(v) if n in keys else v for n, v in raw.items()}

    def _load_learner(self, raw: Dict[str, Any], origin: Any) -> None:
        """Copy the stacked parameters and Adam state (and the injected
        rates) of an anchor into the carry."""
        params = params_from_jax(raw["params"], self.policy)
        opt = opt_state_from_jax(raw["opt_state"], self.policy)
        for k, p in self.model.params.items():
            for what, t in (("params", params.get(k)),
                            ("Adam mu", opt["mu"].get(k)),
                            ("Adam nu", opt["nu"].get(k))):
                if t is None or tuple(t.shape) != tuple(p.shape):
                    raise SystemExit(
                        f"sweep resume: checkpoint {origin} {what} of {k} "
                        f"has shape {None if t is None else tuple(t.shape)}"
                        f", the population {tuple(p.shape)}"
                    )
        with torch.no_grad():
            for k, p in self.model.params.items():
                p.copy_(params[k])
                self.opt_state.mu[k].copy_(opt["mu"][k])
                self.opt_state.nu[k].copy_(opt["nu"][k])
            self.opt_state.count.copy_(opt["count"])
            if "learning_rate" in opt:
                self._iteration.lr.copy_(opt["learning_rate"])

    def _adopt_lrs(self, stored: np.ndarray) -> None:
        """The rates live in the restored optimizer state: continue at the
        checkpoint's, and say so when they differ from this run's."""
        if not np.allclose(stored, self._lrs_host, rtol=1e-6):
            print(
                "[sweep] WARNING: checkpoint member learning rates "
                f"{stored.tolist()} differ from this run's "
                f"{self._lrs_host.tolist()} — continuing at the "
                "CHECKPOINT's rates (they live in the restored optimizer "
                "state)"
            )
        self._lrs_host = stored


def population_aggregate(
    host: Dict[str, np.ndarray], seed0: int
) -> Dict[str, float]:
    """One population record from per-member metrics ``{name: (K,)}``:
    each metric's mean over the members under its own name, and the
    spread, ``reward_best``, ``reward_worst`` and ``best_seed``."""
    rewards = np.asarray(host["reward"])
    record = {k: float(np.mean(v)) for k, v in host.items()}
    record["reward_best"] = float(rewards.max())
    record["reward_worst"] = float(rewards.min())
    record["best_seed"] = int(seed0 + rewards.argmax())
    return record


def write_sweep_summary(
    log_dir: Any,
    seed0: int,
    num_seeds: int,
    rewards: np.ndarray,
    extra: Optional[Dict[str, Any]] = None,
) -> None:
    """``sweep_summary.json``: the members' seeds, final rewards, the best
    seed and its directory (and ``extra``, such as the learning rates)."""
    summary = {
        "seeds": [int(seed0 + i) for i in range(num_seeds)],
        "final_reward": [float(r) for r in rewards],
        "best_seed": int(seed0 + rewards.argmax()),
        "best_dir": f"seed{int(rewards.argmax())}",
    }
    if extra:
        summary.update(extra)
    path = Path(log_dir) / "sweep_summary.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(summary, indent=2))
