"""PPO trainer: rollout, GAE and the minibatch epochs, dispatched as CUDA
graphs, with metrics drained a dispatch late and checkpoints written off
the hot path.

Counterpart of the single-run path of the JAX package's ``train/trainer.py``
(``TrainConfig``, ``make_ppo_iteration``, ``make_fused_chunk`` and
``Trainer``). The JAX package compiles an iteration, or ``fused_chunk``
iterations, into one program. Here an iteration is three phases over a
static carry (``train/iteration.py``), each captured once as a CUDA graph
and replayed (``train/capture.py``); a dispatch replays them for one,
``iters_per_dispatch`` or ``fused_chunk`` iterations without reading the
device. The host reads the metrics once a dispatch, one batched transfer of
the rows the dispatch wrote; with ``fused_chunk`` it does so after the next
chunk is queued, so the device computes while the host logs, and
checkpoints go to a background writer from a device-side snapshot. On the
CPU, and on the card with ``capture=False`` (tests compare the two), the
same phases run eagerly.

Timestep accounting matches SB3: ``num_timesteps`` counts agent-transitions
(``n_steps * M * N`` an iteration) and the default budget is ``5000 * M``
(reference vectorized_env.py:116,134). ``env_steps_per_sec`` counts
formation-steps (``n_steps * M`` an iteration), as the JAX trainer does.

Randomness: the model is initialised from a CPU generator seeded with
``seed``; resets, action noise and minibatch permutations draw, in that
order, from one generator on the training device seeded with ``seed +
2**32``. Its state is checkpointed, so a resume continues the stream.
Populations are ``train/sweep.py``'s, the curriculum over padded
formations ``train/curriculum.py``'s.

Scenario training (``scenario_schedule``, ``scenarios/schedule.py``) follows
the JAX trainer: every dispatch draws a fresh scenario per formation from
the schedule's current stage at its severity (one draw an iteration, so a
``fused_chunk`` chunk trains each iteration at its own schedule point and
a stage change lands inside the chunk where the host loop puts it), and
writes it into the iteration's ``(M,)`` scenario buffers between graph
replays. The draw ``d`` comes from a CPU generator seeded from a hash of
(``seed``, ``d``), so the mixes are a pure function of the draw counter,
which never rewinds (a resume re-enters at ``num_timesteps // (n_steps *
M * N)``; a rollback or a schedule swap draws fresh mixes). The layers
draw from their own device generator (``seed + 2**33``), registered with
the graphs and checkpointed beside the run's.

Observability, as the JAX trainer's, at host seams only: the dispatch
loop and the drain record into the metrics registry
(``train_iterations_total``, ``train_env_steps_per_sec``,
``train_steps_per_sec``, ``train_compiles``, ``train_chunk_drain_seconds``,
``train_chunks_total``), each phase graph registers in the program ledger
at its build (subsystem ``trainer``), the device-memory watermark is
sampled at the drain, and ``profile=true`` traces ``profile_iterations``
dispatches (``utils/profiling.py::TraceWindow``). ``architecture=sebulba``
is ``train/sebulba/``.

``shard_fn`` (``parallel.make_shard_fn``) trains one rank of a mesh, as the
JAX trainer's ``shard_fn`` places its state: the iteration is
``train/iteration.py``'s ``DataParallelIteration`` over this rank's block
(``parallel/``), the parameters are rank 0's, and across processes every
rank builds only its own block (``parallel.reset_batch_sharded``), the
coordinator alone writes checkpoints, which then hold the learner and the
streams but not the env block (a resume is broadcast and the env stays
freshly reset, as the JAX package's multi-host resume). An 'sp' mesh runs
the phases eagerly: the ring step's collectives sit between its env
steps. Non-formation envs, and scenarios with 'sp', with k-NN on a mesh
or across processes, are refused in the JAX trainer's words.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import struct
import sys
import threading
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from marl_distributedformation_tpu_torch.algo import PPOConfig, adam_init
from marl_distributedformation_tpu_torch.analysis.guards import (
    RetraceGuard,
    ledgered_call,
    nan_guard,
    no_host_transfers,
    sample_device_watermark,
)
from marl_distributedformation_tpu_torch.chaos.plane import (
    InjectedFault,
    fault_point,
)
from marl_distributedformation_tpu_torch.compat.convert import (
    inject_hyperparams,
    opt_state_from_jax,
    opt_state_to_jax,
    params_from_jax,
    params_to_jax,
)
from marl_distributedformation_tpu_torch.device import DeviceLike, resolve_device
from marl_distributedformation_tpu_torch.env.types import (
    EnvParams,
    FormationState,
)
from marl_distributedformation_tpu_torch.envs import spec_for_params
from marl_distributedformation_tpu_torch.obs.metrics import get_registry
from marl_distributedformation_tpu_torch.scenarios import (
    ScenarioParams,
    ScenarioStreams,
    broadcast_params,
    get_scenario,
    init_scenario_state,
    sample_scenario_batch,
)
from marl_distributedformation_tpu_torch.scenarios.params import (
    stack_params,
)
from marl_distributedformation_tpu_torch.train.capture import (
    PhaseGraph,
    own_stream,
)
from marl_distributedformation_tpu_torch.parallel.distributed import (
    is_coordinator,
    reset_batch_sharded,
    world_size,
)
from marl_distributedformation_tpu_torch.parallel.mesh import (
    Placement,
    replicate,
)
from marl_distributedformation_tpu_torch.train.iteration import (
    ENV_FIELDS,
    DataParallelIteration,
    PhasedIteration,
)
from marl_distributedformation_tpu_torch.train.recovery import (
    RecoveryConfig,
    RecoveryLadder,
    fold_recovery_generator,
    record_health_flags,
    scale_injected_lr,
    wrap_health,
)
from marl_distributedformation_tpu_torch.utils.checkpoint import (
    AsyncCheckpointWriter,
    broadcast_restore,
    checkpoint_path,
    device_snapshot,
    nonfinite_leaf,
    prune_checkpoints,
    quarantine_checkpoint,
    restore_latest_partial,
    save_checkpoint,
    tree_to_host,
)
from marl_distributedformation_tpu_torch.utils.config import repo_root
from marl_distributedformation_tpu_torch.utils.logging import (
    MetricsLogger,
    Throughput,
    run_logger,
)
from marl_distributedformation_tpu_torch.utils.profiling import TraceWindow

Tensor = torch.Tensor

# The run generator is seeded apart from the init generator, the scenario
# layers' generator apart from both.
RUN_SEED_OFFSET = 1 << 32
SCENARIO_SEED_OFFSET = 2 << 32
# Tag of the scenario mixes' stream (the JAX trainer folds its sampling
# key with it).
SCENARIO_SAMPLE_TAG = 0x5CE7
RESUME_KEYS = (
    "policy", "params", "opt_state", "num_timesteps", "learning_rate",
    "torch_generator", "torch_env_state", "torch_obs", "torch_step",
    "torch_scenario_generator",
)


def scenario_sample_generator(seed: int, draw: int) -> torch.Generator:
    """The CPU generator of the scenario mix of draw ``draw``: seeded from
    a hash of (``seed``, the tag, ``draw``), so each draw's mix is a pure
    function of the two."""
    digest = hashlib.blake2b(
        struct.pack("<qqq", int(seed), SCENARIO_SAMPLE_TAG, int(draw)),
        digest_size=8,
    ).digest()
    return torch.Generator().manual_seed(
        int.from_bytes(digest, "little") >> 1
    )


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Run-level configuration of the single-run trainer; fields and
    defaults as the JAX package's."""

    num_formations: int = 1000  # cfg/config.yaml:3
    total_timesteps: Optional[int] = None  # default 5000 * M
    seed: int = 0
    save_freq: int = 10  # vec-steps between checkpoints
    checkpoint: bool = True
    name: str = "default"
    log_dir: Optional[str] = None  # default <repo>/logs/{name}
    use_wandb: bool = False
    use_tensorboard: bool = False
    resume: bool = False
    log_interval: int = 1  # rollouts between metric records
    iters_per_dispatch: int = 1  # iterations a dispatch of the host loop;
    #   metrics are the burst's mean (episode_dones: sum, health_*: min)
    fused_chunk: int = 0  # > 0: dispatch chunks of this many iterations,
    #   drain their per-iteration metrics one chunk late, checkpoint at
    #   chunk boundaries on a background writer; excludes iters_per_dispatch
    health: bool = False  # the health word and skip-update guard
    health_grad_norm_max: float = 1.0e6  # raw global grad-norm bound
    health_param_drift_max: float = 10.0  # |p_new| <= this * (|p_old|+1)
    recovery: bool = False  # the escalation ladder (needs health)
    recovery_breach_iters: int = 3  # skipped iterations in a row = breach
    recovery_max_rollbacks: int = 3  # retries before a halt
    recovery_lr_backoff: float = 1.0  # learning-rate factor a rollback
    #   (!= 1 checkpoints optax's inject_hyperparams layout)
    recovery_severity_backoff: float = 1.0  # scenario severity factor a
    #   rollback
    keep_last_n: int = 0  # keep the newest N checkpoints (0 = all)
    profile: bool = False  # trace profile_iterations post-warm-up
    #   dispatches with torch.profiler into {log_dir}/profile/
    profile_iterations: int = 3  # dispatches to trace (chunks when fused)
    architecture: str = "anakin"  # "anakin" | "sebulba" (train/sebulba/:
    #   an actor lane and a learner lane joined by a bounded transfer
    #   queue and a latest-wins parameter bus; fused_chunk is K, the
    #   batches the learner drains a chunk)
    actor_devices: int = 1  # sebulba: CUDA devices of the actor slice
    transfer_queue_depth: int = 2  # sebulba: trajectories in flight
    max_param_staleness: int = 2  # sebulba: drop a batch acted with
    #   parameters more than this many learner updates old
    # Runtime guards (analysis/guards.py), the JAX trainer's knobs.
    guard_retraces: int = 0  # > 0: fail the run when the iteration is
    #   built more often than this (1: the steady-state contract)
    guard_transfers: bool = False  # the CUDA sync debug mode ("error")
    #   around every post-warm-up dispatch: a host sync inside raises
    guard_nans: bool = False  # a dispatch whose outputs hold a NaN is
    #   re-run eagerly from its starting state under nan_guard, which
    #   raises FloatingPointError naming the first op that made one


def default_total_timesteps(config: TrainConfig) -> int:
    """``total_timesteps``, else ``5000 * M`` agent-transitions."""
    if config.total_timesteps is not None:
        return config.total_timesteps
    return 5000 * config.num_formations


def fill_ent_schedule(
    ppo: PPOConfig,
    env_params: EnvParams,
    config: TrainConfig,
    iterations: Optional[int] = None,
) -> PPOConfig:
    """Fill ``ppo.total_iterations``, the schedules' horizon, from the run's
    planned iteration count; a no-op without a schedule or when set."""
    if (
        ppo.ent_coef_final is None and ppo.log_std_final is None
    ) or ppo.total_iterations > 0:
        return ppo
    if iterations is None:
        per_iter = config.num_formations * env_params.num_agents * ppo.n_steps
        iterations = -(-default_total_timesteps(config) // per_iter)
    return dataclasses.replace(ppo, total_iterations=max(1, int(iterations)))


Iteration = Callable[..., Tuple[int, FormationState, Tensor, Dict[str, Any]]]


def make_ppo_iteration(
    env_params: EnvParams,
    ppo: PPOConfig,
    per_formation: bool = False,
    env_step_fn: Any = None,
) -> Iteration:
    """One training iteration as a function, run eagerly: ``(model,
    opt_state, step, env_state, obs, generator, noise=None,
    permutations=None, mark=None) -> (step, env_state, last_obs,
    metrics)``; updates ``model`` and ``opt_state`` in place.

    A ``PhasedIteration`` for one call (the trainer keeps one for the run).
    ``noise``, ``permutations`` and ``env_step_fn`` let tests inject the
    JAX package's draws; ``mark(phase)`` is called at "rollout", "update"
    and "end".
    """

    def iteration(model, opt_state, step, env_state, obs, generator,
                  noise=None, permutations=None, mark=None):
        if bool(model.per_formation) != per_formation:
            raise ValueError(
                f"per_formation={per_formation} but the model's is "
                f"{model.per_formation}"
            )
        it = PhasedIteration(
            env_params, ppo, model, opt_state, generator, env_state, obs,
            step=int(step), env_step_fn=env_step_fn,
        )
        it.run(noise, permutations, mark)
        return int(it.step), it.env, it.obs, it.metrics(it.ring.take(1)[0])

    return iteration


def reduce_burst(names: Tuple[str, ...], rows: Tensor) -> Tensor:
    """One metrics row from the rows of a burst of iterations, as the JAX
    package's ``make_fused_chunk(reduce_metrics=True)``: ``episode_dones``
    sums, the ``health_*`` flags take the minimum (one skip marks the
    burst), the rest the mean."""
    sums, mins, means = rows.sum(0), rows.min(0).values, rows.mean(0)
    return torch.stack([
        sums[j] if n == "episode_dones"
        else mins[j] if n.startswith("health_") else means[j]
        for j, n in enumerate(names)
    ])


def _copy_into(dst: Any, src: Any) -> None:
    """Copy the tensors of ``src`` into those of ``dst``, two trees of
    dicts of one layout."""
    if isinstance(dst, dict):
        for k, v in dst.items():
            _copy_into(v, src[k])
    elif isinstance(dst, torch.Tensor):
        dst.copy_(src)


def metrics_to_host(metrics: Dict[str, Any]) -> Dict[str, float]:
    """Floats of an iteration's metrics, sorted by name, with one
    device-to-host transfer for all the tensors."""
    names = [k for k, v in metrics.items() if isinstance(v, Tensor)]
    out = {k: float(v) for k, v in metrics.items() if k not in names}
    if names:
        values = torch.stack([metrics[k].to(torch.float32) for k in names])
        out.update(zip(names, values.tolist()))
    return dict(sorted(out.items()))


@dataclasses.dataclass
class ChunkMetrics:
    """The metric rows a dispatch wrote, still on the device, and the event
    that closes the dispatch (CUDA)."""

    names: Tuple[str, ...]
    rows: Tensor  # (iterations, [K,] len(names))
    ready: Optional[Any]
    severities: Optional[List[float]] = None  # scenario severity an
    #   iteration, as trained

    def to_host(self) -> Dict[str, np.ndarray]:
        """``{name: (iterations,) float32}`` (``(iterations, K)`` for a
        population), in one transfer that waits for this dispatch only."""
        host = tree_to_host({"rows": self.rows}, self.ready)["rows"]
        return {n: host[..., j] for j, n in enumerate(self.names)}


class Trainer:
    """The single-run training loop of ``model``: dispatches, metrics,
    checkpoints, resume, the health word and the recovery ladder.

    On CUDA the iteration's phases run as captured graphs; ``capture=False``
    runs them eagerly (tests and ``chip_smoke.py`` compare the two; there
    is no config key for it). ``scenario_schedule`` trains under the
    schedule's disturbance scenarios (see the module docstring).
    """

    resume_keys = RESUME_KEYS  # what a resume reads from a checkpoint

    def __init__(
        self,
        env_params: EnvParams,
        ppo: PPOConfig = PPOConfig(),
        config: TrainConfig = TrainConfig(),
        *,
        model: torch.nn.Module,
        device: DeviceLike = None,
        capture: bool = True,
        scenario_schedule: Any = None,
        shard_fn: Any = None,
    ) -> None:
        self.device = resolve_device(device)
        ppo = fill_ent_schedule(ppo, env_params, config)
        self._shard_fn = shard_fn
        self.mesh = getattr(shard_fn, "mesh", None)
        self._multihost = world_size() > 1
        self.env_params = env_params
        # The env is resolved from the params type, as eval and the
        # scenario engine resolve it.
        self.env_spec = spec_for_params(env_params)
        self.ppo = ppo
        self.config = config
        self.num_envs = config.num_formations * env_params.num_agents
        self.model = model.to(self.device)
        self.policy = type(model).__name__
        self.per_formation = model.per_formation

        self._iters_per_dispatch = max(1, int(config.iters_per_dispatch))
        self._fused_chunk = max(0, int(config.fused_chunk))
        if self._fused_chunk and self._iters_per_dispatch > 1:
            raise SystemExit(
                "fused_chunk and iters_per_dispatch are two spellings of "
                "dispatch fusion; set exactly one (fused_chunk: stacked "
                "per-iteration metrics drained a chunk late, background "
                "checkpoints; iters_per_dispatch: the host loop's burst)"
            )
        if config.recovery and not config.health:
            raise SystemExit(
                "recovery=true needs health=true: the escalation ladder "
                "reads the health flags at the drain; without them it is "
                "blind"
            )

        self._check_mesh(scenario_schedule)
        self.generator = torch.Generator(device=self.device).manual_seed(
            config.seed + RUN_SEED_OFFSET
        )
        generators = [self.generator]
        env_state, obs = self._initial_env()
        if self.mesh is not None:
            replicate(dict(self.model.named_parameters()), self.mesh)
        scenario = self._init_scenarios(scenario_schedule)
        if scenario:
            env_state = init_scenario_state(
                env_state, env_params, scenario["scenario_streams"])
            generators.append(self.scenario_generator)
        self.opt_state = adam_init(dict(self.model.named_parameters()))
        iteration_cls, mesh_options = PhasedIteration, {}
        if self.mesh is not None:
            iteration_cls = DataParallelIteration
            mesh_options = {"mesh": self.mesh, **self._mesh_options()}
        self._iteration = wrap_health(iteration_cls(
            env_params, ppo, self.model, self.opt_state, self.generator,
            env_state, obs,
            ring_rows=2 * max(self._fused_chunk, self._iters_per_dispatch),
            **self._iteration_options(), **scenario, **mesh_options,
        ), config)
        # The ring step's collectives run inside the rollout, between its
        # env steps: an 'sp' mesh runs its phases eagerly.
        self.capture = (capture and self.device.type == "cuda"
                        and (self.mesh is None
                             or self.mesh.axis_size("sp") == 1))
        it = self._iteration
        # The phases capture and replay on the trainer's own stream
        # (train/capture.py: C6).
        self.capture_stream = own_stream(self, self.device)
        self._phases = tuple(
            PhaseGraph(name, fn, generators, self.capture,
                       subsystem="trainer", program=f"train_{name}",
                       stream=self.capture_stream)
            for name, fn in it.phase_fns()
        )
        # The iteration's build receipt: one a run, at the dispatch that
        # captures the phases (the CPU: runs them first); JAX counts the
        # traces of its iteration program.
        self.retrace_guard = RetraceGuard(
            "train_iteration", max_traces=config.guard_retraces or None)
        # guard_transfers waits for the checkpoint write in flight before a
        # guarded dispatch: the sync debug mode is the process's.
        self._guarded_writer: Optional[AsyncCheckpointWriter] = None
        # optax's inject_hyperparams layout in checkpoints (JAX: inject_lr).
        self.injected_lr = config.recovery_lr_backoff != 1.0

        self.num_timesteps = 0
        self._vec_steps_since_save = 0
        self.log_dir = config.log_dir or str(
            repo_root() / "logs" / config.name
        )
        # profile=true: profile_iterations dispatches after the first two
        # (which warm up and capture the graphs); _dispatch drives it.
        self.trace_window = TraceWindow(self.log_dir, config.profile,
                                        config.profile_iterations, skip=2)
        self.last_record: Dict[str, float] = {}
        # Called with "rollout", "update" and "end" at each iteration's
        # phase boundaries (chip_smoke.py records CUDA events there).
        self.phase_hook: Optional[Callable[[str], None]] = None
        self.halted = False
        self.recovery_ladder: Optional[RecoveryLadder] = None
        self._recovery_verdict: Optional[str] = None
        self._last_good_ckpt: Optional[Path] = None
        # The checkpoint-durability hook (the always-learning pipeline sets
        # it to nudge its CheckpointStream): called with the path AFTER the
        # atomic rename lands; for an async write that is on the writer
        # thread, when the file is discoverable, not at submit time.
        self.on_checkpoint: Optional[Callable[[Any], None]] = None
        self._rollback_anchor: Optional[Dict[str, Any]] = None
        if config.recovery:
            self.recovery_ladder = RecoveryLadder(
                RecoveryConfig(
                    breach_iters=config.recovery_breach_iters,
                    max_rollbacks=config.recovery_max_rollbacks,
                    lr_backoff=config.recovery_lr_backoff,
                    severity_backoff=config.recovery_severity_backoff,
                ),
                self.log_dir,
            )
        if config.resume:
            self._try_resume()
        if self.recovery_ladder is not None:
            # The last-resort rollback target: the run's starting state.
            self._rollback_anchor = self._host_tree()

    # ------------------------------------------------------------------
    # The carry
    # ------------------------------------------------------------------

    def _initial_env(self) -> Tuple[FormationState, Tensor]:
        """The env carry the run starts from: a reset of the run's env drawn
        from the run's generator, and its observation. On a mesh, this
        rank's block of it (``_place``)."""
        spec = self.env_spec
        if self._multihost:
            # Every rank builds its own formation block only, from the
            # whole batch's draws (parallel.reset_batch_sharded).
            block = reset_batch_sharded(
                self.generator, self.env_params, self.config.num_formations,
                self.mesh, self.device).tree
            return self._slab(block, spec.obs(block, self.env_params))
        state = spec.reset_batch(self.env_params, self.config.num_formations,
                                 self.generator, self.device)
        obs = spec.obs(state, self.env_params)
        if self._shard_fn is not None:
            _, state, obs = self._shard_fn({}, state, obs)
        return state, obs

    def _slab(self, block: Any, obs: Tensor) -> Tuple[Any, Tensor]:
        """This rank's agent slab of its formation block and its
        observation (the block itself without 'sp')."""
        if self.mesh.axis_size("sp") == 1:
            return block, obs
        slab = Placement(self.mesh, (None, "sp"))
        return (dataclasses.replace(block, agents=slab.place(block.agents)),
                slab.place(obs))

    def _iteration_options(self) -> Dict[str, Any]:
        """Further arguments of the run's ``PhasedIteration``."""
        return {}

    def _mesh_options(self) -> Dict[str, Any]:
        """Further arguments of the run's ``DataParallelIteration``."""
        return {}

    def _check_mesh(self, scenario_schedule: Any) -> None:
        """The JAX trainer's refusals of what does not compose with a mesh
        or with more than one process."""
        mesh = self.mesh
        if self._multihost and mesh is None:
            raise SystemExit(
                "multi-host training needs a mesh (cfg.mesh / make_shard_fn)")
        if mesh is None:
            return
        if self.env_spec.name != "formation":
            raise SystemExit(
                f"env {self.env_spec.name!r} does not compose with mesh "
                "sharding / multi-host yet (the sharded env steps in "
                "parallel/ are formation-specialized); drop the mesh or "
                "use env=formation"
            )
        # A mesh that names 'sp' steps through the ring step, at size 1 too
        # (the JAX trainer's test).
        sp = "sp" in mesh.shape
        if scenario_schedule is not None:
            if sp or self.env_params.obs_mode == "knn":
                blocker = (
                    "the agent-axis ('sp') sharded ring step — drop 'sp' "
                    "from the mesh"
                    if sp
                    else "the shard_map knn env step a dp mesh uses for "
                    "obs_mode=knn — use obs_mode=ring on this mesh, or "
                    "drop the mesh"
                )
                raise SystemExit(
                    f"scenario training does not compose with {blocker}; "
                    "scenarios currently wrap only the plain vmapped step"
                )
            if self._multihost:
                raise SystemExit(
                    "scenario training is single-host for now (per-host "
                    "scenario-param construction is not wired); drop "
                    "scenarios or run single-process"
                )

    # ------------------------------------------------------------------
    # Scenario training
    # ------------------------------------------------------------------

    def _init_scenarios(self, schedule: Any) -> Dict[str, Any]:
        """The scenario state of the run: the schedule, its specs, the
        counters, the layers' generator and the iteration's scenario
        buffers (all formations clean until the first dispatch writes
        them); ``{}`` without a schedule."""
        self._scenario_schedule = schedule
        self.scenario_severity = 0.0
        # Recovery severity backoff: the factor on every sampled severity.
        self._severity_scale = 1.0
        # A schedule handed over by another thread, applied at the next
        # dispatch (request_scenario_schedule).
        self._pending_schedule: Any = None
        self._schedule_lock = threading.Lock()
        # The schedule position, and the draw counter that never rewinds.
        self._scenario_rollouts = 0
        self._scenario_draws = 0
        if schedule is None:
            return {}
        self._scenario_specs = tuple(get_scenario(n) for n in schedule.names)
        self._build_scenario_samplers()
        self.scenario_severity = float(schedule.severity_at(0))
        self.scenario_generator = torch.Generator(
            device=self.device).manual_seed(
                self.config.seed + SCENARIO_SEED_OFFSET)
        sp = broadcast_params(ScenarioParams.zeros(),
                              self.config.num_formations, self.device)
        return {"scenario_params": sp,
                "scenario_streams": ScenarioStreams(self.scenario_generator)}

    @property
    def scenario_params(self) -> Optional[ScenarioParams]:
        """The iteration's scenario buffers, as the last dispatch's last
        iteration trained (None without scenarios)."""
        return self._iteration.scenario_params

    def update_scenario_schedule(self, schedule: Any) -> None:
        """Swap the schedule mid-run, between dispatches: the new schedule
        starts at its own rollout 0; the draw counter runs on, so no mix of
        the run is drawn twice. Only values change, so the captured graphs
        stay. Other threads use ``request_scenario_schedule``."""
        if self._scenario_schedule is None:
            raise ValueError(
                "this trainer was built without scenario training — its "
                "captured iteration reads no scenario buffers, so a "
                "schedule cannot be installed mid-run (construct the "
                "trainer with scenarios=['clean'] to reserve them, then "
                "update freely)"
            )
        self._scenario_specs = tuple(get_scenario(n) for n in schedule.names)
        self._build_scenario_samplers()
        self._scenario_schedule = schedule
        self._scenario_rollouts = 0
        self.scenario_severity = self._severity(0)

    def request_scenario_schedule(self, schedule: Any) -> None:
        """Hand a schedule over from another thread: it is applied at the
        next dispatch. Unknown names raise here, in the caller."""
        if self._scenario_schedule is None:
            raise ValueError(
                "this trainer was built without scenario training — "
                "construct it with scenarios=['clean'] to reserve the "
                "scenario buffers for curriculum feedback"
            )
        for name in schedule.names:
            get_scenario(name)
        with self._schedule_lock:
            self._pending_schedule = schedule

    def _apply_pending_schedule(self) -> None:
        if self._pending_schedule is None:
            return
        with self._schedule_lock:
            pending, self._pending_schedule = self._pending_schedule, None
        if pending is not None:
            self.update_scenario_schedule(pending)

    def _severity(self, rollout: int) -> float:
        """The schedule's severity at ``rollout`` times the backoff."""
        severity = self._scenario_schedule.severity_at(rollout)
        if self._severity_scale != 1.0:
            severity = severity * self._severity_scale
        return severity

    def _build_scenario_samplers(self) -> None:
        """The two host samplers over the schedule's current specs, each a
        program of the ledger (subsystem ``scenarios``) built at its first
        call, as the JAX trainer's two jitted samplers are; a schedule swap
        rebuilds them."""
        if not hasattr(self, "_sampler_guard"):
            self._sampler_guard = RetraceGuard("scenario_sampler")
        self._sample_scenarios = ledgered_call(
            self._draw_rows, self._sampler_guard, subsystem="scenarios",
            program="scenario_sampler")
        self._sample_scenario_chunk = ledgered_call(
            self._draw_rows, self._sampler_guard, subsystem="scenarios",
            program="scenario_sampler_chunk")

    def _draw_rows(self, severities: List[float], probs: Any,
                   draw: int) -> ScenarioParams:
        """One mix an entry of ``severities``, stacked: row i drawn with
        draw ``draw + i``'s generator at ``probs[i]``."""
        return stack_params([
            sample_scenario_batch(
                scenario_sample_generator(self.config.seed, draw + i),
                np.float32(severity), probs[i], self._scenario_specs,
                self.config.num_formations,
            )
            for i, severity in enumerate(severities)
        ])

    def _chunked_draws(self, k: int) -> bool:
        """Whether a dispatch of ``k`` iterations draws its mixes as a chunk
        (a ``fused_chunk`` chunk, or a burst of more than one)."""
        return k > 1 or bool(self._fused_chunk)

    def _scenario_rows(
        self, rollout: int, draw: int, k: int
    ) -> Tuple[ScenarioParams, List[float]]:
        """The mixes of the next ``k`` iterations, ``(k, M)``-leading on
        the CPU, and their severities: iteration i at the schedule's
        rollout ``rollout + i`` (its severity and stage probabilities), drawn
        with draw ``draw + i``'s generator. A single dispatch of one
        iteration takes ``severity_at`` (scaled in float64), a chunk
        ``severity_chunk`` (scaled per row), as the JAX trainer's two
        samplers do."""
        schedule = self._scenario_schedule
        if not self._chunked_draws(k):
            severities = [self._severity(rollout)]
            probs = schedule.probs_at(rollout)[None]
            return self._sample_scenarios(severities, probs, draw), severities
        severities = list(schedule.severity_chunk(rollout, k))
        if self._severity_scale != 1.0:
            severities = [s * self._severity_scale for s in severities]
        probs = schedule.probs_chunk(rollout, k)
        return self._sample_scenario_chunk(severities, probs, draw), \
            severities

    def _load_scenario_rows(self, k: int) -> Tuple[Any, List[float]]:
        """The next ``k`` iterations' mixes on the device, and their
        severities; the counters move on."""
        rows, severities = self._scenario_rows(
            self._scenario_rollouts, self._scenario_draws, k)
        if self.device.type == "cuda":
            # Pinned, so the copy queues behind the dispatch in flight
            # instead of waiting for it.
            rows = rows.map(lambda t: t.pin_memory())
        rows = rows.map(lambda t: t.to(self.device, non_blocking=True))
        self._scenario_rollouts += k
        self._scenario_draws += k
        self.scenario_severity = self._severity(self._scenario_rollouts)
        return rows, severities

    @property
    def total_timesteps(self) -> int:
        return default_total_timesteps(self.config)

    @property
    def env_state(self) -> FormationState:
        return self._iteration.env

    @property
    def obs(self) -> Tensor:
        return self._iteration.obs

    @property
    def step(self) -> int:
        """Optimizer steps so far, the schedules' clock (reads the
        device)."""
        return int(self._iteration.step)

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
        """``rollouts`` iterations, queued without reading the device, and
        the host counters advanced; returns their metric rows. With
        scenarios, each iteration's mix is written into the scenario
        buffers before its replay."""
        self._apply_pending_schedule()
        # The train lane's chaos seams: a 'raise' armed here is state
        # corruption at the dispatch boundary, a NaN or a finite 1e18
        # multiplied into the live parameters (the stand-ins for organic
        # divergence that the health word and the ladder absorb).
        try:
            fault_point("train.carry_poison")
        except InjectedFault:
            self._poison_carry(float("nan"))
        try:
            fault_point("train.grad_bomb")
        except InjectedFault:
            self._poison_carry(1.0e18)
        rows = severities = None
        if self._scenario_schedule is not None:
            rows, severities = self._load_scenario_rows(rollouts)
            self._last_severities = severities
        warm = all(p.calls > 0 and not p.builds_next() for p in self._phases)
        # The dispatch's iterations may both warm a phase up and capture it
        # (a fused chunk's first two).
        if any(phase.builds_next(rollouts) for phase in self._phases):
            self.retrace_guard.record(self._iteration.env.agents,
                                      self._iteration.obs)
        start = self._nan_guard_start() if self.config.guard_nans else None
        guard: Any = contextlib.nullcontext()
        if self.config.guard_transfers and warm:
            # Post-warm-up only: a build legitimately reads the device.
            if self._guarded_writer is not None:
                self._guarded_writer.wait()
            guard = no_host_transfers()
        self.trace_window.before_dispatch()
        try:
            with guard:
                self._run_iterations(rows, rollouts, self._phases)
        except BaseException:
            self.trace_window.close()
            raise
        self.trace_window.after_dispatch()
        if start is not None:
            self._check_nans(start, rows, rollouts)
        self._advance(rollouts)
        get_registry().counter("train_iterations_total").inc(rollouts)
        ready = None
        if self.device.type == "cuda":
            ready = torch.cuda.Event()
            ready.record()
        return ChunkMetrics(
            self.metric_names, self._iteration.ring.take(rollouts), ready,
            severities,
        )

    def _run_iterations(self, rows: Any, rollouts: int,
                        phases: Optional[Tuple[Any, ...]]) -> None:
        """``rollouts`` iterations through ``phases`` (None: eagerly),
        each with its scenario row written first."""
        for i in range(rollouts):
            if rows is not None:
                self._iteration.scenario_params.copy_(
                    rows.map(lambda t: t[i]))
            self._iteration.run(mark=self.phase_hook, phases=phases)

    def _nan_guard_start(self) -> Tuple[Dict[str, Any], Dict[str, Any],
                                        List[Tuple[Any, Any]]]:
        """The live carry a dispatch starts from, a copy of it and the
        generators' states: what ``_check_nans`` re-runs the dispatch
        from."""
        state = self._checkpoint_state()
        live = {k: v for k, v in state.items()
                if k not in ("num_timesteps", "generator",
                             "scenario_generator")}
        saved = device_snapshot(live).tree
        generators = [self.generator]
        if self._scenario_schedule is not None:
            generators.append(self.scenario_generator)
        return live, saved, [(g, g.get_state()) for g in generators]

    def _check_nans(self, start: Any, rows: Any, rollouts: int) -> None:
        """guard_nans after a dispatch: one flag of its outputs (the
        metric rows and the parameters); on a NaN, the dispatch again from
        its starting state, eagerly under ``nan_guard``, which raises
        ``FloatingPointError`` at the first op that makes one."""
        outputs = [self._iteration.ring.take(rollouts),
                   *self.model.parameters()]
        if not bool(torch.stack([torch.isnan(t).any() for t in outputs])
                    .any()):
            return
        live, saved, generators = start
        with torch.no_grad():
            _copy_into(live, saved)
        for gen, state in generators:
            gen.set_state(state)
        with nan_guard():
            self._run_iterations(rows, rollouts, None)
        raise FloatingPointError(
            "invalid value (nan) in the outputs of a train dispatch; its "
            "eager re-run under nan_guard made none (a NaN only the "
            "captured graph makes)"
        )

    def _advance(self, rollouts: int) -> None:
        """The host's counters after ``rollouts`` iterations."""
        self.num_timesteps += rollouts * self.ppo.n_steps * self.num_envs
        self._vec_steps_since_save += rollouts * self.ppo.n_steps

    def graph_count(self) -> int:
        """CUDA graphs captured so far (0 eagerly): one a phase."""
        return sum(phase.graph is not None for phase in self._phases)

    def run_iteration(self) -> Dict[str, Tensor]:
        """One host-loop dispatch, ``iters_per_dispatch`` iterations (1 by
        default); returns the metrics on the device, the burst's reduction
        (``reduce_burst``)."""
        if self._fused_chunk:
            raise RuntimeError(
                "a fused_chunk trainer dispatches with run_chunk()"
            )
        chunk = self._dispatch(self._iters_per_dispatch)
        row = reduce_burst(chunk.names, chunk.rows)
        return self._iteration.metrics(row)

    def run_chunk(self) -> ChunkMetrics:
        """One chunk of ``fused_chunk`` iterations, queued; its
        per-iteration metric rows stay on the device until drained."""
        if not self._fused_chunk:
            raise RuntimeError("run_chunk() needs fused_chunk > 0")
        return self._dispatch(self._fused_chunk)

    # ------------------------------------------------------------------
    # Training
    # ------------------------------------------------------------------

    def _logger(self) -> MetricsLogger:
        return run_logger(self.config, self.log_dir)

    def train(self) -> Dict[str, float]:
        """The full run with metrics and checkpoints; returns the last
        record."""
        if self._fused_chunk:
            return self._train_fused()
        logger = self._logger()
        meter = Throughput()
        iteration = 0
        try:
            while (self.num_timesteps < self.total_timesteps
                   and not self.halted):
                metrics = self.run_iteration()
                iteration += 1
                meter.tick(self._iters_per_dispatch * self.ppo.n_steps
                           * self.config.num_formations)
                # Every dispatch, not at log cadence: GET /metrics answers
                # "how fast right now" whatever log_interval is.
                self._record_lane_metrics(meter.rate())
                if iteration % self.config.log_interval == 0:
                    record = metrics_to_host(metrics)
                    if self._observe_health(record, iteration):
                        continue  # rolled back or halted: drop the record
                    record["env_steps_per_sec"] = meter.rate()
                    if self._scenario_schedule is not None:
                        # The severity the dispatch's first iteration
                        # trained at, as a fused record carries it.
                        record["scenario_severity"] = float(
                            np.float32(self._last_severities[0]))
                    self.last_record = record
                    logger.log(record, self.num_timesteps)
                if (
                    self.config.checkpoint
                    and self._vec_steps_since_save >= self.config.save_freq
                ):
                    if (
                        self.recovery_ladder is not None
                        and iteration % self.config.log_interval != 0
                    ):
                        # This dispatch's flags were not read: read them
                        # before publishing its state.
                        flags = metrics_to_host({
                            k: metrics[k]
                            for k in ("health_ok", "health_word")
                        })
                        if self._observe_health(flags, iteration):
                            continue
                    if not self._saves_suspended():
                        self.save()
            if self.recovery_ladder is not None and not self.halted:
                self._ensure_finite_final_state(None, iteration)
            if self.config.checkpoint and not self._saves_suspended():
                self.save()
        finally:
            self.trace_window.close()
            logger.close()
        return self.last_record

    def _record_lane_metrics(self, env_steps_rate: float) -> None:
        """The lane's throughput gauges and build count into the registry
        (the ``GET /metrics`` namespace), at a host seam."""
        registry = get_registry()
        registry.gauge("train_env_steps_per_sec").set(env_steps_rate)
        per_iter = self.ppo.n_steps * self.config.num_formations
        registry.gauge("train_steps_per_sec").set(
            env_steps_rate / per_iter if per_iter else 0.0)
        registry.gauge("train_compiles").set(self.retrace_guard.count)

    def _train_fused(self) -> Dict[str, float]:
        """Dispatch chunk N+1, then drain chunk N (the device computes while
        the host logs); checkpoint at chunk boundaries on a background
        writer from a device snapshot. Records are per iteration, as the
        host loop's, ``log_interval`` counted on the global iteration."""
        logger = self._logger()
        meter = Throughput()
        writer = (
            AsyncCheckpointWriter(
                keep_last_n=self.config.keep_last_n,
                protect=self._protected_paths,
            )
            if self.config.checkpoint else None
        )
        k = self._fused_chunk
        iteration = 0
        pending = None  # the chunk in flight, drained a dispatch later
        try:
            while (self.num_timesteps < self.total_timesteps
                   and not self.halted):
                steps_before = self.num_timesteps
                chunk = self.run_chunk()
                if pending is not None:
                    self._drain_chunk(logger, meter, *pending)
                    if self._act_on_recovery_verdict(writer, iteration):
                        # The chunk just queued trained from the diverged
                        # state: abandon it undrained.
                        pending = None
                        continue
                pending = (chunk, iteration, steps_before)
                iteration += k
                if (
                    writer is not None
                    and self._vec_steps_since_save >= self.config.save_freq
                    and not self._saves_suspended()
                ):
                    self.save_async(writer)
            if pending is not None:
                self._drain_chunk(logger, meter, *pending)
                self._act_on_recovery_verdict(writer, iteration)
            if self.recovery_ladder is not None and not self.halted:
                self._ensure_finite_final_state(writer, iteration)
            if writer is not None:
                if not self._saves_suspended():
                    self.save_async(writer)
                writer.close()  # the last write is on disk before return
                writer = None
        finally:
            self.trace_window.close()
            if writer is not None:
                writer.close_quietly()
            logger.close()
        return self.last_record

    def _drain_chunk(
        self, logger: MetricsLogger, meter: Throughput, chunk: ChunkMetrics,
        first_iteration: int, steps_before: int,
    ) -> None:
        """One transfer for a chunk's metrics, the ladder's look at its
        health flags, then a record an iteration at the JAX trainer's
        steps."""
        t_drain = time.perf_counter()
        host = chunk.to_host()
        meter.tick(self._fused_chunk * self.ppo.n_steps
                   * self.config.num_formations)
        registry = get_registry()
        registry.histogram("train_chunk_drain_seconds").observe(
            time.perf_counter() - t_drain)
        registry.counter("train_chunks_total").inc()
        # The drain just synced, so the sample costs no extra stall.
        sample_device_watermark()
        self._record_lane_metrics(meter.rate())
        if "health_ok" in host:
            if self.recovery_ladder is not None:
                self._recovery_verdict = self.recovery_ladder.observe(
                    host["health_ok"], host.get("health_word"),
                    first_iteration)
            else:
                record_health_flags(host)
        per_iter = self.ppo.n_steps * self.num_envs
        for i in range(self._fused_chunk):
            if (first_iteration + i + 1) % self.config.log_interval:
                continue
            record = {name: float(host[name][i]) for name in sorted(host)}
            record["env_steps_per_sec"] = meter.rate()
            if chunk.severities is not None:
                record["scenario_severity"] = float(
                    np.float32(chunk.severities[i]))
            logger.log(record, steps_before + (i + 1) * per_iter)
            self.last_record = record

    def profile_breakdown(self, iters: int = 10) -> Dict[str, float]:
        """Where an iteration's time goes: ``iters`` iterations through the
        trainer's own phases (captured on the card), timed phase by phase
        with CUDA events (the host's clock on the CPU), and ``n_steps`` env
        steps alone under uniform random actions. The run's state (learner,
        env carry, generators, counters) is restored afterwards, so the
        timed iterations leave no trace. Returns seconds an iteration, as
        the JAX trainer's: ``total``, ``rollout`` (policy, env, GAE and
        the update's rows), ``env``, ``policy`` (rollout - env),
        ``update`` (the minibatch steps and the end), and ``frac_env``,
        ``frac_policy``, ``frac_update`` of their sum."""
        if self._fused_chunk:
            raise RuntimeError("profile_breakdown times the host loop's "
                               "iteration; build the trainer without "
                               "fused_chunk")
        saved = self._host_tree()
        since_save = self._vec_steps_since_save
        draws = self._scenario_draws
        while any(p.calls == 0 or p.builds_next() for p in self._phases):
            self._dispatch(1)  # warm up and capture, outside the timing
        cuda = self.device.type == "cuda"

        def stamp():
            if not cuda:
                return time.perf_counter()
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            return event

        def seconds(a, b) -> float:
            return a.elapsed_time(b) / 1e3 if cuda else b - a

        marks: List[List[Any]] = []
        for _ in range(iters):
            marks.append([])
            self._iteration.run(mark=lambda _: marks[-1].append(stamp()),
                                phases=self._phases)
        it = self._iteration
        state = type(it.env)(**{f: getattr(it.env, f).clone()
                                for f in it.env_fields})
        gen = torch.Generator(device=self.device).manual_seed(0)
        step = it.env_step_fn or (lambda s, v: self.env_spec.step_batch(
            s, v, self.env_params, gen))
        env_marks = [stamp()]
        for _ in range(self.ppo.n_steps):
            velocity = self.env_params.max_speed * (
                2 * torch.rand(state.agents.shape, generator=gen,
                               device=self.device) - 1)
            state, _ = step(state, velocity)
        env_marks.append(stamp())
        if cuda:
            torch.cuda.synchronize()
        rows = [(seconds(m[0], m[1]), seconds(m[1], m[2])) for m in marks]
        env = seconds(*env_marks)
        self._load_tree(saved, "the state before profile_breakdown")
        self._vec_steps_since_save = since_save
        self._scenario_draws = draws
        rollout = float(np.mean([r for r, _ in rows]))
        update = float(np.mean([u for _, u in rows]))
        result = {"total": rollout + update, "rollout": rollout, "env": env,
                  "update": update, "policy": max(rollout - env, 0.0)}
        stage_sum = result["env"] + result["policy"] + result["update"]
        for k in ("env", "policy", "update"):
            result[f"frac_{k}"] = result[k] / stage_sum if stage_sum else 0.0
        return result

    # ------------------------------------------------------------------
    # The recovery ladder's actions
    # ------------------------------------------------------------------

    def _saves_suspended(self) -> bool:
        """While the ladder suspects the state, nothing is saved: a finite
        but diverged state passes the non-finite gate."""
        return (self.recovery_ladder is not None
                and self.recovery_ladder.suspect)

    def _poison_carry(self, value: float) -> None:
        """Multiply the live parameters by ``value`` (NaN kills the loss; a
        finite 1e18 explodes the gradients): the stand-in for divergence
        that tests use, at a dispatch boundary."""
        with torch.no_grad():
            for p in self.model.parameters():
                p.mul_(value)

    def _observe_health(self, host_metrics: Dict[str, Any],
                        iteration: int) -> bool:
        """Feed a host-loop record's health flags to the ladder and act on
        its verdict; True when the state was restored (or the run
        halted)."""
        if "health_ok" not in host_metrics:
            return False
        if self.recovery_ladder is None:
            record_health_flags(host_metrics)
            return False
        self._recovery_verdict = self.recovery_ladder.observe(
            host_metrics["health_ok"], host_metrics.get("health_word"),
            iteration,
        )
        return self._act_on_recovery_verdict(None, iteration)

    def _act_on_recovery_verdict(
        self, writer: Optional[AsyncCheckpointWriter], iteration: int
    ) -> bool:
        """Act on the verdict of the last drain: roll back, or roll back
        and halt; True when the state was restored."""
        verdict, self._recovery_verdict = self._recovery_verdict, None
        if verdict in (None, "ok"):
            return False
        if verdict == "rollback":
            self._perform_rollback(writer, iteration)
            return True
        self._perform_rollback(
            writer, iteration,
            halt_reason=(
                "sustained divergence with the rollback budget exhausted "
                f"({self.recovery_ladder.recoveries} recoveries spent)"
            ),
        )
        return True

    def _perform_rollback(
        self,
        writer: Optional[AsyncCheckpointWriter],
        iteration: int,
        halt_reason: Optional[str] = None,
    ) -> None:
        """Restore the newest valid good state (the checkpoint walk, or the
        run's starting state) into the static carry, move the generator
        into the next retry stream and apply the learning-rate backoff;
        with ``halt_reason`` the run ends there, on finite parameters."""
        t0 = time.perf_counter()
        ladder = self.recovery_ladder
        if writer is not None:
            try:
                writer.wait()  # it may be publishing the file to restore
            except RuntimeError:
                pass  # a failed write never blocks recovery
        found = None
        if self.config.checkpoint:
            for _ in range(8):
                found = restore_latest_partial(self.log_dir,
                                               self.resume_keys)
                if (
                    found is not None and ladder is not None
                    and ladder.last_rollback_path == str(found[0])
                ):
                    # The last rollback restored this file and the run
                    # diverged again with no healthy progress: the file is
                    # the poison.
                    quarantine_checkpoint(
                        found[0], "rollback target re-diverged (finite but "
                        "unhealthy state); walking back",
                    )
                    found = None
                    continue
                break
        if found is not None:
            path, restored = found
        else:
            path, restored = None, self._rollback_anchor
        draws = self._scenario_draws
        self._load_tree(restored, path or "the run's starting state")
        recoveries_next = (ladder.recoveries if ladder is not None else 0) + 1
        fold_recovery_generator(self.generator, recoveries_next)
        lr_scale = None
        if self.config.recovery_lr_backoff != 1.0:
            scale_injected_lr(self._iteration.lr,
                              self.config.recovery_lr_backoff)
            lr_scale = self.config.recovery_lr_backoff
        severity_scale = None
        if self._scenario_schedule is not None:
            fold_recovery_generator(self.scenario_generator, recoveries_next)
            if self.config.recovery_severity_backoff != 1.0:
                self._severity_scale *= self.config.recovery_severity_backoff
                severity_scale = self._severity_scale
            self._scenario_rollouts = self.num_timesteps // (
                self.ppo.n_steps * self.num_envs)
            # The draw counter never rewinds: the retry trains on fresh
            # mixes, not the ones that diverged.
            self._scenario_draws = max(draws, self._scenario_rollouts)
            self.scenario_severity = self._severity(self._scenario_rollouts)
        self._vec_steps_since_save = 0
        if path is not None:
            self._last_good_ckpt = Path(path)
        mttr_s = time.perf_counter() - t0
        if ladder is None:
            return
        if halt_reason is None:
            ladder.note_rollback(
                to_step=self.num_timesteps,
                path=str(path) if path is not None else None,
                mttr_s=mttr_s, iteration=iteration, lr_scale=lr_scale,
                severity_scale=severity_scale,
            )
        else:
            ladder.note_halt(iteration, halt_reason)
            self.halted = True

    def _ensure_finite_final_state(
        self, writer: Optional[AsyncCheckpointWriter], iteration: int
    ) -> None:
        """The run ends on finite parameters, even when the budget ran out
        mid-breach: one host read at the end of the run."""
        params = tree_to_host(dict(self.model.named_parameters()))
        if nonfinite_leaf(params) is not None:
            self._perform_rollback(writer, iteration)

    def _protected_paths(self) -> set:
        """The ladder's current rollback target survives pruning."""
        return {self._last_good_ckpt} if self._last_good_ckpt else set()

    # ------------------------------------------------------------------
    # Checkpoints
    # ------------------------------------------------------------------

    def _checkpoint_state(self) -> Dict[str, Any]:
        """What a checkpoint holds, as device tensors and host values."""
        it = self._iteration
        state = {
            "params": {k: p.detach()
                       for k, p in self.model.named_parameters()},
            "opt": {"count": self.opt_state.count,
                    "mu": dict(self.opt_state.mu),
                    "nu": dict(self.opt_state.nu)},
            "num_timesteps": int(self.num_timesteps),
            "generator": self.generator.get_state(),
            "env": {f: getattr(it.env, f) for f in it.env_fields},
            "obs": it.obs,
            "step": it.step,
        }
        if self.injected_lr:
            state["lr"] = it.lr
        if self._scenario_schedule is not None:
            state["scenario_generator"] = self.scenario_generator.get_state()
        return state

    def _checkpoint_tree(self, host: Dict[str, Any]) -> Dict[str, Any]:
        """The checkpoint from ``_checkpoint_state`` on the host: the JAX
        trainer's learner keys in its layout, and the port's own resume
        state under ``torch_`` keys, which the JAX package's reader ignores
        (a learner-only checkpoint to it). Reads nothing else that
        changes, so it runs on the writer's thread."""
        hyper = None
        if "lr" in host:
            hyper = inject_hyperparams(float(host["lr"]), self.ppo.adam_eps)
        tree = {
            "policy": self.policy,
            "params": params_to_jax(host["params"], self.policy),
            "opt_state": opt_state_to_jax(host["opt"], self.policy, hyper),
            "num_timesteps": host["num_timesteps"],
            "learning_rate": float(self.ppo.learning_rate),
            "torch_generator": host["generator"],
            "torch_env_state": host["env"],
            "torch_obs": host["obs"],
            "torch_step": int(host["step"]),
            **({"torch_scenario_generator": host["scenario_generator"]}
               if "scenario_generator" in host else {}),
        }
        if self._multihost:
            # Across processes the env carry is each rank's block: a
            # resume restores the learner and the streams, and the env
            # stays freshly reset (the JAX package's multi-host resume).
            del tree["torch_env_state"], tree["torch_obs"]
        return tree

    def _host_tree(self) -> Dict[str, Any]:
        return self._checkpoint_tree(tree_to_host(self._checkpoint_state()))

    def _snapshot_for_write(self) -> Dict[str, Any]:
        """The checkpoint's state through the ``train.snapshot`` chaos
        seam: an armed fault poisons the parameters of this copy (never
        the live carry), which the non-finite write gate must keep out of
        discovery."""
        state = self._checkpoint_state()
        try:
            fault_point("train.snapshot")
        except InjectedFault:
            state = dict(state)
            state["params"] = {k: p * float("nan")
                               for k, p in state["params"].items()}
        return state

    def save(self) -> Optional[str]:
        """Write a checkpoint now; returns its path, or None when the
        non-finite gate refused the state."""
        path = save_checkpoint(
            self.log_dir, self.num_timesteps,
            self._checkpoint_tree(tree_to_host(self._snapshot_for_write())),
        )
        self._vec_steps_since_save = 0
        if path is None:
            return None
        self._last_good_ckpt = path
        if self.config.keep_last_n > 0:
            prune_checkpoints(self.log_dir, self.config.keep_last_n,
                              protect=self._protected_paths())
        if self.on_checkpoint is not None:
            self.on_checkpoint(path)
        return str(path)

    def save_async(self, writer: AsyncCheckpointWriter) -> str:
        """A checkpoint that does not stall the dispatch loop: a device
        snapshot queued behind the work that produced the state, brought
        to the host and written by ``writer``'s thread. The same bytes as
        ``save``."""
        path = checkpoint_path(self.log_dir, self.num_timesteps)
        if not is_coordinator():
            # Only the coordinator writes (utils/checkpoint.py).
            self._vec_steps_since_save = 0
            return str(path)
        on_checkpoint = self.on_checkpoint

        def on_done(p: Path) -> None:
            # On the writer thread, after the rename: the file passed the
            # non-finite gate and is discoverable.
            self._last_good_ckpt = Path(p)
            if on_checkpoint is not None:
                on_checkpoint(p)

        writer.submit(
            path,
            device_snapshot(self._snapshot_for_write(),
                            finish=self._checkpoint_tree),
            on_done=on_done,
        )
        if self.config.guard_transfers:
            self._guarded_writer = writer
        self._vec_steps_since_save = 0
        return str(path)

    def _load_tree(self, raw: Dict[str, Any], origin: Any) -> None:
        """Copy a checkpoint tree (``RESUME_KEYS``) into the static carry.
        Params and, when present, the Adam state (with its learning rate in
        the ``inject_hyperparams`` layout) and ``num_timesteps`` come from
        the JAX trainer's keys; the generator, env state, observation and
        step from the port's ``torch_`` keys. A file without them (one the
        JAX package wrote) restores the learner only, and the step from 0,
        as the JAX package does with a learner-only file."""
        policy = raw.get("policy", "MLPActorCritic")
        if policy != self.policy:
            raise ValueError(
                f"checkpoint {origin} holds a {policy}, this run trains a "
                f"{self.policy}"
            )
        if "num_timesteps" not in raw:
            raise ValueError(f"checkpoint {origin} has no num_timesteps")
        it = self._iteration
        self.model.load_state_dict(params_from_jax(raw["params"], policy))
        if "opt_state" in raw:
            opt = opt_state_from_jax(raw["opt_state"], policy)
            for k, p in self.model.named_parameters():
                for moment in ("mu", "nu"):
                    if opt[moment][k].shape != p.shape:
                        raise ValueError(
                            f"checkpoint {origin}: Adam {moment} of {k} has "
                            f"shape {tuple(opt[moment][k].shape)}, the model "
                            f"{tuple(p.shape)}"
                        )
            with torch.no_grad():
                self.opt_state.count.copy_(opt["count"])
                for k in self.opt_state.mu:
                    self.opt_state.mu[k].copy_(opt["mu"][k])
                    self.opt_state.nu[k].copy_(opt["nu"][k])
                if "learning_rate" in opt:
                    it.lr.fill_(opt["learning_rate"])
        self.num_timesteps = int(raw["num_timesteps"])
        ckpt_lr = raw.get("learning_rate")
        if ckpt_lr is not None and not np.isclose(
            float(ckpt_lr), self.ppo.learning_rate, rtol=1e-6
        ):
            print(
                f"[trainer] WARNING: checkpoint was trained at "
                f"learning_rate={float(ckpt_lr):g} but this run uses "
                f"{self.ppo.learning_rate:g}",
                file=sys.stderr,
            )
        if "torch_generator" in raw:
            self.generator.set_state(
                torch.from_numpy(np.array(raw["torch_generator"]))
            )
        if "torch_env_state" in raw:
            env = raw["torch_env_state"]
            if np.shape(env["agents"]) != tuple(it.env.agents.shape):
                raise ValueError(
                    f"checkpoint {origin}: env state of shape "
                    f"{np.shape(env['agents'])}, this run has "
                    f"{tuple(it.env.agents.shape)}"
                )
            with torch.no_grad():
                # A clean run's file keeps this run's episode draws.
                for f in it.env_fields:
                    if f in ENV_FIELDS or f in env:
                        getattr(it.env, f).copy_(
                            torch.from_numpy(np.array(env[f])))
                it.obs.copy_(torch.from_numpy(np.array(raw["torch_obs"])))
        it.step.fill_(int(raw.get("torch_step", 0)))
        if self._scenario_schedule is not None:
            if "torch_scenario_generator" in raw:
                self.scenario_generator.set_state(torch.from_numpy(
                    np.array(raw["torch_scenario_generator"])))
            # Re-enter the schedule where the run left off: every rollout
            # adds n_steps * M * N to num_timesteps.
            self._scenario_rollouts = self.num_timesteps // (
                self.ppo.n_steps * self.num_envs)
            self._scenario_draws = self._scenario_rollouts
            self.scenario_severity = self._severity(self._scenario_rollouts)

    def _try_resume(self) -> None:
        """Restore the newest valid checkpoint in ``log_dir``
        (``_load_tree``)."""
        found = broadcast_restore(self.log_dir, self.resume_keys)
        if found is None:
            return
        path, raw = found
        self._load_tree(raw, path)
        print(f"[trainer] resumed from {path} at {self.num_timesteps} steps")
