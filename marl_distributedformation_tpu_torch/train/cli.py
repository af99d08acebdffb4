"""Training entry point of the port: the repository's ``python train.py
name=x`` workflow on PyTorch.

    python -m marl_distributedformation_tpu_torch.train name=myrun
    python -m marl_distributedformation_tpu_torch.train name=gnn100 \\
        policy=gnn obs_mode=knn num_agents_per_formation=100 \\
        num_formation=1024 preset=tpu total_timesteps=30720000
    python -m marl_distributedformation_tpu_torch.train name=gnn100 \\
        policy=gnn obs_mode=knn num_agents_per_formation=100 \\
        num_formation=1024 preset=tpu fused_chunk=10 health=true
    python -m marl_distributedformation_tpu_torch.train name=pop4 \\
        policy=gnn obs_mode=knn num_agents_per_formation=100 \\
        num_formation=1024 preset=tpu num_seeds=4 fused_chunk=10
    python -m marl_distributedformation_tpu_torch.train name=ctde20 \\
        policy=ctde num_agents_per_formation=20 num_formation=2048 \\
        preset=tpu
    python -m marl_distributedformation_tpu_torch.train name=hetero5 \\
        num_seeds=4 num_formation=64 num_agents_per_formation=20 \\
        preset=tpu total_timesteps=2560000 ent_coef_final=0.0 \\
        log_std_final=-2.5 log_std_decay_start=0.5 \\
        "curriculum=[{rollouts: 30, agent_counts: [5]},
                     {rollouts: 40, agent_counts: [5, 5, 20]},
                     {rollouts: 30, agent_counts: [5, 5, 20], num_obstacles: 4},
                     {rollouts: 100, agent_counts: [5, 5, 20], num_obstacles: 4}]"

Reads ``cfg/config.yaml`` with ``key=value`` overrides, as the root
``train.py`` does, and never writes it. ``device`` defaults to ``cuda``; the
CPU runs only with ``device=cpu``. Metrics go to ``logs/{name}/metrics.jsonl``,
checkpoints to ``logs/{name}/rl_model_{steps}_steps.msgpack`` and the
resolved config, with the device that ran it, to ``logs/{name}/config.json``
(``config_resume.json`` on a resume). On the card the iteration runs as
captured CUDA graphs (``train/capture.py``); ``fused_chunk``,
``iters_per_dispatch``, ``health``, ``recovery*`` and ``keep_last_n`` mean
what they mean to the JAX trainer. ``policy`` is ``mlp``, ``ctde`` or
``gnn``. ``num_seeds > 1`` trains a population (``train/sweep.py``) with
member checkpoints under ``logs/{name}/seed{i}/``, ``learning_rates`` (one
a member) its rates. ``curriculum`` trains over padded heterogeneous
formations (``train/curriculum.py``; with ``num_seeds > 1`` a population
of candidates, ``train/hetero_sweep.py``), dispatched and refused as the
root ``train.py`` dispatches and refuses it. ``scenarios`` (with
``scenario_severity``) trains a single run under disturbance scenarios
(``scenarios/schedule.py``); the schedule is built at config time, so an
unknown name exits naming the registry, and scenarios with a curriculum or
with ``num_seeds > 1`` exit with the root ``train.py``'s messages:

    python -m marl_distributedformation_tpu_torch.train name=scen100 \
        policy=gnn obs_mode=knn num_agents_per_formation=100 \
        num_formation=1024 preset=tpu fused_chunk=10 \
        "scenarios=[{rollouts: 12, scenarios: [clean]},
                    {rollouts: 12, scenarios: [wind, sensor_noise], severity: 0.5}]"

``architecture=sebulba`` trains through the split actor and learner lanes
(``train/sebulba/``; ``fused_chunk`` is K, the batches a learner chunk
drains; ``transfer_queue_depth``, ``max_param_staleness``,
``actor_devices``), refused with a curriculum or ``num_seeds > 1`` in the
root ``train.py``'s words:

    python -m marl_distributedformation_tpu_torch.train name=sebulba100 \
        policy=gnn obs_mode=knn num_agents_per_formation=100 \
        num_formation=1024 preset=tpu architecture=sebulba fused_chunk=10

``telemetry`` and ``telemetry_reservoir`` configure the metrics registry
(``obs/metrics.py``), ``telemetry_port`` serves it as Prometheus text on
``GET /metrics`` during the run, ``ledger`` and ``ledger_reservoir`` the
program ledger, whose census lands in ``logs/{name}/program_ledger.json``
at exit (by default); ``profile=true`` traces ``profile_iterations``
dispatches into ``logs/{name}/profile/``.

A mistyped key exits with a did-you-mean, as does an ``env`` that is not
registered (``formation`` and, since the env-spec slice, ``pursuit_evasion``
train). A knob of a feature the port does not have yet exits naming its
ROADMAP item when set to anything but its YAML default: nothing is silently
ignored.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path
from typing import Dict, Optional, Union

import torch

from marl_distributedformation_tpu_torch.algo import PPOConfig
from marl_distributedformation_tpu_torch.device import resolve_device
from marl_distributedformation_tpu_torch.envs import spec_for_params
from marl_distributedformation_tpu_torch.models import (
    CTDEActorCritic,
    GNNActorCritic,
    MLPActorCritic,
)
from marl_distributedformation_tpu_torch.obs import (
    TelemetryServer,
    configure_ledger,
    configure_metrics,
    get_ledger,
)
from marl_distributedformation_tpu_torch.parallel import (
    init_distributed,
    is_coordinator,
    make_hybrid_mesh,
    make_shard_fn,
    rank_device,
)
from marl_distributedformation_tpu_torch.parallel.distributed import (
    process_index,
    world_size,
)
from marl_distributedformation_tpu_torch.train.curriculum import (
    HeteroTrainer,
    curriculum_from_cfg,
    padded_env_params,
)
from marl_distributedformation_tpu_torch.train.hetero_sweep import (
    HeteroSweepTrainer,
)
from marl_distributedformation_tpu_torch.train.sebulba import SebulbaDriver
from marl_distributedformation_tpu_torch.train.sweep import (
    SweepTrainer,
    member_block,
)
from marl_distributedformation_tpu_torch.train.trainer import (
    TrainConfig,
    Trainer,
)
from marl_distributedformation_tpu_torch.utils.config import (
    as_override,
    env_params_from_config,
    load_config,
    read_yaml,
    refuse_jax_only,
    repo_root,
    scenario_schedule_from_config,
    validate_override_keys,
)

# Keys the entry point reads beyond the YAML's and EnvParams' fields, with
# the defaults of those the YAML does not list.
TRAIN_KEYS = ("device", "resume", "guard_retraces", "guard_transfers",
              "guard_nans")
_UNLISTED_DEFAULTS = {
    "guard_retraces": 0, "guard_transfers": False, "guard_nans": False,
}

# Knobs of features not ported yet, and the ROADMAP item that ports each
# (none since A12 ported ``mesh``).
UNPORTED: Dict[str, str] = {}


def refuse_unported(cfg) -> None:
    """Exit when ``cfg`` asks for something the port does not do."""
    defaults = {**_UNLISTED_DEFAULTS, **read_yaml("cfg/config.yaml")}
    for key, item in UNPORTED.items():
        default = as_override(defaults.get(key))
        if as_override(cfg.get(key, default)) != default:
            raise SystemExit(
                f"{key}={cfg[key]!r} is not ported yet (ROADMAP {item}); "
                f"leave it at {default!r}"
            )
    refuse_jax_only(cfg, defaults)


def ppo_from_config(cfg) -> PPOConfig:
    return PPOConfig(
        n_steps=cfg.n_steps,
        learning_rate=cfg.learning_rate,
        ent_coef=cfg.ent_coef,
        gamma=cfg.gamma,
        gae_lambda=cfg.gae_lambda,
        clip_range=cfg.clip_range,
        clip_range_vf=cfg.get("clip_range_vf"),
        n_epochs=cfg.n_epochs,
        batch_size=cfg.batch_size,
        vf_coef=cfg.vf_coef,
        max_grad_norm=cfg.max_grad_norm,
        normalize_advantage=cfg.normalize_advantage,
        log_std_init=cfg.log_std_init,
        ent_coef_final=cfg.get("ent_coef_final"),
        log_std_final=cfg.get("log_std_final"),
        log_std_decay_start=float(cfg.get("log_std_decay_start") or 0.0),
    )


def train_config_from_config(cfg) -> TrainConfig:
    run_name = str(cfg.name)  # YAML parses numeric-looking names as ints
    return TrainConfig(
        num_formations=cfg.num_formation,
        total_timesteps=cfg.total_timesteps,
        seed=cfg.seed,
        save_freq=cfg.save_freq,
        name=run_name,
        log_dir=str(repo_root() / "logs" / run_name),
        use_wandb=cfg.use_wandb,
        use_tensorboard=bool(cfg.get("use_tensorboard", False)),
        resume=bool(cfg.get("resume", False)),
        log_interval=cfg.log_interval,
        iters_per_dispatch=int(cfg.get("iters_per_dispatch", 1)),
        fused_chunk=int(cfg.get("fused_chunk", 0)),
        health=bool(cfg.get("health", False)),
        health_grad_norm_max=float(cfg.get("health_grad_norm_max", 1.0e6)),
        health_param_drift_max=float(
            cfg.get("health_param_drift_max", 10.0)
        ),
        recovery=bool(cfg.get("recovery", False)),
        recovery_breach_iters=int(cfg.get("recovery_breach_iters", 3)),
        recovery_max_rollbacks=int(cfg.get("recovery_max_rollbacks", 3)),
        recovery_lr_backoff=float(cfg.get("recovery_lr_backoff", 1.0)),
        recovery_severity_backoff=float(
            cfg.get("recovery_severity_backoff", 1.0)
        ),
        keep_last_n=int(cfg.get("keep_last_n", 0)),
        profile=bool(cfg.get("profile", False)),
        profile_iterations=int(cfg.get("profile_iterations", 3)),
        architecture=str(cfg.get("architecture", "anakin")),
        actor_devices=int(cfg.get("actor_devices", 1)),
        transfer_queue_depth=int(cfg.get("transfer_queue_depth", 2)),
        max_param_staleness=int(cfg.get("max_param_staleness", 2)),
        guard_retraces=int(cfg.get("guard_retraces") or 0),
        guard_transfers=bool(cfg.get("guard_transfers", False)),
        guard_nans=bool(cfg.get("guard_nans", False)),
    )


def build_model(
    cfg, env_params, policy: str, seed: Optional[int] = None
) -> torch.nn.Module:
    """The ``policy`` model with the config's tower widths and
    ``log_std_init``, initialised from a CPU generator seeded with ``seed``
    (the config's by default; a population's member i takes ``seed +
    i``)."""
    sizes = cfg.get("hidden_sizes")
    extra = {"hidden": tuple(int(w) for w in sizes)} if sizes else {}
    gen = torch.Generator().manual_seed(
        int(cfg.seed if seed is None else seed)
    )
    if policy == "gnn":
        if env_params.obs_mode != "knn":
            raise SystemExit(
                "policy=gnn needs the k-NN observation graph: set "
                "obs_mode=knn (and knn_k) in the config"
            )
        return GNNActorCritic(
            k=env_params.knn_k, act_dim=env_params.act_dim,
            goal_in_obs=env_params.goal_in_obs,
            log_std_init=cfg.log_std_init, generator=gen, **extra,
        )
    if policy == "ctde":
        return CTDEActorCritic(
            env_params.obs_dim, env_params.act_dim,
            log_std_init=cfg.log_std_init, generator=gen, **extra,
        )
    if policy == "mlp":
        return MLPActorCritic(
            env_params.obs_dim, env_params.act_dim,
            log_std_init=cfg.log_std_init, generator=gen, **extra,
        )
    raise SystemExit(
        f"policy={policy!r} is not implemented; the port has mlp, ctde and "
        "gnn"
    )


def snapshot_config(cfg, log_dir: str, device: torch.device) -> Path:
    """The resolved config and the device that ran it, as JSON:
    ``config.json``, or ``config_resume.json`` on a resume."""
    path = Path(log_dir)
    path.mkdir(parents=True, exist_ok=True)
    out = path / ("config_resume.json" if cfg.get("resume") else "config.json")
    snap = dict(cfg)
    snap["resolved_platform"] = device.type
    snap["resolved_device"] = (
        torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    )
    with open(out, "w") as f:
        json.dump(snap, f, indent=2, default=str)
    return out


def shard_fn_from_config(cfg):
    """The ``mesh`` knob's ``shard_fn`` (``parallel.make_shard_fn`` over
    ``make_hybrid_mesh``, a plain mesh of the world's ranks), or None;
    the process group must be up (``parallel.init_distributed``)."""
    if not cfg.get("mesh"):
        return None
    return make_shard_fn(mesh=make_hybrid_mesh(dict(cfg.mesh)))


def build_hetero_trainer(
    cfg, env_params, num_seeds: int, common: dict, shard_fn=None
) -> Union[HeteroTrainer, HeteroSweepTrainer]:
    """The curriculum's trainer, as the root ``train.py``'s
    ``build_hetero_trainer``: formation env, ring observations, the MLP or
    CTDE policy; ``num_seeds > 1`` candidates in one population."""
    env_name = spec_for_params(env_params).name
    if env_name != "formation":
        raise SystemExit(
            f"curriculum training is formation-only (the hetero padded-"
            f"formation machinery wraps env/hetero.py, not the registered-"
            f"env dispatch); env={env_name!r} does not compose — drop "
            "curriculum or set env=formation"
        )
    policy = cfg.get("policy", "mlp")
    if policy not in ("mlp", "ctde"):
        raise SystemExit(
            f"curriculum training supports policy=mlp (shared per-agent "
            f"MLP) and policy=ctde (masked centralized critic); "
            f"policy={policy!r} is not supported — the GNN needs knn obs, "
            "and heterogeneous formations are ring-observed"
        )
    if env_params.obs_mode != "ring":
        raise SystemExit(
            "curriculum training uses the ring observation model (padded "
            f"formations mask the ring per transition); obs_mode="
            f"{env_params.obs_mode!r} is not supported — set obs_mode=ring"
        )
    curriculum = curriculum_from_cfg(cfg.curriculum)
    padded = padded_env_params(curriculum, env_params)
    if num_seeds > 1:
        mesh = getattr(shard_fn, "mesh", None)
        return HeteroSweepTrainer(
            curriculum, env_params, num_seeds=num_seeds,
            models=[build_model(cfg, padded, policy, int(cfg.seed) + i)
                    for i in member_block(num_seeds, mesh)],
            mesh=mesh, **common,
        )
    return HeteroTrainer(curriculum, env_params,
                         model=build_model(cfg, padded, policy),
                         shard_fn=shard_fn, **common)


def build_trainer(
    argv=None, capture: bool = True
) -> Union[Trainer, SweepTrainer]:
    """The run ``argv`` (or the command line) asks for, set up but not
    started, dispatched as the root ``train.py`` dispatches: with
    ``curriculum``, a ``HeteroTrainer`` (a ``HeteroSweepTrainer`` of
    ``num_seeds`` candidates when it is above 1); else a ``SweepTrainer``
    of ``num_seeds`` members when it is above 1, or a ``Trainer``. Writes
    the config snapshot. ``capture=False`` runs the iteration eagerly on
    the card (comparisons only; not a config key)."""
    overrides = sys.argv[1:] if argv is None else list(argv)
    validate_override_keys(overrides, extra_keys=TRAIN_KEYS)
    cfg = load_config(overrides)
    num_seeds = int(cfg.get("num_seeds", 1))
    learning_rates = cfg.get("learning_rates")
    if learning_rates and num_seeds <= 1:
        raise SystemExit(
            "learning_rates is a population knob: set num_seeds to the "
            "number of rates (one member per rate)"
        )
    refuse_unported(cfg)
    # At config time: an unknown scenario name exits naming the registry.
    scenario_schedule = scenario_schedule_from_config(cfg)
    # The launcher's variables, when set, wire this process into its
    # group (parallel/distributed.py); a mesh's rank has its own device.
    if init_distributed(device=cfg.get("device")):
        print(f"[train] multi-process: rank {process_index()} of "
              f"{world_size()} on {rank_device(cfg.get('device'))}")
    shard_fn = shard_fn_from_config(cfg)
    device = (rank_device(cfg.get("device")) if shard_fn is not None
              else resolve_device(cfg.get("device")))
    env_params = env_params_from_config(cfg)
    policy = cfg.get("policy", "mlp")
    train_cfg = train_config_from_config(cfg)
    common = dict(ppo=ppo_from_config(cfg), config=train_cfg, device=device,
                  capture=capture)
    if train_cfg.architecture == "sebulba" and cfg.get("curriculum"):
        raise SystemExit(
            "architecture=sebulba does not compose with curriculum "
            "training yet (the hetero stage machinery is Anakin-shaped); "
            "drop one of the two"
        )
    if train_cfg.architecture == "sebulba" and shard_fn is not None:
        raise SystemExit(
            "sebulba partitions WHOLE devices into actor/learner "
            "slices; mesh sharding (shard_fn) is Anakin-only — drop "
            "the mesh or use architecture=anakin"
        )
    if cfg.get("curriculum"):
        if num_seeds > 1 and learning_rates:
            raise SystemExit(
                "learning_rates does not compose with curriculum "
                "populations (candidate-seed selection trains at one "
                "rate); drop one of the two"
            )
        if scenario_schedule is not None:
            raise SystemExit(
                "scenarios do not compose with curriculum training yet "
                "(the hetero step is not scenario-wrapped); drop one of "
                "the two"
            )
        trainer = build_hetero_trainer(cfg, env_params, num_seeds, common,
                                       shard_fn)
        what = (f"{num_seeds} candidates x " if num_seeds > 1 else "") + (
            f"{trainer.curriculum.total_rollouts}-rollout curriculum of "
            f"{len(trainer.curriculum.stages)} stages, ")
    elif train_cfg.architecture == "sebulba":
        if train_cfg.guard_transfers or train_cfg.guard_nans:
            raise SystemExit(
                "guard_transfers and guard_nans guard the Anakin dispatch; "
                "under architecture=sebulba the actor lane synchronizes on "
                "its own thread while the learner dispatches (the CUDA "
                "sync debug mode is the process's), so they are refused "
                "there; guard_retraces budgets both lanes"
            )
        if num_seeds > 1:
            raise SystemExit(
                "architecture=sebulba does not compose with num_seeds>1 "
                "population sweeps yet (the sweep's vmapped iteration is "
                "Anakin-shaped); drop one of the two"
            )
        trainer = SebulbaDriver(
            env_params, model=build_model(cfg, env_params, policy),
            scenario_schedule=scenario_schedule, **common,
        )
        what = (f"sebulba (K={trainer._learner_chunk_k}, queue depth "
                f"{train_cfg.transfer_queue_depth}), ")
    elif train_cfg.architecture != "anakin":
        raise SystemExit(
            f"architecture={train_cfg.architecture!r} is unknown; "
            "available: anakin (fused same-device), sebulba (split "
            "acting/learning — docs/sebulba.md)"
        )
    elif num_seeds > 1:
        if scenario_schedule is not None:
            raise SystemExit(
                "scenarios do not compose with num_seeds>1 population "
                "sweeps yet (the vmapped sweep iteration is not "
                "scenario-wrapped); drop one of the two"
            )
        mesh = getattr(shard_fn, "mesh", None)
        trainer = SweepTrainer(
            env_params, num_seeds=num_seeds,
            models=[build_model(cfg, env_params, policy, int(cfg.seed) + i)
                    for i in member_block(num_seeds, mesh)],
            learning_rates=learning_rates, mesh=mesh, **common,
        )
        what = f"{num_seeds} members x "
    else:
        trainer = Trainer(
            env_params, model=build_model(cfg, env_params, policy),
            scenario_schedule=scenario_schedule, shard_fn=shard_fn, **common,
        )
        what = ""
        if scenario_schedule is not None:
            what = (f"{scenario_schedule.total_rollouts}-rollout scenario "
                    f"schedule of {len(scenario_schedule.stages)} stages "
                    f"over {', '.join(scenario_schedule.names)}, ")
    if shard_fn is not None:
        what += f"mesh {shard_fn.mesh.shape} (rank {shard_fn.mesh.rank}), "
    if is_coordinator():
        snapshot_config(cfg, trainer.log_dir, device)
    print(
        f"[train] {cfg.name}: {what}M={cfg.num_formation} formations x "
        f"N={trainer.env_params.num_agents} agents, "
        f"{trainer.total_timesteps} agent-transitions on {device}, "
        f"logs -> {trainer.log_dir}"
    )
    return trainer


def main(argv=None) -> Union[Trainer, SweepTrainer]:
    """Build the run, configure the metrics registry and the program
    ledger, serve ``GET /metrics`` when ``telemetry_port`` is set, train,
    and write ``logs/{name}/program_ledger.json`` at exit, as the root
    ``train.py`` does."""
    overrides = sys.argv[1:] if argv is None else list(argv)
    trainer = build_trainer(overrides)
    cfg = load_config(overrides)
    configure_metrics(
        enabled=bool(cfg.get("telemetry", True)),
        reservoir=int(cfg.get("telemetry_reservoir", 512)),
    )
    configure_ledger(
        enabled=bool(cfg.get("ledger", True)),
        reservoir=int(cfg.get("ledger_reservoir", 256)),
    )
    telemetry = None
    if cfg.get("telemetry_port") is not None:
        telemetry = TelemetryServer(port=int(cfg.telemetry_port)).start()
        print(f"[train] telemetry: {telemetry.url}")
    try:
        final = trainer.train()
    finally:
        if telemetry is not None:
            telemetry.stop()
        ledger = get_ledger()
        if ledger.enabled and ledger.entries() and is_coordinator():
            try:
                path = ledger.write_census(
                    Path(trainer.log_dir) / "program_ledger.json")
                print(f"[train] program ledger census -> {path}")
            except OSError as e:
                print(f"[train] census write failed: {e!r}")
    print(f"[train] done at {trainer.num_timesteps} steps: {final}")
    return trainer
