"""Serve a trained policy from its checkpoint directory.

Counterpart of the single-engine modes of the repository's
``scripts/serve_policy.py``:

    # one-shot smoke benchmark against the newest checkpoint (1 JSON line)
    python -m marl_distributedformation_tpu_torch.serve logs/run1 --smoke

    # long-running server: hot-reloads new checkpoints as training writes
    # them, emits serving metrics to {log_dir}/serving/metrics.jsonl
    python -m marl_distributedformation_tpu_torch.serve logs/run1 --watch

    # no checkpoint yet? serve a freshly initialized policy
    python -m marl_distributedformation_tpu_torch.serve \\
        --init-policy MLPActorCritic --obs-dim 8 --smoke --device cpu

    # a fleet of replicas behind one router, coordinated hot reload, and
    # an HTTP frontend (POST /v1/act, GET /v1/health, GET /v1/metrics)
    python -m marl_distributedformation_tpu_torch.serve logs/run1 \\
        --fleet --replicas 2 --port 8100

    # named model lanes over one fleet (serving/tenancy/): each lane serves
    # the newest checkpoint of its directory and hot-reloads from it
    python -m marl_distributedformation_tpu_torch.serve --fleet \\
        --tenants formation-a=logs/a/promoted,formation-b=logs/b/promoted

The server is the in-process stack of ``serving/`` (the bucketed engine,
one CUDA graph a rung on the card; the micro-batching scheduler; the
hot-reload registry), or with ``--fleet`` the fleet of ``serving/fleet/``
(``--replicas`` replicas, default one a CUDA device, so several share a
card; with ``--port`` the HTTP frontend; without ``--port`` or
``--watch``, the fleet smoke storm's one JSON line). ``--device`` defaults to ``cuda`` and raises without
a GPU; the CPU serves only with ``--device cpu``. A per-formation policy
(CTDE, GNN) takes whole formations as request rows, ``(agents, obs_dim)``:
pass both. A GNN checkpoint reads its ``knn_k`` and ``goal_in_obs`` from
the run's ``config.json`` beside the checkpoints, which the port's trainer
writes.

``--tenants NAME=DIR,...`` (with ``--fleet``) serves named lanes: each
lane's architecture is read from its newest checkpoint, so same-arch lanes
share one router group and its captured rungs, and a GNN lane reads its
env params from the ``config.json`` of its run (the directory or its
parent). Without ``--port`` or ``--watch`` it prints the tenant smoke's one
JSON line. The sharded and bf16 rungs, the trace recorder and the serving
benches (``--sharded``, ``--bf16``, ``--mesh-devices``,
``--record-trace``, ``--slo-bench``, ``--elastic-bench`` and their knobs)
are not ported yet: each exits naming ROADMAP A13.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

# serve_policy.py flags the port does not serve yet, each refused naming
# the ROADMAP item.
UNPORTED_FLAGS = {
    "--sharded": "store_true",
    "--bf16": "store_true",
    "--mesh-devices": int,
    "--record-trace": str,
    "--elastic-bench": "store_true",
    "--slo-bench": "store_true",
    "--slo-p95-ms": float,
    "--slo-iterations": int,
    "--slo-passes": int,
    "--load-rps": float,
    "--big-rung": int,
}


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument(
        "log_dir", nargs="?",
        help="checkpoint directory (logs/{name}) to serve and watch",
    )
    parser.add_argument(
        "--init-policy",
        help="serve a freshly initialized policy of this class instead of a "
        "checkpoint (requires --obs-dim)",
    )
    parser.add_argument("--obs-dim", type=int, help="request row width")
    parser.add_argument(
        "--hidden",
        help="with --init-policy: comma-separated tower widths (default the "
        "model's own, 64,64)",
    )
    parser.add_argument(
        "--agents", type=int,
        help="agents per formation — required for per-formation policies "
        "(CTDE/GNN), whose request rows are (agents, obs_dim)",
    )
    parser.add_argument("--buckets", default="1,8,64,512",
                        help="comma-separated batch-shape ladder")
    parser.add_argument("--window-ms", type=float, default=2.0,
                        help="coalescing window")
    parser.add_argument("--queue", type=int, default=256,
                        help="request queue bound")
    parser.add_argument("--poll-s", type=float, default=2.0,
                        help="checkpoint poll cadence")
    parser.add_argument(
        "--smoke", action="store_true",
        help="run the mixed-size smoke benchmark and print one JSON line",
    )
    parser.add_argument("--duration", type=float, default=3.0,
                        help="smoke duration (s)")
    parser.add_argument("--clients", type=int, default=4,
                        help="smoke client threads")
    parser.add_argument("--stochastic", action="store_true",
                        help="sample actions instead of the deterministic mode")
    parser.add_argument(
        "--scenario",
        help="perturb smoke request observations with this registered "
        "scenario's sensor-noise magnitudes",
    )
    parser.add_argument("--scenario-severity", type=float, default=1.0,
                        help="severity scale for --scenario (default 1.0)")
    parser.add_argument("--watch", action="store_true",
                        help="keep serving + hot-reloading until interrupted")
    parser.add_argument(
        "--obs-trace", choices=("on", "off"), default="on",
        help="the tracing spine: batch spans + trace-ID propagation",
    )
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
    parser.add_argument(
        "--fleet", action="store_true",
        help="serve a fleet of replicas behind one router, with a "
        "coordinated hot reload (serving/fleet/)",
    )
    parser.add_argument(
        "--replicas", type=int,
        help="with --fleet: replica count (default one a CUDA device; "
        "more than devices cycle over them)",
    )
    parser.add_argument(
        "--port", type=int,
        help="with --fleet: serve HTTP on this port (0: ephemeral)",
    )
    parser.add_argument(
        "--tenants", action="append",
        help="with --fleet: named model lanes as NAME=DIR pairs "
        "(comma-joined or repeated); each lane serves DIR's newest "
        "checkpoint and hot-reloads from DIR",
    )
    for flag, kind in UNPORTED_FLAGS.items():
        if kind == "store_true":
            parser.add_argument(flag, action="store_true",
                                help=argparse.SUPPRESS)
        else:
            parser.add_argument(flag, type=kind, help=argparse.SUPPRESS)
    return parser


def _refuse_unported(args: argparse.Namespace) -> None:
    for flag in UNPORTED_FLAGS:
        value = getattr(args, flag.lstrip("-").replace("-", "_"))
        if value is not None and value is not False:
            raise SystemExit(
                f"{flag} is not ported yet (ROADMAP A13: the sharded and "
                "bf16 rungs, the trace recorder and the serving benches); "
                "serve without it"
            )


def _init_policy(args, device):
    """A freshly initialized policy for ``--init-policy`` runs (seed 0)."""
    import torch

    from marl_distributedformation_tpu_torch.compat.policy import (
        POLICY_REGISTRY,
        LoadedPolicy,
    )

    if args.obs_dim is None:
        raise SystemExit("--init-policy requires --obs-dim")
    if args.init_policy not in POLICY_REGISTRY:
        raise SystemExit(
            f"unknown policy {args.init_policy!r}; known: "
            f"{sorted(POLICY_REGISTRY)}"
        )
    if args.init_policy == "GNNActorCritic":
        raise SystemExit(
            "--init-policy GNNActorCritic has no k to build with; serve a "
            "trained GNN checkpoint directory instead"
        )
    kwargs = {}
    if args.hidden:
        kwargs["hidden"] = tuple(int(w) for w in args.hidden.split(","))
    model = POLICY_REGISTRY[args.init_policy](
        obs_dim=args.obs_dim, act_dim=2,
        generator=torch.Generator().manual_seed(0), **kwargs,
    )
    return LoadedPolicy(model.to(device).eval(), num_agents=args.agents)


def _run_env_params(log_dir: Path):
    """The run's env params from the ``config.json`` the trainer writes
    beside its checkpoints, or None when there is none."""
    config = log_dir / "config.json"
    if not config.exists():
        return None
    from marl_distributedformation_tpu_torch.utils.config import (
        Config,
        env_params_from_config,
    )

    return env_params_from_config(Config(json.loads(config.read_text())))


def _infer_row_shape(policy) -> tuple:
    """Feature shape of one request row, as ``serve_policy.py`` infers it:
    per-formation policies (CTDE/GNN) take whole ``(agents, obs_dim)``
    formations and must be given both; a flat policy's first tower layer
    records the obs width."""
    if getattr(policy.model, "per_formation", False):
        raise SystemExit(
            f"policy {type(policy.model).__name__} serves whole "
            "formations: pass --obs-dim AND --agents to size a request "
            "row (row shape = (agents, obs_dim))"
        )
    layer = getattr(policy.model, "pi_0", None)
    if layer is None:
        raise SystemExit(
            "cannot infer --obs-dim from this checkpoint "
            f"(policy {type(policy.model).__name__}); pass --obs-dim"
        )
    return (int(layer.weight.shape[1]),)


def _run_fleet(args, device) -> int:
    """The ``--fleet`` path: router + coordinated reload + the optional
    HTTP frontend."""
    from marl_distributedformation_tpu_torch.serving.fleet import (
        FleetFrontend,
        FleetRouter,
        fleet_from_checkpoint_dir,
        run_fleet_smoke,
        warmup_fleet,
    )

    buckets = tuple(int(b) for b in args.buckets.split(","))
    # The CUDA default replicates over every card; an explicit device
    # (the CPU) hosts every replica.
    devices = None if args.device in (None, "cuda") else [device]
    logger = None
    coordinator = None
    common = dict(num_replicas=args.replicas, devices=devices,
                  buckets=buckets, window_ms=args.window_ms,
                  max_queue=args.queue)
    if args.init_policy:
        router = FleetRouter(_init_policy(args, device), **common)
    elif args.log_dir:
        from marl_distributedformation_tpu_torch.utils.logging import (
            MetricsLogger,
        )

        logger = MetricsLogger(Path(args.log_dir) / "serving",
                               run_name="fleet")
        router, coordinator = fleet_from_checkpoint_dir(
            args.log_dir, env_params=_run_env_params(Path(args.log_dir)),
            poll_interval_s=args.poll_s, device=device, logger=logger,
            **common,
        )
        print(
            f"[serve] fleet serving {type(router.policy.model).__name__} "
            f"from {args.log_dir} at step {coordinator.fleet_step}",
            file=sys.stderr,
        )
    else:
        raise SystemExit("need a log_dir or --init-policy (see --help)")
    policy = router.policy
    if args.obs_dim:
        row_shape = ((args.agents, args.obs_dim) if args.agents
                     else (args.obs_dim,))
    else:
        row_shape = _infer_row_shape(policy)
    print(
        f"[serve] fleet: {len(router.replicas)} replicas over "
        f"{len({str(r.device) for r in router.replicas})} devices, "
        f"buckets {args.buckets}",
        file=sys.stderr,
    )
    frontend = None
    try:
        # Every rung of every replica built (captured on the card) before
        # any traffic.
        warmup_fleet(router, row_shape)
        router.start()
        if coordinator is not None:
            coordinator.start()
        if args.port is not None:
            frontend = FleetFrontend(router, port=args.port).start()
            print(f"[serve] fleet frontend listening on {frontend.url}",
                  file=sys.stderr)
        if args.smoke or (args.port is None and not args.watch):
            report = run_fleet_smoke(
                router, row_shape=row_shape, duration_s=args.duration,
                num_clients=args.clients,
                deterministic=not args.stochastic, coordinator=coordinator,
                warmup=False,
            )
            report["buckets"] = ",".join(str(b) for b in buckets)
            report["replicas"] = float(len(router.replicas))
            report["device"] = str(device)
            print(json.dumps(report), flush=True)
            if report["client_requests_ok"] == 0:
                print("[serve] fleet smoke served 0 requests — failing",
                      file=sys.stderr)
                return 1
        else:
            print("[serve] fleet serving; Ctrl-C to stop", file=sys.stderr)
            while True:
                time.sleep(10.0)
                snap = router.snapshot()
                print(
                    f"[serve] step={snap['model_step']:.0f} "
                    f"healthy={snap['fleet_healthy_replicas']:.0f}/"
                    f"{len(router.replicas)} "
                    f"routed={snap['fleet_routed_total']:.0f} "
                    f"p95={snap['latency_p95_ms']:.1f}ms",
                    file=sys.stderr,
                )
    except KeyboardInterrupt:
        print("[serve] interrupted; shutting down", file=sys.stderr)
    finally:
        if frontend is not None:
            frontend.stop()
        if coordinator is not None:
            coordinator.stop()
        router.stop()
        if logger is not None:
            logger.close()
    return 0


def _parse_tenants(chunks) -> list:
    """``NAME=DIR`` pairs from repeated or comma-joined --tenants values."""
    lanes = []
    seen = set()
    for chunk in chunks:
        for item in chunk.split(","):
            item = item.strip()
            if not item:
                continue
            name, sep, directory = item.partition("=")
            if not sep or not name or not directory:
                raise SystemExit(
                    f"--tenants wants NAME=DIR pairs, got {item!r}"
                )
            if name in seen:
                raise SystemExit(f"--tenants declares {name!r} twice")
            seen.add(name)
            lanes.append((name, directory))
    if not lanes:
        raise SystemExit("--tenants got no NAME=DIR pairs")
    return lanes


def _lane_spec(name: str, lane_dir: str, agents):
    """The ``TenantSpec`` of one ``--tenants`` lane, its architecture read
    from the directory's newest checkpoint and, where there is one, its
    env params from its run's ``config.json`` (the directory's or its
    parent's: a ``promoted/`` directory sits inside its run's)."""
    from marl_distributedformation_tpu_torch.compat.policy import (
        infer_hidden,
        load_checkpoint_raw,
    )
    from marl_distributedformation_tpu_torch.envs import spec_for_params
    from marl_distributedformation_tpu_torch.serving.tenancy import (
        TenantSpec,
    )
    from marl_distributedformation_tpu_torch.utils.checkpoint import (
        latest_checkpoint,
    )

    path = latest_checkpoint(Path(lane_dir))
    if path is None:
        raise SystemExit(
            f"--tenants {name}={lane_dir}: no rl_model_*_steps"
            ".msgpack checkpoint there to serve"
        )
    raw = load_checkpoint_raw(path)
    policy_cls = raw.get("policy", "MLPActorCritic")
    hidden = infer_hidden(raw["params"]["params"], policy_cls)
    env, overrides = "formation", {}
    run_params = (_run_env_params(Path(lane_dir))
                  or _run_env_params(Path(lane_dir).parent))
    if run_params is not None:
        env = spec_for_params(run_params).name
        overrides = {f: getattr(run_params, f)
                     for f in ("obs_mode", "knn_k", "goal_in_obs")
                     if hasattr(run_params, f)}
        agents = agents or run_params.num_agents
    try:
        return TenantSpec(
            model_id=name,
            env=env,
            policy=policy_cls,
            hidden=tuple(hidden) if hidden else (64, 64),
            promoted_dir=str(lane_dir),
            num_agents=agents,
            env_overrides=overrides,
        )
    except ValueError as e:
        raise SystemExit(f"--tenants {name}: {e}") from e


def _run_tenants(args, device) -> int:
    """The --tenants serving path: named model lanes over ONE fleet
    (``serving/tenancy/``). Same-arch lanes land in one router group
    (shared captured rungs) and distinct archs get their own: the smoke's
    ``shared_rung_compiles`` census is the receipt."""
    from marl_distributedformation_tpu_torch.serving.fleet import (
        FleetFrontend,
    )
    from marl_distributedformation_tpu_torch.serving.tenancy import (
        TenantDirectory,
        run_tenant_smoke,
        tenant_fleet_from_directory,
    )

    pairs = _parse_tenants(args.tenants)
    buckets = tuple(int(b) for b in args.buckets.split(","))
    directory = TenantDirectory(
        _lane_spec(name, lane_dir, args.agents) for name, lane_dir in pairs)
    fleet = tenant_fleet_from_directory(
        directory,
        poll_interval_s=args.poll_s,
        device=device,
        num_replicas=args.replicas,
        devices=None if args.device in (None, "cuda") else [device],
        buckets=buckets,
        window_ms=args.window_ms,
        max_queue=args.queue,
        watch=True,
    )
    groups = directory.arch_groups()
    print(
        f"[serve] tenant fleet: {len(directory)} lanes in "
        f"{len(groups)} arch group(s) — "
        + "; ".join(
            f"{arch}: {', '.join(s.model_id for s in specs)}"
            for arch, specs in groups.items()
        ),
        file=sys.stderr,
    )
    frontend = None
    try:
        # Every rung of every group built (captured on the card) before
        # any traffic.
        fleet.warmup()
        fleet.start()
        if args.port is not None:
            # The frontend speaks the tenant fleet's surface: submits
            # carry model_id, /v1/metrics reports per-lane gauges.
            frontend = FleetFrontend(fleet, port=args.port).start()
            print(f"[serve] tenant frontend listening on {frontend.url}",
                  file=sys.stderr)
        if args.smoke or (args.port is None and not args.watch):
            report = run_tenant_smoke(
                fleet,
                duration_s=args.duration,
                clients_per_lane=max(1, args.clients // len(pairs)),
                deterministic=not args.stochastic,
                warmup=False,
            )
            report["buckets"] = ",".join(str(b) for b in buckets)
            report["device"] = str(device)
            print(json.dumps(report), flush=True)
            starved = [name for name, _ in pairs
                       if report[f"model_{name}__requests_ok"] == 0]
            wiggled = [name for name, _ in pairs
                       if report[f"model_{name}__step_monotonic_violations"]
                       > 0]
            if starved or wiggled:
                print(
                    f"[serve] tenant smoke failing — lanes served 0: "
                    f"{starved}; lanes non-monotonic: {wiggled}",
                    file=sys.stderr,
                )
                return 1
        else:
            print("[serve] tenant fleet serving; Ctrl-C to stop",
                  file=sys.stderr)
            while True:
                time.sleep(10.0)
                steps = fleet.lane_steps()
                print(
                    "[serve] "
                    + " ".join(f"{mid}@{step}"
                               for mid, step in sorted(steps.items()))
                    + f" healthy={fleet.healthy_replicas}/"
                    f"{len(fleet.replicas)}",
                    file=sys.stderr,
                )
    except KeyboardInterrupt:
        print("[serve] interrupted; shutting down", file=sys.stderr)
    finally:
        if frontend is not None:
            frontend.stop()
        fleet.stop()
    return 0


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    _refuse_unported(args)
    if args.tenants:
        if not args.fleet:
            raise SystemExit("--tenants requires --fleet")
        if args.log_dir or args.init_policy:
            raise SystemExit(
                "--tenants names each lane's checkpoint dir itself; drop "
                "the positional log_dir / --init-policy"
            )
        if args.scenario:
            raise SystemExit(
                "--tenants does not combine with --scenario (each lane "
                "serves its own env's rows)"
            )
    if (args.port is not None or args.replicas is not None) \
            and not args.fleet:
        raise SystemExit("--port/--replicas require --fleet")
    if args.fleet and args.scenario:
        raise SystemExit(
            "--scenario perturbs the single-engine smoke only; run it "
            "without --fleet"
        )

    from marl_distributedformation_tpu_torch import obs
    from marl_distributedformation_tpu_torch.device import resolve_device

    obs.configure(enabled=args.obs_trace == "on")
    if args.scenario:
        # Resolve against the registry before loading anything: a typo'd
        # name exits naming the valid entries.
        from marl_distributedformation_tpu_torch.scenarios import (
            get_scenario,
        )

        try:
            get_scenario(args.scenario)
        except ValueError as e:
            raise SystemExit(str(e)) from e
    device = resolve_device(args.device)
    if args.tenants:
        return _run_tenants(args, device)
    if args.fleet:
        return _run_fleet(args, device)

    from marl_distributedformation_tpu_torch.serving import (
        BucketedPolicyEngine,
        MicroBatchScheduler,
        ModelRegistry,
        run_smoke_benchmark,
    )

    registry = None
    if args.init_policy:
        policy = _init_policy(args, device)
    elif args.log_dir:
        registry = ModelRegistry(
            args.log_dir, poll_interval_s=args.poll_s, device=device,
            env_params=_run_env_params(Path(args.log_dir)),
        )
        policy = registry.policy
        print(
            f"[serve] serving {type(policy.model).__name__} from "
            f"{args.log_dir} at step {registry.active_step} on {device}",
            file=sys.stderr,
        )
    else:
        raise SystemExit("need a log_dir or --init-policy (see --help)")

    if args.obs_dim:
        row_shape = ((args.agents, args.obs_dim) if args.agents
                     else (args.obs_dim,))
    else:
        row_shape = _infer_row_shape(policy)
    buckets = tuple(int(b) for b in args.buckets.split(","))
    engine = BucketedPolicyEngine(policy, buckets=buckets)

    logger = None
    if args.log_dir:
        from marl_distributedformation_tpu_torch.utils.logging import (
            MetricsLogger,
        )

        logger = MetricsLogger(Path(args.log_dir) / "serving",
                               run_name="serving")
    scheduler = MicroBatchScheduler(
        engine, registry=registry, max_queue=args.queue,
        window_ms=args.window_ms, logger=logger,
    )
    if registry is not None:
        registry.start()
    try:
        with scheduler:
            if args.smoke or not args.watch:
                report = run_smoke_benchmark(
                    scheduler, row_shape=row_shape,
                    duration_s=args.duration, num_clients=args.clients,
                    deterministic=not args.stochastic, registry=registry,
                    scenario=args.scenario,
                    scenario_severity=args.scenario_severity,
                )
                report["buckets"] = ",".join(str(b) for b in buckets)
                report["device"] = str(device)
                print(json.dumps(report), flush=True)
                if report["client_requests_ok"] == 0:
                    # A smoke run that served nothing is a failure, not a
                    # report (e.g. a row shape the model rejects).
                    print("[serve] smoke served 0 requests — failing",
                          file=sys.stderr)
                    return 1
            else:
                print("[serve] watching for checkpoints; Ctrl-C to stop",
                      file=sys.stderr)
                while True:
                    time.sleep(10.0)
                    snap = scheduler.metrics.snapshot()
                    print(
                        f"[serve] step="
                        f"{registry.active_step if registry else 0} "
                        f"requests={snap['requests']:.0f} "
                        f"occupancy={snap['batch_occupancy_pct']:.1f}% "
                        f"p95={snap['latency_p95_ms']:.1f}ms",
                        file=sys.stderr,
                    )
    except KeyboardInterrupt:
        print("[serve] interrupted; shutting down", file=sys.stderr)
    finally:
        if registry is not None:
            registry.stop()
        if logger is not None:
            logger.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
