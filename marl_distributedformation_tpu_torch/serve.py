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

    # a fleet plus a slice-backed big-rung replica (serving/sharded.py),
    # bf16 rungs, and the offered arrivals recorded as a replayable trace
    python -m marl_distributedformation_tpu_torch.serve logs/run1 --fleet \\
        --sharded --mesh-devices 2 --bf16 --record-trace trace.jsonl

    # the serving benches (one JSON line each): replicated vs sharded vs
    # bf16 under one open-loop trace, and elastic vs static capacity
    python -m marl_distributedformation_tpu_torch.serve --init-policy \\
        MLPActorCritic --obs-dim 8 --slo-bench --replicas 2
    python -m marl_distributedformation_tpu_torch.serve --init-policy \\
        MLPActorCritic --obs-dim 8 --hidden 64,64 --elastic-bench \\
        --replicas 2 --load-rps 120

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
JSON line.

``--sharded`` adds one slice-backed big-rung replica whose ``dp`` row
blocks (``--mesh-devices``, default the replica count) cycle over the
fleet's devices: on one card ``--mesh-devices 2`` is two row blocks on
``cuda:0``, time-sharing it. The benches (``--slo-bench``,
``--elastic-bench``) build their fleets on ``--replicas`` (and
``--mesh-devices``) device slots of ``--device`` in the same way; their
numbers on one card are time-sharing, not scaling.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import tempfile
import time
from pathlib import Path


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
    parser.add_argument(
        "--sharded", action="store_true",
        help="with --fleet: add the slice-backed big-rung replica "
        "(serving/sharded.py: partition-rule parameters over a dp slice "
        "of row blocks cycling over the fleet's devices; big requests "
        "route there)",
    )
    parser.add_argument(
        "--bf16", action="store_true",
        help="with --sharded: serve the sharded rungs in bfloat16 (opt-in; "
        "divergence bounded by tests/bf16_budget.py)",
    )
    parser.add_argument(
        "--mesh-devices", type=int,
        help="dp width of the sharded slice (default: the fleet replica "
        "count); on one card N row blocks on cuda:0",
    )
    parser.add_argument(
        "--record-trace", metavar="PATH",
        help="with --fleet: record every offered request arrival (rows, "
        "SLO class, inter-arrival gap, captured before admission control) "
        "and dump replayable loadgen JSONL here on shutdown",
    )
    parser.add_argument(
        "--elastic-bench", action="store_true",
        help="run the elastic-vs-static capacity bench: a shifting-mix "
        "trace against a frozen first-half-tuned fleet and a "
        "CapacityController-managed one, both measured on the storm "
        "half; one JSON line",
    )
    parser.add_argument(
        "--slo-bench", action="store_true",
        help="run the SLO-driven serving bench: replicated vs sharded vs "
        "bf16 under the same open-loop load trace, then bisect for req/s "
        "at the p95 target; one JSON line",
    )
    parser.add_argument("--slo-p95-ms", type=float, default=50.0,
                        help="p95 latency target of the benches (50 ms)")
    parser.add_argument("--slo-iterations", type=int, default=5,
                        help="rate-bisection steps of the benches (5)")
    parser.add_argument(
        "--slo-passes", type=int, default=4,
        help="interleaved replay passes a config for --slo-bench; each "
        "config reports its best pass (default 4, extended while any "
        "config's floor still improves)",
    )
    parser.add_argument("--load-rps", type=float, default=300.0,
                        help="base offered rate of the benches' traces")
    parser.add_argument(
        "--big-rung", type=int, default=512,
        help="the rung the sharded-vs-replicated p95 comparison tracks",
    )
    return parser


def _bench_policy(args, device):
    """The benches' policy: ``--init-policy``'s, or the newest checkpoint
    of ``log_dir``."""
    if args.init_policy:
        return _init_policy(args, device)
    from marl_distributedformation_tpu_torch.compat.policy import (
        LoadedPolicy,
    )
    from marl_distributedformation_tpu_torch.utils.checkpoint import (
        latest_checkpoint,
    )

    if not args.log_dir:
        raise SystemExit("need a log_dir or --init-policy (see --help)")
    path = latest_checkpoint(Path(args.log_dir))
    if path is None:
        raise SystemExit(f"no checkpoint under {args.log_dir}")
    return LoadedPolicy.from_checkpoint(
        path, env_params=_run_env_params(Path(args.log_dir)), device=device)


def _row_shape(args, policy) -> tuple:
    """A request row's shape: ``(agents, obs_dim)``, ``(obs_dim,)``, or
    inferred from a flat policy."""
    if args.obs_dim:
        return ((args.agents, args.obs_dim) if args.agents
                else (args.obs_dim,))
    return _infer_row_shape(policy)


def _run_slo_bench(args, device) -> int:
    """The SLO-driven serving bench, one JSON line: three fleets driven by
    the SAME open-loop request trace (``serving/loadgen.py``):

    1. replicated only;
    2. + an f32 sharded big-rung slice (``serving/sharded.py``);
    3. + a bf16 sharded slice, which also runs the bisection for
       ``req_per_sec_at_p95_slo``.

    As the JAX script's: thread-matched fleets (a sharded config spends one
    replica on the slice, so every fleet runs ``--replicas`` scheduler
    threads), a dedicated big-rung lane (the slice serves only
    ``--big-rung``, its window 0), and interleaved best-of-N passes
    against long-lived warmed fleets. The fleets' device slots are
    ``max(--replicas, --mesh-devices)`` slots of ``device``: on one card
    every number is time-sharing ``cuda:0``, not scaling."""
    from marl_distributedformation_tpu_torch.serving import (
        ShardedSpec,
        max_rate_at_slo,
        run_load,
        synthetic_trace,
    )
    from marl_distributedformation_tpu_torch.serving.autotune import (
        autotune_ladder,
    )
    from marl_distributedformation_tpu_torch.serving.fleet import (
        FleetRouter,
        warmup_fleet,
    )

    replicas = args.replicas or 2
    mesh_devices = args.mesh_devices or replicas
    devices = [device] * max(replicas, mesh_devices)
    policy = _bench_policy(args, device)
    row_shape = _row_shape(args, policy)
    buckets = tuple(int(b) for b in args.buckets.split(","))
    big = args.big_rung
    if big not in buckets:
        raise SystemExit(
            f"--big-rung {big} must be one of the ladder rungs {buckets}"
        )
    # The slice serves the big rung only (the earned-ladder lane shape).
    # Big rungs are ~20% of requests, so the mixed stream queues the
    # replicated lanes.
    sharded_buckets = (big,)
    size_mix = ((1, 0.4), (8, 0.2), (64, 0.2), (big, 0.2))
    trace = synthetic_trace(args.duration, args.load_rps, seed=7,
                            size_mix=size_mix)

    def _fleet(sharded):
        # Thread-matched: the slice replaces one replicated replica.
        n = replicas if sharded is None else max(1, replicas - 1)
        return FleetRouter(policy, devices=devices, num_replicas=n,
                           buckets=buckets, window_ms=args.window_ms,
                           max_queue=args.queue, sharded=sharded)

    def _spec(dtype=None):
        # window_ms=0: the dedicated lane's requests fill the rung on
        # arrival, so there is nothing to coalesce.
        return ShardedSpec(axis_sizes={"dp": mesh_devices},
                           buckets=sharded_buckets, min_rows=big,
                           dtype=dtype, window_ms=0.0)

    report = {
        "slo_p95_target_ms": float(args.slo_p95_ms),
        "replicas": replicas,
        "mesh_devices": mesh_devices,
        "buckets": ",".join(str(b) for b in buckets),
        "big_rung": big,
        "passes": args.slo_passes,
    }
    max_compiles = 0

    def _best(key, value):
        """Fold one pass's p95 into the config's best (an empty pass
        reports 0.0 and is ignored)."""
        if value <= 0:
            return
        prev = report.get(key)
        report[key] = value if prev is None or prev <= 0 else min(prev,
                                                                  value)

    configs = [("replicated", None), ("sharded", _spec()),
               ("bf16", _spec("bfloat16"))]
    settle = synthetic_trace(min(1.0, args.duration), args.load_rps,
                             seed=11, size_mix=size_mix)
    with contextlib.ExitStack() as stack:
        routers = {}
        for label, spec in configs:
            router = _fleet(spec)
            # Every rung of every replica built before traffic, then the
            # schedulers start.
            warmup_fleet(router, row_shape)
            routers[label] = stack.enter_context(router)
        # One unrecorded settle replay a fleet: a fresh process's first
        # replays run well over the steady floor.
        for label, _ in configs:
            run_load(routers[label], settle, row_shape, seed=11)
        # Fixed passes, then more while any config's best p95 still
        # improved >10% in the last round, up to 4 extra rounds.
        rounds = 0
        while rounds < max(1, args.slo_passes) + 4:
            i = rounds
            before = {label: report.get(f"{label}_{big}_p95_ms", 0.0)
                      for label, _ in configs}
            for label, _ in configs[i % 3:] + configs[:i % 3]:
                rep = run_load(routers[label], trace, row_shape, seed=7)
                _best(f"{label}_{big}_p95_ms",
                      rep.per_size_p95_ms.get(big, 0.0))
                _best(f"{label}_p95_ms", rep.p95_ms)
            rounds += 1
            if rounds >= max(1, args.slo_passes):
                if all(before[label] > 0
                       and report[f"{label}_{big}_p95_ms"]
                       > 0.9 * before[label] for label, _ in configs):
                    break
        report["passes"] = rounds
        for key in list(report):
            if key.endswith("_p95_ms"):
                report[key] = float(report[key])
        for label, _ in configs:
            report.setdefault(f"{label}_{big}_p95_ms", 0.0)
        f32_p95 = report[f"sharded_{big}_p95_ms"]
        bf16_p95 = report[f"bf16_{big}_p95_ms"]
        report["bf16_speedup_pct"] = (
            100.0 * (f32_p95 / bf16_p95 - 1.0) if bf16_p95 > 0 else 0.0)
        # The capacity number: the highest sustained open-loop rate that
        # holds the p95 target, on the full config (slice + bf16 rungs).
        best, probes = max_rate_at_slo(
            routers["bf16"], row_shape, p95_target_ms=args.slo_p95_ms,
            lo_rps=args.load_rps / 2, hi_rps=args.load_rps * 8,
            probe_duration_s=min(1.0, args.duration),
            iterations=args.slo_iterations, seed=7, size_mix=size_mix,
            batch_fraction=0.1, probe_retries=2,
        )
        preempted = sum(r.scheduler.metrics.preempted_total
                        for r in routers["bf16"].replicas)
        for router in routers.values():
            for counts in router.compile_counts().values():
                max_compiles = max(max_compiles, *counts.values())
    report["req_per_sec_at_p95_slo"] = best
    report["slo_probes"] = len(probes)
    report["max_compiles_per_rung"] = max_compiles
    report["batch_preempted_total"] = preempted
    plan = autotune_ladder(trace, p95_target_ms=args.slo_p95_ms,
                           mesh_divisor=mesh_devices,
                           sharded_min_rows=min(sharded_buckets))
    report["autotuned"] = plan.to_dict()
    report["device"] = str(device)
    print(json.dumps(report), flush=True)
    if report[f"sharded_{big}_p95_ms"] <= 0:
        print("[serve] slo bench measured no big-rung completions — failing",
              file=sys.stderr)
        return 1
    return 0


def _run_elastic_bench(args, device) -> int:
    """The elastic-vs-static capacity bench, one JSON line: a shifting-mix
    day (interactive-heavy first half, big-rung storm second half) against
    two fleets on ``--replicas`` device slots of ``device``:

    - **static**: split and ladder autotuned on the FIRST half, then
      frozen (what a pre-traffic tuner ships);
    - **elastic**: boots the same, but a ``CapacityController`` watches
      the live ``TraceRecorder`` and re-splits at the fleet batch barrier
      when the mix shifts (prewarm-then-commit; the serving interruption
      is ``elastic_resplit_pause_ms``, the barrier pause alone).

    Both are measured on the storm half with the same rate bisection;
    budget-1 receipts and a ledger census diff (no program registered
    during the measured storm) ride the report. On one card every number
    is time-sharing ``cuda:0``, not scaling."""
    from marl_distributedformation_tpu_torch.obs.ledger import get_ledger
    from marl_distributedformation_tpu_torch.serving import (
        CapacityController,
        TraceRecorder,
        max_rate_at_slo,
        run_load,
        synthetic_trace,
    )
    from marl_distributedformation_tpu_torch.serving.autotune import (
        autotune_ladder,
    )
    from marl_distributedformation_tpu_torch.serving.fleet import (
        FleetReloadCoordinator,
        FleetRouter,
        warmup_fleet,
    )

    replicas = args.replicas or 2
    if not args.init_policy:
        raise SystemExit("--elastic-bench wants --init-policy + --obs-dim")
    policy = _init_policy(args, device)
    devices = [device] * replicas
    row_shape = (args.obs_dim,)
    duration = args.duration
    interactive_mix = ((1, 0.5), (2, 0.2), (4, 0.2), (8, 0.1))
    storm_mix = ((64, 0.35), (128, 0.3), (256, 0.35))
    storm_rps = max(4.0, args.load_rps / 6.0)
    interactive = synthetic_trace(duration, args.load_rps, seed=7,
                                  size_mix=interactive_mix)
    storm = synthetic_trace(duration, storm_rps, seed=9, size_mix=storm_mix)
    # The split a pre-traffic tuner ships: autotuned on the first half,
    # then frozen. The storm never informs it.
    first_half_plan = autotune_ladder(interactive,
                                      p95_target_ms=args.slo_p95_ms)
    boot_buckets = first_half_plan.buckets
    report = {
        "replicas": replicas,
        "slo_p95_target_ms": float(args.slo_p95_ms),
        "boot_buckets": ",".join(str(b) for b in boot_buckets),
        "interactive_rps": float(args.load_rps),
        "storm_rps": float(storm_rps),
    }

    def _measure_storm(router, seed):
        rep = run_load(router, storm, row_shape, seed=seed)
        best, _ = max_rate_at_slo(
            router, row_shape, p95_target_ms=args.slo_p95_ms,
            lo_rps=storm_rps / 2, hi_rps=storm_rps * 8,
            probe_duration_s=min(1.0, duration),
            iterations=args.slo_iterations, seed=seed, size_mix=storm_mix,
            probe_retries=2,
        )
        return rep.p95_ms, best

    with contextlib.ExitStack() as stack:
        kw = dict(devices=devices, num_replicas=replicas,
                  buckets=boot_buckets, window_ms=first_half_plan.window_ms,
                  max_queue=args.queue)
        static = FleetRouter(policy, **kw)
        recorder = TraceRecorder()
        elastic = FleetRouter(policy, trace_recorder=recorder, **kw)
        warmup_fleet(static, row_shape)
        warmup_fleet(elastic, row_shape)
        stack.enter_context(static)
        stack.enter_context(elastic)
        with tempfile.TemporaryDirectory() as empty_dir:
            coordinator = FleetReloadCoordinator(empty_dir, elastic)
            controller = CapacityController(
                elastic, coordinator, row_shape=row_shape,
                p95_target_ms=args.slo_p95_ms, min_requests=32,
            )
            # First half: both fleets serve the interactive mix.
            run_load(static, interactive, row_shape, seed=11)
            rep_i = run_load(elastic, interactive, row_shape, seed=11)
            report["elastic_interactive_p95_ms"] = rep_i.p95_ms
            controller.step()  # may retune windows; interactive-earned
            # The mix shifts: storm traffic reaches the elastic fleet and
            # the controller re-splits, prewarm-then-commit. The static
            # fleet serves the same storm on its frozen split.
            run_load(elastic, storm, row_shape, seed=13)
            resplit = controller.step()
            if resplit is None or not resplit.get("committed"):
                print(f"[serve] elastic bench: storm re-split did not "
                      f"commit ({resplit}) — failing", file=sys.stderr)
                return 1
            # The measured storm: the census diff shows no build rides it.
            programs_before = len(get_ledger().entries())
            static_p95, static_rate = _measure_storm(static, seed=13)
            elastic_p95, elastic_rate = _measure_storm(elastic, seed=13)
            report["elastic_storm_new_programs"] = (
                len(get_ledger().entries()) - programs_before)
            snap = controller.snapshot()
            report["static_storm_p95_ms"] = static_p95
            report["elastic_storm_p95_ms"] = elastic_p95
            report["req_per_sec_at_p95_slo_static"] = static_rate
            report["req_per_sec_at_p95_slo_elastic"] = elastic_rate
            report["elastic_resplit_pause_ms"] = snap["elastic_last_pause_ms"]
            report["elastic_resplits_committed"] = snap[
                "elastic_resplits_committed"]
            report["elastic_prewarm_compiles"] = snap[
                "elastic_prewarm_compiles_total"]
            report["elastic_buckets"] = ",".join(
                str(b) for b in resplit["decision"]["replicated_buckets"]
                + resplit["decision"]["sharded_buckets"])
            max_compiles = 0
            for router in (static, elastic):
                for counts in router.compile_counts().values():
                    if counts:
                        max_compiles = max(max_compiles, *counts.values())
            report["max_compiles_per_rung"] = max_compiles
    report["device"] = str(device)
    print(json.dumps(report), flush=True)
    if report["req_per_sec_at_p95_slo_elastic"] <= 0:
        print("[serve] elastic bench: elastic fleet sustained no rate at "
              "the p95 target — failing", file=sys.stderr)
        return 1
    return 0


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
    sharded = None
    if args.sharded:
        from marl_distributedformation_tpu_torch.serving import ShardedSpec

        import torch

        width = args.mesh_devices or args.replicas or (
            len(devices) if devices else torch.cuda.device_count())
        sharded = ShardedSpec(axis_sizes={"dp": width},
                              dtype="bfloat16" if args.bf16 else None)
    recorder = None
    if args.record_trace:
        from marl_distributedformation_tpu_torch.serving import TraceRecorder

        recorder = TraceRecorder()
    logger = None
    coordinator = None
    common = dict(num_replicas=args.replicas, devices=devices,
                  buckets=buckets, window_ms=args.window_ms,
                  max_queue=args.queue, sharded=sharded,
                  trace_recorder=recorder)
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
    row_shape = _row_shape(args, router.policy)
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
        if recorder is not None:
            # Replayable loadgen JSONL (serving.loadgen.load_trace): feed
            # it back through run_load or autotune_ladder.
            if recorder.save(args.record_trace):
                print(f"[serve] recorded {recorder.recorded_total} arrivals "
                      f"-> {args.record_trace}", file=sys.stderr)
            else:
                print("[serve] --record-trace saw <2 arrivals; nothing to "
                      "save", file=sys.stderr)
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


def _check_flags(args) -> None:
    """The serving modes' refusals, in the JAX script's words (the benches
    build their own fleets and skip them)."""
    if (args.port is not None or args.replicas is not None) \
            and not args.fleet:
        raise SystemExit("--port/--replicas require --fleet")
    if args.record_trace and not args.fleet:
        raise SystemExit("--record-trace requires --fleet")
    if args.record_trace and args.tenants:
        raise SystemExit(
            "--record-trace records one fleet's offered stream; it "
            "does not combine with --tenants yet"
        )
    if (args.sharded or args.bf16) and not args.fleet:
        raise SystemExit("--sharded/--bf16 require --fleet")
    if args.bf16 and not args.sharded:
        raise SystemExit("--bf16 requires --sharded")
    if args.tenants:
        if not args.fleet:
            raise SystemExit("--tenants requires --fleet")
        if args.log_dir or args.init_policy:
            raise SystemExit(
                "--tenants names each lane's checkpoint dir itself; drop "
                "the positional log_dir / --init-policy"
            )
        if args.sharded or args.scenario:
            raise SystemExit(
                "--tenants does not combine with --sharded/--scenario "
                "yet (lanes + sharded big-rung is an open item)"
            )
    if args.fleet and args.scenario:
        raise SystemExit(
            "--scenario perturbs the single-engine smoke only; run it "
            "without --fleet"
        )


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    if not (args.slo_bench or args.elastic_bench):
        _check_flags(args)

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
    if args.slo_bench:
        return _run_slo_bench(args, device)
    if args.elastic_bench:
        return _run_elastic_bench(args, device)
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

    row_shape = _row_shape(args, policy)
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
