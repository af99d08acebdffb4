"""Mesh host process: one fleet + frontend + agent, loopback-spawnable.

Counterpart of the JAX package's ``serving/mesh/host.py``.
``python -m marl_distributedformation_tpu_torch.serving.mesh.host`` boots
the full per-host serving stack (``FleetRouter`` with ``--replicas``
replicas on ``--device``, ``FleetFrontend`` on the data port, ``HostAgent``
on the control port) from a promoted-checkpoint directory, registers with
the coordinator, and serves until killed. This is the unit the loopback
mesh (``serving/mesh/loopback.py``) and the chaos storm's ``--mesh``
campaign spawn as real OS processes: ``kill -9`` of one of these is a
REAL host death, not a ``SimulatedCrash``.

``--device`` defaults to ``cuda`` and raises without a card; ``--device
cpu`` runs on the CPU. Every rung of every replica is built (captured on
the card) before the ready line. A run directory's env params come from
its ``config.json`` (the promoted directory's or its parent's, as the
serve CLI reads them: a GNN's ``knn_k``); ``--num-agents`` sets the
formation width. A policy on k-NN observations answers one batch of real
rows before the ready line: its env's observations at the largest rung,
built on the host's device (``knn_fused`` on the card), whose launches the
host counts and reports as ``knn_fused_launches`` in its metrics and its
ready line (the served GNN itself reads its neighbors from the rows and
launches no kernel; a parent cannot profile a subprocess's kernels).

The process prints exactly ONE JSON line on stdout when ready::

    {"ready": true, "host_id": ..., "data_url": ..., "control_url": ...,
     "pid": ..., "step": ...}

plus the port's ``device``, ``kernels_prebuilt`` (the k-NN library was
built before this host started) and ``knn_fused_launches``, and nothing
else (logs go to stderr), so a parent can parse the ports it bound
ephemerally. ``--fault-spec`` arms the process-local chaos plane with an
explicit JSON fault list: how a barrier test makes THIS host (and only
this host) misbehave deterministically.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import threading
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple


class CountedRouter:
    """A host's router whose ``snapshot()`` (the host's ``/v1/metrics``
    JSON and its heartbeat's gossip) also carries the k-NN kernels'
    launches the host made, ``{name}_launches``. Everything else is the
    router's."""

    def __init__(self, router: Any, launches: Dict[str, int]) -> None:
        self._router = router
        self.launches = launches

    def __getattr__(self, name: str) -> Any:
        return getattr(self._router, name)

    def snapshot(self) -> Dict[str, float]:
        snap = self._router.snapshot()
        snap.update({f"{k}_launches": float(v)
                     for k, v in self.launches.items()})
        return snap


def run_env_params(promoted_dir: str | Path,
                   num_agents: Optional[int] = None) -> Any:
    """The served run's env params: its ``config.json`` in the promoted
    directory or its parent (a ``promoted/`` directory sits inside its
    run's), with ``num_agents`` when given; ``EnvParams(num_agents=...)``
    without a config; None with neither."""
    from marl_distributedformation_tpu_torch.env import EnvParams
    from marl_distributedformation_tpu_torch.utils.config import (
        Config,
        env_params_from_config,
    )

    for d in (Path(promoted_dir), Path(promoted_dir).parent):
        config = d / "config.json"
        if config.exists():
            env = env_params_from_config(
                Config(json.loads(config.read_text())))
            if num_agents is not None:
                env = env.replace(num_agents=int(num_agents))
            return env
    return None if num_agents is None else EnvParams(num_agents=num_agents)


def write_run_config(run_dir: str | Path, env_params: Any) -> Path:
    """``run_dir/config.json`` holding ``env_params`` in the train CLI's
    keys (what :func:`run_env_params` reads), for a run directory that
    the train CLI did not write."""
    import dataclasses

    config = {f.name: getattr(env_params, f.name)
              for f in dataclasses.fields(env_params)}
    config["num_agents_per_formation"] = config.pop("num_agents")
    path = Path(run_dir) / "config.json"
    path.write_text(json.dumps(config))
    return path


def probe_rows(env_params: Any, count: int, device: Any,
               seed: int = 0) -> Any:
    """``count`` formations' observations from the env's reset, built on
    ``device`` (k-NN observations through ``knn_fused`` on the card), as
    a numpy request of whole formations."""
    import torch

    from marl_distributedformation_tpu_torch.envs import spec_for_params

    spec = spec_for_params(env_params)
    gen = torch.Generator(device=device).manual_seed(seed)
    state = spec.reset_batch(env_params, count, gen, device)
    return spec.obs(state, env_params).cpu().numpy()


def start_host_stack(
    promoted_dir: str | Path,
    coordinator_url: str,
    host_id: str,
    env_params: Any = None,
    obs_dim: Optional[int] = None,
    act_dim: int = 2,
    replicas: int = 1,
    buckets: Sequence[int] = (1, 8),
    heartbeat_s: float = 0.25,
    window_ms: float = 2.0,
    device: Any = "cuda",
    port: int = 0,
    control_port: int = 0,
) -> Tuple[Any, Any, Any, Any]:
    """The host stack, started: ``(router, fleet, frontend, agent)``, the
    router a :class:`CountedRouter`. Every rung of every replica is built
    before the schedulers start; a policy on k-NN observations then
    answers one batch of its env's rows at the largest rung, its kernel
    launches counted on this thread. The caller owns teardown (agent,
    frontend, router)."""
    import numpy as np

    from marl_distributedformation_tpu_torch.device import resolve_device
    from marl_distributedformation_tpu_torch.ops import knn_cuda
    from marl_distributedformation_tpu_torch.serving.fleet import (
        FleetFrontend,
        fleet_from_checkpoint_dir,
        warmup_fleet,
    )
    from marl_distributedformation_tpu_torch.serving.mesh.agent import (
        HostAgent,
    )

    device = resolve_device(device)
    if device.type == "cuda":
        knn_cuda._lib()  # a library that does not load fails the host
    router, fleet = fleet_from_checkpoint_dir(
        promoted_dir,
        env_params=env_params,
        act_dim=act_dim,
        num_replicas=replicas,
        buckets=tuple(int(b) for b in buckets),
        window_ms=window_ms,
        device=device,
    )
    # The MESH coordinator drives every reload through the agent's staged
    # two-phase RPCs: the local directory watcher stays off, or host-local
    # polls would race the global barrier.
    if obs_dim is None:
        obs_dim = env_params.obs_dim
    per_formation = getattr(router.policy.model, "per_formation", False)
    row_shape = ((env_params.num_agents, obs_dim) if per_formation
                 else (obs_dim,))
    warmup_fleet(router, row_shape)
    router.start()
    launches: Dict[str, int] = {}
    with knn_cuda.counted_for(launches):
        if (per_formation and env_params is not None
                and getattr(env_params, "obs_mode", "ring") == "knn"):
            rows = probe_rows(env_params, int(max(buckets)), device)
            result = router.submit(rows).result(timeout=60.0)
            if not np.isfinite(result.actions).all():
                router.stop()
                raise RuntimeError(
                    f"mesh host {host_id}: non-finite actions on its "
                    "probe rows")
    counted = CountedRouter(router, launches)
    frontend = FleetFrontend(counted, port=port).start()
    agent = HostAgent(
        host_id=host_id,
        router=counted,
        fleet=fleet,
        coordinator_url=coordinator_url,
        data_url=frontend.url,
        control_port=control_port,
        heartbeat_interval_s=heartbeat_s,
    ).start()
    return counted, fleet, frontend, agent


def _arm_faults(spec_json: str, host_id: str) -> None:
    from marl_distributedformation_tpu_torch.chaos import (
        FaultSchedule,
        FaultSpec,
        get_fault_plane,
    )

    specs = [
        FaultSpec(
            point=str(s["point"]),
            kind=str(s["kind"]),
            at_hit=int(s.get("at_hit", 1)),
            seconds=float(s.get("seconds", 0.0)),
        )
        for s in json.loads(spec_json)
    ]
    plane = get_fault_plane()
    plane.arm(FaultSchedule(specs))
    plane.enabled = True
    print(f"[mesh-host {host_id}] chaos armed: {len(specs)} fault(s)",
          file=sys.stderr)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument(
        "--promoted-dir", required=True,
        help="coordinator-watched checkpoint directory to serve from",
    )
    ap.add_argument("--coordinator-url", required=True)
    ap.add_argument("--host-id", required=True)
    ap.add_argument("--replicas", type=int, default=1)
    ap.add_argument("--buckets", default="1,8")
    ap.add_argument("--obs-dim", type=int, default=None)
    ap.add_argument("--act-dim", type=int, default=2)
    ap.add_argument(
        "--num-agents", type=int, default=None,
        help="the formation width of a per-formation policy (its env "
        "params otherwise come from the run's config.json)",
    )
    ap.add_argument("--port", type=int, default=0, help="data port")
    ap.add_argument("--control-port", type=int, default=0)
    ap.add_argument("--heartbeat-s", type=float, default=0.25)
    ap.add_argument("--window-ms", type=float, default=2.0)
    ap.add_argument(
        "--device", default="cuda",
        help="the device every replica serves on (cuda raises without a "
        "card; cpu runs on the CPU)",
    )
    ap.add_argument(
        "--fault-spec", default=None,
        help="JSON list of {point, kind, at_hit, seconds} to arm on "
        "THIS host's chaos plane (deterministic misbehavior for the "
        "barrier tests)",
    )
    args = ap.parse_args(argv)

    from marl_distributedformation_tpu_torch.ops import _build, knn_cuda

    prebuilt = _build.library_path(knn_cuda.SOURCE).exists()
    env_params = run_env_params(args.promoted_dir, args.num_agents)
    obs_dim = args.obs_dim if env_params is None else env_params.obs_dim
    if obs_dim is None:
        ap.error("--obs-dim, --num-agents or a run config.json is required "
                 "(warmup shape)")
    if args.fault_spec:
        _arm_faults(args.fault_spec, args.host_id)

    router, fleet, frontend, agent = start_host_stack(
        args.promoted_dir,
        args.coordinator_url,
        args.host_id,
        env_params=env_params,
        obs_dim=obs_dim,
        act_dim=args.act_dim,
        replicas=args.replicas,
        buckets=tuple(int(b) for b in args.buckets.split(",") if b),
        heartbeat_s=args.heartbeat_s,
        window_ms=args.window_ms,
        device=args.device,
        port=args.port,
        control_port=args.control_port,
    )
    print(
        json.dumps(
            {
                "ready": True,
                "host_id": args.host_id,
                "data_url": frontend.url,
                "control_url": agent.control_url,
                "pid": os.getpid(),
                "step": int(fleet.fleet_step),
                "device": str(router.replicas[0].device),
                "kernels_prebuilt": prebuilt,
                "knn_fused_launches": int(
                    router.launches.get("knn_fused", 0)),
            }
        ),
        flush=True,
    )

    done = threading.Event()

    def _term(signum, frame) -> None:
        done.set()

    signal.signal(signal.SIGTERM, _term)
    signal.signal(signal.SIGINT, _term)
    try:
        done.wait()
    finally:
        agent.stop()
        frontend.stop()
        router.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
