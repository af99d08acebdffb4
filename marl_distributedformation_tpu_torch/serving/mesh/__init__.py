"""Fleet-of-fleets: the cross-host serving tier.

Counterpart of the JAX package's ``serving/mesh/``. Every serving
invariant the fleet earned stops at the process boundary; this package
carries them across it: a host tier layered above the per-host
``FleetRouter`` stacks, with the CONTROL plane, not the data plane, doing
the cross-host work.

- :class:`~.coordinator.MeshCoordinator` — stdlib RPC service owning the
  host registry, replica discovery, health gossip (leases + heartbeats,
  suspect -> dead taxonomy), and the **cross-host reload barrier**: a
  two-phase generalization of the fleet batch-barrier commit (prepare on
  every host, commit only when ALL hosts staged, abort-and-restore on any
  wedge or timeout), so ``model_step`` stays globally monotonic in
  response completion order ACROSS hosts. The pinned-reload/rollback
  exemption rides up unchanged.
- :class:`~.agent.HostAgent` — one host's control-plane presence:
  membership + the heartbeat gossip payload (the host's merged
  ``/v1/metrics`` namespace), the barrier's host side, and stale-host
  catch-up.
- :class:`~.router.MetaRouter` / :class:`~.router.MeshFrontend` — the
  host-tier frontend: routes by per-host estimated drain (gossiped
  ``fleet_estimated_drain_s``), circuit-breaks dead hosts with bounded
  cross-host failover of accepted requests, and propagates ``X-Trace-Id``
  through the extra hop.
- :mod:`~.loopback` — the whole topology on one machine: coordinator +
  MetaRouter in-process, hosts as REAL subprocesses (``kill -9`` is a
  real host death), every host on one device (on a one-card machine the
  hosts time-share ``cuda:0``).
- :func:`~.smoke.run_mesh_smoke` — mesh req/s, global-swap latency,
  kill-one-host failover accounting, and per-host budget-1 capture
  receipts.

The always-learning pipeline promotes unchanged: the ``Promoter``
publishes ONCE into ``promoted/`` and the coordinator (duck-type
compatible with ``FleetReloadCoordinator``) drives the global commit;
``promotions.jsonl`` schema 4 records the round's host count.
"""

from marl_distributedformation_tpu_torch.serving.mesh.agent import (  # noqa: F401,E501
    HostAgent,
)
from marl_distributedformation_tpu_torch.serving.mesh.coordinator import (  # noqa: F401,E501
    HOST_ALIVE,
    HOST_DEAD,
    HOST_SUSPECT,
    MeshCoordinator,
    MeshHost,
)
from marl_distributedformation_tpu_torch.serving.mesh.loopback import (  # noqa: F401,E501
    LocalMesh,
    build_inprocess_host,
    spawn_host_process,
    spawn_local_mesh,
)
from marl_distributedformation_tpu_torch.serving.mesh.router import (  # noqa: F401,E501
    MeshFrontend,
    MeshResult,
    MetaRouter,
    NoHealthyHosts,
)
from marl_distributedformation_tpu_torch.serving.mesh.rpc import (  # noqa: F401,E501
    JsonRpcServer,
    MeshRpcError,
    MeshUnreachable,
    rpc_call,
)

__all__ = [
    "HOST_ALIVE",
    "HOST_DEAD",
    "HOST_SUSPECT",
    "HostAgent",
    "JsonRpcServer",
    "LocalMesh",
    "MeshCoordinator",
    "MeshFrontend",
    "MeshHost",
    "MeshResult",
    "MeshRpcError",
    "MeshUnreachable",
    "MetaRouter",
    "NoHealthyHosts",
    "build_inprocess_host",
    "rpc_call",
    "run_mesh_smoke",
    "spawn_host_process",
    "spawn_local_mesh",
]


def run_mesh_smoke(*args, **kwargs):
    """Lazy alias for :func:`~.smoke.run_mesh_smoke` (the smoke pulls in
    trainer machinery; importing the mesh package must not)."""
    from marl_distributedformation_tpu_torch.serving.mesh.smoke import (
        run_mesh_smoke as _run,
    )

    return _run(*args, **kwargs)
