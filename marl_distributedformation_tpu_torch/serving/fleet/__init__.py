"""Replica-managed serving fleet over the single-engine stack.

Counterpart of the JAX package's ``serving/fleet/``. One
``MicroBatchScheduler`` + ``BucketedPolicyEngine`` pair is one replica;
this package runs several behind one submit surface, the Podracer way
(arXiv:2104.06272): the replicated program behind a thin host-side
dispatch layer, the network strictly outside the captured path. On one
card the replicas share the device, each with its own engine, stream,
worker thread and copy of the parameters.

- :class:`~.router.FleetRouter` — routes each request to the healthy
  replica with the lowest estimated drain time, circuit-breaks replicas
  whose worker dies or whose ``RetraceGuard`` trips (failing their
  accepted requests over), and half-open-probes broken replicas back in.
- :class:`~.reload.FleetReloadCoordinator` — polls the checkpoint
  directory ONCE for the whole fleet and swaps every replica at a
  fleet-wide batch barrier, so ``model_step`` in responses is globally
  monotonic.
- :class:`~.frontend.FleetFrontend` — stdlib HTTP/JSON frontend above
  ``FleetRouter.submit``: ``model_step`` on every response, ``429`` +
  ``Retry-After`` backpressure, ``/v1/health``, ``/v1/metrics``.
- :class:`~.metrics.FleetMetrics` — routed/rejected/failed-over/breaks
  counters, merged latency percentiles and per-replica occupancy.
- :func:`~.smoke.run_fleet_smoke` — a mixed-size request storm across the
  fleet with the receipts (builds a rung a replica, step-monotonicity
  violations) in one report; :func:`~.smoke.warmup_fleet` builds every
  rung of every replica before traffic.
"""

from marl_distributedformation_tpu_torch.serving.fleet.frontend import (
    FleetFrontend,
)
from marl_distributedformation_tpu_torch.serving.fleet.metrics import (
    FleetMetrics,
)
from marl_distributedformation_tpu_torch.serving.fleet.reload import (
    FleetReloadCoordinator,
    ReplicaRegistry,
    fleet_from_checkpoint_dir,
)
from marl_distributedformation_tpu_torch.serving.fleet.router import (
    FleetRouter,
    NoHealthyReplicas,
    Replica,
)
from marl_distributedformation_tpu_torch.serving.fleet.smoke import (
    run_fleet_smoke,
    warmup_fleet,
)

__all__ = [
    "FleetFrontend",
    "FleetMetrics",
    "FleetReloadCoordinator",
    "FleetRouter",
    "NoHealthyReplicas",
    "Replica",
    "ReplicaRegistry",
    "fleet_from_checkpoint_dir",
    "run_fleet_smoke",
    "warmup_fleet",
]
