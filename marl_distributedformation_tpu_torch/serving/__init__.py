"""Policy inference serving: the port's counterpart of the JAX package's
``serving/`` single-engine stack.

- :class:`~.engine.BucketedPolicyEngine` — a ladder of bucketed batch
  shapes, one CUDA graph a rung on the card; arbitrary request sizes pad
  to the next rung, so each rung is built exactly once (pinned by
  ``analysis.guards.RetraceGuard``).
- :class:`~.scheduler.MicroBatchScheduler` — bounded request queue that
  coalesces concurrent requests within a deadline window, with
  backpressure (reject-with-retry-after), per-request timeouts, SLO
  classes and tenant lanes.
- :class:`~.registry.ModelRegistry` — watches a ``logs/{name}/``
  directory and hot-swaps new checkpoints atomically between batches.
- :class:`~.metrics.ServingMetrics` — queue depth, batch occupancy,
  latency percentiles.
- :class:`~.client.ServingClient` — the client, over one scheduler, a
  fleet router, or HTTP endpoints (the fleet frontend's ``/v1/act``).
- ``loadgen`` / ``autotune`` — open-loop traffic replay measuring req/s at
  a p95 target (``max_rate_at_slo``), and the ladder autotuner.
- ``serving.fleet`` — the multi-replica layer: ``FleetRouter``,
  ``FleetReloadCoordinator`` (poll-once batch-barrier swap, globally
  step-monotonic), ``FleetFrontend`` (stdlib HTTP/JSON), ``FleetMetrics``,
  ``run_fleet_smoke``.
- ``serving.tenancy`` — named model lanes over one fleet:
  ``TenantDirectory`` declares lanes (env, architecture, SLO class,
  promoted dir), ``TenantFleet`` serves them — same-arch lanes share each
  replica's captured rungs, per-lane admission queues, per-lane reload
  coordinators with per-model step monotonicity, ``run_tenant_smoke`` for
  the isolation evidence.

- ``serving.mesh`` — the cross-host tier above per-host fleets:
  ``MeshCoordinator`` (host registry, lease gossip, the two-phase global
  commit), ``HostAgent``, ``MetaRouter``/``MeshFrontend``, the loopback
  mesh of host subprocesses (``spawn_local_mesh``) and ``run_mesh_smoke``.

- :class:`~.sharded.ShardedPolicyEngine` — the big rungs over a slice of
  row blocks instead of one replica: partition-rule placement over the
  JAX paths (``match_partition_rules`` / ``make_shard_and_gather_fns``),
  batch-axis request splitting, one CUDA graph a row block a rung, an
  optional ``mp`` axis and bf16 rungs. ``ShardedSpec`` plugs it into a
  ``FleetRouter``.
- ``serving.elastic`` — the live capacity loop: ``TraceRecorder``
  records offered arrivals at the schedulers, ``CapacityController``
  replays the window through the same autotune DP and re-splits the fleet
  (new ladder, new replicated/sharded split), prewarm-then-commit at the
  fleet batch barrier.
"""

from marl_distributedformation_tpu_torch.serving.autotune import (
    LadderPlan,
    autotune_ladder,
    plans_equivalent,
    replay_recorder,
)
from marl_distributedformation_tpu_torch.serving.client import (
    ServingClient,
    backoff_s,
)
from marl_distributedformation_tpu_torch.serving.engine import (
    DEFAULT_BUCKETS,
    BucketedPolicyEngine,
)
from marl_distributedformation_tpu_torch.serving.elastic import (
    CapacityController,
    CapacityDecision,
)
from marl_distributedformation_tpu_torch.serving.loadgen import (
    RequestTrace,
    TraceRecorder,
    max_rate_at_slo,
    run_load,
    synthetic_trace,
)
from marl_distributedformation_tpu_torch.serving.metrics import ServingMetrics
from marl_distributedformation_tpu_torch.serving.registry import ModelRegistry
from marl_distributedformation_tpu_torch.serving.scheduler import (
    SLO_BATCH,
    SLO_INTERACTIVE,
    BackpressureError,
    MicroBatchScheduler,
    RequestTimeout,
    ServedResult,
)
from marl_distributedformation_tpu_torch.serving.sharded import (
    ShardedPolicyEngine,
    ShardedSpec,
)
from marl_distributedformation_tpu_torch.serving.smoke import run_smoke_benchmark

__all__ = [
    "BackpressureError",
    "BucketedPolicyEngine",
    "CapacityController",
    "CapacityDecision",
    "DEFAULT_BUCKETS",
    "LadderPlan",
    "MicroBatchScheduler",
    "ModelRegistry",
    "RequestTimeout",
    "RequestTrace",
    "SLO_BATCH",
    "SLO_INTERACTIVE",
    "ServedResult",
    "ServingClient",
    "ServingMetrics",
    "ShardedPolicyEngine",
    "ShardedSpec",
    "TraceRecorder",
    "autotune_ladder",
    "backoff_s",
    "max_rate_at_slo",
    "plans_equivalent",
    "replay_recorder",
    "run_load",
    "run_smoke_benchmark",
    "synthetic_trace",
]
