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

The sharded engine, tenancy, elastic capacity and the mesh are not ported
yet (ROADMAP A13).
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
from marl_distributedformation_tpu_torch.serving.smoke import run_smoke_benchmark

__all__ = [
    "BackpressureError",
    "BucketedPolicyEngine",
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
