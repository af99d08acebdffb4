"""The always-learning fleet: trainer -> promotion gate -> fleet reload.

Counterpart of the JAX package's ``pipeline/``. Every piece exists
separately — a captured-graph trainer streaming async checkpoints
(train/), a build-once robustness eval matrix (scenarios/matrix.py), and
a serving fleet with step-monotonic coordinated hot reload
(serving/fleet/) — this package composes them
into ONE supervised continuous-learning loop, in the Podracer idiom
(arXiv:2104.06272) of keeping the accelerator training loop hot while
host-side control planes run alongside:

- :class:`~.stream.CheckpointStream` tails the trainer's ``logs/{name}/``
  output incrementally (never a torn file, O(new) per poll).
- :class:`~.gate.PromotionGate` runs every candidate through the
  robustness matrix plus a clean-return regression check against the
  currently-served baseline — ONE program across all candidates, a CUDA
  graph captured once on the card (budget-1 RetraceGuard receipt).
- :class:`~.promote.Promoter` publishes only passing checkpoints into
  the ``promoted/`` directory the fleet's reload coordinator watches,
  preserving fleet-wide step monotonicity.
- :class:`~.rollback.RollbackMonitor` samples fleet serving stats and
  demotes to the last-good checkpoint when a served-metric regression
  trips (a monotonicity-exempt pinned reload —
  ``FleetReloadCoordinator.reload_pinned``).
- :class:`~.supervisor.AlwaysLearningPipeline` wires the above and
  writes the versioned ``promotions.jsonl`` verdict log.

Entry point: ``python -m marl_distributedformation_tpu_torch.always_learning``.
The promotion/rollback state machine is in ``supervisor.py``, the
verdict-log schema in ``promote.py``.
"""

from marl_distributedformation_tpu_torch.pipeline.stream import (  # noqa: F401
    CheckpointStream,
)
from marl_distributedformation_tpu_torch.pipeline.gate import (  # noqa: F401
    GateConfig,
    GateVerdict,
    PromotionGate,
    judge_candidate,
    judge_falsifiers,
)
from marl_distributedformation_tpu_torch.pipeline.promote import (  # noqa: F401
    PromotionLog,
    Promoter,
)
from marl_distributedformation_tpu_torch.pipeline.rollback import (  # noqa: F401
    RollbackMonitor,
)
from marl_distributedformation_tpu_torch.pipeline.supervisor import (  # noqa: F401
    AlwaysLearningPipeline,
    PromotionRecord,
)

__all__ = [
    "AlwaysLearningPipeline",
    "CheckpointStream",
    "GateConfig",
    "GateVerdict",
    "PromotionGate",
    "PromotionLog",
    "PromotionRecord",
    "Promoter",
    "RollbackMonitor",
    "judge_candidate",
    "judge_falsifiers",
]
