"""The chaos plane: deterministic fault injection, invariant checking and
self-healing supervision.

Counterpart of the JAX package's ``chaos/``:

- :mod:`.plane` — production seams call :func:`fault_point` (one
  attribute read when the plane is disabled, the shipped default), and a
  seeded :class:`FaultSchedule` arms faults at them;
- :mod:`.invariants` — pure checkers over a campaign's artifacts (step
  monotonicity, no request lost, budget-1 receipts, checkpoint-directory
  consistency, the train and Sebulba lanes' contracts) and the
  ``chaos_violation`` flight-recorder alarm; ``check_audit_log`` reads
  the pipeline's audit log and waits for the pipeline (ROADMAP A13);
- :mod:`.watchdog` — heartbeat-driven lane supervision with
  capped-backoff restarts (the fleet's workers, Sebulba's lanes).
"""

from marl_distributedformation_tpu_torch.chaos.invariants import (
    Violation,
    check_bounded_staleness,
    check_budget_one,
    check_checkpoint_dir,
    check_final_params_finite,
    check_finite_checkpoints,
    check_no_duplicate_consume,
    check_no_request_lost,
    check_params_version_monotone,
    check_recovery_log,
    check_step_monotonic,
    report_violations,
)
from marl_distributedformation_tpu_torch.chaos.plane import (
    DISRUPTIVE_KINDS,
    FAULT_KINDS,
    INJECTION_POINTS,
    FaultPlane,
    FaultSchedule,
    FaultSpec,
    InjectedFault,
    SimulatedCrash,
    configure_chaos,
    fault_point,
    get_fault_plane,
    set_fault_plane,
)
from marl_distributedformation_tpu_torch.chaos.watchdog import (
    Heartbeat,
    Lane,
    LaneWatchdog,
)

__all__ = [
    "DISRUPTIVE_KINDS",
    "FAULT_KINDS",
    "INJECTION_POINTS",
    "FaultPlane",
    "FaultSchedule",
    "FaultSpec",
    "Heartbeat",
    "InjectedFault",
    "Lane",
    "LaneWatchdog",
    "SimulatedCrash",
    "Violation",
    "check_bounded_staleness",
    "check_budget_one",
    "check_checkpoint_dir",
    "check_final_params_finite",
    "check_finite_checkpoints",
    "check_no_duplicate_consume",
    "check_no_request_lost",
    "check_params_version_monotone",
    "check_recovery_log",
    "check_step_monotonic",
    "configure_chaos",
    "fault_point",
    "get_fault_plane",
    "report_violations",
    "set_fault_plane",
]
