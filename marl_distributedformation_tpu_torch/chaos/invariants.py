"""Invariant checkers: what must still be true after a chaos campaign.

Counterpart of the JAX package's ``chaos/invariants.py``: the same
checkers over the port's artifacts (``check_audit_log`` reads the
pipeline's ``promotions.jsonl``, which both packages write alike).

Each checker is a pure function over campaign artifacts (served-step
samples, probe outcomes, compile receipts, ``promotions.jsonl``, a
checkpoint directory) returning a list of :class:`Violation` — empty
means the invariant held through whatever the fault schedule did.
:func:`report_violations` is the alarm half: every tripped checker
becomes a ``chaos_violation`` flight-recorder incident carrying the
recent span history plus the armed/fired fault schedule as structured
context, so a failing campaign is diagnosable from its artifacts alone
(no re-run, no debugger).

The invariants are the ones the subsystems individually earned, restated
so one campaign exercises them all:

- **step monotonicity** — ``model_step`` never goes backward in
  response order, except across an audited rollback;
- **no accepted request lost** — every admitted request resolves
  (result or typed error), none wedge forever;
- **budget-1 compile receipts** — the gate's matrix program and every
  serving rung compile at most once, faults or no faults;
- **checkpoint-dir crash consistency** — every discoverable checkpoint
  is checksum-valid; torn writes are invisible (``.tmp``), corrupt
  files are quarantined aside, never served.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

from marl_distributedformation_tpu_torch.chaos.plane import (
    FaultPlane,
    get_fault_plane,
)


@dataclasses.dataclass
class Violation:
    """One tripped invariant."""

    invariant: str
    detail: str
    context: Optional[dict] = None

    def record(self) -> dict:
        out = {"invariant": self.invariant, "detail": self.detail}
        if self.context:
            out["context"] = dict(self.context)
        return out


def check_step_monotonic(
    samples: Sequence[Tuple[float, int]],
    rollback_to_steps: Sequence[int] = (),
) -> List[Violation]:
    """``model_step`` over response order must never decrease — except a
    decrease landing exactly on an audited rollback target (the
    monotonicity-exempt pinned demotion). ``samples`` are ``(t, step)``
    in response order."""
    violations: List[Violation] = []
    allowed = set(int(s) for s in rollback_to_steps)
    prev: Optional[int] = None
    for t, step in samples:
        step = int(step)
        if prev is not None and step < prev and step not in allowed:
            violations.append(
                Violation(
                    "step_monotonic",
                    f"served step went backward {prev} -> {step} with no "
                    "audited rollback to that step",
                    {"t": t, "from_step": prev, "to_step": step},
                )
            )
        prev = step
    return violations


def check_no_request_lost(
    outcomes: Sequence[Dict[str, Any]],
) -> List[Violation]:
    """Every accepted request must RESOLVE — a success, or a typed
    error the caller can act on. ``outcomes`` are
    ``{"ok": bool, "error": str|None, "hung": bool}`` per accepted
    request (the storm's prober fills them); a hung future is the
    violation this checker exists for."""
    violations = []
    hung = [o for o in outcomes if o.get("hung")]
    if hung:
        violations.append(
            Violation(
                "no_request_lost",
                f"{len(hung)} accepted request(s) never resolved "
                "(future wedged past its deadline + slack)",
                {"hung": len(hung), "total": len(outcomes)},
            )
        )
    return violations


def check_budget_one(compiles: Dict[str, int]) -> List[Violation]:
    """Every named program's compile count must be <= 1 — the budget-1
    receipts must hold with chaos armed."""
    violations = []
    for name, count in sorted(compiles.items()):
        if int(count) > 1:
            violations.append(
                Violation(
                    "budget_one",
                    f"program {name!r} compiled {count} times under "
                    "chaos (budget is 1)",
                    {"program": name, "compiles": int(count)},
                )
            )
    return violations


# Events that terminate a candidate's journey vs. annotate it.
_AUDIT_EVENTS = frozenset({
    "promoted", "rejected", "rolled_back", "rollback_failed",
    "promotion_deferred", "promotion_superseded", "curriculum_updated",
    "curriculum_update_failed", "candidate_vanished",
})


def check_audit_log(path: str | Path) -> List[Violation]:
    """``promotions.jsonl`` must read back as a consistent state
    machine: known events, promoted steps strictly ascending, every
    rollback demoting to a step that actually served (a previously
    promoted step), and no superseded candidate later claimed as
    promoted."""
    from marl_distributedformation_tpu_torch.pipeline.promote import PromotionLog

    violations: List[Violation] = []
    try:
        records = PromotionLog.read(path)
    except Exception as e:  # noqa: BLE001 — unparseable log IS the trip
        return [
            Violation(
                "audit_log", f"promotions.jsonl unreadable: {e!r}",
                {"path": str(path)},
            )
        ]
    promoted_steps: List[int] = []
    superseded: set = set()
    for i, rec in enumerate(records):
        event = rec.get("event")
        if event not in _AUDIT_EVENTS:
            violations.append(
                Violation(
                    "audit_log",
                    f"line {i}: unknown event {event!r}",
                    {"line": i},
                )
            )
            continue
        step = rec.get("step")
        if event == "promoted":
            if step in superseded:
                violations.append(
                    Violation(
                        "audit_log",
                        f"line {i}: step {step} promoted AFTER being "
                        "superseded — a never-served candidate became "
                        "the baseline",
                        {"line": i, "step": step},
                    )
                )
            if promoted_steps and step <= promoted_steps[-1]:
                violations.append(
                    Violation(
                        "audit_log",
                        f"line {i}: promoted step {step} does not ascend "
                        f"past {promoted_steps[-1]}",
                        {"line": i, "step": step},
                    )
                )
            promoted_steps.append(step)
        elif event == "promotion_superseded":
            superseded.add(step)
        elif event == "rolled_back":
            to_step = rec.get("to_step")
            if to_step not in promoted_steps:
                violations.append(
                    Violation(
                        "audit_log",
                        f"line {i}: rolled back to step {to_step}, which "
                        "was never promoted",
                        {"line": i, "to_step": to_step},
                    )
                )
    return violations


def check_checkpoint_dir(log_dir: str | Path) -> List[Violation]:
    """Crash consistency of a checkpoint directory: every DISCOVERABLE
    file (the ``.msgpack``-suffixed names ``latest_checkpoint`` /
    ``CheckpointDiscovery`` would serve) must carry a valid checksum
    footer; torn ``.tmp`` files and quarantined (``.quarantined``)
    files are invisible to discovery and therefore fine."""
    from marl_distributedformation_tpu_torch.utils.checkpoint import (
        CorruptCheckpointError,
        strip_footer,
    )

    violations: List[Violation] = []
    log_dir = Path(log_dir)
    if not log_dir.is_dir():
        return violations
    for p in sorted(log_dir.iterdir()):
        if p.suffix != ".msgpack" or p.name.startswith("."):
            continue  # invisible to discovery: torn tmp, quarantined
        try:
            strip_footer(p.read_bytes(), origin=str(p))
        except CorruptCheckpointError as e:
            violations.append(
                Violation(
                    "checkpoint_crash_consistency",
                    f"discoverable checkpoint {p.name} is corrupt and "
                    f"was never quarantined: {e}",
                    {"path": str(p)},
                )
            )
        except OSError as e:
            violations.append(
                Violation(
                    "checkpoint_crash_consistency",
                    f"discoverable checkpoint {p.name} unreadable: {e!r}",
                    {"path": str(p)},
                )
            )
    return violations


def check_finite_checkpoints(log_dir: str | Path) -> List[Violation]:
    """Train-lane invariant (docs/recovery.md): no DISCOVERABLE
    checkpoint may carry non-finite float leaves — the write gate
    (utils/checkpoint.py) must have skipped every poisoned snapshot
    before it reached a ``rl_model_*`` name. Corrupt files are the
    crash-consistency checker's business; this one restores each valid
    file and walks its floats."""
    from marl_distributedformation_tpu_torch.utils.checkpoint import (
        CorruptCheckpointError,
        msgpack_restore_file,
        nonfinite_leaf,
    )

    violations: List[Violation] = []
    log_dir = Path(log_dir)
    if not log_dir.is_dir():
        return violations
    for p in sorted(log_dir.iterdir()):
        if p.suffix != ".msgpack" or p.name.startswith("."):
            continue
        try:
            tree = msgpack_restore_file(p)
        except (CorruptCheckpointError, OSError):
            continue  # check_checkpoint_dir owns damage
        bad = nonfinite_leaf(tree)
        if bad is not None:
            violations.append(
                Violation(
                    "nonfinite_checkpoint",
                    f"discoverable checkpoint {p.name} carries "
                    f"non-finite values at {bad} — a diverged state "
                    "became visible to discovery (the write gate "
                    "failed)",
                    {"path": str(p), "leaf": bad},
                )
            )
    return violations


def check_final_params_finite(params: Any) -> List[Violation]:
    """The run must END on finite params, whatever the fault schedule
    did mid-flight — the recovery ladder's terminal guarantee. ``params``
    is a tree of tensors (on any device) or arrays."""
    from marl_distributedformation_tpu_torch.utils.checkpoint import (
        nonfinite_leaf,
        tree_to_host,
    )

    bad = nonfinite_leaf(tree_to_host(params))
    if bad is None:
        return []
    return [
        Violation(
            "finite_final_params",
            f"the run terminated with non-finite params at {bad} — the "
            "recovery ladder failed to restore a last-good state",
            {"leaf": bad},
        )
    ]


def check_recovery_log(
    path: str | Path,
    max_rollbacks: Optional[int] = None,
    mttr_bound_s: Optional[float] = None,
) -> List[Violation]:
    """``recovery.jsonl`` must read back as a consistent ladder history:
    schema-valid lines (train.recovery.read_recovery_log), rollback
    counters strictly ascending, every MTTR finite and positive (and
    under ``mttr_bound_s`` when given — recovery must be BOUNDED, not
    just eventual), a ``halt`` only as the final event, and no more
    rollbacks than the configured budget."""
    import math

    from marl_distributedformation_tpu_torch.train.recovery import (
        read_recovery_log,
    )

    violations: List[Violation] = []
    try:
        records = read_recovery_log(path)
    except ValueError as e:
        return [
            Violation(
                "recovery_log", f"recovery.jsonl invalid: {e}",
                {"path": str(path)},
            )
        ]
    last_recoveries = 0
    for i, rec in enumerate(records):
        event = rec.get("event")
        if event == "rollback":
            n = int(rec["recoveries"])
            if n != last_recoveries + 1:
                violations.append(
                    Violation(
                        "recovery_log",
                        f"line {i}: rollback counter jumped "
                        f"{last_recoveries} -> {n} (must ascend by 1)",
                        {"line": i},
                    )
                )
            last_recoveries = n
            if max_rollbacks is not None and n > max_rollbacks:
                violations.append(
                    Violation(
                        "recovery_log",
                        f"line {i}: {n} rollbacks exceed the configured "
                        f"budget of {max_rollbacks}",
                        {"line": i},
                    )
                )
            mttr = rec["mttr_s"]
            if not (
                isinstance(mttr, (int, float))
                and math.isfinite(mttr)
                and mttr > 0.0
            ):
                violations.append(
                    Violation(
                        "recovery_mttr",
                        f"line {i}: rollback MTTR {mttr!r} is not a "
                        "finite number > 0",
                        {"line": i},
                    )
                )
            elif mttr_bound_s is not None and float(mttr) > mttr_bound_s:
                violations.append(
                    Violation(
                        "recovery_mttr",
                        f"line {i}: rollback MTTR {float(mttr):.3f}s "
                        f"exceeds the {mttr_bound_s}s bound — recovery "
                        "must be bounded, not merely eventual",
                        {"line": i},
                    )
                )
        elif event == "halt" and i != len(records) - 1:
            violations.append(
                Violation(
                    "recovery_log",
                    f"line {i}: 'halt' is terminal but "
                    f"{len(records) - 1 - i} event(s) follow it",
                    {"line": i},
                )
            )
    return violations


def check_no_duplicate_consume(
    consumed_seqs: Sequence[int],
) -> List[Violation]:
    """Sebulba transfer contract (docs/sebulba.md): no trajectory batch
    is ever consumed twice. ``consumed_seqs`` is the TransferQueue's
    consume-order artifact; the chaos ``sebulba.dequeue`` seam redelivers
    items, so the queue's seq guard must leave this STRICTLY increasing
    — a repeat or regression means a duplicate reached the learner
    (the same batch counted into two updates)."""
    violations: List[Violation] = []
    prev: Optional[int] = None
    for i, seq in enumerate(consumed_seqs):
        seq = int(seq)
        if prev is not None and seq <= prev:
            violations.append(
                Violation(
                    "no_duplicate_consume",
                    f"consume order position {i}: seq {seq} after {prev} "
                    "— a redelivered trajectory batch reached the "
                    "learner twice (the queue's seq guard failed)",
                    {"position": i, "seq": seq, "prev": prev},
                )
            )
        prev = seq
    return violations


def check_params_version_monotone(
    consumed_versions: Sequence[int],
) -> List[Violation]:
    """Sebulba params contract: the ``params_version`` stamped on
    consumed batches never goes BACKWARD — the ParamBus is single-slot
    latest-wins, so an actor can act on stale params (dropped publish)
    but never on a version older than one it already acted with. A
    regression here means the bus swapped backward or a stale batch
    outlived the staleness gate out of order."""
    violations: List[Violation] = []
    prev: Optional[int] = None
    for i, version in enumerate(consumed_versions):
        version = int(version)
        if prev is not None and version < prev:
            violations.append(
                Violation(
                    "params_version_monotone",
                    f"consume order position {i}: params_version "
                    f"{version} after {prev} — the latest-wins bus "
                    "regressed (an older snapshot overwrote a newer one)",
                    {"position": i, "version": version, "prev": prev},
                )
            )
        prev = version
    return violations


def check_bounded_staleness(
    staleness_samples: Sequence[int],
    max_param_staleness: int,
) -> List[Violation]:
    """Sebulba staleness contract: every batch the learner CONSUMED was
    acted with params at most ``max_param_staleness`` updates behind the
    learner's current version — the driver's staleness gate must drop
    (never train on) anything older, even while the chaos
    ``sebulba.param_publish`` seam is holding publishes back."""
    violations: List[Violation] = []
    bound = int(max_param_staleness)
    for i, staleness in enumerate(staleness_samples):
        staleness = int(staleness)
        if staleness > bound:
            violations.append(
                Violation(
                    "bounded_staleness",
                    f"consumed batch {i} was acted {staleness} params "
                    f"versions behind the learner (bound: {bound}) — "
                    "the staleness gate let an over-stale trajectory "
                    "into an update",
                    {"position": i, "staleness": staleness, "bound": bound},
                )
            )
    return violations


def report_violations(
    violations: Sequence[Violation],
    plane: Optional[FaultPlane] = None,
    trace_id: Optional[str] = None,
) -> List[dict]:
    """Alarm every violation: one ``chaos_violation`` incident per trip,
    dumping the recent span history PLUS the armed/fired fault schedule
    as structured flight-recorder context — the campaign's postmortem
    writes itself. Returns the violation records (the report's
    ``chaos_violations`` list). Never raises."""
    from marl_distributedformation_tpu_torch.obs import get_registry, get_tracer

    plane = plane if plane is not None else get_fault_plane()
    tracer = get_tracer()
    registry = get_registry()
    records = []
    for v in violations:
        records.append(v.record())
        registry.counter("chaos_invariant_violations_total").inc()
        tracer.incident(
            "chaos_violation",
            trace_id=trace_id,
            invariant=v.invariant,
            detail=v.detail,
            violation_context=v.context or {},
            fault_schedule_armed=plane.armed_record(),
            fault_schedule_fired=plane.fired_record(),
        )
    return records
