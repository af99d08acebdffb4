"""The self-healing train lane: the health word inside the iteration, the
escalation ladder on the host.

Counterpart of the JAX package's ``train/recovery.py``:

1. **The health word** (``make_health_iteration``): every iteration
   computes four flags — finite loss, finite global grad norm, grad norm
   within ``grad_norm_max``, parameter-norm drift within
   ``param_drift_max`` — packs them into ``health_word`` (bits
   ``HEALTH_*``) and ``health_ok``, and selects the whole carry (parameters,
   Adam state, the optimizer step, env state, observation) back to its
   values before the iteration when a flag is down: the skip-update guard.
   The generator always advances, as the JAX package's key does. The check
   and the ``torch.where`` select run in the iteration's end phase, inside
   its captured graph, and the flags ride the metrics, so the host sees
   them at the drain with no extra transfer. ``torch.where(True, new, old)``
   is ``new`` bit for bit, so a healthy run is the same with the guard on
   or off.
2. **The ladder** (``RecoveryLadder``), fed the drained flags: a skipped
   iteration is logged; ``breach_iters`` in a row is a sustained breach
   and asks for a rollback to the last good checkpoint while the budget
   lasts, then for a halt. Every transition is one line of
   ``logs/{name}/recovery.jsonl`` (``RECOVERY_EVENTS``).
3. **Retry streams** (``fold_recovery_generator``), and the learning-rate
   and scenario-severity backoffs: retry N from checkpoint C draws from a
   stream that is a pure function of (C, N), different for every N; the
   trainer scales the learning rate and the sampled severities by their
   factors at every rollback, and its scenario mixes come from draws it
   has not made before.

Every transition also lands in the metrics registry under the JAX
package's names (``train_skipped_updates_total``,
``train_consecutive_unhealthy``, ``train_divergence_events_total``,
``train_recoveries_total``, ``train_recovery_mttr_seconds``,
``train_halted``). The chaos plane's train seams (``train.carry_poison``,
``train.grad_bomb`` at the dispatch boundary, ``train.snapshot`` at a
checkpoint's snapshot; ``train/trainer.py``) poison the state through
``Trainer._poison_carry`` and the snapshot copy, so a seeded
``FaultSchedule`` drives the ladder as organic divergence would.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from marl_distributedformation_tpu_torch.algo.optim import global_norm
from marl_distributedformation_tpu_torch.obs.metrics import get_registry

Tensor = torch.Tensor

RECOVERY_LOG = "recovery.jsonl"

# Health-word bits: a flagged iteration has at least one bit clear.
HEALTH_LOSS_FINITE = 1  # loss is finite
HEALTH_GRAD_FINITE = 2  # global grad norm is finite
HEALTH_GRAD_BOUNDED = 4  # global grad norm <= grad_norm_max
HEALTH_DRIFT_BOUNDED = 8  # |params_new| <= drift_max * (|params_old| + 1)
HEALTH_ALL = (
    HEALTH_LOSS_FINITE
    | HEALTH_GRAD_FINITE
    | HEALTH_GRAD_BOUNDED
    | HEALTH_DRIFT_BOUNDED
)
HEALTH_METRICS = ("health_ok", "health_word")

# The events a recovery.jsonl line may carry, with their required keys.
RECOVERY_EVENTS: Dict[str, tuple] = {
    "skip": ("time", "event", "iteration", "skipped", "consecutive"),
    "rollback": (
        "time", "event", "iteration", "to_step", "recoveries", "mttr_s",
    ),
    "halt": ("time", "event", "iteration", "recoveries", "reason"),
}

# Offset of the retry streams, as the JAX package's fold_recovery_key.
_RECOVERY_TAG = 0x7EC0_0000


@dataclasses.dataclass(frozen=True)
class HealthConfig:
    """Bounds of the health word; generous, so that a healthy run never
    trips it (healthy pre-clip grad norms reach the hundreds, divergence
    shows as 1e18 or NaN)."""

    grad_norm_max: float = 1.0e6
    param_drift_max: float = 10.0  # |p_new| <= this * (|p_old| + 1)


@dataclasses.dataclass(frozen=True)
class RecoveryConfig:
    """The ladder's knobs."""

    breach_iters: int = 3  # consecutive skipped iterations = a breach
    max_rollbacks: int = 3  # retries before a breach halts the run
    lr_backoff: float = 1.0  # learning-rate factor at every rollback
    severity_backoff: float = 1.0  # scenario severity factor at every
    #   rollback


def health_flags(
    loss: Tensor,
    grad_norm: Optional[Tensor],
    params_old: Sequence[Tensor],
    params_new: Sequence[Tensor],
    health: HealthConfig,
    members: Optional[int] = None,
) -> Tuple[Tensor, Tensor]:
    """``(healthy, word)``: a 0-d bool and the 0-d float32 health word of an
    iteration with mean ``loss``, mean raw ``grad_norm`` (None passes both
    grad checks) and the parameters before and after it. No host read.
    With ``members`` K (a population: ``loss`` and ``grad_norm`` ``(K,)``,
    parameters stacked ``(K, ...)``), one flag and word a member, each
    from the member's own values only."""
    loss_ok = torch.isfinite(loss)
    if grad_norm is None:
        grad_finite = torch.ones_like(loss_ok)
        grad_bounded = torch.ones_like(loss_ok)
    else:
        grad_finite = torch.isfinite(grad_norm)
        # NaN <= x is False: a non-finite norm fails both flags.
        grad_bounded = grad_norm <= health.grad_norm_max
    p_old = global_norm(params_old, members)
    p_new = global_norm(params_new, members)
    drift_ok = torch.isfinite(p_new) & (
        p_new <= health.param_drift_max * (p_old + 1.0)
    )
    healthy = loss_ok & grad_finite & grad_bounded & drift_ok
    f32 = torch.float32
    word = (
        loss_ok.to(f32) * HEALTH_LOSS_FINITE
        + grad_finite.to(f32) * HEALTH_GRAD_FINITE
        + grad_bounded.to(f32) * HEALTH_GRAD_BOUNDED
        + drift_ok.to(f32) * HEALTH_DRIFT_BOUNDED
    )
    return healthy, word


class HealthGuard:
    """The skip-update guard of one iteration: ``save`` copies the learner
    tensors (parameters first, then the rest of what the update changes) to
    backups before the iteration; ``apply`` checks the iteration and writes
    the selected carry back. Backups keep their storage, so both run inside
    a captured graph.

    With ``members`` K (a population), every learner tensor and env carry
    has the members in turn along its first axis, and the check and the
    select are per member: a diverged member keeps its own state from
    before the iteration while the others take their new state, as the JAX
    package's guard does when wrapped before ``jax.vmap``."""

    def __init__(
        self,
        health: HealthConfig,
        params: Sequence[Tensor],
        learner: Sequence[Tensor],
        members: Optional[int] = None,
    ) -> None:
        self.health = health
        self.params = list(params)
        self.learner = list(learner)
        self.members = members
        self._backups = [torch.empty_like(t) for t in self.learner]

    def _select(self, healthy: Tensor, new: Tensor, old: Tensor) -> Tensor:
        """``new`` where healthy, else ``old``; per member along the first
        axis with ``members``."""
        if self.members is None:
            return torch.where(healthy, new, old)
        k = self.members
        return torch.where(healthy.reshape(k, 1), new.reshape(k, -1),
                           old.reshape(k, -1)).reshape(new.shape)

    def save(self) -> None:
        with torch.no_grad():
            for b, t in zip(self._backups, self.learner):
                b.copy_(t)

    def apply(
        self,
        loss: Tensor,
        grad_norm: Optional[Tensor],
        env_pairs: Sequence[Tuple[Tensor, Tensor]],
    ) -> Tensor:
        """Check the iteration, keep its learner state and move the env
        carry to its new values (``env_pairs``: ``(carry, new)``) when
        healthy, else restore the saved learner and keep the old env carry;
        returns ``[health_ok, health_word]`` float32."""
        n = len(self.params)
        healthy, word = health_flags(
            loss, grad_norm, self._backups[:n], self.params, self.health,
            self.members,
        )
        with torch.no_grad():
            for live, old in zip(self.learner, self._backups):
                live.copy_(self._select(healthy, live, old))
            for carry, new in env_pairs:
                carry.copy_(self._select(healthy, new, carry))
        return torch.stack([healthy.to(torch.float32), word], dim=-1)


def make_health_iteration(iteration: Any, health: HealthConfig) -> Any:
    """``iteration`` (a ``train.iteration.PhasedIteration``, or its
    population counterpart) with the health word and the skip-update
    guard: its metrics gain ``health_ok`` and ``health_word``."""
    iteration.health = HealthGuard(
        health, iteration.params, iteration.learner_tensors(),
        getattr(iteration, "members", None),
    )
    return iteration


def wrap_health(iteration: Any, config: Any) -> Any:
    """The one seam that turns the guard on: ``iteration`` with the health
    word when ``config.health`` (a ``TrainConfig``) is set, as it is
    otherwise."""
    if not getattr(config, "health", False):
        return iteration
    return make_health_iteration(iteration, HealthConfig(
        grad_norm_max=config.health_grad_norm_max,
        param_drift_max=config.health_param_drift_max,
    ))


def fold_recovery_generator(
    generator: torch.Generator, recoveries: int
) -> None:
    """Move a restored generator into the ``recoveries``-th retry stream:
    reseed it from a hash of its restored state and ``recoveries``. A
    verbatim restore would replay the draws that diverged; the fold gives
    every retry its own stream, and retry N from checkpoint C stays a pure
    function of (C, N)."""
    digest = hashlib.blake2b(
        generator.get_state().numpy().tobytes()
        + (_RECOVERY_TAG + int(recoveries)).to_bytes(8, "little"),
        digest_size=8,
    ).digest()
    generator.manual_seed(int.from_bytes(digest, "little") >> 1)


def nonfinite_flag_count(host_metrics: Dict[str, Any]) -> int:
    """Skipped updates in drained metrics: ``health_ok`` entries below
    0.5, over every axis; 0 without the health word."""
    flags = host_metrics.get("health_ok")
    if flags is None:
        return 0
    return int((np.asarray(flags, dtype=np.float64) < 0.5).sum())


def record_health_flags(host_metrics: Dict[str, Any]) -> int:
    """The drain seam of a run without the ladder: count the drained
    skipped updates into ``train_skipped_updates_total``."""
    skipped = nonfinite_flag_count(host_metrics)
    if skipped:
        get_registry().counter("train_skipped_updates_total").inc(skipped)
    return skipped


class RecoveryLadder:
    """The host's escalation ladder, fed per-iteration health flags at the
    drain.

    ``observe`` walks the flags in iteration order: a healthy iteration
    resets the run of breaches, an unhealthy one extends it, and reaching
    ``breach_iters`` is a sustained breach: ``"rollback"`` while the budget
    lasts, ``"halt"`` after it; anything short is ``"ok"`` (the guard
    contained it; a ``skip`` line is still written). The trainer acts and
    calls ``note_rollback`` or ``note_halt``. After a rollback the ladder is
    on probation until a fully healthy drain, and ``suspect`` holds saves
    back meanwhile.
    """

    def __init__(self, config: RecoveryConfig, log_dir: str | Path) -> None:
        self.config = config
        self.log_path = Path(log_dir) / RECOVERY_LOG
        # One file a process: a resumed run moves the old history aside.
        if self.log_path.exists() and self.log_path.stat().st_size > 0:
            rotated = self.log_path.with_name(
                f"{RECOVERY_LOG}.{int(time.time() * 1000)}"
            )
            try:
                self.log_path.replace(rotated)
            except OSError:
                pass
        self.recoveries = 0
        self.skipped_total = 0
        self.breaches = 0
        self.halted = False
        self._consecutive = 0
        # The file the last rollback restored, until a healthy drain: if
        # the next rollback finds it newest again, it holds the poison.
        self.last_rollback_path: Optional[str] = None
        self._probation = False

    @property
    def suspect(self) -> bool:
        """True while the last observation ended unhealthy or a rollback is
        unproven: the trainer submits no checkpoint then, so that a finite
        but diverged state never becomes the newest file."""
        return (self._consecutive > 0 or self._probation) and not self.halted

    def observe(
        self, ok_flags: Any, words: Any = None, first_iteration: int = 0
    ) -> str:
        """One drained batch of flags (host values, iteration order);
        returns ``"ok"``, ``"rollback"`` or ``"halt"``."""
        if self.halted:
            return "halt"
        ok = np.asarray(ok_flags, dtype=np.float64).reshape(-1)
        skipped = int((ok < 0.5).sum())
        self.skipped_total += skipped
        registry = get_registry()
        if skipped:
            registry.counter("train_skipped_updates_total").inc(skipped)
        breach = False
        for value in ok:
            if value >= 0.5:
                self._consecutive = 0
            else:
                self._consecutive += 1
                if self._consecutive >= self.config.breach_iters:
                    breach = True
        registry.gauge("train_consecutive_unhealthy").set(
            float(self._consecutive))
        if skipped == 0 and self._consecutive == 0:
            self.last_rollback_path = None
            self._probation = False
            return "ok"
        word_min: Optional[int] = None
        if words is not None:
            w = np.asarray(words, dtype=np.float64).reshape(-1)
            if w.size:
                word_min = int(w.min())
        self._append({
            "event": "skip",
            "iteration": int(first_iteration),
            "skipped": skipped,
            "consecutive": int(self._consecutive),
            "health_word_min": word_min,
        })
        if not breach:
            return "ok"
        self.breaches += 1
        registry.counter("train_divergence_events_total").inc()
        if self.recoveries >= self.config.max_rollbacks:
            return "halt"
        return "rollback"

    def note_rollback(
        self,
        to_step: int,
        path: Optional[str],
        mttr_s: float,
        iteration: int,
        lr_scale: Optional[float] = None,
        severity_scale: Optional[float] = None,
    ) -> None:
        self.recoveries += 1
        self._consecutive = 0
        self._probation = True
        self.last_rollback_path = str(path) if path is not None else None
        registry = get_registry()
        registry.counter("train_recoveries_total").inc()
        registry.histogram("train_recovery_mttr_seconds").observe(
            float(mttr_s))
        self._append({
            "event": "rollback",
            "iteration": int(iteration),
            "to_step": int(to_step),
            "recoveries": int(self.recoveries),
            "mttr_s": round(float(mttr_s), 4),
            "checkpoint": str(path) if path is not None else None,
            "lr_scale": lr_scale,
            "severity_scale": severity_scale,
        })

    def note_halt(self, iteration: int, reason: str) -> None:
        self.halted = True
        get_registry().gauge("train_halted").set(1.0)
        self._append({
            "event": "halt",
            "iteration": int(iteration),
            "recoveries": int(self.recoveries),
            "reason": str(reason)[:300],
        })

    def _append(self, record: Dict[str, Any]) -> None:
        line = {"time": round(time.time(), 3), **record}
        try:
            self.log_path.parent.mkdir(parents=True, exist_ok=True)
            with open(self.log_path, "a") as f:
                f.write(json.dumps(line) + "\n")
        except OSError:
            pass  # the audit trail must never become the failure


def read_recovery_log(path: str | Path) -> List[Dict[str, Any]]:
    """Parse and validate ``recovery.jsonl``: every line JSON, every event
    known, every required key present. Raises ``ValueError`` naming the
    first bad line; a missing file is an empty history."""
    path = Path(path)
    if not path.exists():
        return []
    records: List[Dict[str, Any]] = []
    for i, raw in enumerate(path.read_text().splitlines()):
        if not raw.strip():
            continue
        try:
            rec = json.loads(raw)
        except json.JSONDecodeError as e:
            raise ValueError(
                f"{path}:{i + 1}: unparseable recovery line: {e}"
            ) from e
        event = rec.get("event")
        required = RECOVERY_EVENTS.get(event)
        if required is None:
            raise ValueError(
                f"{path}:{i + 1}: unknown recovery event {event!r} "
                f"(known: {sorted(RECOVERY_EVENTS)})"
            )
        missing = [k for k in required if k not in rec]
        if missing:
            raise ValueError(
                f"{path}:{i + 1}: {event!r} line is missing required "
                f"key(s) {missing}"
            )
        records.append(rec)
    return records


def scale_injected_lr(lr: Tensor, factor: float) -> None:
    """Scale the learning rate in place. It is device data that every
    captured minibatch step reads, so a rollback changes it without a new
    capture; the checkpoint carries it in optax's ``inject_hyperparams``
    layout (``compat.convert.opt_state_to_jax``)."""
    with torch.no_grad():
        lr.mul_(factor)
