"""PromotionGate: the quality door between training and serving.

Counterpart of the JAX package's ``pipeline/gate.py``. Every candidate
checkpoint runs through the SAME eval program
(``scenarios.matrix.MatrixProgram``: the model's and the scenario's
parameters are copied into the program's static buffers, so its step is
built once for the life of the gate, a CUDA graph captured on the card and
the first eager run on the CPU; the budget-1 RetraceGuard receipt spans
every candidate of an always-learning run) and is judged on two axes:

- **Clean-return regression** vs the currently-served baseline: a
  candidate whose clean-env ``episode_return_per_agent`` falls more than
  ``clean_tolerance`` (relative) below the served checkpoint's is
  rejected — training divergence, a corrupted file (NaN params evaluate
  to NaN returns, which never pass the finite check), or a genuinely
  worse policy all land here.
- **Severity-rung regression** on the robustness matrix: for each
  configured scenario x severity cell, the candidate may not fall more
  than ``rung_tolerance`` (relative) below the baseline's cell — a
  policy that got better on the clean env by sacrificing robustness is
  caught at the rung that regressed.

The first loadable candidate bootstraps the baseline (there is nothing
served to regress against); thereafter :meth:`PromotionGate.accept`
installs each promoted candidate's already-computed cells as the new
baseline — promotion never re-evaluates anything. ``rebase(step)``
reverts the baseline after a rollback so later candidates are judged
against what is actually serving again.
"""

from __future__ import annotations

import dataclasses
import math
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from marl_distributedformation_tpu_torch.chaos.plane import fault_point
from marl_distributedformation_tpu_torch.env.types import EnvParams
from marl_distributedformation_tpu_torch.eval import episode_length
from marl_distributedformation_tpu_torch.obs import get_registry, get_tracer
from marl_distributedformation_tpu_torch.utils.checkpoint import (
    checkpoint_step,
)

# Cells: {scenario: {"{severity:g}": {metric: float}}}
Cells = Dict[str, Dict[str, Dict[str, float]]]


@dataclasses.dataclass(frozen=True)
class GateConfig:
    """What the gate evaluates and how much regression it tolerates.

    ``adversarial=True`` adds the worst-case rung: every candidate also
    runs the falsifier search (``scenarios.adversary.AdversarySearch`` —
    one more program, built once, budget-1 across all
    candidates), and a falsifier discovered BELOW
    ``adversarial_min_severity`` is a rejection carrying the falsifier's
    concrete params in the verdict — the supervisor feeds those back
    into the trainer's schedule (scenarios/adversary.py). Unlike the
    matrix rungs this is an ABSOLUTE floor, not a baseline regression:
    "must survive every family up to severity S" is the robustness
    contract a served policy owes, whoever served before it.
    """

    scenarios: Tuple[str, ...] = ("wind", "sensor_noise")
    severities: Tuple[float, ...] = (0.5, 1.0)
    eval_formations: int = 256
    eval_seed: int = 1234
    deterministic: bool = True
    metric: str = "episode_return_per_agent"
    clean_tolerance: float = 0.05  # relative clean-return slack vs served
    rung_tolerance: float = 0.10  # relative per-cell slack vs served
    # -- adversarial rung (off by default: it costs a second
    # program and generations x population eval cells per candidate) --
    adversarial: bool = False
    adversarial_scenarios: Tuple[str, ...] = ()  # () -> `scenarios`
    adversarial_min_severity: float = 0.5  # falsifier below this rejects
    adversarial_drop_tolerance: float = 0.2
    adversarial_max_severity: float = 1.5
    adversarial_grid: int = 4
    adversarial_generations: int = 3
    adversarial_formations: int = 64
    # -- eval deadline (chaos hardening) ---------------------------------
    # A candidate wedged past this many seconds (a hung device op, an
    # injected wedge) yields a ``gate_timeout`` verdict and the stream
    # moves on — one stuck eval must not stall the always-learning loop
    # forever. None/0 disables the deadline (the program's
    # FIRST eval includes its compile, so size this past the cold
    # compile or run a warmup candidate first).
    gate_timeout_s: Optional[float] = None


@dataclasses.dataclass
class GateVerdict:
    """One candidate's judgment — everything ``promotions.jsonl`` needs.

    ``falsifiers`` is None when the adversarial rung did not run, else
    the search's ``Falsifier.record()`` list (possibly empty) — so a
    rejection carries the exact disturbance params that broke the
    candidate, ready for ``scenarios.from_falsifiers`` (promotions.jsonl
    schema 3)."""

    step: int
    path: str
    passed: bool
    reasons: List[str]  # empty iff passed
    clean: Dict[str, float]
    cells: Cells
    baseline_step: Optional[int]
    eval_compiles: int
    eval_seconds: float
    falsifiers: Optional[List[dict]] = None
    adversary_compiles: int = 0
    # The eval deadline fired: the candidate wedged past gate_timeout_s
    # and was failed WITHOUT a completed eval (reasons[0] carries the
    # ``gate_timeout:`` taxonomy).
    timed_out: bool = False

    def record(self) -> dict:
        """The flat payload logged per candidate (PromotionLog adds
        schema/event/time)."""
        out = {
            "step": self.step,
            "checkpoint": self.path,
            "passed": self.passed,
            "reasons": list(self.reasons),
            "clean": self.clean,
            "cells": self.cells,
            "baseline_step": self.baseline_step,
            "gate_eval_compiles": self.eval_compiles,
            "gate_eval_seconds": round(self.eval_seconds, 4),
        }
        if self.falsifiers is not None:
            out["falsifiers"] = list(self.falsifiers)
            out["gate_adversary_compiles"] = self.adversary_compiles
        if self.timed_out:
            out["gate_timeout"] = True
        return out


def _relative_regression(candidate: float, baseline: float) -> float:
    """Scale-free drop of ``candidate`` below ``baseline`` (positive =
    worse). Denominated on |baseline| with a floor of 1 so a
    near-zero baseline cannot turn noise into infinity."""
    return (baseline - candidate) / max(abs(baseline), 1.0)


def judge_candidate(
    metric: str,
    clean: Dict[str, float],
    cells: Cells,
    baseline_clean: Optional[Dict[str, float]],
    baseline_cells: Optional[Cells],
    clean_tolerance: float,
    rung_tolerance: float,
) -> List[str]:
    """Pure verdict logic: the list of rejection reasons (empty = pass).

    Separated from the gate so the rejection taxonomy is unit-testable
    without a single eval (tests/test_pipeline.py feeds it synthetic
    numbers for every branch).
    """
    reasons: List[str] = []
    outputs = [clean] + [
        m for per_sev in cells.values() for m in per_sev.values()
    ]
    missing = [m for m in outputs if metric not in m]
    if missing and any(m for m in outputs):
        # The eval ran and emitted metrics, just not THIS one: a config
        # typo, not corruption — name the fix, don't blame the params.
        emitted = sorted({k for m in outputs for k in m})
        reasons.append(
            f"gate metric {metric!r} absent from eval output (emitted: "
            f"{', '.join(emitted)}) — check the gate metric config"
        )
        return reasons
    values = [m.get(metric, math.nan) for m in outputs]
    if not all(math.isfinite(v) for v in values):
        reasons.append(
            f"non-finite {metric} in candidate eval (corrupted or "
            "diverged parameters)"
        )
        return reasons  # NaN poisons every comparison below; stop here
    if baseline_clean is None:
        return reasons  # bootstrap: nothing served to regress against
    drop = _relative_regression(
        clean.get(metric, math.nan), baseline_clean.get(metric, math.nan)
    )
    if not math.isfinite(drop) or drop > clean_tolerance:
        reasons.append(
            f"clean {metric} regressed {drop * 100.0:.1f}% vs served "
            f"baseline (tolerance {clean_tolerance * 100.0:.1f}%)"
        )
    for scenario, per_sev in cells.items():
        base_sev = (baseline_cells or {}).get(scenario, {})
        for sev, metrics in per_sev.items():
            base = base_sev.get(sev)
            if base is None:
                continue  # no baseline cell: nothing to regress against
            drop = _relative_regression(
                metrics.get(metric, math.nan), base.get(metric, math.nan)
            )
            if not math.isfinite(drop) or drop > rung_tolerance:
                reasons.append(
                    f"severity rung {scenario}@{sev} {metric} regressed "
                    f"{drop * 100.0:.1f}% vs served baseline (tolerance "
                    f"{rung_tolerance * 100.0:.1f}%)"
                )
    return reasons


def judge_falsifiers(
    falsifiers: List[dict], min_severity: float, metric: str
) -> List[str]:
    """Pure adversarial-rung verdict: rejection reasons for falsifiers
    below the severity floor (empty = the candidate survives every
    searched family up to the floor). Unit-testable without an eval,
    like :func:`judge_candidate`."""
    reasons: List[str] = []
    for falsifier in falsifiers:
        severity = float(falsifier.get("severity", math.nan))
        if not math.isfinite(severity) or severity < min_severity:
            drop = float(falsifier.get("drop", math.nan))
            reasons.append(
                f"adversarial falsifier {falsifier.get('scenario')}"
                f"@{severity:g}: {metric} drops {drop * 100.0:.1f}% vs "
                f"clean below the severity floor {min_severity:g}"
            )
    return reasons


class PromotionGate:
    """Judge candidates against the served baseline with one
    eval program.

    The program is built lazily from the FIRST loadable candidate (the
    checkpoint records its own architecture) and reused for every later
    one; a candidate with a different architecture is a rejection, not a
    rebuild (``MatrixProgram.check_params``).

    ``device`` is where candidates load and evaluate (``cuda`` when None;
    ``train.assign_gate_device`` picks it under the Sebulba partition).
    ``program`` goes to both programs' ``EpisodeProgram`` (tests start the
    matrix from JAX's resets and draws with ``initial_state`` and
    ``streams_factory``; ``capture=False`` keeps the card eager).
    """

    def __init__(
        self,
        env_params: EnvParams,
        config: GateConfig = GateConfig(),
        device=None,
        **program,
    ) -> None:
        self.env_params = env_params
        self.config = config
        # Slice assignment (train/sebulba): the gate's programs live on
        # this device, beside the learner's rather than interleaved with
        # it where the card count allows; on one card it is the learner's
        # own device, a time-share (``gate_device`` records it).
        self.device = device
        self._program_options = program
        self.program = None  # scenarios.matrix.MatrixProgram, lazy
        self.adversary = None  # scenarios.adversary.AdversarySearch, lazy
        self._baseline_step: Optional[int] = None  # guarded by _eval_lock
        self._baseline_clean: Optional[Dict[str, float]] = None  # guarded by _eval_lock
        self._baseline_cells: Optional[Cells] = None  # guarded by _eval_lock
        # Serializes eval bodies. The deadline wrapper ABANDONS a
        # wedged eval thread, but CPython cannot kill it — when it
        # wakes it would otherwise race the next candidate's eval on
        # shared gate state (the lazy program/adversary builds would
        # double-compile, breaking the budget-1 receipt). Under the
        # lock a still-wedged gate makes later candidates time out too
        # (honest: the gate IS wedged) until the stuck thread drains.
        self._eval_lock = threading.Lock()
        # Promoted-step history so a rollback can rebase the comparison
        # point without re-evaluating (bounded: serving history is short).
        self._history: Dict[int, Tuple[Dict[str, float], Cells]] = {}  # guarded by _eval_lock
        self._history_order: List[int] = []  # guarded by _eval_lock
        self.eval_seconds_total = 0.0  # guarded by _eval_lock
        self.cells_evaluated = 0  # guarded by _eval_lock

    # -- evaluation ------------------------------------------------------

    @property
    def baseline_step(self) -> Optional[int]:
        return self._baseline_step

    def evaluate(
        self, path: str | Path, trace_id: Optional[str] = None
    ) -> GateVerdict:
        """Run one candidate through the matrix + regression checks.
        Never raises for a bad candidate — unloadable / wrong-
        architecture / non-finite candidates are failed verdicts with
        the reason recorded. ``trace_id`` labels the eval span (obs/)
        so the gate leg of a promotion trace carries the candidate's
        identity.

        With ``gate_timeout_s`` set, the eval runs on a worker thread
        under a deadline: a candidate wedged past it (hung device op,
        injected wedge) yields a ``gate_timeout`` verdict and the
        stream moves on — the wedged thread is abandoned (CPython
        cannot kill it) and its late result discarded."""
        path = Path(path)
        timeout = self.config.gate_timeout_s
        if not timeout:
            return self._evaluate_inner(path, trace_id)
        box: List[GateVerdict] = []
        worker = threading.Thread(
            target=lambda: box.append(self._evaluate_inner(path, trace_id)),
            name="gate-eval",
            daemon=True,
        )
        worker.start()
        worker.join(float(timeout))
        if box:
            return box[0]
        try:
            step = checkpoint_step(path)
        except ValueError:
            step = -1
        if worker.is_alive():
            reason = (
                f"gate_timeout: eval exceeded gate_timeout_s="
                f"{float(timeout):g}s (wedged candidate; the stream "
                "moves on, the stuck eval thread is abandoned)"
            )
        else:
            # The worker died without producing a verdict — an
            # uncontained (BaseException-grade) kill. Same taxonomy:
            # this candidate never finished its eval.
            reason = (
                "gate_timeout: eval thread died before producing a "
                "verdict (crashed candidate)"
            )
        get_registry().counter("pipeline_gate_timeouts_total").inc()
        get_tracer().incident(
            "gate_timeout", trace_id=trace_id, step=step, path=str(path),
            gate_timeout_s=float(timeout),
        )
        return GateVerdict(
            step=step,
            path=str(path),
            passed=False,
            reasons=[reason],
            clean={},
            cells={},
            baseline_step=self._baseline_step,
            eval_compiles=(
                self.program.compile_count if self.program else 0
            ),
            eval_seconds=float(timeout),
            timed_out=True,
        )

    def _evaluate_inner(
        self, path: Path, trace_id: Optional[str] = None
    ) -> GateVerdict:
        with self._eval_lock:
            return self._evaluate_unlocked(path, trace_id)

    # Caller holds _eval_lock.
    def _evaluate_unlocked(
        self, path: Path, trace_id: Optional[str] = None
    ) -> GateVerdict:
        from marl_distributedformation_tpu_torch.compat.policy import (
            LoadedPolicy,
        )
        from marl_distributedformation_tpu_torch.scenarios.matrix import (
            MatrixProgram,
        )

        path = Path(path)
        cfg = self.config
        try:
            step = checkpoint_step(path)
        except ValueError as e:
            # Not a checkpoint-shaped filename — unreachable via the
            # stream (regex-filtered) but a direct caller still gets a
            # rejected verdict, not an exception.
            return GateVerdict(
                step=-1,
                path=str(path),
                passed=False,
                reasons=[f"not a checkpoint path: {e!r}"],
                clean={},
                cells={},
                baseline_step=self._baseline_step,
                eval_compiles=(
                    self.program.compile_count if self.program else 0
                ),
                eval_seconds=0.0,
            )
        try:
            # The chaos seam for the whole eval body: a wedge here (on
            # the deadline wrapper's worker thread) exercises
            # gate_timeout_s; a raise is a contained rejected verdict.
            fault_point("gate.eval", path=path)
            pol = LoadedPolicy.from_checkpoint(
                path,
                act_dim=self.env_params.act_dim,
                env_params=self.env_params,
                device=self.device,
            )
            if self.program is None:
                self.program = MatrixProgram(
                    pol.model,
                    self.env_params,
                    num_formations=cfg.eval_formations,
                    deterministic=cfg.deterministic,
                    seed=cfg.eval_seed,
                    device=self.device,
                    **self._program_options,
                )
            t0 = time.perf_counter()
            # The span wraps the MatrixProgram calls from the HOST side
            # (dispatch + drain): recording happens after the program
            # returns, never inside it.
            with get_tracer().span(
                "gate.matrix_eval", trace_id=trace_id, step=step,
                cells=1 + len(cfg.scenarios) * len(cfg.severities),
            ):
                clean = self.program.evaluate_clean(
                    pol.params, origin=str(path)
                )
                cells = self.program.evaluate_cells(
                    pol.params, cfg.scenarios, cfg.severities,
                    origin=str(path),
                )
            falsifiers = None
            if cfg.adversarial:
                # The adversarial rung: its OWN population program (another
                # shape than the matrix runner's), built once from the
                # first candidate and budget-1 across every later one,
                # like the matrix itself.
                if self.adversary is None:
                    from marl_distributedformation_tpu_torch.scenarios import (
                        AdversaryConfig,
                        AdversarySearch,
                    )

                    self.adversary = AdversarySearch(
                        pol.model,
                        self.env_params,
                        AdversaryConfig(
                            scenarios=(
                                cfg.adversarial_scenarios or cfg.scenarios
                            ),
                            metric=cfg.metric,
                            drop_tolerance=cfg.adversarial_drop_tolerance,
                            max_severity=cfg.adversarial_max_severity,
                            grid=cfg.adversarial_grid,
                            generations=cfg.adversarial_generations,
                            num_formations=cfg.adversarial_formations,
                            seed=cfg.eval_seed,
                            deterministic=cfg.deterministic,
                        ),
                        device=self.device,
                        **self._program_options,
                    )
                with get_tracer().span(
                    "gate.adversary_search", trace_id=trace_id, step=step,
                ):
                    search_report = self.adversary.search(
                        pol.params, origin=str(path)
                    )
                falsifiers = search_report["falsifiers"]
        except Exception as e:  # noqa: BLE001 — a bad candidate must
            # never kill the pipeline; it is a rejected verdict.
            return GateVerdict(
                step=step,
                path=str(path),
                passed=False,
                reasons=[f"candidate failed to load/evaluate: {e!r}"],
                clean={},
                cells={},
                baseline_step=self._baseline_step,
                eval_compiles=(
                    self.program.compile_count if self.program else 0
                ),
                eval_seconds=0.0,
            )
        seconds = time.perf_counter() - t0
        self.eval_seconds_total += seconds
        self.cells_evaluated += 1 + len(cfg.scenarios) * len(cfg.severities)
        reasons = judge_candidate(
            cfg.metric,
            clean,
            cells,
            self._baseline_clean,
            self._baseline_cells,
            cfg.clean_tolerance,
            cfg.rung_tolerance,
        )
        if falsifiers is not None:
            reasons.extend(
                judge_falsifiers(
                    falsifiers, cfg.adversarial_min_severity, cfg.metric
                )
            )
        return GateVerdict(
            step=step,
            path=str(path),
            passed=not reasons,
            reasons=reasons,
            clean=clean,
            cells=cells,
            baseline_step=self._baseline_step,
            eval_compiles=self.program.compile_count,
            eval_seconds=seconds,
            falsifiers=falsifiers,
            adversary_compiles=(
                self.adversary.compile_count if self.adversary else 0
            ),
        )

    # -- baseline management ---------------------------------------------

    def accept(self, verdict: GateVerdict, keep_history: int = 8) -> None:
        """Install a PROMOTED candidate's already-computed evals as the
        new comparison baseline (no re-eval, ever). Takes the eval lock:
        an ABANDONED eval thread (deadline wrapper gave up on it) that
        wakes mid-install must not judge against a half-replaced
        baseline — the same wedge hazard the lock already serializes
        between candidate evals."""
        assert verdict.passed, "only promoted candidates become baselines"
        with self._eval_lock:
            self._baseline_step = verdict.step
            self._baseline_clean = verdict.clean
            self._baseline_cells = verdict.cells
            self._history[verdict.step] = (verdict.clean, verdict.cells)
            self._history_order.append(verdict.step)
            while len(self._history_order) > keep_history:
                dropped = self._history_order.pop(0)
                if dropped != self._baseline_step:
                    self._history.pop(dropped, None)

    def rebase(self, step: int) -> None:
        """After a rollback: judge future candidates against the
        checkpoint that is serving AGAIN. A step evicted from the
        bounded history (a demotion cascade longer than
        ``keep_history``) degrades to bootstrap judging — finite
        candidates pass until the next promotion re-establishes a real
        baseline — rather than crashing the control plane. Locked like
        :meth:`accept` (same abandoned-eval race)."""
        with self._eval_lock:
            entry = self._history.get(step)
            if entry is None:
                self._baseline_step = step
                self._baseline_clean = None
                self._baseline_cells = None
                return
            clean, cells = entry
            self._baseline_step = step
            self._baseline_clean = clean
            self._baseline_cells = cells

    # -- observability ---------------------------------------------------

    def device_str(self) -> Optional[str]:
        """The assigned eval device as a stable label (None: the default
        device) — the promotion span breakdown records which slice
        served each gate eval."""
        return str(self.device) if self.device is not None else None

    def eval_steps_per_sec(self) -> float:
        """Gate throughput in formation-env-steps evaluated per second
        (cells x formations x episode length over cumulative eval
        wall-clock) — the bench's ``gate_eval_steps_per_sec``."""
        if self.eval_seconds_total <= 0:
            return 0.0
        steps = (
            self.cells_evaluated
            * self.config.eval_formations
            * episode_length(self.env_params)
        )
        return steps / self.eval_seconds_total
