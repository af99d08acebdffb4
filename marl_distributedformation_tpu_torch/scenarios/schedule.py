"""Severity schedules and domain-randomization stages for scenario training.

A copy of the JAX package's ``scenarios/schedule.py``: the schedule is host
data, with no JAX in it. The shape mirrors ``train/curriculum.py``'s ``Curriculum``/``CurriculumStage``
(the repo's existing staged-training idiom): an ordered tuple of stages,
each naming the scenario subset to randomize over and a severity ramp.
Unlike the hetero curriculum — whose stage boundaries rebuild env state —
a scenario stage transition is pure data (a new probs vector and severity
written into the same buffers the captured iteration reads), so schedules
never recapture and compose with ``fused_chunk`` chunks.

Config forms accepted by ``schedule_from_cfg`` (cfg key ``scenarios``):

- a list of names: one flat stage at ``scenario_severity``
  (``scenarios=[wind,sensor_noise] scenario_severity=0.6``);
- a list of stage dicts (YAML string or parsed), each
  ``{rollouts, scenarios, severity, severity_start?}`` — severity ramps
  linearly from ``severity_start`` (default: previous stage's end, 0 for
  the first) to ``severity`` over the stage's rollouts.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np

from marl_distributedformation_tpu_torch.scenarios.registry import (
    ScenarioSpec,
    get_scenario,
    register_scenario,
)


@dataclasses.dataclass(frozen=True)
class ScenarioStage:
    """One schedule phase: randomize over ``scenarios`` while severity
    ramps ``severity_start -> severity`` across ``rollouts``."""

    rollouts: int
    scenarios: Tuple[str, ...]
    severity: float = 0.5
    severity_start: Optional[float] = None

    def __post_init__(self) -> None:
        # User config reaches here — real raises, not asserts (asserts
        # vanish under -O and name neither the stage nor the key).
        if self.rollouts <= 0:
            raise ValueError(
                f"scenario stage {self.scenarios!r}: rollouts must be "
                f"positive, got {self.rollouts}"
            )
        if not self.scenarios:
            raise ValueError("a scenario stage needs at least one scenario")
        for name in self.scenarios:
            get_scenario(name)  # fail fast at construction, naming entries
        if self.severity < 0.0:
            raise ValueError(
                f"scenario stage {self.scenarios!r}: severity must be "
                f"non-negative, got {self.severity}"
            )


@dataclasses.dataclass(frozen=True)
class ScenarioSchedule:
    """An ordered sequence of stages; indexing past the end holds the
    last stage at its end severity (runs whose budget outlives the
    schedule keep training at the final difficulty)."""

    stages: Tuple[ScenarioStage, ...]

    def __post_init__(self) -> None:
        if not self.stages:
            raise ValueError("a scenario schedule needs at least one stage")

    @property
    def names(self) -> Tuple[str, ...]:
        """Union of every stage's scenarios, first-seen order: the fixed
        spec axis the sampler draws over."""
        seen: List[str] = []
        for stage in self.stages:
            for name in stage.scenarios:
                if name not in seen:
                    seen.append(name)
        return tuple(seen)

    @property
    def total_rollouts(self) -> int:
        return sum(s.rollouts for s in self.stages)

    def stage_at(self, rollout: int) -> Tuple[ScenarioStage, int]:
        """(stage, rollout-within-stage) for a global rollout index."""
        done = 0
        for stage in self.stages:
            if rollout < done + stage.rollouts:
                return stage, rollout - done
            done += stage.rollouts
        last = self.stages[-1]
        return last, last.rollouts - 1

    def severity_at(self, rollout: int) -> float:
        """Host-side severity for a global rollout index (linear ramp
        within the stage; stage starts default to the previous end)."""
        start = 0.0
        done = 0
        for stage in self.stages:
            lo = stage.severity_start if stage.severity_start is not None else start
            if rollout < done + stage.rollouts:
                frac = (
                    (rollout - done) / (stage.rollouts - 1)
                    if stage.rollouts > 1
                    else 1.0
                )
                return float(lo + (stage.severity - lo) * frac)
            start = stage.severity
            done += stage.rollouts
        return float(self.stages[-1].severity)

    def probs_at(self, rollout: int) -> np.ndarray:
        """Uniform distribution over the active stage's scenarios, laid
        out on the schedule's union ``names`` axis (zeros elsewhere)."""
        stage, _ = self.stage_at(rollout)
        names = self.names
        probs = np.zeros((len(names),), np.float32)
        for name in stage.scenarios:
            probs[names.index(name)] = 1.0
        return probs / probs.sum()

    @functools.cached_property
    def _stage_table(self):
        """Vectorized twin of the per-rollout walk — one numpy row per
        stage: ``(starts, rollouts, lo, hi, probs_matrix)``. Chunked
        sampling at population scale calls the chunk methods once per
        fused dispatch with ``k`` up to the chunk size; an O(k · stages)
        Python loop there is measurable host work on the dispatch lane,
        while this table turns both chunk methods into a handful of
        vectorized ops. (``cached_property`` stores via the instance
        ``__dict__``, bypassing the frozen-dataclass ``__setattr__``.)"""
        starts, rollouts, lo, hi = [], [], [], []
        probs = []
        done = 0
        prev_end = 0.0
        names = self.names
        for stage in self.stages:
            starts.append(done)
            rollouts.append(stage.rollouts)
            lo.append(
                stage.severity_start
                if stage.severity_start is not None
                else prev_end
            )
            hi.append(stage.severity)
            row = np.zeros((len(names),), np.float32)
            for name in stage.scenarios:
                row[names.index(name)] = 1.0
            probs.append(row / row.sum())
            prev_end = stage.severity
            done += stage.rollouts
        return (
            np.asarray(starts, np.int64),
            np.asarray(rollouts, np.int64),
            np.asarray(lo, np.float64),
            np.asarray(hi, np.float64),
            np.stack(probs, axis=0),
        )

    def _stage_indices(self, rollout: int, k: int) -> np.ndarray:
        starts, rollouts, _, _, _ = self._stage_table
        r = np.arange(rollout, rollout + k)
        # Past-the-end rollouts hold the last stage (stage_at's clamp).
        return np.minimum(
            np.searchsorted(starts + rollouts, r, side="right"),
            len(starts) - 1,
        )

    def severity_chunk(self, rollout: int, k: int) -> np.ndarray:
        """``(k,)`` float32 severities for rollouts ``[rollout, rollout+k)``
        — the per-iteration schedule points a fused chunk trains at
        (stage transitions and ramp steps land INSIDE the chunk, exactly
        where ``k`` host-loop dispatches would put them). Vectorized over
        the chunk, element-for-element identical to :meth:`severity_at`
        (same float64 ramp arithmetic, rounded to f32 at the end)."""
        starts, rollouts, lo, hi, _ = self._stage_table
        idx = self._stage_indices(rollout, k)
        r = np.arange(rollout, rollout + k)
        # Rollouts past the schedule clamp to the final severity
        # (frac=1); single-rollout stages ramp straight to `hi`.
        within = np.minimum(r - starts[idx], rollouts[idx] - 1)
        frac = np.where(
            rollouts[idx] > 1,
            within / np.maximum(rollouts[idx] - 1, 1),
            1.0,
        )
        return (lo[idx] + (hi[idx] - lo[idx]) * frac).astype(np.float32)

    def probs_chunk(self, rollout: int, k: int) -> np.ndarray:
        """``(k, len(names))`` scenario-mix distributions for rollouts
        ``[rollout, rollout+k)`` on the union ``names`` axis — the chunked
        twin of :meth:`probs_at`, one table gather instead of a per-index
        stage walk."""
        _, _, _, _, probs = self._stage_table
        return probs[self._stage_indices(rollout, k)]


# Derived adversarial-spec naming: one STABLE name per attacked family,
# so repeated falsifier feedback for the same scenario overwrites the
# spec in place (the schedule's name union, and with it the trainer's
# sampler axis, never grows across feedback rounds).
ADV_SCENARIO_PREFIX = "adv:"


def from_falsifiers(
    falsifiers: Sequence[Any],
    rollouts: int = 100,
    include_clean: bool = True,
    severity_scale: float = 1.0,
) -> ScenarioSchedule:
    """Turn discovered worst cases into an auto-curriculum stage.

    ``falsifiers`` are ``adversary.Falsifier`` objects (either package's) or
    their ``record()`` dicts (anything with ``scenario`` + ``severity``). Each one registers a derived
    spec ``adv:{scenario}`` whose severity-1 magnitudes are the base
    family's scaled to the falsifier severity (times
    ``severity_scale``), so the returned single-stage schedule trains a
    uniform mix of every falsifier AT its discovered break point
    (severity 1.0, flat — each family at its own magnitudes, which one
    shared stage severity could not express). ``include_clean`` keeps
    the identity scenario in the mix: pure worst-case training forgets
    the clean task (the auto-curriculum retention trade, JaxMARL /
    Jumanji idiom — docs/adversarial.md).

    Consumed by the trainer via ``Trainer.update_scenario_schedule`` /
    ``request_scenario_schedule``: stage data and spec magnitudes are
    values, so the captured iteration is never recaptured.
    """
    if not falsifiers:
        raise ValueError("from_falsifiers needs at least one falsifier")
    names: List[str] = []
    magnitude_fields = [
        f.name
        for f in dataclasses.fields(ScenarioSpec)
        if f.name not in ("name", "description")
    ]
    for falsifier in falsifiers:
        if isinstance(falsifier, dict):
            scenario = str(falsifier["scenario"])
            severity = falsifier["severity"]
        else:
            scenario = str(falsifier.scenario)
            severity = falsifier.severity
        severity = float(severity) * float(severity_scale)
        if not math.isfinite(severity) or severity <= 0.0:
            raise ValueError(
                f"falsifier for scenario {scenario!r} has severity "
                f"{severity!r}; a training stage needs a finite positive "
                "severity (severity 0 is the clean env by construction)"
            )
        base = get_scenario(scenario)  # fail fast on unknown families
        derived = ScenarioSpec(
            name=f"{ADV_SCENARIO_PREFIX}{scenario}",
            description=(
                f"adversarial curriculum: {scenario} at discovered "
                f"falsifier severity {severity:g}"
            ),
            **{
                field: getattr(base, field) * severity
                for field in magnitude_fields
            },
        )
        register_scenario(derived, overwrite=True)
        if derived.name not in names:
            names.append(derived.name)
    if include_clean:
        names.append("clean")
    return ScenarioSchedule(
        stages=(
            ScenarioStage(
                rollouts=int(rollouts),
                scenarios=tuple(names),
                severity=1.0,
                severity_start=1.0,
            ),
        )
    )


def schedule_from_cfg(
    cfg: Any, default_severity: float = 0.5
) -> ScenarioSchedule:
    """Build a schedule from the ``scenarios`` config value (module doc).
    A YAML string (quoted CLI override) is parsed first."""
    if isinstance(cfg, str):
        import yaml

        cfg = yaml.safe_load(cfg)
    if not isinstance(cfg, (list, tuple)) or not cfg:
        raise ValueError(
            "scenarios must be a non-empty list of scenario names or "
            f"stage dicts, got {cfg!r}"
        )
    if all(isinstance(entry, str) for entry in cfg):
        return ScenarioSchedule(
            stages=(
                ScenarioStage(
                    rollouts=1,
                    scenarios=tuple(cfg),
                    severity=float(default_severity),
                    severity_start=float(default_severity),
                ),
            )
        )
    stages = []
    for entry in cfg:
        if not isinstance(entry, dict):
            raise ValueError(
                "scenario stages must all be dicts (or all names), got "
                f"{entry!r}"
            )
        unknown = set(entry) - {
            "rollouts", "scenarios", "severity", "severity_start",
        }
        if unknown:
            raise ValueError(
                f"unknown scenario-stage keys {sorted(unknown)}; valid: "
                "rollouts, scenarios, severity, severity_start"
            )
        stages.append(
            ScenarioStage(
                rollouts=int(entry.get("rollouts", 1)),
                scenarios=tuple(str(n) for n in entry["scenarios"]),
                severity=float(entry.get("severity", default_severity)),
                severity_start=(
                    float(entry["severity_start"])
                    if entry.get("severity_start") is not None
                    else None
                ),
            )
        )
    return ScenarioSchedule(stages=tuple(stages))
