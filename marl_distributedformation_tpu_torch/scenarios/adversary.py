"""Worst-case severity search: the minimal falsifier of a checkpoint.

Counterpart of the JAX package's ``scenarios/adversary.py``. The robustness
matrix (``matrix.py``) answers "how does this policy do at severities
chosen ahead of time?"; this module answers "what is the smallest severity
at which each scenario family breaks this policy?", the minimal-severity
*falsifier*.

A search generation evaluates a population of ``P = 1 + families x grid``
candidate ``ScenarioParams`` in one program. The JAX package vmaps the
episode over the candidates with one key broadcast; the port folds the
candidates into the formation batch: P x M formations, candidate p on
rows ``p*M:(p+1)*M`` with its params repeated there, every candidate
starting from the same M initial states with the same reset, action and
layer draws (drawn for M and tiled, ``matrix.EpisodeProgram``), its
dense layers batched by copy (``matrix.CopyBatchedLinear``), and each
metric reduced over the candidate's own formations. The population's shape
is fixed, so the program is built once for the life of the search, across
every generation and every same-architecture checkpoint
(``compile_count``, the ``RetraceGuard`` receipt).

The search is grid-refine bracketing, a copy of the JAX package's host
logic: generation 0 lays a coarse grid over ``(0, max_severity]`` per
family; each later generation subdivides the bracket between the highest
severity seen safe below the break and the lowest seen falsified, until
the bracket is narrower than ``resolution`` or the generations run out.
"Falsified" means the metric drops more than ``drop_tolerance``
(relative) below the clean cell, which rides as row 0 of every
generation. Severity 0 is never a falsifier: the disturbance stack is the
clean env bitwise at zero.

``schedule.from_falsifiers`` turns a report into a training stage, and
``ContinuousAdversary`` closes the train -> falsify -> train loop over a
trainer's checkpoints.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from marl_distributedformation_tpu_torch.analysis.guards import (
    RetraceGuard,
)
from marl_distributedformation_tpu_torch.device import DeviceLike
from marl_distributedformation_tpu_torch.env.types import EnvParams
from marl_distributedformation_tpu_torch.scenarios.matrix import (
    EpisodeProgram,
    params_signature,
)
from marl_distributedformation_tpu_torch.scenarios.params import (
    ScenarioParams,
    stack_params,
)
from marl_distributedformation_tpu_torch.scenarios.registry import (
    ScenarioSpec,
    get_scenario,
    registered_scenarios,
)

Tensor = torch.Tensor

# Bump when the falsifier record or the report's shape changes (the
# adversarial_search CLI writes it, schedule.from_falsifiers reads it).
FALSIFIERS_SCHEMA = 1


@dataclasses.dataclass(frozen=True)
class AdversaryConfig:
    """What the search attacks and how hard it refines.

    ``scenarios=()`` attacks every registered family except ``clean``. A
    family that survives ``max_severity`` is reported *robust*, not
    falsified; widen ``max_severity`` to keep pushing.
    """

    scenarios: Tuple[str, ...] = ()
    metric: str = "episode_return_per_agent"
    drop_tolerance: float = 0.2  # relative drop vs clean that "breaks"
    max_severity: float = 1.5
    grid: int = 6  # candidates per family per generation
    generations: int = 4
    resolution: float = 0.02  # stop refining below this bracket width
    num_formations: int = 64
    seed: int = 1234
    deterministic: bool = True

    def __post_init__(self) -> None:
        if self.grid < 1:
            raise ValueError(f"grid must be >= 1, got {self.grid}")
        if self.generations < 1:
            raise ValueError(
                f"generations must be >= 1, got {self.generations}"
            )
        if not (self.max_severity > 0.0):
            raise ValueError(
                f"max_severity must be positive, got {self.max_severity}"
            )


@dataclasses.dataclass(frozen=True)
class Falsifier:
    """One family's minimal break point found. ``params`` is the knob dict
    at the falsifier severity (``ScenarioParams`` fields as host floats):
    what a training stage or an audit log needs to reproduce the
    disturbance without the registry."""

    scenario: str
    severity: float
    value: float  # the metric at the falsifier severity
    clean: float  # the same checkpoint's clean-cell metric
    drop: float  # relative drop vs clean (> drop_tolerance)
    params: Dict[str, object]

    def record(self) -> dict:
        return {
            "scenario": self.scenario,
            "severity": round(self.severity, 6),
            "value": self.value,
            "clean": self.clean,
            "drop": round(self.drop, 6),
            "params": self.params,
        }


def _relative_drop(candidate: float, baseline: float) -> float:
    """Scale-free drop of ``candidate`` below ``baseline`` (positive =
    worse); ``|baseline|`` floored at 1, so a near-zero clean return cannot
    turn noise into infinity."""
    return (baseline - candidate) / max(abs(baseline), 1.0)


def scenario_knobs(spec: ScenarioSpec, severity: float) -> Dict[str, object]:
    """The ``ScenarioParams`` knobs of ``spec`` at ``severity`` as host
    floats (``wind`` as a 2-list): the portable falsifier payload."""
    built = spec.build(np.float32(severity))
    out: Dict[str, object] = {}
    for field in dataclasses.fields(ScenarioParams):
        leaf = getattr(built, field.name).numpy()
        out[field.name] = (
            float(leaf) if leaf.ndim == 0 else [float(v) for v in leaf]
        )
    return out


def make_population_runner(
    model: torch.nn.Module,
    env_params: EnvParams,
    num_formations: int,
    deterministic: bool = True,
    max_traces: Optional[int] = 1,
    **program,
) -> Tuple[Callable[..., Dict[str, Tensor]], RetraceGuard]:
    """``(run, guard)``: ``run(params, stacked_params)`` -> each
    candidate's episode metrics, ``(P,)`` device tensors, for a
    ``(P,)``-stacked ``ScenarioParams`` population folded into P x M
    formations; every candidate rolls the same initial states and draws,
    so cells differ only by their disturbance, as in the matrix. One
    program for the whole search (``guard`` is the receipt). ``program``
    goes to ``matrix.EpisodeProgram`` (``seed``, ``device``, ``capture``,
    the tests' ``initial_state`` and ``streams_factory``)."""
    guard = RetraceGuard("adversary_population_eval", max_traces=max_traces)
    prog = EpisodeProgram(model, env_params, num_formations, deterministic,
                          guard=guard, **program)
    return prog.run, guard


def _stack_rows(rows: Sequence[Tuple[ScenarioSpec, float]]) -> ScenarioParams:
    """Each candidate's ``spec.build(severity)`` stacked on a leading
    ``(P,)`` axis, on the host (the population program's input)."""
    return stack_params(spec.build(float(sev)) for spec, sev in rows)


class AdversarySearch:
    """The reusable falsifier-search program (``MatrixProgram``'s
    contract): construction builds nothing, the single build happens on
    the first generation, and every later generation, for this checkpoint
    or a later same-architecture one, reuses it. ``program`` goes to
    ``matrix.EpisodeProgram`` (``capture`` and the tests' hooks)."""

    def __init__(
        self,
        model: torch.nn.Module,
        env_params: EnvParams,
        config: AdversaryConfig = AdversaryConfig(),
        max_traces: Optional[int] = 1,
        device: DeviceLike = None,
        **program,
    ) -> None:
        self.env_params = env_params
        self.config = config
        names = config.scenarios or tuple(
            n for n in registered_scenarios() if n != "clean"
        )
        self.specs: Tuple[ScenarioSpec, ...] = tuple(
            get_scenario(str(n)) for n in names  # fail fast, by name
        )
        if not self.specs:
            raise ValueError("adversary search needs at least one scenario")
        self._clean_spec = get_scenario("clean")
        # Fixed population: 1 clean anchor row + grid rows per family, so
        # the program's shapes never change.
        self.population = 1 + len(self.specs) * config.grid
        self.run, self.guard = make_population_runner(
            model, env_params, config.num_formations, config.deterministic,
            max_traces, seed=config.seed, device=device, **program,
        )
        self._signature: Optional[Tuple] = None
        self.candidates_evaluated = 0
        self.search_seconds_total = 0.0
        # Each searched origin's final brackets, by family: ``(lo, hi)``,
        # the highest severity seen safe below the break and the lowest
        # seen falsified (``None``: robust in range).
        self.brackets: Dict[str, Dict[str, Tuple[float, Optional[float]]]] = {}

    @property
    def compile_count(self) -> int:
        """Builds of the shared population program so far (stays 1 across
        every generation and checkpoint)."""
        return self.guard.count

    def check_params(self, params, origin: str = "<candidate>") -> None:
        """The one-architecture contract, the matrix's rule: another
        structure or shape fails here, by name."""
        sig = params_signature(params)
        if self._signature is None:
            self._signature = sig
        elif sig != self._signature:
            raise ValueError(
                f"checkpoint {origin} has a different parameter "
                "structure/shape than the first candidate — the search "
                "shares one compiled population program, so all "
                "candidates must be one architecture"
            )

    # -- evaluation ------------------------------------------------------

    def _evaluate(
        self, params, rows: List[Tuple[ScenarioSpec, float]]
    ) -> np.ndarray:
        """One generation: ``rows`` padded to the fixed population with
        clean anchors, one run of the program, the config metric per row
        (host floats)."""
        padded = list(rows) + [
            (self._clean_spec, 0.0) for _ in range(self.population - len(rows))
        ]
        out = self.run(params, _stack_rows(padded))
        metric = out.get(self.config.metric)
        if metric is None:
            raise ValueError(
                f"metric {self.config.metric!r} absent from the episode "
                f"eval output (emitted: {', '.join(sorted(out))})"
            )
        return metric.cpu().numpy().astype(np.float64)[: len(rows)]

    def evaluate_cells(
        self,
        params,
        cells: Sequence[Tuple[str, float]],
        origin: str = "<candidate>",
    ) -> List[float]:
        """The config metric at explicit ``(scenario, severity)`` cells,
        through the same program; ``len(cells)`` must fit the
        population."""
        self.check_params(params, origin)
        if len(cells) > self.population:
            raise ValueError(
                f"{len(cells)} cells exceed the population "
                f"({self.population}) — split into multiple calls"
            )
        rows = [
            (get_scenario(str(name)), float(sev)) for name, sev in cells
        ]
        return [float(v) for v in self._evaluate(params, rows)]

    # -- the search ------------------------------------------------------

    def _candidate_severities(
        self,
        lo: float,
        hi: Optional[float],
        done: bool,
    ) -> List[float]:
        """The next generation's probes for one family: fresh families
        grid ``(0, max_severity]``, bracketed ones subdivide ``(lo, hi)``,
        finished ones re-probe their break point (the population's shape
        is fixed; repeats are the cheap filler)."""
        cfg = self.config
        if done:
            return [hi if hi is not None else cfg.max_severity] * cfg.grid
        if hi is None:
            return [
                cfg.max_severity * (i + 1) / cfg.grid
                for i in range(cfg.grid)
            ]
        return [
            lo + (hi - lo) * (i + 1) / (cfg.grid + 1)
            for i in range(cfg.grid)
        ]

    def search(self, params, origin: str = "<candidate>") -> dict:
        """The minimal-severity falsifier per scenario family.

        Host-side control flow over metrics read back once a generation;
        each generation is one run of the population program.
        Deterministic at a fixed config and params. Returns the report
        (``falsifiers`` hold ``Falsifier.record()`` payloads).
        """
        self.check_params(params, origin)
        cfg = self.config
        t0 = time.perf_counter()
        lo: Dict[str, float] = {s.name: 0.0 for s in self.specs}
        hi: Dict[str, Optional[float]] = {s.name: None for s in self.specs}
        hi_value: Dict[str, float] = {}
        # A family is done when its bracket converged, or when a full
        # fresh grid up to max_severity found nothing to refine toward.
        done: Dict[str, bool] = {s.name: False for s in self.specs}
        clean: Optional[float] = None
        generations_run = 0
        for _ in range(cfg.generations):
            if all(done.values()):
                break
            rows: List[Tuple[ScenarioSpec, float]] = [(self._clean_spec, 0.0)]
            placements: List[Tuple[str, float]] = []
            for spec in self.specs:
                sevs = self._candidate_severities(
                    lo[spec.name], hi[spec.name], done[spec.name]
                )
                rows.extend((spec, s) for s in sevs)
                placements.extend((spec.name, s) for s in sevs)
            values = self._evaluate(params, rows)
            generations_run += 1
            self.candidates_evaluated += self.population
            if clean is None:
                clean = float(values[0])
            results: Dict[str, List[Tuple[float, float]]] = {}
            for (name, sev), value in zip(placements, values[1:]):
                results.setdefault(name, []).append((sev, float(value)))
            for spec in self.specs:
                name = spec.name
                if done[name]:
                    continue
                had_break = hi[name] is not None
                for sev, value in results[name]:
                    if _relative_drop(value, clean) > cfg.drop_tolerance:
                        if hi[name] is None or sev < hi[name]:
                            hi[name] = sev
                            hi_value[name] = value
                # Safe probes only raise the floor below the break point
                # (returns need not be monotone in severity: a safe pocket
                # above the first break is not the bracket).
                for sev, value in results[name]:
                    if (
                        _relative_drop(value, clean) <= cfg.drop_tolerance
                        and sev > lo[name]
                        and (hi[name] is None or sev < hi[name])
                    ):
                        lo[name] = sev
                if hi[name] is None:
                    # A full grid up to max_severity stayed safe: robust
                    # in range; re-gridding finds the same answer.
                    done[name] = not had_break
                elif hi[name] - lo[name] <= cfg.resolution:
                    done[name] = True
        seconds = time.perf_counter() - t0
        self.search_seconds_total += seconds
        self.brackets[str(origin)] = {
            s.name: (lo[s.name], hi[s.name]) for s in self.specs
        }

        falsifiers: List[Falsifier] = []
        robust: List[str] = []
        for spec in self.specs:
            severity = hi[spec.name]
            if severity is None:
                robust.append(spec.name)
                continue
            value = hi_value[spec.name]
            falsifiers.append(
                Falsifier(
                    scenario=spec.name,
                    severity=float(severity),
                    value=value,
                    clean=float(clean),
                    drop=_relative_drop(value, float(clean)),
                    params=scenario_knobs(spec, float(severity)),
                )
            )
        return {
            "schema": FALSIFIERS_SCHEMA,
            "origin": str(origin),
            "metric": cfg.metric,
            "drop_tolerance": cfg.drop_tolerance,
            "max_severity": cfg.max_severity,
            "resolution": cfg.resolution,
            "scenarios": [s.name for s in self.specs],
            "clean": float(clean) if clean is not None else None,
            "falsifiers": [f.record() for f in falsifiers],
            "robust": robust,
            "generations": generations_run,
            "population": self.population,
            "candidates": generations_run * self.population,
            "num_formations": cfg.num_formations,
            "seed": cfg.seed,
            "deterministic": cfg.deterministic,
            "eval_compiles": self.compile_count,
            "search_seconds": round(seconds, 4),
        }

    # -- observability ---------------------------------------------------

    def candidates_per_sec(self) -> float:
        """Search throughput in scenario candidates evaluated a second."""
        if self.search_seconds_total <= 0:
            return 0.0
        return self.candidates_evaluated / self.search_seconds_total


class ContinuousAdversary:
    """The falsifier search as a continuous lane over a trainer's
    checkpoints.

    It tails ``log_dir`` (``utils.checkpoint.latest_checkpoint``: always
    the newest, skipping intermediates), attacks each new checkpoint with
    one long-lived ``AdversarySearch`` (one build across every checkpoint
    it judges), and feeds discovered falsifiers back through
    ``on_schedule`` as a ``from_falsifiers`` training stage: pass a
    trainer's ``request_scenario_schedule``, which applies it at the next
    dispatch with the captured graphs unchanged. Drive it with
    ``poll_once`` (tests) or as a daemon thread with ``run``/``stop``.
    """

    def __init__(
        self,
        log_dir,
        env_params: EnvParams,
        config: AdversaryConfig = AdversaryConfig(),
        device: DeviceLike = None,
        on_schedule=None,
        feedback_rollouts: int = 50,
        **program,
    ) -> None:
        from pathlib import Path

        self.log_dir = Path(log_dir)
        self.env_params = env_params
        self.config = config
        self.device = device
        self.on_schedule = on_schedule
        self.feedback_rollouts = int(feedback_rollouts)
        self.program = program
        self.search: Optional[AdversarySearch] = None  # built lazily
        self.last_step = -1
        self.reports: List[dict] = []
        self.schedules_pushed = 0
        self.errors: List[str] = []
        self._stop = None  # threading.Event, created by run()
        self._thread = None

    def poll_once(self) -> Optional[dict]:
        """Attack the newest unseen checkpoint; None when there is nothing
        new. A bad candidate (a corrupt file, another architecture) is a
        recorded error, never a dead lane. On falsifiers, the feedback
        schedule goes through ``on_schedule`` (advisory: a failing
        callback is recorded and the lane keeps attacking)."""
        from marl_distributedformation_tpu_torch.compat.policy import (
            LoadedPolicy,
        )
        from marl_distributedformation_tpu_torch.utils.checkpoint import (
            checkpoint_step,
            latest_checkpoint,
        )

        path = latest_checkpoint(self.log_dir)
        if path is None:
            return None
        try:
            step = checkpoint_step(path)
        except ValueError:
            return None
        if step <= self.last_step:
            return None
        try:
            pol = LoadedPolicy.from_checkpoint(
                path, act_dim=self.env_params.act_dim,
                env_params=self.env_params, device=self.device,
            )
            if self.search is None:
                self.search = AdversarySearch(
                    pol.model, self.env_params, self.config,
                    device=self.device, **self.program,
                )
            report = self.search.search(pol.params, origin=str(path))
        except Exception as e:  # noqa: BLE001 — a bad checkpoint must
            # not kill the lane; the next one may be fine.
            self.errors.append(f"{path.name}: {e!r}"[:300])
            del self.errors[:-32]
            self.last_step = step  # never re-attack a broken file
            return None
        self.last_step = step
        report["step"] = step
        self.reports.append(report)
        if report["falsifiers"] and self.on_schedule is not None:
            from marl_distributedformation_tpu_torch.scenarios.schedule import (
                from_falsifiers,
            )

            try:
                self.on_schedule(
                    from_falsifiers(
                        report["falsifiers"],
                        rollouts=self.feedback_rollouts,
                    )
                )
                self.schedules_pushed += 1
            except Exception as e:  # noqa: BLE001 — feedback is advisory
                self.errors.append(f"on_schedule: {e!r}"[:300])
                del self.errors[:-32]
        return report

    # -- background lane -------------------------------------------------

    def run(self, interval_s: float = 1.0) -> "ContinuousAdversary":
        """Poll from a daemon thread every ``interval_s``."""
        import threading

        if self._thread is not None:
            return self
        self._stop = threading.Event()

        def loop() -> None:
            while not self._stop.is_set():
                try:
                    self.poll_once()
                except Exception as e:  # noqa: BLE001 — keep the lane up
                    self.errors.append(repr(e)[:300])
                    del self.errors[:-32]
                self._stop.wait(interval_s)

        self._thread = threading.Thread(
            target=loop, name="continuous-adversary", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join(timeout=30.0)
        self._thread = None

    def summary(self) -> dict:
        """A flat report of the lane."""
        return {
            "adversary_searches": len(self.reports),
            "adversary_last_step": self.last_step,
            "adversary_schedules_pushed": self.schedules_pushed,
            "adversary_falsifiers_last": (
                len(self.reports[-1]["falsifiers"]) if self.reports else 0
            ),
            "adversary_compiles": (
                self.search.compile_count if self.search is not None else 0
            ),
            "adversary_errors": list(self.errors),
        }
