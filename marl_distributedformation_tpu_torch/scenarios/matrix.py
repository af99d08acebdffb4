"""Robustness evaluation matrix: scenarios x severities x checkpoints.

Counterpart of the JAX package's ``scenarios/matrix.py``. JAX jits one
episode program that takes the model's parameters and the scenario's as
traced inputs, so the whole grid compiles once. The port's form is
``EpisodeProgram``: the model's parameters and a batch of ``ScenarioParams``
live in static buffers, and the evaluation step (act, the scenario step,
the metric row written at a step index kept on the device) is built once.
On the card the step is captured as a CUDA graph (``train/capture.py``)
and replayed ``episode_length`` times a cell; eagerly (the CPU) it runs as
a function. A cell copies the candidate's parameters and the cell's
scenario params into the buffers (``copy_``), restarts from the same
initial states and the same stream positions (the reset, action and layer
streams of ``eval.py``, seeded from ``seed`` again), and runs the episode,
so cells are comparable as the JAX package's are, and the ``clean`` cell
at severity 0 is ``eval.run_episode_metrics`` bitwise. The build count is
the receipt (``analysis.guards.RetraceGuard``): it stays 1 across every
scenario, severity and same-architecture checkpoint.

:class:`MatrixProgram` is the long-lived form; :func:`run_matrix` sweeps a
checkpoint list, and ``python -m
marl_distributedformation_tpu_torch.robustness_matrix`` wraps it.
"""

from __future__ import annotations

import copy
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

from marl_distributedformation_tpu_torch.algo.rollout import policy_forward
from marl_distributedformation_tpu_torch.analysis.guards import (
    RetraceGuard,
)
from marl_distributedformation_tpu_torch.device import (
    DeviceLike,
    draw,
    resolve_device,
)
from marl_distributedformation_tpu_torch.env.types import (
    EnvParams,
    FormationState,
)
from marl_distributedformation_tpu_torch.envs import spec_for_params
from marl_distributedformation_tpu_torch.eval import (
    _ACT_SEED_OFFSET,
    _SCENARIO_SEED_OFFSET,
    ROW_NAMES,
    episode_length,
    episode_summary,
    step_row,
)
from marl_distributedformation_tpu_torch.scenarios.engine import (
    SCENARIO_FIELDS,
    ScenarioStreams,
    TiledStreams,
    init_scenario_state,
    scenario_step_batch,
    tile,
)
from marl_distributedformation_tpu_torch.scenarios.params import (
    FIELDS,
    ScenarioParams,
)
from marl_distributedformation_tpu_torch.scenarios.registry import (
    get_scenario,
)
from marl_distributedformation_tpu_torch.train.capture import PhaseGraph

Tensor = torch.Tensor


def _weights(params) -> Dict[str, Tensor]:
    """A parameter set by name: a ``state_dict``, or a module's own."""
    if isinstance(params, torch.nn.Module):
        return params.state_dict()
    return params


def params_signature(params) -> Tuple:
    """Names, shapes and dtypes of a parameter set, by name. The matrix
    shares one program, so every candidate must match the first one's
    signature: checkpoints of one structure with other widths would
    otherwise pass construction and then fail inside the program."""
    return tuple(sorted(
        (name, tuple(leaf.shape), str(leaf.dtype))
        for name, leaf in _weights(params).items()
    ))


class CopyBatchedLinear(TorchFunctionMode):
    """Every ``F.linear`` inside the mode as one batched GEMM over
    ``copies`` equal parts of its rows (``torch.baddbmm`` with the weight
    and the bias expanded over the parts, the bias added in the GEMM as
    ``addmm`` adds it). One GEMM over all the rows may give equal rows
    unequal bits on the card: how cuBLAS splits the reduction of a tile can
    depend on where the tile falls in the grid. Nor is a batched GEMM over
    separate copies of the weights enough: a P=61 population through
    ``models/population.py``'s stacked members gave every odd member other
    bits than the even ones on the card. Here every part reads the one
    weight and bias, so parts with equal inputs get equal outputs.

    The rows must be copy-major: copy p's rows are the p-th of ``copies``
    equal blocks of the leading axis. ``EpisodeProgram`` holds this: its
    batch is the copies' formations in turn, and every model keeps the
    formation (or formation-major agent) axis leading into its dense
    layers. A leading axis that ``copies`` does not divide raises."""

    def __init__(self, copies: int) -> None:
        super().__init__()
        self.copies = copies

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is not F.linear:
            return func(*args, **kwargs)
        x, weight = args[0], args[1]
        bias = args[2] if len(args) > 2 else kwargs.get("bias")
        if x.dim() < 2 or x.shape[0] % self.copies:
            raise ValueError(
                f"a dense input of shape {tuple(x.shape)} is not "
                f"{self.copies} copy-major blocks")
        parts = x.reshape(self.copies, -1, x.shape[-1])
        w = weight.t().expand(self.copies, *weight.t().shape)
        if bias is None:
            out = torch.bmm(parts, w)
        else:
            out = torch.baddbmm(
                bias.expand(self.copies, parts.shape[1], bias.shape[-1]),
                parts, w)
        return out.reshape(*x.shape[:-1], weight.shape[0])


class EpisodeProgram:
    """Full episodes of ``copies`` x M formations, the model's parameters
    and the scenario params in static buffers, the step built once (see
    the module docstring).

    ``run(params, scenario_params)``: ``params`` is the candidate's
    parameters by name (a ``state_dict``; a module gives its own), and
    ``scenario_params`` one formation's (every formation runs it, copies
    1) or ``(P,)``-stacked candidates, each run on its own M formations
    (``copies`` P). The copies see the same initial states and the same
    reset, action and layer draws (``scenarios.TiledStreams``), so they
    differ only by their disturbance; each metric is reduced over a copy's
    own formations. Returns ``eval.episode_summary``'s metrics as device
    tensors, 0-d for one copy, ``(P,)`` for P.

    The program is built on the first run, and again only for parameters
    of another signature or another number of copies; ``guard`` counts
    the builds. ``capture`` (the card only) captures the step as a CUDA
    graph; otherwise it runs eagerly. Tests start from ``initial_state``
    (M formations) and take the layers' draws from ``streams_factory()``,
    called at each run's start (eager only).
    """

    def __init__(
        self,
        model: torch.nn.Module,
        env_params: EnvParams,
        num_formations: int,
        deterministic: bool = True,
        seed: int = 1234,
        device: DeviceLike = None,
        capture: bool = True,
        *,
        guard: RetraceGuard,
        initial_state: Optional[FormationState] = None,
        streams_factory: Optional[Callable[[], ScenarioStreams]] = None,
    ) -> None:
        if initial_state is not None:
            dev = initial_state.agents.device
        else:
            dev = resolve_device(device)
        self.device = dev
        self.template = model
        self.env_params = env_params
        self.env = spec_for_params(env_params)
        self.num_formations = num_formations
        self.deterministic = deterministic
        self.seed = seed
        self.T = episode_length(env_params)
        self.capture = (capture and dev.type == "cuda"
                        and streams_factory is None)
        self.guard = guard
        self.initial_state = initial_state
        self.streams_factory = streams_factory
        self.reset_gen = torch.Generator(device=dev)
        self.act_gen = torch.Generator(device=dev)
        self.scenario_gen = torch.Generator(device=dev)
        self._built_for: Optional[Tuple] = None

    # -- the build ---------------------------------------------------------

    def _build(self, params, copies: int) -> None:
        """The static buffers for ``copies`` x M formations and the step
        program over them."""
        if isinstance(params, torch.nn.Module):
            self.template = params
        model = copy.deepcopy(self.template).to(self.device).eval()
        model.requires_grad_(False)
        self.model = model
        self.copies = copies
        self._weights = model.state_dict()
        b = copies * self.num_formations
        self.sp = ScenarioParams(**{
            f: torch.zeros((b, 2) if f == "wind" else (b,),
                           dtype=torch.float32, device=self.device)
            for f in FIELDS
        })
        # The buffers own their storage: the start may hold the caller's
        # initial_state, which the step must not write into.
        state = self._start()
        self.state = type(state)(**{f: getattr(state, f).clone()
                                    for f in SCENARIO_FIELDS})
        self.obs = torch.zeros((b, self.env_params.num_agents,
                                self.env_params.obs_dim),
                               dtype=torch.float32, device=self.device)
        rows = (self.T,) if copies == 1 else (copies, self.T)
        self.rows = {name: torch.zeros(rows, dtype=torch.float32,
                                       device=self.device)
                     for name in ROW_NAMES}
        self.t = torch.zeros((1,), dtype=torch.int64, device=self.device)
        self._step = PhaseGraph(
            "eval_step", self._step_fn,
            (self.reset_gen, self.act_gen, self.scenario_gen),
            capture=self.capture,
            guard=self.guard if self.capture else None,
            signature=(self._weights, copies),
            subsystem=getattr(self.guard, "subsystem", None),
            program=getattr(self.guard, "name", None),
        )

    def _streams(self) -> ScenarioStreams:
        inner = (self.streams_factory() if self.streams_factory is not None
                 else ScenarioStreams(self.scenario_gen))
        return inner if self.copies == 1 else TiledStreams(inner,
                                                           self.copies)

    def _start(self, with_obs: bool = False):
        """The episode's start, as ``eval.run_episode_metrics`` makes it:
        the streams seeded from ``seed`` again, the reset (or
        ``initial_state``) tiled over the copies, and the layers' first
        episode draws; with ``with_obs`` also the observation."""
        p, m = self.env_params, self.num_formations
        self.reset_gen.manual_seed(self.seed)
        self.act_gen.manual_seed(self.seed + _ACT_SEED_OFFSET)
        self.scenario_gen.manual_seed(self.seed + _SCENARIO_SEED_OFFSET)
        state = self.initial_state
        if state is None:
            state = self.env.reset_batch(p, m, self.reset_gen, self.device)
        obs = self.env.obs(state, p) if with_obs else None
        if self.copies > 1:
            state = FormationState(**{
                f: tile(getattr(state, f), self.copies)
                for f in ("agents", "goal", "obstacles", "steps")
            })
            obs = None if obs is None else tile(obs, self.copies)
        self.streams = self._streams()
        state = init_scenario_state(state, p, self.streams)
        return (state, obs) if with_obs else state

    def _act(self, obs: Tensor) -> Tensor:
        """``eval.policy_act_fn``'s action; over copies, the dense layers
        batched by copy (``CopyBatchedLinear``) and the noise of a
        stochastic policy drawn for M formations and tiled."""
        if self.copies == 1:
            mean, log_std, _ = policy_forward(self.model, obs)
        else:
            with CopyBatchedLinear(self.copies):
                mean, log_std, _ = policy_forward(self.model, obs)
        a = mean
        if not self.deterministic:
            m = self.num_formations
            eps = draw(torch.randn, self.act_gen, (m, *mean.shape[1:]),
                       mean.device, mean.dtype)
            a = mean + torch.exp(log_std) * tile(eps, self.copies)
        return self.env_params.max_speed * torch.clamp(a, -1.0, 1.0)

    def _step_fn(self) -> None:
        """One step over the static buffers, its row written at the step
        index ``t`` (a device counter)."""
        p = self.env_params
        with torch.no_grad():
            vel = self._act(self.obs)
            fresh = None
            if self.copies > 1:
                fresh = self.env.reset_batch(p, self.num_formations,
                                             self.reset_gen, self.device)
                fresh = FormationState(**{
                    f: tile(getattr(fresh, f), self.copies)
                    for f in ("agents", "goal", "obstacles", "steps")
                })
            state, tr = scenario_step_batch(
                self.state, vel, self.sp, p, self.reset_gen, self.streams,
                fresh=fresh)
            for f in SCENARIO_FIELDS:
                getattr(self.state, f).copy_(getattr(state, f))
            self.obs.copy_(tr.obs)
            for name, value in step_row(tr, self.copies).items():
                row = self.rows[name]
                row.index_copy_(row.dim() - 1, self.t,
                                value.to(torch.float32).reshape(
                                    *row.shape[:-1], 1))
            self.t.add_(1)

    # -- a run -------------------------------------------------------------

    def _scenario_buffers(self, scenario_params: ScenarioParams,
                          copies: int) -> ScenarioParams:
        """``scenario_params`` on the host, one row a formation."""
        m = self.num_formations
        sp = scenario_params.to("cpu")
        if copies == 1:
            return sp.map(lambda leaf: leaf.expand(m, *leaf.shape))
        return sp.map(lambda leaf: leaf.repeat_interleave(m, dim=0))

    def run(self, params, scenario_params: ScenarioParams
            ) -> Dict[str, Tensor]:
        copies = (scenario_params.fault_prob.shape[0]
                  if scenario_params.batched else 1)
        signature = (params_signature(params), copies)
        if signature != self._built_for:
            build = self._build if self.capture else self.guard.wrap(
                self._build)
            build(params, copies)
            self._built_for = signature
        weights = _weights(params)
        with torch.no_grad():
            for name, buf in self._weights.items():
                buf.copy_(weights[name])
            self.sp.copy_(self._scenario_buffers(scenario_params, copies))
            state, obs = self._start(with_obs=True)
            for f in SCENARIO_FIELDS:
                getattr(self.state, f).copy_(getattr(state, f))
            self.obs.copy_(obs)
            self.t.zero_()
        for _ in range(self.T):
            self._step()
        # Copies: a metric may be a view of the rows, which the next run
        # overwrites.
        return {k: v.clone()
                for k, v in episode_summary(self.rows, self.T).items()}


def make_matrix_runner(
    model: torch.nn.Module,
    env_params: EnvParams,
    num_formations: int,
    deterministic: bool = True,
    max_traces: Optional[int] = 1,
    **program,
) -> Tuple[Callable[..., Dict[str, Tensor]], RetraceGuard]:
    """``(run, guard)``: ``run(params, scenario_params)`` -> the episode
    metrics (0-d device tensors) of one ``EpisodeProgram`` built once for
    the whole matrix; ``guard`` is the budget-``max_traces`` receipt.
    ``program`` goes to ``EpisodeProgram`` (``seed``, ``device``,
    ``capture``, the tests' ``initial_state`` and ``streams_factory``)."""
    guard = RetraceGuard("robustness_matrix_eval", max_traces=max_traces,
                         subsystem="gate")
    prog = EpisodeProgram(model, env_params, num_formations, deterministic,
                          guard=guard, **program)
    return prog.run, guard


class MatrixProgram:
    """The scenario x severity eval program, reusable across candidates.

    Construction builds nothing; the single build happens on the first
    evaluated cell and every later cell (any scenario, any severity, any
    same-architecture parameter set) reuses it (``compile_count`` is the
    receipt). ``check_params`` enforces the one-architecture contract
    against the first candidate seen. ``program`` goes to
    ``EpisodeProgram`` (``capture``, the tests' ``initial_state`` and
    ``streams_factory``).
    """

    def __init__(
        self,
        model: torch.nn.Module,
        env_params: EnvParams,
        num_formations: int = 256,
        deterministic: bool = True,
        seed: int = 1234,
        max_traces: Optional[int] = 1,
        device: DeviceLike = None,
        **program,
    ) -> None:
        self.model = model
        self.env_params = env_params
        self.num_formations = num_formations
        self.deterministic = deterministic
        self.seed = seed
        self.run, self.guard = make_matrix_runner(
            model, env_params, num_formations, deterministic, max_traces,
            seed=seed, device=device, **program,
        )
        self._signature: Optional[Tuple] = None

    @property
    def compile_count(self) -> int:
        """Builds of the shared program so far (the build-once receipt:
        stays 1 across every candidate and cell)."""
        return self.guard.count

    def check_params(self, params, origin: str = "<candidate>") -> None:
        """Fail fast on parameters the program cannot serve (another
        structure, shape or dtype than the first candidate's)."""
        sig = params_signature(params)
        if self._signature is None:
            self._signature = sig
        elif sig != self._signature:
            raise ValueError(
                f"checkpoint {origin} has a different parameter "
                "structure/shape than the first candidate — the matrix "
                "shares one compiled program, so all candidates must be "
                "one architecture (run separate matrices per architecture)"
            )

    def evaluate_clean(
        self, params, origin: str = "<candidate>"
    ) -> Dict[str, float]:
        """The clean env's episode metrics, through the registry's
        ``clean`` scenario at severity 0 in the same program as every
        disturbed cell: ``eval.run_episode_metrics`` bitwise."""
        self.check_params(params, origin)
        out = self.run(params, get_scenario("clean").build(0.0))
        return {k: float(v) for k, v in out.items()}

    def evaluate_cells(
        self,
        params,
        scenarios: Sequence[str],
        severities: Sequence[float],
        origin: str = "<candidate>",
    ) -> Dict[str, Dict[str, Dict[str, float]]]:
        """The scenario x severity grid for one parameter set:
        ``cells[scenario][f"{severity:g}"] -> metrics``."""
        self.check_params(params, origin)
        specs = [get_scenario(str(name)) for name in scenarios]  # fail fast
        cells: Dict[str, Dict[str, Dict[str, float]]] = {}
        for spec in specs:
            per_severity: Dict[str, Dict[str, float]] = {}
            for severity in severities:
                out = self.run(params, spec.build(np.float32(severity)))
                per_severity[f"{float(severity):g}"] = {
                    k: float(v) for k, v in out.items()
                }
            cells[spec.name] = per_severity
        return cells


def run_matrix(
    checkpoint_paths: Sequence[str],
    env_params: EnvParams,
    scenarios: Sequence[str],
    severities: Sequence[float],
    num_formations: int = 256,
    seed: int = 1234,
    deterministic: bool = True,
    device: DeviceLike = None,
    **program,
) -> Dict:
    """Every checkpoint over scenarios x severities.

    The checkpoints must share one architecture (one run's series; a
    mismatch names the file before the first cell). Returns the report:
    ``matrix[checkpoint][scenario][severity] -> metrics`` and the build
    count (``eval_compiles``, the receipt).
    """
    from marl_distributedformation_tpu_torch.compat.policy import (
        LoadedPolicy,
    )

    if not checkpoint_paths:
        raise ValueError("run_matrix needs at least one checkpoint path")
    specs = [get_scenario(str(name)) for name in scenarios]  # fail fast
    policies = [
        LoadedPolicy.from_checkpoint(
            str(p), act_dim=env_params.act_dim, env_params=env_params,
            device=device,
        )
        for p in checkpoint_paths
    ]
    program = MatrixProgram(
        policies[0].model, env_params, num_formations=num_formations,
        deterministic=deterministic, seed=seed, device=device, **program,
    )
    for path, pol in zip(checkpoint_paths, policies):
        program.check_params(pol.params, origin=str(path))
    matrix: Dict[str, Dict[str, Dict[str, Dict[str, float]]]] = {}
    for path, pol in zip(checkpoint_paths, policies):
        matrix[str(path)] = program.evaluate_cells(
            pol.params, [spec.name for spec in specs], severities,
            origin=str(path),
        )
    return {
        "scenarios": [spec.name for spec in specs],
        "severities": [float(s) for s in severities],
        "checkpoints": [str(p) for p in checkpoint_paths],
        "eval_formations": num_formations,
        "num_agents": env_params.num_agents,
        "seed": seed,
        "deterministic": deterministic,
        "matrix": matrix,
        "eval_compiles": program.compile_count,
    }
