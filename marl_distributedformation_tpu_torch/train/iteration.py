"""The training iteration as three phases over a static carry.

Counterpart of the body of the JAX package's ``make_ppo_iteration``
(``train/trainer.py``), cut where the port's CUDA graphs are cut
(``train/capture.py``):

- ``rollout``: the health guard's backups (with the health word on), the
  ``n_steps`` rollout, GAE, the flat rows and every epoch's permutation
  into ``PPOUpdate``, the new env state and observation into pending
  buffers, and the rollout's metrics into a buffer;
- ``minibatch``: one ``PPOUpdate.step``, run ``num_minibatch_steps`` times;
- ``end``: the iteration's metrics row (rollout, the update's epoch means,
  the health flags), the health select or the plain write-back of the env
  carry, and the row into the metrics ring.

Padded heterogeneous formations (``env/hetero.py``, the curriculum's) add a
``HeteroLayout`` to the carry: the counts' mask, ring indices and targets,
which the env step, a per-formation model's forward (the mask), the loss
(the mask as weights, broadcast over the rollout's steps) and the reward
metric (weighted by the mask) read. A stage reset (``reset_env``) rewrites
the layout, the env carry and the observation in place, between
iterations, so the same captured graphs serve every stage.

Scenario training (``scenarios/``) adds the batch's ``ScenarioParams`` to
the carry as static ``(M,)`` buffers, which the env step
(``scenarios.scenario_step_batch``) reads and the trainer writes in place
between iterations (a new mix a dispatch, a stage change, a severity ramp),
and the episode draws of the layers to the env carry (``ScenarioState``);
the layers draw from their own generator. The same captured graphs serve
every scenario, stage and severity.

Every tensor one phase hands to another, and all the carry (parameters,
Adam state, optimizer step, learning rate, env state, observation,
metrics), keeps its storage from iteration to iteration and is only
written in place, so that each phase can be captured once and replayed. A
phase draws only from the iteration's generator. Nothing reads back to the
host; the metrics leave the device when the trainer drains the ring.

Buffers whose shapes the first iteration decides (the update's rows, the
rollout metrics, the ring) are made on the first call of their phase,
which is always eager (``train/capture.py`` warms each phase up before it
captures it).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from marl_distributedformation_tpu_torch.algo import (
    AdamState,
    MinibatchData,
    PPOConfig,
    collect_rollout,
    compute_gae,
)
from marl_distributedformation_tpu_torch.algo.ppo import (
    PopulationUpdate,
    PPOUpdate,
)
from marl_distributedformation_tpu_torch.env.hetero import (
    HeteroLayout,
    HeteroState,
    hetero_step_batch,
)
from marl_distributedformation_tpu_torch.env.types import (
    EnvParams,
    FormationState,
)
from marl_distributedformation_tpu_torch.models.population import (
    PopulationModel,
)
from marl_distributedformation_tpu_torch.scenarios.engine import (  # noqa: F401
    ENV_FIELDS,
    SCENARIO_FIELDS,
    ScenarioState,
    ScenarioStreams,
    make_scenario_step,
)
from marl_distributedformation_tpu_torch.scenarios.params import (
    ScenarioParams,
)
from marl_distributedformation_tpu_torch.train.recovery import HEALTH_METRICS

Tensor = torch.Tensor

ROLLOUT_TOTALS = ("reward", "episode_dones")


class MetricsRing:
    """``rows`` metric rows on the device, written in turn by the end phase
    at a device position, so that a captured end phase writes each
    iteration's row to the next slot. The host keeps the same position
    (``take``): the trainer reads back a dispatch's rows once."""

    def __init__(self, names: Tuple[str, ...], rows: int, device,
                 lead: Tuple[int, ...] = ()) -> None:
        self.names = names
        self.rows = rows
        # A row is (len(names),), or (K, len(names)) for a population.
        self.buf = torch.zeros((rows, *lead, len(names)),
                               dtype=torch.float32, device=device)
        self.pos = torch.zeros((), dtype=torch.int64, device=device)
        self.host_pos = 0

    def write(self, row: Tensor) -> None:
        at = self.pos.reshape(1)
        self.buf.index_copy_(0, at, row.unsqueeze(0))
        self.pos.add_(1).remainder_(self.rows)

    def advance(self) -> None:
        """The host's position follows one ``write``."""
        self.host_pos = (self.host_pos + 1) % self.rows

    def take(self, count: int) -> Tensor:
        """``(count, [K,] len(names))``: the rows of the last ``count``
        iterations, in order: a view, or a copy when they wrap the ring's
        end (a curriculum's chunks clipped at stage boundaries)."""
        if count > self.rows:
            raise ValueError(f"{count} rows from a ring of {self.rows}")
        start = (self.host_pos - count) % self.rows
        if start + count <= self.rows:
            return self.buf[start:start + count]
        return torch.cat([self.buf[start:],
                          self.buf[:start + count - self.rows]])


class PhasedIteration:
    """One training iteration of ``model`` on M formations, in phases (see
    the module docstring), over its own static carry.

    ``env_state`` and ``obs`` are copied into the carry; ``step`` (the
    optimizer step, the schedules' clock) and ``lr`` become 0-d device
    tensors. ``opt_state`` and the model's parameters are the trainer's and
    are updated in place. Per-formation models (the GNN) are minibatched by
    whole formations, ``batch_size // N`` of them; ``batch_size`` stays in
    agent-transitions. ``env_step_fn`` replaces the env step (tests inject
    the JAX package's resets). ``layout`` makes the formations padded ones
    (see the module docstring); ``env_state`` is then a ``HeteroState`` of
    its counts. ``scenario_params`` (``(M,)``-leading buffers, read in
    place) steps the env through the disturbance stack, the layers drawing
    from ``scenario_streams``; ``env_state`` is then a ``ScenarioState``.
    """

    members: Optional[int] = None  # K for a population (see below)
    forward = None  # collect_rollout's default, policy_forward
    # Whether ``end`` moves the env carry on: a Sebulba learner, whose
    # rows come from the actor lane, leaves the env to the actor.
    writes_env = True

    def __init__(
        self,
        env_params: EnvParams,
        ppo: PPOConfig,
        model: torch.nn.Module,
        opt_state: AdamState,
        generator: Optional[torch.Generator],
        env_state: FormationState,
        obs: Tensor,
        *,
        step: int = 0,
        lr: Optional[float] = None,
        ring_rows: int = 2,
        env_step_fn: Any = None,
        layout: Optional[HeteroLayout] = None,
        scenario_params: Optional[ScenarioParams] = None,
        scenario_streams: Optional[ScenarioStreams] = None,
    ) -> None:
        self.env_params = env_params
        self.ppo = ppo
        self.model = model
        self.opt_state = opt_state
        self.generator = generator
        self.layout = layout
        self.scenario_params = scenario_params
        if env_step_fn is None and layout is not None:
            env_step_fn = self._hetero_step
        if env_step_fn is None and scenario_params is not None:
            scenario_step = make_scenario_step(env_params, scenario_streams,
                                               generator)

            def env_step_fn(state, velocity):
                # The buffers are read at every step: written in place
                # between replays, never rebound.
                return scenario_step(state, velocity, self.scenario_params)
        self.env_step_fn = env_step_fn
        self.env_fields = (ENV_FIELDS if scenario_params is None
                           else SCENARIO_FIELDS)
        self.per_formation = bool(model.per_formation)
        device = obs.device
        self.device = device
        n = env_params.num_agents
        if self.per_formation:
            update_ppo = dataclasses.replace(
                ppo, batch_size=max(1, ppo.batch_size // n)
            )
            self.row_shape: Tuple[int, ...] = (n,)
        else:
            update_ppo = ppo
            self.row_shape = ()
        k = self.members or 1
        m = obs.shape[0] // k
        self.lead: Tuple[int, ...] = () if self.members is None else (k,)
        rows = ppo.n_steps * m * (1 if self.per_formation else n)
        carry = {f: getattr(env_state, f).detach().clone()
                 for f in self.env_fields}
        state_cls = (FormationState if scenario_params is None
                     else ScenarioState)
        if layout is None:
            self.env = state_cls(**carry)
        else:
            layout.set(env_state.n_agents, env_state.n_obstacles)
            self.env = HeteroState(**carry, n_agents=layout.n_agents,
                                   n_obstacles=layout.n_obstacles)
        self.obs = obs.detach().clone()
        self._pending_env = state_cls(**{
            f: torch.empty_like(getattr(self.env, f))
            for f in self.env_fields
        })
        self._pending_obs = torch.empty_like(self.obs)
        self.step = torch.full(self.lead, int(step), dtype=torch.int64,
                               device=device)
        self.lr = torch.tensor(
            ppo.learning_rate if lr is None else lr, dtype=torch.float32,
            device=device,
        ).expand(self.lead).clone()
        self.params = [p for _, p in model.named_parameters()]
        update = PPOUpdate if self.members is None else PopulationUpdate
        self.update = update(
            model, opt_state, update_ppo, rows, self.step, self.lr
        )
        self.ring_rows = ring_rows
        self.health: Any = None
        self._rollout_names: Optional[Tuple[str, ...]] = None
        self._rollout_row: Optional[Tensor] = None
        self.ring: Optional[MetricsRing] = None

    @property
    def num_minibatch_steps(self) -> int:
        return self.update.num_steps

    def learner_tensors(self) -> List[Tensor]:
        """What an iteration's update changes: the parameters, then Adam's
        count, mu and nu, then the optimizer step."""
        return [
            *self.params, self.opt_state.count,
            *self.opt_state.mu.values(), *self.opt_state.nu.values(),
            self.step,
        ]

    def env_pairs(self) -> List[Tuple[Tensor, Tensor]]:
        """``(carry, pending)`` of the env state and the observation."""
        pairs = [
            (getattr(self.env, f), getattr(self._pending_env, f))
            for f in self.env_fields
        ]
        return pairs + [(self.obs, self._pending_obs)]

    def reset_env(self, env_state: HeteroState, obs: Tensor) -> None:
        """A stage reset of padded formations, between iterations and
        outside the graphs: the layout of ``env_state``'s counts, the env
        carry and the observation, each written in place."""
        with torch.no_grad():
            self.layout.set(env_state.n_agents, env_state.n_obstacles)
            for f in ENV_FIELDS:
                getattr(self.env, f).copy_(getattr(env_state, f))
            self.obs.copy_(obs)

    def _hetero_step(self, state: HeteroState, velocity: Tensor):
        return hetero_step_batch(state, velocity, self.env_params,
                                 self.generator, layout=self.layout)

    # ------------------------------------------------------------------
    # The phases
    # ------------------------------------------------------------------

    def rollout(
        self, noise: Optional[Tensor] = None,
        permutations: Optional[Tensor] = None,
    ) -> None:
        """Backups, rollout, GAE, the update's rows and permutations, the
        pending env carry and the rollout metrics. ``noise`` and
        ``permutations`` replace the generator's draws (tests)."""
        if self.health is not None:
            self.health.save()
        p = self.env_params
        mask = None if self.layout is None else self.layout.fmask
        env, last_obs, batch, last_value = collect_rollout(
            self.model, self.env, self.obs, self.generator, p,
            self.ppo.n_steps, env_step_fn=self.env_step_fn, noise=noise,
            forward=self.forward,
            mask=mask if self.per_formation else None,
        )
        advantages, returns = compute_gae(
            batch.rewards, batch.values, batch.dones, last_value,
            self.ppo.gamma, self.ppo.gae_lambda,
        )
        flat = MinibatchData(
            obs=self._flat(batch.obs, p.obs_dim),
            actions=self._flat(batch.actions, p.act_dim),
            old_log_probs=self._flat(batch.log_probs),
            advantages=self._flat(advantages),
            returns=self._flat(returns),
        )
        weights = None
        if mask is not None:
            # Padded agents weigh 0 in the loss; the mask holds for every
            # step of the rollout.
            weights = mask.expand(self.ppo.n_steps, *mask.shape)
            flat.weights = self._flat(weights)
            flat.mask = flat.weights if self.per_formation else None
        self.update.load(flat, self.generator, permutations)
        with torch.no_grad():
            for f in self.env_fields:
                getattr(self._pending_env, f).copy_(getattr(env, f))
            self._pending_obs.copy_(last_obs)
            if self._rollout_names is None:
                self._rollout_names = tuple(
                    k for k in batch.metrics if k not in ROLLOUT_TOTALS
                ) + ROLLOUT_TOTALS
                self._rollout_row = torch.zeros(
                    (*self.lead, len(self._rollout_names)),
                    dtype=torch.float32, device=self.device,
                )
            values = [
                self._reduce(batch.metrics[k], "mean")
                for k in self._rollout_names[:-len(ROLLOUT_TOTALS)]
            ]
            if weights is None:
                reward = self._reduce(batch.rewards, "mean")
            else:
                reward = self._reduce(batch.rewards * weights, "sum") / (
                    torch.clamp_min(self._reduce(weights, "sum"), 1.0))
            # Formation-level episode count: dones are broadcast to agents
            # (agent row 0 is active in every formation).
            values += [reward, self._reduce(batch.dones[..., 0], "sum")]
            self._rollout_row.copy_(torch.stack(values, dim=-1))

    # One run's rollout rows and reductions; a population overrides them.

    def _flat(self, x: Tensor, *tail: int) -> Tensor:
        """Time-major rollout rows ``(T, M, N, *tail)`` as the update's flat
        rows: agent rows, or whole formations for a per-formation model."""
        return x.reshape(-1, *self.row_shape, *tail)

    def _reduce(self, x: Tensor, op: str) -> Tensor:
        """``x.mean()`` or ``x.sum()`` over a rollout tensor ``(T, M,
        ...)``."""
        return getattr(x, op)()

    def minibatch(self) -> None:
        """One minibatch step of the update."""
        self.update.step()

    def end(self) -> None:
        """The metrics row, the health select or the env write-back, and
        the row into the ring."""
        with torch.no_grad():
            upd = self.update.means()
            row = torch.cat([self._rollout_row, upd], dim=-1)
            names = self.update.names
            pairs = self.env_pairs() if self.writes_env else []
            if self.health is not None:
                flags = self.health.apply(
                    upd[..., names.index("loss")],
                    upd[..., names.index("grad_norm")], pairs,
                )
                row = torch.cat([row, flags], dim=-1)
            else:
                for carry, pending in pairs:
                    carry.copy_(pending)
            if self.ring is None:
                self.ring = MetricsRing(
                    self.metric_names(), self.ring_rows, self.device,
                    self.lead,
                )
            self.ring.write(row)

    def metric_names(self) -> Tuple[str, ...]:
        """The names of a metrics row, in its order."""
        if self._rollout_names is None:
            raise RuntimeError("metric names are known after a rollout")
        return (
            self._rollout_names + self.update.names
            + (HEALTH_METRICS if self.health is not None else ())
        )

    def run(
        self, noise: Optional[Tensor] = None,
        permutations: Optional[Tensor] = None,
        mark: Optional[Callable[[str], None]] = None,
        phases: Optional[Tuple[Callable[[], None], ...]] = None,
    ) -> None:
        """One whole iteration: the phases eagerly, or ``phases`` (the
        trainer's ``PhaseGraph``s of ``rollout``, ``minibatch`` and
        ``end``); ``mark(phase)`` is called at "rollout", "update" and
        "end"."""
        rollout, minibatch, end = phases or (
            lambda: self.rollout(noise, permutations), self.minibatch,
            self.end,
        )
        if mark is not None:
            mark("rollout")
        rollout()
        if mark is not None:
            mark("update")
        for _ in range(self.num_minibatch_steps):
            minibatch()
        end()
        if mark is not None:
            mark("end")
        self.ring.advance()

    def metrics(self, row: Tensor) -> Dict[str, Tensor]:
        """A metrics row as ``{name: 0-d tensor}`` (``(K,)`` for a
        population)."""
        return {n: row[..., j] for j, n in enumerate(self.ring.names)}


class PopulationIteration(PhasedIteration):
    """One training iteration of a population of K members
    (``models.population.PopulationModel``) in the same three phases over
    one static carry: the counterpart of ``jax.vmap`` of the iteration in
    the JAX package's ``train/sweep.py``.

    The members' M formations each are folded into one env batch of K*M
    formations, member i's at rows ``i*M`` to ``(i+1)*M``: one env step and
    one k-NN launch a step advance the whole population (the env and the
    k-NN are per formation, so the fold is exact). ``generator`` is the
    members' K generators; each member draws its resets, action noise and
    permutations from its own, in its single run's order. ``step`` and
    ``lr`` become ``(K,)`` (``lr`` a float for every member, or one a
    member); ``opt_state`` holds stacked moments and a ``(K,)`` count
    (``algo.optim.population_adam_init``). The update is
    ``algo.ppo.PopulationUpdate``; a metrics row is ``(K, names)``.
    """

    def __init__(
        self,
        env_params: EnvParams,
        ppo: PPOConfig,
        model: Any,
        opt_state: AdamState,
        generators: Sequence[torch.Generator],
        env_state: FormationState,
        obs: Tensor,
        **kwargs: Any,
    ) -> None:
        self.members = model.num_members
        if len(generators) != self.members:
            raise ValueError(f"{len(generators)} generators for "
                             f"{self.members} members")
        super().__init__(env_params, ppo, model, opt_state, list(generators),
                         env_state, obs, **kwargs)

    forward = staticmethod(PopulationModel.rollout_forward)

    def _by_member(self, x: Tensor) -> Tensor:
        """``(T, K*M, ...)`` as ``(K, T, M, ...)``: each member's rows in
        its single run's order."""
        k = self.members
        return x.reshape(x.shape[0], k, -1, *x.shape[2:]).transpose(0, 1)

    def _flat(self, x: Tensor, *tail: int) -> Tensor:
        return self._by_member(x).reshape(
            self.members, -1, *self.row_shape, *tail
        )

    def _reduce(self, x: Tensor, op: str) -> Tensor:
        return getattr(self._by_member(x).reshape(self.members, -1), op)(-1)
