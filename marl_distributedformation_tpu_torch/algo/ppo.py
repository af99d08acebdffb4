"""Proximal Policy Optimization: clipped surrogate, minibatch epochs.

Counterpart of the JAX package's ``algo/ppo.py`` with the same config, loss,
metrics and quirks:

- when the rollout size is not a multiple of ``batch_size`` the remainder is
  dropped from each epoch's shuffled pass (SB3 runs a last, smaller
  minibatch); ``batch_size`` is clamped to the rollout size;
- advantages are normalised per minibatch with the unbiased std;
- the ``ent_coef_final`` and ``log_std_final`` schedules take their progress
  from the optimizer step as two float32 limbs (``step // 4096``,
  ``step % 4096``), so it stays monotone past 2^24;
- the ``log_std`` ceiling is computed from the step before the optimizer
  step and applied after it, one step behind (ADVICE.md); kept as it is.

The JAX package scans the minibatches inside one program. Here one
minibatch step is a function of device tensors only (``PPOUpdate.step``):
the optimizer step counter, the learning rate, the schedules, the
minibatch's rows (picked by a device counter from permutations drawn up
front) and the metrics all live on the device, so the step can be captured
once as a CUDA graph and replayed (``train/capture.py``), and it reads
nothing back to the host.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from marl_distributedformation_tpu_torch.algo.optim import (
    AdamState,
    clipped_adam_step,
    member_views,
)
from marl_distributedformation_tpu_torch.models import distributions

Tensor = torch.Tensor

LOSS_METRICS = (
    "loss", "policy_loss", "value_loss", "entropy", "approx_kl",
    "clip_fraction",
)


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    """Static PPO hyperparameters, fields and defaults as the JAX package's:
    SB3's defaults with the reference's overrides (``n_steps=10``,
    ``learning_rate=1e-3``, ``ent_coef=0.01``). ``ent_coef_final`` anneals
    the entropy bonus linearly over the run; ``log_std_final`` clamps the
    ``log_std`` parameter under a ceiling that decays from ``log_std_init``
    after ``log_std_decay_start`` of the run. ``total_iterations`` is the
    schedules' horizon, filled by the trainer."""

    n_steps: int = 10
    learning_rate: float = 1e-3
    ent_coef: float = 0.01
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_range: float = 0.2
    clip_range_vf: Optional[float] = None
    n_epochs: int = 10
    batch_size: int = 64
    vf_coef: float = 0.5
    max_grad_norm: float = 0.5
    adam_eps: float = 1e-5
    normalize_advantage: bool = True
    log_std_init: float = 0.0
    ent_coef_final: Optional[float] = None
    log_std_final: Optional[float] = None
    log_std_decay_start: float = 0.0
    total_iterations: int = 0


@dataclasses.dataclass
class MinibatchData:
    """Flat rollout rows: ``(b, obs_dim)`` for agent-factored models,
    ``(b, N, obs_dim)`` for per-formation ones. For padded formations
    (``env/hetero.py``), ``weights`` (shaped like ``advantages``) weigh the
    loss's reductions, 0 on padded agents, and ``mask`` ``(b, N)`` goes to
    a per-formation model's forward; both None for homogeneous batches."""

    obs: Tensor
    actions: Tensor
    old_log_probs: Tensor
    advantages: Tensor
    returns: Tensor
    weights: Optional[Tensor] = None
    mask: Optional[Tensor] = None

    def take(self, idx: Tensor) -> "MinibatchData":
        return MinibatchData(**{
            f.name: None if getattr(self, f.name) is None
            else getattr(self, f.name)[idx]
            for f in dataclasses.fields(self)
        })


def _wmean(x: Tensor, weights: Optional[Tensor]) -> Tensor:
    """Mean of ``x`` weighted by ``weights``; the plain mean without."""
    if weights is None:
        return x.mean()
    w = weights.reshape(x.shape)
    return (x * w).sum() / torch.clamp_min(w.sum(), 1e-8)


def ppo_loss(
    model: torch.nn.Module,
    mb: MinibatchData,
    config: PPOConfig,
    ent_coef: Union[float, Tensor, None] = None,
    rows: Optional[Tuple[int, int]] = None,
) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Clipped-surrogate PPO loss on one minibatch (SB3 semantics) and its
    metrics (detached). ``ent_coef`` (a float or a 0-d tensor) overrides
    ``config.ent_coef`` when the entropy coefficient is scheduled. With
    ``mb.weights``, the policy and value losses, ``approx_kl`` and
    ``clip_fraction`` are weighted means and the advantages are normalised
    over the weighted rows (at least 2, variance over ``n - 1``).

    ``rows`` ``(start, count)`` is one rank's contiguous share of the
    minibatch (``DataParallelUpdate``): the advantages are normalised over
    the whole minibatch, the model runs on the rows only, and the loss and
    every metric are the rows' share of the whole minibatch's (sums over
    the rows over the whole's count or weight; the entropy times
    ``count / b``), so that the ranks' shares add up to the single
    run's."""
    w = mb.weights
    advantages = mb.advantages
    if config.normalize_advantage:
        if w is None:
            advantages = (advantages - advantages.mean()) / (
                advantages.std(correction=1) + 1e-8
            )
        else:
            wa = w.reshape(advantages.shape)
            n_active = torch.clamp_min(wa.sum(), 2.0)
            adv_mean = (advantages * wa).sum() / n_active
            adv_var = (((advantages - adv_mean) ** 2) * wa).sum() / (
                n_active - 1.0
            )
            advantages = (advantages - adv_mean) / (
                torch.sqrt(adv_var) + 1e-8
            )
    share = 1.0
    if rows is None:
        def mean(x: Tensor) -> Tensor:
            return _wmean(x, w)
    else:
        start, count = rows
        share = count / mb.obs.shape[0]
        total = (float(mb.advantages.numel()) if w is None
                 else torch.clamp_min(w.sum(), 1e-8))
        mb = MinibatchData(**{
            f.name: None if getattr(mb, f.name) is None
            else getattr(mb, f.name).narrow(0, start, count)
            for f in dataclasses.fields(mb)
        })
        advantages = advantages.narrow(0, start, count)
        w = mb.weights

        def mean(x: Tensor) -> Tensor:
            if w is None:
                return x.sum() / total
            return (x * w.reshape(x.shape)).sum() / total

    if mb.mask is not None:
        out_mean, log_std, values = model(mb.obs, mb.mask)
    else:
        out_mean, log_std, values = model(mb.obs)
    log_probs = distributions.log_prob(mb.actions, out_mean, log_std)
    ent = distributions.entropy(log_std)
    if rows is not None:
        ent = ent * share

    ratio = torch.exp(log_probs - mb.old_log_probs)
    unclipped = advantages * ratio
    clipped = advantages * torch.clamp(
        ratio, 1.0 - config.clip_range, 1.0 + config.clip_range
    )
    policy_loss = -mean(torch.minimum(unclipped, clipped))

    if config.clip_range_vf is not None:
        # SB3's value clipping around the rollout-time values, recovered
        # from GAE's identity returns = advantages + values.
        old_values = mb.returns - mb.advantages
        values = old_values + torch.clamp(
            values - old_values, -config.clip_range_vf, config.clip_range_vf
        )
    value_loss = mean((mb.returns - values) ** 2)
    entropy_loss = -ent

    coef = config.ent_coef if ent_coef is None else ent_coef
    loss = policy_loss + coef * entropy_loss + config.vf_coef * value_loss
    with torch.no_grad():
        metrics = {
            "loss": loss.detach(),
            "policy_loss": policy_loss.detach(),
            "value_loss": value_loss.detach(),
            "entropy": ent.detach(),
            "approx_kl": mean(mb.old_log_probs - log_probs),
            "clip_fraction": mean(
                ((ratio - 1.0).abs() > config.clip_range).to(torch.float32)
            ),
        }
    return loss, metrics


SCHEDULE_METRICS = ("ent_coef", "log_std_ceiling")
SPLIT = 4096  # the two limbs of the step: step // SPLIT, step % SPLIT


def scheduled(config: PPOConfig) -> Tuple[str, ...]:
    """The schedule metrics ``config`` turns on, in ``SCHEDULE_METRICS``
    order."""
    on = (config.ent_coef_final is not None, config.log_std_final is not None)
    return tuple(n for n, o in zip(SCHEDULE_METRICS, on) if o)


def _divisor(value: float, device: torch.device) -> Tensor:
    # A 1-element tensor, never a Python scalar: CUDA divides by a scalar as
    # a multiplication by its reciprocal, which rounds differently.
    return torch.tensor([value], dtype=torch.float32, device=device)


class Schedules:
    """``ent_coef`` and ``log_std_ceiling`` at a device step counter (0-d,
    or one a member ``(K,)``), in float32 on the device as the JAX package
    computes them: progress from
    the two limbs ``step // 4096`` and ``step % 4096``, so that it stays
    monotone past 2^24. XLA contracts ``a + p*(b-a)`` into one fused
    multiply-add; here it rounds twice, so values agree within one rounding
    of the schedule's span. The divisors are made on the device once, at
    construction (never under capture)."""

    def __init__(
        self, config: PPOConfig, expected_total: int, device: torch.device
    ) -> None:
        self.config = config
        f32 = np.float32
        self._hi_scale = float(f32(SPLIT / expected_total))
        self._total = _divisor(float(f32(expected_total)), device)
        start = config.log_std_decay_start
        self._start = float(f32(start))
        self._span = _divisor(float(f32(max(1.0 - start, 1e-8))), device)

    def __call__(self, step: Tensor) -> Dict[str, Tensor]:
        c = self.config
        hi = torch.div(step, SPLIT, rounding_mode="floor").to(torch.float32)
        lo = torch.remainder(step, SPLIT).to(torch.float32)
        progress = torch.clamp(
            hi * self._hi_scale + lo / self._total, 0.0, 1.0
        ).reshape(step.shape)
        out: Dict[str, Tensor] = {}
        if c.ent_coef_final is not None:
            out["ent_coef"] = c.ent_coef + progress * (
                c.ent_coef_final - c.ent_coef
            )
        if c.log_std_final is not None:
            sprog = torch.clamp(
                (progress - self._start) / self._span, 0.0, 1.0
            ).reshape(step.shape)
            out["log_std_ceiling"] = c.log_std_init + sprog * (
                c.log_std_final - c.log_std_init
            )
        return out


def schedule_values(
    config: PPOConfig, step: Union[int, Tensor], expected_total: int
) -> Dict[str, Tensor]:
    """``ent_coef`` and ``log_std_ceiling`` (only the scheduled ones) at
    optimizer step ``step``, as 0-d float32 tensors on ``step``'s device."""
    step = torch.as_tensor(step, dtype=torch.int64)
    return Schedules(config, expected_total, step.device)(step)


def draw_permutations(
    generator: Optional[torch.Generator],
    n_epochs: int,
    total: int,
    used: int,
    device: torch.device,
) -> Tensor:
    """``(n_epochs, used)`` int64: each epoch's ``torch.randperm(total,
    generator)`` cut to the ``used`` rows of whole minibatches, drawn in
    epoch order. ``randperm`` on the card draws its keys from the
    generator's Philox stream and sorts on the device, so a captured draw
    replays the stream as the eager one does."""
    return torch.stack([
        torch.randperm(total, generator=generator, device=device)[:used]
        for _ in range(n_epochs)
    ])


def _check_schedules(model: torch.nn.Module, config: PPOConfig) -> None:
    if config.ent_coef_final is None and config.log_std_final is None:
        return
    if config.total_iterations <= 0:
        raise ValueError(
            "ent_coef_final/log_std_final need total_iterations > 0 (the "
            "trainer fills it; pass the planned iteration count when "
            "building PPOConfig by hand)"
        )
    if config.log_std_final is not None:
        names = {n.split(".")[-1] for n, _ in model.named_parameters()}
        if "log_std" not in names:
            raise ValueError(
                "log_std_final needs a 'log_std' parameter; the model has "
                f"{sorted(names)}"
            )
        if not 0.0 <= config.log_std_decay_start < 1.0:
            raise ValueError(
                "log_std_decay_start is the fraction of the run to hold the "
                f"ceiling and must be in [0, 1), got "
                f"{config.log_std_decay_start}"
            )


class PPOUpdate:
    """``n_epochs`` of shuffled minibatch steps over ``rows`` flat rollout
    rows, as device state and one step function.

    ``load`` copies an iteration's rows into static buffers, draws (or takes)
    every epoch's permutation and rewinds the minibatch counter; ``step``
    runs the next minibatch: its rows picked by the counter, the loss, the
    gradients, optax's clipped Adam with the learning rate ``lr`` (a 0-d
    tensor), the ``log_std`` ceiling, and one row of metrics written at the
    counter. ``means`` averages each epoch's rows and then the epochs. The
    optimizer step ``step_count`` (0-d int64) is the schedules' clock and
    advances in place; ``model``'s parameters and ``opt_state`` are updated
    in place. Every tensor a step reads or writes keeps its storage from
    call to call, so a captured step replays correctly; the buffers are
    made on the first ``load``, which must not run under capture.
    """

    def __init__(
        self,
        model: torch.nn.Module,
        opt_state: AdamState,
        config: PPOConfig,
        rows: int,
        step_count: Tensor,
        lr: Tensor,
    ) -> None:
        _check_schedules(model, config)
        self.model = model
        self.opt_state = opt_state
        self.config = config
        self.rows = rows
        self.batch_size = min(config.batch_size, rows)
        self.num_minibatches = rows // self.batch_size
        self.used = self.num_minibatches * self.batch_size
        self.num_steps = config.n_epochs * self.num_minibatches
        self.step_count = step_count
        self.lr = lr
        device = step_count.device
        self.device = device
        named = list(model.named_parameters())
        self._params = [p for _, p in named]
        self._log_std = [p for n, p in named if n.split(".")[-1] == "log_std"]
        self.schedules: Optional[Schedules] = None
        if scheduled(config):
            expected_total = (
                config.total_iterations * config.n_epochs
                * self.num_minibatches
            )
            self.schedules = Schedules(config, expected_total, device)
        self.names: Tuple[str, ...] = (
            LOSS_METRICS + ("grad_norm",) + scheduled(config)
        )
        self.data: Optional[MinibatchData] = None
        lead = self._members()
        self.perms = torch.zeros(
            (self.num_steps, *lead, self.batch_size), dtype=torch.int64,
            device=device,
        )
        self.counter = torch.zeros((), dtype=torch.int64, device=device)
        self.buf = torch.zeros(
            (self.num_steps, *lead, len(self.names)), dtype=torch.float32,
            device=device,
        )

    def _members(self) -> Tuple[int, ...]:
        """The member axis of the buffers: none for one run."""
        return ()

    def _stage(self, data: MinibatchData) -> None:
        """Copy an iteration's rows into the static buffers (made on the
        first call)."""
        if self.data is None:
            self.data = MinibatchData(**{
                f.name: None if getattr(data, f.name) is None
                else torch.empty_like(getattr(data, f.name))
                for f in dataclasses.fields(data)
            })
        for f in dataclasses.fields(data):
            src = getattr(data, f.name)
            if src is not None:
                getattr(self.data, f.name).copy_(src)

    def load(
        self,
        data: MinibatchData,
        generator: Optional[torch.Generator],
        permutations: Optional[Tensor] = None,
    ) -> None:
        """Take an iteration's rows and its permutations ``(n_epochs,
        used)``, drawn from ``generator`` (``draw_permutations``) unless
        given, and rewind to the first minibatch."""
        if data.obs.shape[0] != self.rows:
            raise ValueError(
                f"PPOUpdate was built for {self.rows} rows, got "
                f"{data.obs.shape[0]}"
            )
        self._stage(data)
        if permutations is None:
            permutations = draw_permutations(
                generator, self.config.n_epochs, self.rows, self.used,
                self.device,
            )
        self.perms.copy_(permutations.reshape(self.perms.shape))
        self.counter.zero_()

    def step(self) -> None:
        """One minibatch step (see the class docstring)."""
        config = self.config
        at = self.counter.reshape(1)
        idx = self.perms.index_select(0, at).reshape(-1)
        mb = self.data.take(idx)
        values = {} if self.schedules is None else self.schedules(
            self.step_count
        )
        loss, metrics = ppo_loss(self.model, mb, config, values.get("ent_coef"))
        grads = torch.autograd.grad(loss, self._params)
        metrics["grad_norm"] = clipped_adam_step(
            self._params, grads, self.opt_state, self.lr,
            config.max_grad_norm, config.adam_eps,
        )
        metrics.update(values)
        with torch.no_grad():
            self.step_count.add_(1)
            if "log_std_ceiling" in values:
                for p in self._log_std:
                    p.clamp_(max=values["log_std_ceiling"])
            row = torch.stack([metrics[n] for n in self.names])
            self.buf.index_copy_(0, at, row.reshape(1, -1))
            self.counter.add_(1)

    def means(self) -> Tensor:
        """``(len(names),)`` (``(K, len(names))`` for a population): each
        epoch's mean over its minibatches, then the mean over the
        epochs."""
        per = self.buf.reshape(
            self.config.n_epochs, self.num_minibatches, *self.buf.shape[1:]
        )
        return per.mean(dim=1).mean(dim=0)

    def run(self) -> None:
        for _ in range(self.num_steps):
            self.step()


ALIGN = 128  # float32 elements in 512 bytes


def rank_rows(total: int, rank: int, world: int) -> Tuple[int, int]:
    """``(start, count)``: rank ``rank``'s contiguous share of ``total``
    rows split over ``world`` ranks (the first ``total % world`` ranks
    take one more)."""
    base, extra = divmod(total, world)
    return rank * base + min(rank, extra), base + (rank < extra)


class DataParallelUpdate(PPOUpdate):
    """``PPOUpdate`` over the ranks of a data-parallel mesh: every rank
    holds the whole rollout (gathered) and the same permutations, takes
    its contiguous share of each global minibatch (``rank_rows``), and the
    ranks' gradients are summed before optax's clip, so the update is the
    single run's up to its rounding.

    A minibatch step is three calls, so that the two around the sum can be
    captured as CUDA graphs whatever the backend: ``grad_step`` (the
    rows, the loss share of ``ppo_loss(rows=...)``, ``autograd.grad``, and
    the gradients and metric shares into one flat buffer), ``reduce`` (the
    buffer summed over the ranks by ``reduce_fn``, outside any graph), and
    ``apply_step`` (the clip, Adam, the schedules' clock, the ``log_std``
    ceiling and the metrics row). With one rank the loss is the single
    run's, ``ppo_loss`` on the whole minibatch, and the step is the single
    run's bitwise."""

    def __init__(
        self,
        model: torch.nn.Module,
        opt_state: AdamState,
        config: PPOConfig,
        rows: int,
        step_count: Tensor,
        lr: Tensor,
        rank: int = 0,
        world: int = 1,
        reduce_fn: Any = None,
    ) -> None:
        super().__init__(model, opt_state, config, rows, step_count, lr)
        if self.batch_size < world:
            raise ValueError(
                f"a minibatch of {self.batch_size} rows does not split over "
                f"{world} ranks"
            )
        self.rank_rows = (None if world == 1
                          else rank_rows(self.batch_size, rank, world))
        self.reduce_fn = reduce_fn
        # Each gradient's slot starts on a 512-byte boundary, as a fresh
        # allocation does: optax's global norm (``torch._foreach_norm``)
        # may sum in another order on a less aligned view.
        offsets, n = [], 0
        for p in self._params:
            offsets.append(n)
            n += -(-p.numel() // ALIGN) * ALIGN
        self.flat = torch.zeros(n + len(LOSS_METRICS), dtype=torch.float32,
                                device=self.device)
        self._grads = [self.flat[o:o + p.numel()].view_as(p)
                       for o, p in zip(offsets, self._params)]
        self._metric_shares = self.flat[n:]

    def grad_step(self) -> None:
        """The rank's loss share and gradients into ``flat``."""
        at = self.counter.reshape(1)
        idx = self.perms.index_select(0, at).reshape(-1)
        mb = self.data.take(idx)
        values = {} if self.schedules is None else self.schedules(
            self.step_count
        )
        loss, metrics = ppo_loss(self.model, mb, self.config,
                                 values.get("ent_coef"), self.rank_rows)
        grads = torch.autograd.grad(loss, self._params)
        with torch.no_grad():
            for dst, src in zip(self._grads, grads):
                dst.copy_(src)
            self._metric_shares.copy_(
                torch.stack([metrics[n] for n in LOSS_METRICS]))

    def reduce(self) -> None:
        """``flat`` summed over the ranks (the identity alone)."""
        if self.reduce_fn is not None:
            self.reduce_fn(self.flat)

    def apply_step(self) -> None:
        """The summed gradients through optax's clip and Adam, then the
        clock, the ceiling and the metrics row."""
        config = self.config
        at = self.counter.reshape(1)
        values = {} if self.schedules is None else self.schedules(
            self.step_count
        )
        metrics = dict(zip(LOSS_METRICS, self._metric_shares.unbind(0)))
        metrics["grad_norm"] = clipped_adam_step(
            self._params, self._grads, self.opt_state, self.lr,
            config.max_grad_norm, config.adam_eps,
        )
        metrics.update(values)
        with torch.no_grad():
            self.step_count.add_(1)
            if "log_std_ceiling" in values:
                for p in self._log_std:
                    p.clamp_(max=values["log_std_ceiling"])
            row = torch.stack([metrics[n] for n in self.names])
            self.buf.index_copy_(0, at, row.reshape(1, -1))
            self.counter.add_(1)

    def step(self) -> None:
        self.grad_step()
        self.reduce()
        self.apply_step()


class PopulationUpdate(PPOUpdate):
    """``PPOUpdate`` over a population's member axis (a
    ``models.population.PopulationModel``; the counterpart of ``jax.vmap``
    of the update in the JAX package's ``train/sweep.py``).

    Every member has its own ``rows`` flat rows ``(K, rows, ...)``, its
    own permutations drawn from its own generator, its own minibatch (a
    ``(K, batch_size)`` index), advantages normalised over its own
    minibatch, its own loss, raw global gradient norm, clip and Adam step
    (``clipped_adam_step`` on views of the stacked tensors, so that member
    i's clip never reads member j's gradients), at its own learning rate
    ``lr[i]`` of the ``(K,)`` device ``lr`` and its own optimizer step
    ``step_count[i]`` (``(K,)``: a member that the health guard holds
    back keeps its own). The schedules and the ``log_std`` ceiling follow
    each member's step. The layers run once for all members
    (``PopulationModel.map``: ``torch.func.vmap``, or a population of
    one's single-run calls), and one ``autograd.grad`` of the members'
    summed losses gives every member its own gradients. A metrics row is
    ``(K, len(names))``.
    """

    def _members(self) -> Tuple[int, ...]:
        return (self.model.num_members,)

    def __init__(
        self,
        model: Any,
        opt_state: AdamState,
        config: PPOConfig,
        rows: int,
        step_count: Tensor,
        lr: Tensor,
    ) -> None:
        super().__init__(model, opt_state, config, rows, step_count, lr)
        self.k = model.num_members
        self._member_params, self._member_states = member_views(
            self._params, opt_state
        )
        # Member i's rows start at i * rows of the flattened buffers.
        self._offsets = (
            torch.arange(self.k, dtype=torch.int64, device=self.device)
            * rows
        )[:, None]

    def load(
        self,
        data: MinibatchData,
        generators: Sequence[torch.Generator],
        permutations: Optional[Tensor] = None,
    ) -> None:
        """Take an iteration's rows ``(K, rows, ...)`` and the members'
        permutations ``(K, n_epochs, used)``, member i's drawn from
        ``generators[i]`` unless given, and rewind."""
        if tuple(data.obs.shape[:2]) != (self.k, self.rows):
            raise ValueError(
                f"PopulationUpdate was built for {self.k} members of "
                f"{self.rows} rows, got {tuple(data.obs.shape[:2])}"
            )
        self._stage(data)
        if permutations is None:
            permutations = torch.stack([
                draw_permutations(g, self.config.n_epochs, self.rows,
                                  self.used, self.device)
                for g in generators
            ])
        per_member = permutations.reshape(
            self.k, self.num_steps, self.batch_size
        )
        self.perms.copy_(per_member.transpose(0, 1) + self._offsets)
        self.counter.zero_()

    def _minibatch(self, idx: Tensor) -> Dict[str, Tensor]:
        """The rows at flat indices ``idx (K*batch_size,)`` as ``(K,
        batch_size, ...)`` tensors."""
        out = {}
        for f in dataclasses.fields(self.data):
            t = getattr(self.data, f.name)
            if t is None:
                continue
            flat = t.reshape(self.k * self.rows, *t.shape[2:])
            out[f.name] = flat.index_select(0, idx).reshape(
                self.k, self.batch_size, *t.shape[2:]
            )
        return out

    def step(self) -> None:
        """One minibatch step of every member (see the class
        docstring)."""
        config = self.config
        at = self.counter.reshape(1)
        idx = self.perms.index_select(0, at).reshape(-1)
        rows = self._minibatch(idx)
        values = {} if self.schedules is None else self.schedules(
            self.step_count
        )
        call = self.model.member_call

        def member_loss(params, rows, coef=None):
            return ppo_loss(functools.partial(call, params),
                            MinibatchData(**rows), config, coef)

        members = self.model.map(member_loss)
        if "ent_coef" in values:
            loss, metrics = members(self.model.params, rows,
                                    values["ent_coef"])
        else:
            loss, metrics = members(self.model.params, rows)
        # Contiguous, as one run's: a batched backward may hand a weight's
        # gradient back transposed, and a norm's sum order follows layout.
        grads = [g.contiguous() for g in
                 torch.autograd.grad(loss.sum(), self._params)]
        metrics["grad_norm"] = torch.stack([
            clipped_adam_step(
                self._member_params[i], [g[i] for g in grads],
                self._member_states[i], self.lr[i], config.max_grad_norm,
                config.adam_eps,
            )
            for i in range(self.k)
        ])
        metrics.update(values)
        with torch.no_grad():
            self.step_count.add_(1)
            if "log_std_ceiling" in values:
                ceiling = values["log_std_ceiling"]
                for p in self._log_std:
                    p.clamp_(max=ceiling.reshape(self.k,
                                                 *[1] * (p.dim() - 1)))
            row = torch.stack([metrics[n] for n in self.names], dim=-1)
            self.buf.index_copy_(0, at, row.unsqueeze(0))
            self.counter.add_(1)


def ppo_update(
    model: torch.nn.Module,
    opt_state: AdamState,
    step: Union[int, Tensor],
    data: MinibatchData,
    generator: Optional[torch.Generator],
    config: PPOConfig,
    permutations: Optional[Tensor] = None,
) -> Tuple[Union[int, Tensor], Dict[str, Tensor]]:
    """``n_epochs`` of shuffled minibatch steps over flat rollout rows, in
    one call (``PPOUpdate`` eagerly).

    Updates ``model``'s parameters and ``opt_state`` in place and returns
    ``(step after the update, metrics)``: 0-d device tensors averaged over
    the minibatches of each epoch and then over the epochs. ``step`` is the
    optimizer step before the update, an int (an int is returned) or a 0-d
    int64 tensor (advanced in place). ``permutations`` ``(n_epochs, used)``
    replaces the draw (tests feed the JAX package's).
    """
    device = data.obs.device
    step_t = torch.as_tensor(step, dtype=torch.int64).to(device)
    lr = torch.tensor(config.learning_rate, dtype=torch.float32, device=device)
    update = PPOUpdate(model, opt_state, config, data.obs.shape[0], step_t, lr)
    update.load(data, generator, permutations)
    update.run()
    means = update.means()
    metrics = {n: means[j] for j, n in enumerate(update.names)}
    return (int(step_t) if isinstance(step, int) else step_t), metrics
