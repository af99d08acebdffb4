"""Padded heterogeneous formations: mixed agent counts at static shapes.

Counterpart of the JAX package's ``env/hetero.py`` (BASELINE config 5),
batched over M formations directly instead of ``vmap``. Every formation is
padded to ``params.num_agents`` (N_max) agents and ``params.num_obstacles``
(K_max) obstacle slots; the active counts ``n_agents`` and ``n_obstacles``
are ``(M,)`` int32 data, so a curriculum changes the mix without changing a
shape:

- the ring follows each formation's ``n``: neighbors are gathered at
  ``(i - 1 + n) mod n`` and ``(i + 1) mod n``, and the spacing target is
  the chord ``2*R*sin(pi/n)`` (reference simulate.py:26) of the formation's
  own ``n``;
- padded agents are inert: their velocity is 0 before the step, their
  reward and observation 0 after it, and they carry weight 0 in the PPO
  loss (``algo/ppo.py``'s ``MinibatchData.weights``);
- obstacle slots ``>= k`` are parked at ``FAR_AWAY``, outside the world, so
  the containment test never fires on them;
- an auto-reset keeps the formation's ``n`` and ``k``.

The index, mask and target tensors derived from the counts form a
``HeteroLayout``. A trainer keeps one whose tensors are static buffers,
rewritten in place at a stage reset (``HeteroLayout.set``), so that the
iteration's captured CUDA graphs stay valid across curriculum stages.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Tuple

import torch

from marl_distributedformation_tpu_torch.device import (
    DeviceLike,
    Streams,
    resolve_device,
)
from marl_distributedformation_tpu_torch.env.formation import (
    _const,
    _in_obstacle,
    _norm,
    _where,
    compute_obs,
    compute_reward,
    integrate,
    reset_batch,
)
from marl_distributedformation_tpu_torch.env.types import (
    EnvParams,
    FormationState,
    Transition,
)

Tensor = torch.Tensor

FAR_AWAY = -1.0e6  # where inactive obstacle slots are parked


@dataclasses.dataclass
class HeteroState(FormationState):
    """``FormationState`` of padded formations: ``agents`` is always
    ``(M, N_max, 2)``, rows ``>= n_agents`` padding; obstacle slots ``>=
    n_obstacles`` are parked at ``FAR_AWAY``."""

    n_agents: Tensor  # (M,) int32, 2 <= n <= N_max
    n_obstacles: Tensor  # (M,) int32, 0 <= k <= K_max


def agent_mask(n_agents: Tensor, n_max: int) -> Tensor:
    """``(M, N_max)`` bool: True for each formation's first ``n`` slots."""
    return torch.arange(n_max, device=n_agents.device) < n_agents[:, None]


def obstacle_slots(n_obstacles: Tensor, k_max: int) -> Tensor:
    """``(M, K_max)`` bool: True for each formation's first ``k`` slots."""
    return agent_mask(n_obstacles, k_max)


def ring_gather_indices(
    n_agents: Tensor, n_max: int
) -> Tuple[Tensor, Tensor]:
    """The dynamic ring's neighbor indices ``(prev, next)``, each ``(M,
    N_max)`` int64: ``(i - 1 + n) mod n`` and ``(i + 1) mod n`` (the padded
    stand-in for the reference's ``torch.roll``, simulate.py:181-182).
    Padded slots get in-range indices whose outputs every consumer masks."""
    idx = torch.arange(n_max, device=n_agents.device)[None, :]
    n = n_agents.to(torch.int64)[:, None]
    return (idx - 1 + n) % n, (idx + 1) % n


def desired_neighbor_dist(n_agents: Tensor, params: EnvParams) -> Tensor:
    """``(M,)`` float32 chord target ``2*R*sin(pi/n)`` of each formation's
    ``n`` (reference simulate.py:26)."""
    nf = n_agents.to(torch.float32)
    return 2.0 * params.desired_radius * torch.sin(_const([math.pi], nf) / nf)


def park_obstacles(obstacles: Tensor, slots: Tensor) -> Tensor:
    """``obstacles (M, K, 2)`` with the inactive ``slots`` at
    ``FAR_AWAY``."""
    return torch.where(slots[..., None], obstacles, FAR_AWAY)


def _gather_agents(x: Tensor, idx: Tensor) -> Tensor:
    """``x (M, N, ...)`` at the agent indices ``idx (M, N)``."""
    if x.dim() > 2:
        idx = idx[..., None].expand(*idx.shape, x.shape[-1])
    return torch.gather(x, 1, idx)


class HeteroLayout:
    """What the counts ``n_agents`` and ``n_obstacles`` (each ``(M,)``)
    decide: the agent mask (bool ``mask``, float32 ``fmask`` and the active
    count ``active``), the ring indices ``prev``/``next``, the chord target
    ``target (M, 1)`` and the active obstacle ``slots``. ``set`` rewrites
    every tensor in place."""

    def __init__(
        self, params: EnvParams, num_formations: int, device: DeviceLike = None
    ) -> None:
        dev = resolve_device(device)
        m, n, k = num_formations, params.num_agents, params.num_obstacles
        self.params = params
        self.n_agents = torch.full((m,), n, dtype=torch.int32, device=dev)
        self.n_obstacles = torch.full((m,), k, dtype=torch.int32, device=dev)
        self.mask = torch.ones((m, n), dtype=torch.bool, device=dev)
        self.fmask = torch.ones((m, n), dtype=torch.float32, device=dev)
        self.active = torch.full((m,), float(n), device=dev)
        self.prev = torch.zeros((m, n), dtype=torch.int64, device=dev)
        self.next = torch.zeros((m, n), dtype=torch.int64, device=dev)
        self.target = torch.zeros((m, 1), dtype=torch.float32, device=dev)
        self.slots = torch.ones((m, k), dtype=torch.bool, device=dev)
        self.set(self.n_agents, self.n_obstacles)

    @classmethod
    def of(cls, n_agents: Tensor, n_obstacles: Tensor,
           params: EnvParams) -> "HeteroLayout":
        """The layout of these counts, on their device."""
        layout = cls(params, n_agents.shape[0], n_agents.device)
        layout.set(n_agents, n_obstacles)
        return layout

    def set(self, n_agents: Tensor, n_obstacles: Tensor) -> None:
        """Rewrite every tensor for new counts (a stage reset), in place."""
        p = self.params
        n_agents = n_agents.to(self.n_agents.device, torch.int32)
        n_obstacles = n_obstacles.to(self.n_obstacles.device, torch.int32)
        if bool((n_agents < 2).any()) or bool((n_agents > p.num_agents).any()):
            raise ValueError(f"agent counts must be in [2, {p.num_agents}]")
        if bool((n_obstacles < 0).any()) or bool(
            (n_obstacles > p.num_obstacles).any()
        ):
            raise ValueError(
                f"obstacle counts must be in [0, {p.num_obstacles}]"
            )
        prev, nxt = ring_gather_indices(n_agents, p.num_agents)
        mask = agent_mask(n_agents, p.num_agents)
        with torch.no_grad():
            self.n_agents.copy_(n_agents)
            self.n_obstacles.copy_(n_obstacles)
            self.mask.copy_(mask)
            self.fmask.copy_(mask.to(torch.float32))
            self.active.copy_(self.fmask.sum(-1))
            self.prev.copy_(prev)
            self.next.copy_(nxt)
            self.target.copy_(desired_neighbor_dist(n_agents, p)[:, None])
            self.slots.copy_(obstacle_slots(n_obstacles, p.num_obstacles))

    def neighbors(self, x: Tensor, dim: int = -2) -> Tuple[Tensor, Tensor]:
        """``(prev, next)`` of ``x (M, N, ...)`` on the dynamic ring (the
        agent axis is 1 whatever ``dim`` says: ``compute_reward``'s
        ``neighbors_fn``)."""
        return _gather_agents(x, self.prev), _gather_agents(x, self.next)


def hetero_reset_batch(
    params: EnvParams,
    n_agents: Tensor,
    n_obstacles: Tensor,
    generator: Streams = None,
    device: DeviceLike = None,
    uniforms: Optional[Tuple[Tensor, Tensor, Tensor]] = None,
) -> HeteroState:
    """Fresh padded formations for the counts ``(M,)``: the homogeneous
    reset at the padded sizes (``env.formation.reset_batch``, drawn from
    ``generator`` unless ``uniforms`` are given), obstacle slots ``>=
    n_obstacles`` parked. Padded agent rows are drawn like real ones and
    never read."""
    base = reset_batch(params, n_agents.shape[0], generator, device, uniforms)
    dev = base.agents.device
    n_obstacles = n_obstacles.to(dev, torch.int32)
    return HeteroState(
        agents=base.agents,
        goal=base.goal,
        obstacles=park_obstacles(
            base.obstacles, obstacle_slots(n_obstacles, params.num_obstacles)
        ),
        steps=base.steps,
        n_agents=n_agents.to(dev, torch.int32),
        n_obstacles=n_obstacles,
    )


def hetero_metrics(
    agents: Tensor,
    goal: Tensor,
    pos_neighbors: Tuple[Tensor, Tensor],
    mask: Tensor,
) -> Dict[str, Tensor]:
    """Progress metrics ``(M,)`` over each formation's active agents (the
    homogeneous ``compute_metrics``, reference simulate.py:238-254); the
    spacing spread divides by ``active - 1``."""
    fmask = mask.to(torch.float32)
    active = fmask.sum(-1)
    dist_to_goal = _norm(agents - goal[:, None, :])
    dist_right = _norm(agents - pos_neighbors[1])
    mean_right = (dist_right * fmask).sum(-1) / active
    var_right = (((dist_right - mean_right[:, None]) ** 2) * fmask).sum(-1) / (
        active - 1.0
    )
    return {
        "avg_dist_to_goal": (dist_to_goal * fmask).sum(-1) / active,
        "ave_dist_to_neighbor": mean_right,
        "std_dist_to_neighbor": torch.sqrt(var_right),
    }


def _check_ring(params: EnvParams) -> None:
    if params.obs_mode != "ring":
        raise ValueError(
            "heterogeneous formations use ring obs; knn swarms are "
            "homogeneous (BASELINE.json configs 4 vs 5)"
        )


def hetero_compute_obs(
    state: HeteroState, params: EnvParams,
    layout: Optional[HeteroLayout] = None,
) -> Tensor:
    """The masked observation ``(M, N_max, obs_dim)`` of ``state`` (padded
    rows 0); ``layout`` is the state's counts' (made when None)."""
    _check_ring(params)
    if layout is None:
        layout = HeteroLayout.of(state.n_agents, state.n_obstacles, params)
    obs = compute_obs(state.agents, state.goal, params,
                      pos_neighbors=layout.neighbors(state.agents))
    return torch.where(layout.mask[..., None], obs, 0.0)


def hetero_step_batch(
    state: HeteroState,
    velocity: Tensor,
    params: EnvParams,
    generator: Streams = None,
    fresh: Optional[FormationState] = None,
    layout: Optional[HeteroLayout] = None,
) -> Tuple[HeteroState, Transition]:
    """Advance M padded formations one step with raw velocities ``(M,
    N_max, 2)``, in the homogeneous step's order (reference
    simulate.py:70-118): padded velocity 0, integrate and clip, obstacle
    containment, reward on the dynamic ring with each formation's target,
    padded reward 0, the timeout, the auto-reset to ``fresh`` (drawn from
    ``generator`` when not given; its obstacles parked here) keeping ``n``
    and ``k``, then the masked observation and metrics (means over active
    agents, and ``num_active_agents``). ``layout`` is the state's counts'
    (made when None; a trainer passes its static one)."""
    _check_ring(params)
    if layout is None:
        layout = HeteroLayout.of(state.n_agents, state.n_obstacles, params)
    mask, fmask = layout.mask, layout.fmask
    velocity = torch.where(mask[..., None], velocity, 0.0)
    agents, out_of_bounds = integrate(state.agents, velocity, params)
    in_obstacle = _in_obstacle(agents, state.obstacles, params)
    reward, terms = compute_reward(
        agents, state.goal, out_of_bounds, in_obstacle, params,
        neighbors_fn=layout.neighbors,
        pos_neighbors=layout.neighbors(agents),
        neighbor_dist_target=layout.target,
    )
    reward = torch.where(mask, reward, 0.0)

    if params.strict_parity:
        done = state.steps > params.max_steps  # Q1: pre-increment check
    else:
        done = state.steps + 1 >= params.max_steps
        if params.goal_termination:
            close = _norm(agents - state.goal[:, None, :]) < (
                params.close_goal_dist
            )
            done = done | torch.where(mask, close, True).all(-1)

    if fresh is None:
        fresh = reset_batch(params, agents.shape[0], generator,
                            device=agents.device)
    next_state = HeteroState(
        agents=_where(done, fresh.agents, agents),
        goal=_where(done, fresh.goal, state.goal),
        obstacles=_where(done, park_obstacles(fresh.obstacles, layout.slots),
                         state.obstacles),
        steps=torch.where(done, fresh.steps, state.steps + 1),
        n_agents=state.n_agents,
        n_obstacles=state.n_obstacles,
    )

    pos_neighbors = layout.neighbors(next_state.agents)
    obs = compute_obs(next_state.agents, next_state.goal, params,
                      pos_neighbors=pos_neighbors)
    obs = torch.where(mask[..., None], obs, 0.0)
    active = layout.active
    metrics = hetero_metrics(next_state.agents, next_state.goal,
                             pos_neighbors, mask)
    metrics.update({k: (v * fmask).sum(-1) / active for k, v in terms.items()})
    metrics["reward"] = (reward * fmask).sum(-1) / active
    metrics["num_active_agents"] = active
    return next_state, Transition(
        obs=obs, reward=reward, done=done, metrics=metrics
    )


def make_hetero_vec_env(
    params: EnvParams,
    device: DeviceLike = None,
    generator: Optional[torch.Generator] = None,
) -> Tuple[
    Callable[[Tensor, Tensor], Tuple[HeteroState, Tensor]],
    Callable[[HeteroState, Tensor], Tuple[HeteroState, Transition]],
]:
    """``(reset_fn, step_fn)`` over padded formations on ``device``:
    ``reset_fn(n_agents, n_obstacles) -> (state, obs)`` for ``(M,)``
    counts; ``step_fn(state, actions)`` scales policy actions in [-1, 1]
    by ``max_speed`` (reference vectorized_env.py:68-82). Both draw from
    ``generator``."""
    dev = resolve_device(device)

    def reset_fn(
        n_agents: Tensor, n_obstacles: Tensor
    ) -> Tuple[HeteroState, Tensor]:
        state = hetero_reset_batch(params, n_agents.to(dev),
                                   n_obstacles.to(dev), generator, dev)
        return state, hetero_compute_obs(state, params)

    def step_fn(
        state: HeteroState, actions: Tensor
    ) -> Tuple[HeteroState, Transition]:
        return hetero_step_batch(state, params.max_speed * actions, params,
                                 generator)

    return reset_fn, step_fn
