"""Agent-axis ('sp') sharding with one-agent halos around the ring of ranks.

Counterpart of the JAX package's ``parallel/ring.py``. Every agent reads
only its two ring neighbors, for the ring observation and the reward
mixing, so the agent axis N splits over the 'sp' ranks of a mesh and each
rank trades one agent at each end of its slab with its ring neighbors
(``halo_neighbors``), instead of gathering the formation. JAX sends the
halos with ``lax.ppermute``; here one all-gather over the sp ring carries
every rank's two end agents (2 agents a formation a rank), which gloo and
NCCL both run on the card's tensors.

``obs_mode="knn"`` gathers the positions over 'sp' (8N bytes a formation)
and searches locally for the rank's slab (``ops.knn_local`` through
``env.formation.compute_obs_knn_sharded``): the plain search, in JAX too,
with global neighbor indices, so the rows equal the unsharded
observation's. Reward mixing and the metrics keep the halos; a
formation's means are one all-reduce over 'sp' of its slabs' sums.

The env math is ``env.formation``'s, parameterized by a ``neighbors_fn``.
An auto-reset draws the whole batch's fresh formations and keeps the
rank's rows and slab (``mesh.fresh_block``), so sharded and unsharded
trajectories coincide.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch

from marl_distributedformation_tpu_torch.env.formation import (
    _in_obstacle,
    _norm,
    _where,
    compute_obs,
    compute_obs_knn_sharded,
    compute_reward,
    integrate,
)
from marl_distributedformation_tpu_torch.env.types import (
    EnvParams,
    FormationState,
    Transition,
)
from marl_distributedformation_tpu_torch.parallel.mesh import (
    Mesh,
    Placement,
    fresh_block,
)

Tensor = torch.Tensor


def halo_neighbors(block: Tensor, axis: int, mesh: Mesh,
                   axis_name: str = "sp") -> Tuple[Tensor, Tensor]:
    """Sharded ``formation.ring_neighbors``: per-agent ``(prev, next)``
    along the sharded agent axis of a slab ``(m, n_local, ...)``, from the
    end agents of the ring neighbors' slabs. With one rank on the ring
    this is plain wrap-around (``torch.roll``)."""
    axis = axis % block.dim()
    assert axis == 1, f"sharded agent axis must be axis 1, got {axis}"
    ends = torch.cat([block[:, :1], block[:, -1:]], dim=1)
    ring = mesh.all_gather(ends, axis_name)  # (sp, m, 2, ...)
    sp, idx = mesh.axis_size(axis_name), mesh.index(axis_name)
    from_prev = ring[(idx - 1) % sp][:, 1:2]
    from_next = ring[(idx + 1) % sp][:, 0:1]
    prev = torch.cat([from_prev, block[:, :-1]], dim=1)
    nxt = torch.cat([block[:, 1:], from_next], dim=1)
    return prev, nxt


def make_ring_step(params: EnvParams, mesh: Mesh):
    """The batched env step of this rank's block with the agent axis split
    over 'sp' (and formations over 'dp'): ``ring_step(state, velocity,
    generator=None, fresh=None) -> (state, Transition)``. ``state`` and
    ``velocity`` are the rank's ``(m, n_local, ...)`` block
    (``place_ring_state``); the per-agent outputs are the slab's, the
    per-formation outputs (``done``, metrics) the formations'. ``fresh``
    replaces the auto-reset's draws (the whole batch's, then the rank's
    rows and slab)."""
    sp_size = mesh.axis_size("sp")
    if params.obs_mode not in ("ring", "knn"):
        raise ValueError(
            f"agent-axis ('sp') sharding supports obs_mode 'ring' (halo "
            f"exchange) and 'knn' (all-gather + local-query search); got "
            f"{params.obs_mode!r}"
        )
    if params.num_agents % sp_size != 0:
        raise ValueError(
            f"num_agents={params.num_agents} not divisible by sp={sp_size}"
        )
    n_local = params.num_agents // sp_size
    offset = mesh.index("sp") * n_local
    n_agents = float(params.num_agents)

    def neighbors_fn(x: Tensor, axis: int) -> Tuple[Tensor, Tensor]:
        return halo_neighbors(x, axis, mesh)

    def psum(x: Tensor) -> Tensor:
        return mesh.all_reduce(x, "sp")

    def ring_step(state: FormationState, velocity: Tensor,
                  generator: Any = None, fresh: Any = None
                  ) -> Tuple[FormationState, Transition]:
        agents, out_of_bounds = integrate(state.agents, velocity, params)
        in_obstacle = _in_obstacle(agents, state.obstacles, params)
        # Halo exchanges #1 (positions) and #2 (per-agent rewards).
        mixed, terms = compute_reward(
            agents, state.goal, out_of_bounds, in_obstacle, params,
            neighbors_fn=neighbors_fn,
        )
        if params.strict_parity:
            done = state.steps > params.max_steps  # Q1 pre-increment check
        else:
            done = state.steps + 1 >= params.max_steps
            if params.goal_termination:
                close = _norm(agents - state.goal[:, None, :]) < (
                    params.close_goal_dist)
                done = done | (psum(close.sum(-1)) == params.num_agents)
        if fresh is None:
            fresh = fresh_block(params, mesh, agents, generator)
        new = FormationState(
            agents=_where(done, fresh.agents, agents),
            goal=_where(done, fresh.goal, state.goal),
            obstacles=_where(done, fresh.obstacles, state.obstacles),
            steps=torch.where(done, fresh.steps, state.steps + 1),
        )
        # Exchange #3: post-reset positions, for the ring observation and
        # the neighbor-distance metrics.
        post = neighbors_fn(new.agents, 1)
        if params.obs_mode == "knn":
            all_pos = gather_agents(new.agents, mesh)  # (m, N, 2)
            obs = compute_obs_knn_sharded(new.agents, all_pos, new.goal,
                                          params, offset)
        else:
            obs = compute_obs(new.agents, new.goal, params,
                              pos_neighbors=post)
        # The metrics: one all-reduce of the slabs' sums, then the
        # centered second pass of the unbiased std.
        dist_goal = _norm(new.agents - new.goal[:, None, :])
        dist_right = _norm(new.agents - post[1])
        parts = [dist_goal, dist_right, mixed, *terms.values()]
        sums = psum(torch.stack([p.sum(-1) for p in parts], dim=-1))
        means = sums / n_agents
        mean_right = means[:, 1]
        var = psum(((dist_right - mean_right[:, None]) ** 2).sum(-1)) / (
            n_agents - 1.0)
        metrics = {
            "avg_dist_to_goal": means[:, 0],
            "ave_dist_to_neighbor": mean_right,
            "std_dist_to_neighbor": torch.sqrt(var),
            "reward": means[:, 2],
        }
        metrics.update({k: means[:, 3 + i] for i, k in enumerate(terms)})
        return new, Transition(obs=obs, reward=mixed, done=done,
                               metrics=metrics)

    return ring_step


def place_ring_state(state: FormationState, mesh: Mesh) -> FormationState:
    """This rank's block of a global batched ``FormationState`` for ring
    stepping: agents split over ('dp', 'sp'), the per-formation leaves
    over 'dp' (whole over 'sp')."""
    agents = Placement(mesh, ("dp", "sp")).place(state.agents)
    rest = Placement(mesh, ("dp",)).place(
        {f: getattr(state, f) for f in ("goal", "obstacles", "steps")})
    return FormationState(agents=agents, **rest)


def gather_agents(block: Tensor, mesh: Mesh) -> Tensor:
    """The whole formations ``(m, N, ...)`` of a rank's slabs ``(m,
    n_local, ...)``, gathered over 'sp'."""
    if mesh.axis_size("sp") == 1:
        return block
    ring = mesh.all_gather(block, "sp")  # (sp, m, n_local, ...)
    return ring.transpose(0, 1).reshape(
        block.shape[0], -1, *block.shape[2:])
