"""The world's ranks as a named mesh, and where each tree lives on it.

Counterpart of the JAX package's ``parallel/mesh.py``. JAX lays a
``jax.sharding.Mesh`` over one controller's devices and lets the SPMD
partitioner insert the collectives; here each rank is a process
(``parallel/distributed.py``) and the mesh names the world's ranks as a
grid, row-major over its axes (rank = ``dp_index * sp + sp_index`` for
``{dp, sp}``). It holds a process group along each axis: the ``sp`` rings
(the ranks of one dp index) and the ``dp`` groups (the ranks of one sp
index).

Formations are the data axis, split over ``dp`` in contiguous blocks;
parameters are replicated (broadcast from rank 0). ``sp`` splits the agent
axis of each formation (``parallel/ring.py``). The trainer's dp update
(``parallel/data.py``) all-gathers the rollout and all-reduces the
gradients over every rank of the mesh.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from marl_distributedformation_tpu_torch.parallel import distributed as pd

Tensor = torch.Tensor


def resolve_axis_sizes(
    axis_sizes: Dict[str, int], n_devices: int
) -> Tuple[Tuple[str, ...], Tuple[int, ...]]:
    """Resolve a ``{name: size}`` spec against the device count: a single
    -1 means "all remaining devices"; the total may not exceed
    ``n_devices``. Shared by :func:`make_mesh` and
    ``distributed.make_hybrid_mesh``."""
    names = tuple(axis_sizes.keys())
    sizes = list(axis_sizes.values())
    if -1 in sizes:
        known = int(np.prod([s for s in sizes if s != -1]))
        sizes[sizes.index(-1)] = n_devices // known
    total = int(np.prod(sizes))
    if total > n_devices:
        raise ValueError(
            f"mesh {dict(zip(names, sizes))} needs {total} devices; "
            f"only {n_devices} available"
        )
    return names, tuple(sizes)


class Mesh:
    """Named axes over the world's ranks (see the module docstring):
    ``shape`` ``{name: size}``, this rank's ``coords`` ``{name: index}``,
    its process group along each axis (``group(name)``; ``group()`` is
    every rank of the mesh), and ``device``, the rank's device."""

    def __init__(self, names: Tuple[str, ...], sizes: Tuple[int, ...],
                 rank: int = 0, device: Optional[torch.device] = None
                 ) -> None:
        self.axis_names = names
        self.shape = dict(zip(names, sizes))
        self.size = int(np.prod(sizes))
        self.rank = rank
        self.device = device
        index = np.unravel_index(rank, sizes) if sizes else ()
        self.coords = {n: int(i) for n, i in zip(names, index)}
        self._groups: Dict[Optional[str], Any] = {None: None}
        if pd.world_size() > 1:
            grid = np.arange(self.size).reshape(sizes)
            for axis, name in enumerate(names):
                if sizes[axis] == 1:
                    continue  # its collectives are the identity
                # Every rank creates every group, in one order.
                lines = np.moveaxis(grid, axis, -1).reshape(-1, sizes[axis])
                for line in lines:
                    ranks = [int(r) for r in line]
                    group = (None if len(ranks) == pd.world_size() else
                             dist.new_group(ranks))
                    if rank in ranks:
                        self._groups[name] = group

    def group(self, axis: Optional[str] = None) -> Any:
        """The process group along ``axis`` (the world's ranks when None);
        None also where the group is the whole world."""
        return self._groups.get(axis)

    def axis_size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def index(self, axis: str) -> int:
        return self.coords.get(axis, 0)

    def all_reduce(self, t: Tensor, axis: Optional[str] = None) -> Tensor:
        """``t`` summed in place over ``axis`` (every rank of the group
        when None, a group of one included)."""
        if axis is not None and self.axis_size(axis) == 1:
            return t
        return pd.all_reduce_sum(t, self.group(axis))

    def all_gather(self, t: Tensor, axis: Optional[str] = None,
                   out: Optional[Tensor] = None) -> Tensor:
        """``(size, *t.shape)``: ``t`` of every rank along ``axis`` (every
        rank when None), in mesh order."""
        if axis is not None and self.axis_size(axis) == 1:
            return t.unsqueeze(0)
        return pd.all_gather(t, self.group(axis), out)

    def whole_shape(self, shape: Tuple[int, ...]) -> Tuple[int, ...]:
        """The global shape of a rank's ``(m, n_local, ...)`` block."""
        return (shape[0] * self.axis_size("dp"),
                shape[1] * self.axis_size("sp"), *shape[2:])

    def take(self, t: Tensor) -> Tensor:
        """This rank's ``(m, n_local, ...)`` block of a global ``(M, N,
        ...)`` tensor."""
        return Placement(self, ("dp", "sp")).place(t)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank}, coords={self.coords})"


def make_mesh(axis_sizes: Dict[str, int],
              device: Optional[torch.device] = None) -> Mesh:
    """A mesh with named axes over the world's ranks, e.g. ``{"dp": 4}`` or
    ``{"dp": 4, "sp": 2}``; size -1 for one axis means "all remaining
    ranks". A mesh covers every rank: a rank outside it would have no
    place in the collectives."""
    n = pd.world_size()
    names, sizes = resolve_axis_sizes(axis_sizes, n)
    total = int(np.prod(sizes))
    if total != n:
        raise ValueError(
            f"mesh {dict(zip(names, sizes))} covers {total} of {n} ranks; "
            "every rank must be in the mesh — use -1 for one axis to "
            "absorb the remainder, e.g. mesh={dp: -1}"
        )
    return Mesh(names, sizes, pd.process_index(), device)


@dataclasses.dataclass(frozen=True)
class Placement:
    """Where a tree lives on ``mesh``: ``spec[i]`` names the mesh axis that
    splits dimension ``i`` into contiguous blocks (None: whole); an empty
    spec is replicated, rank 0's copy on every rank."""

    mesh: Mesh
    spec: Tuple[Optional[str], ...] = ()

    def place(self, tree: Any) -> Any:
        """This rank's part of a global ``tree``; a replicated tree is
        broadcast from rank 0 in place and returned."""
        if not self.spec:
            for t in pd.tree_leaves(tree):
                pd.broadcast_(t.detach())
            return tree

        def split(t: Tensor) -> Tensor:
            for dim, axis in enumerate(self.spec):
                if axis is None or dim >= t.dim():
                    continue
                size = self.mesh.axis_size(axis)
                if t.shape[dim] % size:
                    raise ValueError(
                        f"dimension {dim} of {tuple(t.shape)} is not "
                        f"divisible by {axis}={size}")
                count = t.shape[dim] // size
                t = t.narrow(dim, self.mesh.index(axis) * count, count)
            return t

        return pd.tree_map(split, tree)


def formation_sharding(mesh: Mesh) -> Placement:
    """Split the leading formation axis M over 'dp'; everything else
    (agents, coordinates) stays whole on the rank."""
    return Placement(mesh, ("dp",))


def replicated(mesh: Mesh) -> Placement:
    return Placement(mesh, ())


def shard_batch(tree: Any, mesh: Mesh) -> Any:
    """This rank's contiguous formation block of a tree whose tensors all
    carry a leading formation axis."""
    return formation_sharding(mesh).place(tree)


def replicate(tree: Any, mesh: Mesh) -> Any:
    """Rank 0's tensors of ``tree`` on every rank, in place."""
    return replicated(mesh).place(tree)


def make_dp_step(params: Any, mesh: Mesh) -> Callable:
    """The batched env step of this rank's formation block:
    ``dp_step(state, velocity, generator=None, fresh=None)``.

    The block's ``(m, N, 2)`` goes through ``env.formation.step_batch``,
    whose k-NN observation is ``ops.knn_batch(impl="auto")``: the
    ``knn_fused`` kernel at ``(M/dp, N, 2)`` on the card (the reason the
    JAX package wraps its step in ``shard_map``). The step needs no
    collective. An auto-reset draws the whole batch's fresh formations
    from ``generator`` and keeps the block's rows, so a formation resets
    to what the single run draws."""
    from marl_distributedformation_tpu_torch.env.formation import step_batch

    def dp_step(state, velocity, generator=None, fresh=None):
        if fresh is None:
            fresh = fresh_block(params, mesh, state.agents, generator)
        return step_batch(state, velocity, params, fresh=fresh)

    return dp_step


def fresh_block(params: Any, mesh: Mesh, agents: Tensor,
                generator: Any) -> Any:
    """The auto-reset draws of a rank whose block of ``agents`` is ``(m,
    n_local, 2)``: the whole batch's fresh formations ``(dp * m, N)``
    drawn from ``generator``, the rank's formation rows and agent slab
    kept."""
    from marl_distributedformation_tpu_torch.env.formation import reset_batch

    m, n_local = agents.shape[:2]
    dp = mesh.axis_size("dp")
    fresh = reset_batch(params, dp * m, generator, device=agents.device)
    fresh = pd.block_rows(fresh, mesh.index("dp") * m, m)
    if n_local != params.num_agents:
        fresh.agents = fresh.agents.narrow(1, mesh.index("sp") * n_local,
                                           n_local)
    return fresh


def make_shard_fn(
    axis_sizes: Optional[Dict[str, int]] = None,
    mesh: Optional[Mesh] = None,
) -> Callable[[Any, Any, Any], Tuple[Any, Any, Any]]:
    """The ``shard_fn`` hook a trainer applies after initialization:
    replicate the learner's tensors, and keep this rank's block of the env
    state and observation (formations over 'dp'; with 'sp', agents too:
    ``ring.place_ring_state``)."""
    the_mesh = mesh or make_mesh(axis_sizes or {"dp": pd.world_size()})
    extra_axes = set(the_mesh.shape) - {"dp", "sp"}
    if extra_axes:
        raise ValueError(
            f"shard_fn places the 'dp' (formation) and 'sp' (agent) axes; "
            f"mesh has unknown axes {sorted(extra_axes)}"
        )
    has_sp = "sp" in the_mesh.shape

    def shard_fn(train_state, env_state, obs):
        dp = the_mesh.axis_size("dp")
        m = obs.shape[0]
        if m % dp != 0:
            raise ValueError(
                f"num_formations={m} not divisible by dp={dp}"
            )
        if has_sp:
            from marl_distributedformation_tpu_torch.parallel.ring import (
                place_ring_state,
            )

            return (
                replicate(train_state, the_mesh),
                place_ring_state(env_state, the_mesh),
                Placement(the_mesh, ("dp", "sp")).place(obs),
            )
        return (
            replicate(train_state, the_mesh),
            shard_batch(env_state, the_mesh),
            shard_batch(obs, the_mesh),
        )

    shard_fn.mesh = the_mesh
    return shard_fn
