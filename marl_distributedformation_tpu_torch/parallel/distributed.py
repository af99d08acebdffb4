"""Multi-process runtime: process wire-up through ``torch.distributed``, each
rank's device and backend, the collectives on either backend, and each
rank's block of the formation axis.

Counterpart of the JAX package's ``parallel/distributed.py``. JAX runs one
controller over local devices and wires hosts with ``jax.distributed``;
PyTorch's idiom is one process a rank. A launcher (``parallel/launch.py``,
``torchrun``, a cluster's own) starts the processes with the standard
variables ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
``MASTER_PORT``, which ``init_distributed`` reads.

A rank's device is ``cuda:(LOCAL_RANK % device_count)``, as the serving
fleet's replicas cycle over the devices, so on one card every rank shares
``cuda:0``. The backend follows from that map, chosen before the group
starts and never after a failure:

- ``nccl`` where each local rank has a card of its own;
- ``gloo`` on the CPU, and where ranks share a card (NCCL refuses two
  ranks on one device). gloo takes the card's tensors as they are: it
  copies them through host memory on a stream of its own, ordered after
  the caller's, and the caller's stream waits for the result.

A rank draws what the single run draws and keeps its own rows: the resets
below split the whole batch's uniforms and keep the rank's block, so the
number of ranks never changes a formation's draws. A single process is
the world of one: no group, and every collective is the identity.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from marl_distributedformation_tpu_torch.device import (
    DeviceLike,
    resolve_device,
)

Tensor = torch.Tensor

# Seconds a collective may wait for its peers before the group raises.
TIMEOUT_S = 600

# The group's backend: process state, as the group itself is.
_RUNTIME: Dict[str, Any] = {"backend": None}


def _env_int(name: str, default: Optional[int] = None) -> Optional[int]:
    value = os.environ.get(name)
    return default if value in (None, "") else int(value)


def local_rank() -> int:
    """This process's index among the ranks of its host (``LOCAL_RANK``, 0
    when unset)."""
    return _env_int("LOCAL_RANK", 0)


def rank_device(device: DeviceLike = None) -> torch.device:
    """The rank's device: the CPU when asked for by name, else
    ``cuda:(LOCAL_RANK % device_count)`` (raises without a card, as every
    entry point does)."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return dev
    return torch.device("cuda", local_rank() % torch.cuda.device_count())


def choose_backend(device: torch.device, local_world: int,
                   device_count: int) -> str:
    """The backend for ranks on ``device`` when ``local_world`` ranks of a
    host share ``device_count`` cards (see the module docstring)."""
    if device.type == "cuda" and local_world <= device_count:
        return "nccl"
    return "gloo"


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device: DeviceLike = None,
) -> bool:
    """Idempotent wire-up of this process into the launcher's group.

    The arguments default to the launcher's variables:
    ``MASTER_ADDR:MASTER_PORT``, ``WORLD_SIZE`` and ``RANK``. Without
    ``WORLD_SIZE`` the process runs alone and no group starts. With it (a
    world of one included) the group starts on the backend that the
    rank's device asks for (``choose_backend``; ``device`` as
    ``rank_device`` takes it), and a failure to start raises. Returns
    True when more than one process takes part, as the JAX package's
    does, so callers never branch on the launch mode themselves."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    world = num_processes if num_processes is not None else _env_int(
        "WORLD_SIZE")
    if world is None:
        return False
    rank = process_id if process_id is not None else _env_int("RANK", 0)
    if coordinator_address is None:
        coordinator_address = (f"{os.environ.get('MASTER_ADDR', 'localhost')}"
                               f":{os.environ['MASTER_PORT']}")
    dev = rank_device(device)
    local_world = _env_int("LOCAL_WORLD_SIZE", world)
    count = torch.cuda.device_count() if dev.type == "cuda" else 0
    name = choose_backend(dev, local_world, count)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        name, init_method=f"tcp://{coordinator_address}",
        world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=TIMEOUT_S),
    )
    _RUNTIME.update(backend=name)
    return world > 1


def shutdown_distributed() -> None:
    """Leave the group (a no-op alone)."""
    if dist.is_initialized():
        dist.destroy_process_group()
    _RUNTIME.update(backend=None)


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def backend() -> Optional[str]:
    """The group's backend, None alone."""
    return _RUNTIME["backend"] if dist.is_initialized() else None


def is_coordinator() -> bool:
    """True on the process that owns host-side side effects (checkpoint
    writes, metric records, summaries). Always True alone."""
    return process_index() == 0


def barrier() -> None:
    """Every rank waits for the others (a no-op alone)."""
    if world_size() > 1:
        dist.barrier()


# ----------------------------------------------------------------------
# Collectives on either backend
# ----------------------------------------------------------------------


def all_reduce_sum(t: Tensor, group: Any = None) -> Tensor:
    """``t`` summed over the ranks of ``group`` (the world when None), in
    place. A group of one rank still runs the collective (a one-rank NCCL
    group is a real path); only a process without a group skips it."""
    if not dist.is_initialized():
        return t
    dist.all_reduce(t, group=group)
    return t


def all_gather(t: Tensor, group: Any = None,
               out: Optional[Tensor] = None) -> Tensor:
    """``(size, *t.shape)``: every rank's ``t`` of ``group`` in rank order
    (into ``out`` when given)."""
    size = dist.get_world_size(group) if dist.is_initialized() else 1
    if out is None:
        out = torch.empty((size, *t.shape), dtype=t.dtype, device=t.device)
    if not dist.is_initialized():
        out[0].copy_(t)
        return out
    dist.all_gather(list(out.unbind(0)), t.contiguous(), group=group)
    return out


def broadcast_(t: Tensor, src: int = 0, group: Any = None) -> Tensor:
    """``t`` overwritten with rank ``src``'s, in place."""
    if not dist.is_initialized():
        return t
    dist.broadcast(t, src=src, group=group)
    return t


def broadcast_object(obj: Any, src: int = 0) -> Any:
    """Rank ``src``'s ``obj`` (picklable: host trees, numbers, errors) on
    every rank."""
    if world_size() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src)
    return box[0]


def from_coordinator(fn: Callable[[], Any]) -> Any:
    """``fn()`` run on the coordinator alone, its result on every rank. An
    exception it raises is broadcast first and raised on every rank, so no
    peer waits inside the broadcast for a result that will not come (the
    JAX package's ``broadcast_restore`` protocol). Alone, ``fn()``."""
    if world_size() == 1:
        return fn()
    result, err = None, None
    if is_coordinator():
        try:
            result = fn()
        except BaseException as e:  # noqa: BLE001 — raised on every rank
            err = e
    result, err = broadcast_object((result, err))
    if err is not None:
        raise err
    return result


def all_gather_object(obj: Any) -> List[Any]:
    """Every rank's ``obj``, in rank order."""
    if world_size() == 1:
        return [obj]
    out: List[Any] = [None] * world_size()
    dist.all_gather_object(out, obj)
    return out


# ----------------------------------------------------------------------
# A rank's block of the formation axis
# ----------------------------------------------------------------------


def local_formation_slice(
    num_formations: int, process_index_: Optional[int] = None,
    process_count: Optional[int] = None,
) -> Tuple[int, int]:
    """``(start, count)`` of a process's contiguous formation block: the
    formation axis split evenly over ``process_count`` blocks (the
    world's ranks by default); M must divide, so every block has one
    static shape."""
    n_proc = world_size() if process_count is None else process_count
    assert num_formations % n_proc == 0, (
        f"num_formations={num_formations} must be divisible by "
        f"process_count={n_proc}"
    )
    count = num_formations // n_proc
    pid = process_index() if process_index_ is None else process_index_
    return pid * count, count


@dataclasses.dataclass(frozen=True)
class LocalBlock:
    """A rank's rows of a formation-leading tree: ``tree`` holds rows
    ``start .. start + count`` of ``total`` (the JAX package's global
    array, whose addressable shard is the local data)."""

    tree: Any
    start: int
    count: int
    total: int


def tree_map(fn, tree: Any) -> Any:
    """``fn`` on every tensor of a tree of dicts, lists, tuples and
    dataclasses; other leaves pass as they are."""
    if isinstance(tree, Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return type(tree)(**{f.name: tree_map(fn, getattr(tree, f.name))
                             for f in dataclasses.fields(tree)})
    return tree


def tree_leaves(tree: Any) -> List[Tensor]:
    out: List[Tensor] = []
    tree_map(out.append, tree)
    return out


def block_rows(tree: Any, start: int, count: int, dim: int = 0) -> Any:
    """Rows ``start .. start + count`` of every tensor's ``dim``."""
    return tree_map(lambda t: t.narrow(dim, start, count), tree)


def global_from_local(tree: Any, mesh: Any) -> LocalBlock:
    """This rank's formation block ``tree`` with its place in the global
    batch: rows from ``mesh``'s dp index times the block's rows (the
    counterpart of JAX's assembly from process-local data; nothing is
    gathered)."""
    count = int(tree_leaves(tree)[0].shape[0])
    dp, idx = mesh.shape.get("dp", 1), mesh.coords.get("dp", 0)
    return LocalBlock(tree, idx * count, count, dp * count)


def _dp_block(mesh: Any, num_formations: int) -> Tuple[int, int]:
    dp = mesh.shape.get("dp", 1)
    return local_formation_slice(num_formations, mesh.coords.get("dp", 0),
                                 dp)


def reset_batch_sharded(
    generator: Any, params: Any, num_formations: int, mesh: Any,
    device: DeviceLike = None,
) -> LocalBlock:
    """``env.formation.reset_batch`` of this rank's formation block: the
    whole batch's uniforms drawn from ``generator`` as the single run
    draws them, the block's rows kept and scaled (elementwise, so its
    rows equal the unsharded reset's bitwise)."""
    from marl_distributedformation_tpu_torch.env.formation import (
        reset_batch,
        reset_uniforms,
    )

    start, count = _dp_block(mesh, num_formations)
    dev = resolve_device(device)
    uniforms = reset_uniforms(params, num_formations, generator, dev)
    local = reset_batch(params, count, uniforms=block_rows(
        uniforms, start, count))
    return global_from_local(local, mesh)


def hetero_reset_batch_sharded(
    generator: Any, params: Any, n_agents: Tensor, n_obstacles: Tensor,
    mesh: Any, device: DeviceLike = None,
) -> LocalBlock:
    """``env.hetero.hetero_reset_batch`` of this rank's block: the counts
    ``(M,)`` are the whole batch's (drawn alike on every rank), the
    uniforms the whole batch's, and the block's rows of both are kept."""
    from marl_distributedformation_tpu_torch.env.formation import (
        reset_uniforms,
    )
    from marl_distributedformation_tpu_torch.env.hetero import (
        hetero_reset_batch,
    )

    num_formations = int(n_agents.shape[0])
    start, count = _dp_block(mesh, num_formations)
    dev = resolve_device(device)
    uniforms = reset_uniforms(params, num_formations, generator, dev)
    local = hetero_reset_batch(
        params, n_agents[start:start + count],
        n_obstacles[start:start + count], device=dev,
        uniforms=block_rows(uniforms, start, count))
    return global_from_local(local, mesh)


def make_hybrid_mesh(axis_sizes: Dict[str, int],
                     dcn_axis: str = "dp") -> Any:
    """The JAX package's hybrid DCN x ICI mesh. A torch.distributed world
    has no slice topology to read, so this is the single-slice case JAX
    falls back to: ``parallel.mesh.make_mesh`` over the world's ranks
    (``dcn_axis`` must name one of its axes)."""
    from marl_distributedformation_tpu_torch.parallel.mesh import make_mesh

    if dcn_axis not in axis_sizes:
        raise ValueError(f"dcn_axis {dcn_axis!r} not in {tuple(axis_sizes)}")
    return make_mesh(axis_sizes)


def stack_rows(blocks: Sequence[Any]) -> Any:
    """The rank-ordered host blocks of one tree (``all_gather_object``'s)
    concatenated along their leading axes; non-array leaves are the first
    block's."""
    import numpy as np

    first = blocks[0]
    if isinstance(first, dict):
        return {k: stack_rows([b[k] for b in blocks]) for k in first}
    if isinstance(first, np.ndarray) and first.ndim > 0:
        return np.concatenate(blocks, axis=0)
    return first
