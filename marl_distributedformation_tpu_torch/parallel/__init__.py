"""Parallelism across processes: dp over formations, the ring of agent slabs
over 'sp', the process wire-up and the launcher (counterpart of the JAX
package's ``parallel/``)."""

from marl_distributedformation_tpu_torch.parallel.distributed import (  # noqa: F401
    LocalBlock,
    global_from_local,
    hetero_reset_batch_sharded,
    init_distributed,
    is_coordinator,
    local_formation_slice,
    make_hybrid_mesh,
    rank_device,
    reset_batch_sharded,
    shutdown_distributed,
)
from marl_distributedformation_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    Placement,
    formation_sharding,
    make_dp_step,
    make_mesh,
    make_shard_fn,
    replicate,
    replicated,
    resolve_axis_sizes,
    shard_batch,
)
from marl_distributedformation_tpu_torch.parallel.ring import (  # noqa: F401
    halo_neighbors,
    make_ring_step,
    place_ring_state,
)
