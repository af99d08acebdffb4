"""Formation environment, batched over M formations (see ``formation.py``),
and its padded heterogeneous form (``hetero.py``)."""

from marl_distributedformation_tpu_torch.env.baseline import control  # noqa: F401
from marl_distributedformation_tpu_torch.env.formation import (  # noqa: F401
    compute_metrics,
    compute_obs,
    compute_reward,
    integrate,
    make_vec_env,
    reset_batch,
    step_batch,
)
from marl_distributedformation_tpu_torch.env.hetero import (  # noqa: F401
    FAR_AWAY,
    HeteroLayout,
    HeteroState,
    hetero_compute_obs,
    hetero_reset_batch,
    hetero_step_batch,
    make_hetero_vec_env,
)
from marl_distributedformation_tpu_torch.env.types import (  # noqa: F401
    EnvParams,
    FormationState,
    Transition,
)
