"""Formation environment: batched over M formations and one formation at a
time (see ``formation.py``), its padded heterogeneous form (``hetero.py``)
and its space metadata (``spaces.py``)."""

from marl_distributedformation_tpu_torch.env.types import (  # noqa: F401
    EnvParams,
    FormationState,
    Transition,
    batch_of_one,
    formation_row,
)
from marl_distributedformation_tpu_torch.env.formation import (  # noqa: F401
    compute_metrics,
    compute_obs,
    compute_reward,
    integrate,
    make_vec_env,
    reset,
    reset_batch,
    step,
    step_batch,
)
from marl_distributedformation_tpu_torch.env.spaces import (  # noqa: F401
    Box,
    action_space,
    observation_space,
)
from marl_distributedformation_tpu_torch.env.baseline import control  # noqa: F401
from marl_distributedformation_tpu_torch.env.hetero import (  # noqa: F401
    FAR_AWAY,
    HeteroLayout,
    HeteroState,
    agent_mask,
    hetero_compute_obs,
    hetero_reset,
    hetero_reset_batch,
    hetero_step,
    hetero_step_batch,
    make_hetero_vec_env,
)
