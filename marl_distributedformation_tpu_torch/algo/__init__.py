"""PPO: GAE, the clipped Adam, the loss and update, rollout collection."""

from marl_distributedformation_tpu_torch.algo.gae import compute_gae  # noqa: F401
from marl_distributedformation_tpu_torch.algo.optim import (  # noqa: F401
    AdamState,
    adam_init,
)
from marl_distributedformation_tpu_torch.algo.ppo import (  # noqa: F401
    MinibatchData,
    PPOConfig,
    ppo_loss,
    ppo_update,
)
from marl_distributedformation_tpu_torch.algo.rollout import (  # noqa: F401
    RolloutBatch,
    collect_rollout,
)
