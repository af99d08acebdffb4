"""The PPO trainers: the single run (``trainer.py``), populations
(``sweep.py``), the curriculum (``curriculum.py``) and its populations
(``hetero_sweep.py``), and Sebulba's split lanes (``sebulba/``)."""

from marl_distributedformation_tpu_torch.train.trainer import (  # noqa: F401
    TrainConfig,
    Trainer,
    default_total_timesteps,
    fill_ent_schedule,
    make_ppo_iteration,
)
from marl_distributedformation_tpu_torch.train.sebulba import (  # noqa: F401
    ParamBus,
    SebulbaDriver,
    TransferItem,
    TransferQueue,
    partition_devices,
)
