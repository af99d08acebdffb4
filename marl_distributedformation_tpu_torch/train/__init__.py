"""The PPO trainers: the single run (``trainer.py``), populations
(``sweep.py``), the curriculum (``curriculum.py``) and its populations
(``hetero_sweep.py``)."""

from marl_distributedformation_tpu_torch.train.trainer import (  # noqa: F401
    TrainConfig,
    Trainer,
    default_total_timesteps,
    fill_ent_schedule,
    make_ppo_iteration,
)
