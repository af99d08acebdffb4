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
from marl_distributedformation_tpu_torch.train.recovery import (  # noqa: F401
    HealthConfig,
    RecoveryConfig,
    RecoveryLadder,
    fold_recovery_generator,
    make_health_iteration,
    read_recovery_log,
    record_health_flags,
    wrap_health,
)
from marl_distributedformation_tpu_torch.train.sweep import (  # noqa: F401
    SweepTrainer,
)
from marl_distributedformation_tpu_torch.train.curriculum import (  # noqa: F401
    Curriculum,
    CurriculumStage,
    HeteroTrainer,
    curriculum_from_cfg,
    make_hetero_iteration,
    sample_stage_counts,
)
from marl_distributedformation_tpu_torch.train.hetero_sweep import (  # noqa: F401
    HeteroSweepTrainer,
)
from marl_distributedformation_tpu_torch.train.sebulba import (  # noqa: F401
    ParamBus,
    SebulbaDriver,
    TransferItem,
    TransferQueue,
    assign_gate_device,
    partition_devices,
)
