"""Config, logging, checkpointing and profiling utilities (counterpart of
the JAX package's ``utils/``)."""

from marl_distributedformation_tpu_torch.utils.config import (  # noqa: F401
    Config,
    apply_overrides,
    env_params_from_config,
    load_config,
    repo_root,
    scenario_schedule_from_config,
    validate_override_keys,
)
from marl_distributedformation_tpu_torch.utils.checkpoint import (  # noqa: F401
    AsyncCheckpointWriter,
    CheckpointDiscovery,
    CorruptCheckpointError,
    NonFiniteCheckpointError,
    checkpoint_path,
    checkpoint_step,
    device_snapshot,
    latest_checkpoint,
    latest_sweep_state,
    msgpack_restore_file,
    prune_checkpoints,
    quarantine_checkpoint,
    restore_latest_partial,
    restore_state_dict_partial,
    save_checkpoint,
    save_sweep_state,
    strip_footer,
    sweep_state_path,
)
from marl_distributedformation_tpu_torch.utils.logging import (  # noqa: F401
    MetricsLogger,
    Throughput,
)
from marl_distributedformation_tpu_torch.utils.profiling import trace  # noqa: F401
