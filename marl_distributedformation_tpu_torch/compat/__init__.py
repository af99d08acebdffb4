"""The reference's own user surface and the bridges to the JAX package:
``FormationVecEnv`` (the SB3 VecEnv contract, ``vec_env.py``), the
Gymnasium adapters (``gym_env.py``, ``gym_vector_env.py``; they import
gymnasium and are not imported here), the renderer (``render.py``,
matplotlib imported when a renderer is built), SB3 checkpoint import and
export (``sb3_import.py``), checkpoint-backed policies (``policy.py``) and
parameters to and from the JAX package's trees (``convert.py``)."""

from marl_distributedformation_tpu_torch.compat.vec_env import (  # noqa: F401
    FormationVecEnv,
)
from marl_distributedformation_tpu_torch.compat.policy import (  # noqa: F401
    LoadedPolicy,
    load_checkpoint_raw,
)
from marl_distributedformation_tpu_torch.compat.sb3_import import (  # noqa: F401
    import_sb3_checkpoint,
    sb3_state_dict_to_torch,
)
