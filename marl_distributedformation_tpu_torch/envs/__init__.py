"""Environments behind one contract (``EnvSpec``) with declared observation
layouts, named in a fail-fast registry; counterpart of the JAX package's
``envs/``. The port registers ``formation`` and ``pursuit_evasion``, in the
JAX package's order.

    from marl_distributedformation_tpu_torch import envs

    spec = envs.get("formation")
    spec = envs.spec_for_params(params)
    state, obs = spec.reset_env(params, generator, "cpu")  # one formation
    batch = spec.reset_batch(params, 8, generator, "cpu")
"""

from marl_distributedformation_tpu_torch.envs.spec import (  # noqa: F401
    EnvSpec,
    ObsLayout,
)
from marl_distributedformation_tpu_torch.envs.registry import (  # noqa: F401
    get_env,
    register_env,
    registered_envs,
    spec_for_params,
)
from marl_distributedformation_tpu_torch.envs.formation import (  # noqa: F401
    FORMATION_SPEC,
    formation_obs_layout,
)
from marl_distributedformation_tpu_torch.envs.pursuit import (  # noqa: F401
    PURSUIT_SPEC,
    PursuitParams,
)

# ``envs.get("formation")``, the registry's short spelling.
get = get_env

register_env(FORMATION_SPEC)
register_env(PURSUIT_SPEC)
