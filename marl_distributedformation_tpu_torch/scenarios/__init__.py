"""Disturbance scenarios (counterpart of the JAX package's ``scenarios/``):
composable perturbation layers around the env step (``layers.py``), their
magnitudes as data (``params.py``), named severity-scaled recipes
(``registry.py``), the engine with the layers' own random streams
(``engine.py``), training schedules (``schedule.py``), the robustness
matrix (``matrix.py``) and the falsifier search (``adversary.py``). One
step, and one captured iteration, serve every registered scenario at every
severity, and a batch can mix scenarios per formation
(``sample_scenario_batch``).
"""

from marl_distributedformation_tpu_torch.scenarios.params import (  # noqa: F401
    ScenarioParams,
    broadcast_params,
)
from marl_distributedformation_tpu_torch.scenarios.layers import (  # noqa: F401
    neighbor_obs_columns,
    occlude_obs,
    perturb_goal,
    perturb_obs,
    perturb_obstacles,
    perturb_velocity,
)
from marl_distributedformation_tpu_torch.scenarios.engine import (  # noqa: F401
    ScenarioState,
    ScenarioStreams,
    TiledStreams,
    init_scenario_state,
    make_scenario_step,
    scenario_step,
    scenario_step_batch,
)
from marl_distributedformation_tpu_torch.scenarios.registry import (  # noqa: F401
    ScenarioSpec,
    get_scenario,
    register_scenario,
    registered_scenarios,
    sample_scenario_batch,
    scenario_params_for,
)
from marl_distributedformation_tpu_torch.scenarios.schedule import (  # noqa: F401
    ADV_SCENARIO_PREFIX,
    ScenarioSchedule,
    ScenarioStage,
    from_falsifiers,
    schedule_from_cfg,
)
from marl_distributedformation_tpu_torch.scenarios.matrix import (  # noqa: F401
    MatrixProgram,
    make_matrix_runner,
    params_signature,
    run_matrix,
)
from marl_distributedformation_tpu_torch.scenarios.adversary import (  # noqa: F401
    AdversaryConfig,
    AdversarySearch,
    ContinuousAdversary,
    Falsifier,
    make_population_runner,
)
