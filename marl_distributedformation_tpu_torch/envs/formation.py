"""The formation env behind the contract: ``env/formation.py``'s functions,
unchanged, and its declared observation layout.

Counterpart of the JAX package's ``envs/formation.py``.
"""

from __future__ import annotations

from marl_distributedformation_tpu_torch.env.formation import (
    compute_obs,
    reset,
    reset_batch,
    step,
    step_batch,
)
from marl_distributedformation_tpu_torch.env.types import EnvParams
from marl_distributedformation_tpu_torch.envs.spec import EnvSpec, ObsLayout


def formation_obs(state, params: EnvParams):
    """The observation of a state, batched or one formation's."""
    return compute_obs(state.agents, state.goal, params)


def formation_obs_layout(params: EnvParams) -> ObsLayout:
    """The layout ``compute_obs`` produces, as declared blocks.

    ring: ``[self (2) | neighbor: prev+next offsets (4) | goal (2)?]``.
    knn:  ``[self (2) | neighbor: offsets (2k) + dists (k) | goal (2)? |
    neighbor: indices (k)]``; the neighbor block is two disjoint ranges.
    """
    dim = params.obs_dim
    if params.obs_mode == "knn":
        k = params.knn_k
        blocks = [
            ("self", ((0, 2),)),
            ("neighbor", ((2, 2 + 3 * k), (dim - k, dim))),
        ]
        if params.goal_in_obs:
            blocks.append(("goal", ((2 + 3 * k, 2 + 3 * k + 2),)))
    else:
        blocks = [("self", ((0, 2),)), ("neighbor", ((2, 6),))]
        if params.goal_in_obs:
            blocks.append(("goal", ((6, 8),)))
    return ObsLayout(
        dim=dim, topology=params.obs_mode, blocks=tuple(blocks)
    )


FORMATION_SPEC = EnvSpec(
    name="formation",
    description=(
        "ring-formation control (the reference env): N agents form a "
        "regular polygon around a static goal — env/formation.py, "
        "reference simulate.py"
    ),
    params_cls=EnvParams,
    reset=reset,
    step=step,
    reset_batch=reset_batch,
    step_batch=step_batch,
    obs=formation_obs,
    obs_layout=formation_obs_layout,
)
