"""The reference's training invocation and ``FormationEnv(cfg)`` on the
port (reference README.md:18, vectorized_env.py:16-137).

    python -m marl_distributedformation_tpu_torch.vectorized_env name=x

runs the port's ``train`` CLI (``main`` is ``train.cli.main``, imported
when first read, so importing this module for ``FormationEnv`` does not
import the trainers). ``FormationEnv(cfg)`` is a
``compat.FormationVecEnv`` built from the loaded config object, the
reference's constructor signature (vectorized_env.py:17); its device is
``cfg.device`` (``cuda`` unless ``cpu``).
"""

from __future__ import annotations

from marl_distributedformation_tpu_torch.compat.vec_env import FormationVecEnv
from marl_distributedformation_tpu_torch.utils.config import (
    env_params_from_config,
)


def __getattr__(name):
    if name == "main":
        from marl_distributedformation_tpu_torch.train.cli import main

        return main
    raise AttributeError(name)


class FormationEnv(FormationVecEnv):
    """``FormationVecEnv`` from the loaded config object (reference
    vectorized_env.py:17 ``FormationEnv(cfg)``)."""

    def __init__(self, cfg):
        super().__init__(
            env_params_from_config(cfg),
            num_formations=cfg.num_formation,
            seed=int(cfg.get("seed", 0)),
            device=cfg.get("device"),
        )


if __name__ == "__main__":
    from marl_distributedformation_tpu_torch.train.cli import main

    main()
