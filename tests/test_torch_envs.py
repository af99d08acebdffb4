"""The port's env-spec layer (``envs/``) and its config resolution against
the JAX package on the CPU: declared observation layouts, the registry's
contents and fail-fast messages, and ``env=`` through ``utils/config.py``.
Both packages register ``formation`` and ``pursuit_evasion``, in that
order, so their messages are compared whole."""

import dataclasses

import numpy as np
import pytest
import torch

from marl_distributedformation_tpu import envs as jenvs
from marl_distributedformation_tpu.envs import registry as jregistry
from marl_distributedformation_tpu.utils import config as jconfig
from marl_distributedformation_tpu_torch import envs
from marl_distributedformation_tpu_torch.env import EnvParams
from marl_distributedformation_tpu_torch.env import formation
from marl_distributedformation_tpu_torch.envs import registry
from marl_distributedformation_tpu_torch.utils import config
from test_torch_env import jax_params


@pytest.mark.parametrize("goal_in_obs", [True, False])
@pytest.mark.parametrize("obs_mode", ["ring", "knn"])
def test_obs_layouts_equal_jax(obs_mode, goal_in_obs):
    params = EnvParams(num_agents=9, obs_mode=obs_mode, knn_k=3,
                       goal_in_obs=goal_in_obs)
    ours = envs.formation_obs_layout(params)
    ref = jenvs.formation_obs_layout(jax_params(params))
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    for names in (("neighbor",), ("self", "neighbor")):
        np.testing.assert_array_equal(ours.columns(*names),
                                      ref.columns(*names))
    assert ours.dim == params.obs_dim
    with pytest.raises(ValueError) as a:
        ours.require("pursuer", needed_by="a layer")
    with pytest.raises(ValueError) as b:
        ref.require("pursuer", needed_by="a layer")
    assert str(a.value) == str(b.value)


def test_formation_spec_is_the_env_functions():
    spec = envs.get("formation")
    assert spec is envs.get_env("formation") is envs.FORMATION_SPEC
    assert envs.spec_for_params(EnvParams()) is spec
    assert spec.reset_batch is formation.reset_batch
    assert spec.step_batch is formation.step_batch
    assert spec.params_cls is EnvParams
    assert spec.description == jenvs.FORMATION_SPEC.description
    assert spec.default_params(num_agents=7) == EnvParams(num_agents=7)
    params = EnvParams(num_agents=6, obs_mode="knn", knn_k=2, max_steps=3)
    state, obs = spec.reset_env(params, 3, torch.Generator().manual_seed(0),
                                "cpu")
    assert obs.shape == (3, 6, params.obs_dim)
    state, obs, reward, done, info = spec.step_env(
        state, torch.zeros(3, 6, 2), params, torch.Generator().manual_seed(1))
    assert reward.shape == (3, 6) and done.shape == (3,)
    assert "avg_dist_to_goal" in info


def test_registry_contents_and_fail_fast_messages():
    assert envs.registered_envs() == jenvs.registered_envs() == (
        "formation", "pursuit_evasion")
    for name in ("formaton", "swarm", "pursuit"):
        with pytest.raises(ValueError) as ours:
            envs.get_env(name)
        with pytest.raises(ValueError) as ref:
            jenvs.get_env(name)
        assert str(ours.value) == str(ref.value)
    with pytest.raises(ValueError) as ours:
        envs.register_env(envs.FORMATION_SPEC)
    with pytest.raises(ValueError) as ref:
        jenvs.register_env(jenvs.FORMATION_SPEC)
    assert str(ours.value) == str(ref.value)


def test_spec_for_params_and_register_as_jax(monkeypatch):
    """An unregistered params type raises naming the registered pairs; a
    params subclass resolves to its most-derived registered env; a second
    env claiming the same params class is refused."""
    for mod in (registry, jregistry):
        monkeypatch.setattr(mod, "_REGISTRY", dict(mod._REGISTRY))
        monkeypatch.setattr(mod, "_BY_PARAMS_CLS", dict(mod._BY_PARAMS_CLS))

    class Other:
        pass

    with pytest.raises(ValueError, match=r"registered: formation \(EnvParams\)"):
        envs.spec_for_params(Other())

    @dataclasses.dataclass(frozen=True)
    class Sub(EnvParams):
        pass

    assert envs.spec_for_params(Sub()) is envs.FORMATION_SPEC
    clone = dataclasses.replace(envs.FORMATION_SPEC, name="formation2")
    jclone = dataclasses.replace(jenvs.FORMATION_SPEC, name="formation2")
    with pytest.raises(ValueError) as ours:
        envs.register_env(clone)
    with pytest.raises(ValueError) as ref:
        jenvs.register_env(jclone)
    assert str(ours.value) == str(ref.value)
    sub_spec = dataclasses.replace(clone, params_cls=Sub)
    envs.register_env(sub_spec)
    assert envs.spec_for_params(Sub()) is sub_spec
    assert envs.spec_for_params(EnvParams()) is envs.FORMATION_SPEC
    assert envs.registered_envs() == ("formation", "pursuit_evasion",
                                      "formation2")


@pytest.mark.parametrize("override", ["env=formaton", "env=swarm"])
def test_config_env_typos_exit_with_the_registry_message(override):
    with pytest.raises(SystemExit) as ours:
        config.validate_override_keys([override])
    with pytest.raises(SystemExit) as ref:
        jconfig.validate_override_keys([override])
    assert str(ours.value) == str(ref.value)


def test_config_resolves_env_through_the_registry():
    """``env=formation`` builds ``EnvParams`` with every field the config
    sets; a field of the params class that the YAML omits validates (as
    the JAX package's selected-env validation allows); ``pursuit_evasion``
    resolves to its params class with its knobs, as in the JAX package,
    by both entry paths."""
    config.validate_override_keys(["max_steps=12", "env=formation"])
    jconfig.validate_override_keys(["max_steps=12", "env=formation"])
    cfg = config.load_config(["max_steps=12", "num_agents_per_formation=7"])
    params = config.env_params_from_config(cfg)
    want = jconfig.env_params_from_config(
        jconfig.load_config(["max_steps=12", "num_agents_per_formation=7"]))
    assert dataclasses.asdict(params) == dataclasses.asdict(want)
    config.validate_override_keys(["env=pursuit_evasion",
                                   "pursuer_speed=5"])
    pursuit = ["env=pursuit_evasion", "pursuer_speed=5", "max_steps=12"]
    params = config.env_params_from_config(config.load_config(pursuit))
    want = jconfig.env_params_from_config(jconfig.load_config(pursuit))
    assert type(params).__name__ == type(want).__name__ == "PursuitParams"
    assert dataclasses.asdict(params) == dataclasses.asdict(want)
    with pytest.raises(SystemExit, match="did you mean 'max_steps'"):
        config.validate_override_keys(["max_step=3"])
