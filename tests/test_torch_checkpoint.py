"""Checkpoints between the port and the JAX package on the CPU: the writer's
bytes, weight and Adam-state round trips, each package resuming the other's
files, the port's bitwise resume, and the footer and non-finite gates.

Tolerances: every round trip and resume is bitwise; the JAX package's eval
of a port-written checkpoint equals the port's within ``FREE_RUN_RTOL``
(``tests/test_torch_eval.py``).
"""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from marl_distributedformation_tpu.compat.policy import (
    LoadedPolicy as JaxLoadedPolicy,
    load_checkpoint_raw,
)
from marl_distributedformation_tpu.eval import (
    policy_act_fn as jax_policy_act_fn,
)
from marl_distributedformation_tpu.train import TrainConfig as JaxTrainConfig
from marl_distributedformation_tpu.train import Trainer as JaxTrainer
from marl_distributedformation_tpu_torch.algo import PPOConfig
from marl_distributedformation_tpu_torch.compat.convert import (
    opt_state_from_jax,
    opt_state_to_jax,
    params_from_jax,
    params_to_jax,
)
from marl_distributedformation_tpu_torch.env import EnvParams
from marl_distributedformation_tpu_torch.eval import policy_act_fn
from marl_distributedformation_tpu_torch.models import MLPActorCritic
from marl_distributedformation_tpu_torch.train import TrainConfig, Trainer
from marl_distributedformation_tpu_torch.utils.checkpoint import (
    CorruptCheckpointError,
    NonFiniteCheckpointError,
    checkpoint_path,
    msgpack_restore_file,
    msgpack_serialize,
    restore_latest_partial,
    save_checkpoint,
    write_atomic,
)
from test_torch_algo import _pair
from test_torch_env import jax_params
from test_torch_eval import _free_run
from test_torch_models import CKPT, np_tree


def assert_trees_equal(a, b, what=""):
    assert set(a) == set(b), what
    for k in a:
        if isinstance(a[k], dict):
            assert_trees_equal(a[k], b[k], f"{what}/{k}")
        else:
            x, y = np.asarray(a[k]), np.asarray(b[k])
            assert x.dtype == y.dtype and x.shape == y.shape, f"{what}/{k}"
            np.testing.assert_array_equal(x, y, err_msg=f"{what}/{k}")


def test_writer_bytes_equal_flax():
    rng = np.random.default_rng(0)
    tree = {
        "policy": "GNNActorCritic",
        "params": {"params": {"embed": {
            "kernel": rng.normal(size=(4, 8)).astype(np.float32),
            "bias": np.zeros(8, np.float32),
        }}},
        "opt_state": {"0": {}, "1": {"0": {
            "count": np.asarray(7, np.int32),
            "mu": {"x": rng.normal(size=(3,)).astype(np.float32)},
        }, "1": {}}},
        "num_timesteps": 123456789,
        "learning_rate": 1e-3,
        "scalar": np.float32(2.5),
        "torch_generator": rng.integers(0, 255, 16, dtype=np.uint8),
        "steps": np.arange(5, dtype=np.int32),
    }
    assert msgpack_serialize(tree) == serialization.msgpack_serialize(tree)


@pytest.mark.parametrize("kind", ["mlp", "gnn"])
def test_params_and_adam_state_round_trip_bitwise(kind):
    jmodel, jvars, _, policy = _pair(kind)
    tree = np_tree(jvars)
    assert_trees_equal(params_to_jax(params_from_jax(tree, policy), policy),
                       tree)
    # An optax state after a few updates, as flax's state dict writes it.
    tx = optax.chain(optax.clip_by_global_norm(0.5), optax.adam(1e-3))
    state = tx.init(jvars)
    for i in range(3):
        grads = jax.tree_util.tree_map(
            lambda p: jnp.full_like(p, 0.1 * (i + 1)), jvars)
        _, state = tx.update(grads, state, jvars)
    opt = np_tree(serialization.to_state_dict(state))
    assert_trees_equal(opt_state_to_jax(opt_state_from_jax(opt, policy),
                                        policy), opt)


def _mlp(params, seed):
    return MLPActorCritic(params.obs_dim, params.act_dim,
                          generator=torch.Generator().manual_seed(seed))


def _tiny_trainer(tmp_path, iterations=1, **kw):
    cfg = dict(num_formations=3, total_timesteps=iterations * 150,
               log_dir=str(tmp_path), seed=5)
    cfg.update(kw)
    return Trainer(EnvParams(), PPOConfig(n_epochs=2), TrainConfig(**cfg),
                   model=_mlp(EnvParams(), cfg["seed"]), device="cpu")


def test_jax_package_reads_a_port_checkpoint(tmp_path):
    trainer = _tiny_trainer(tmp_path)
    trainer.train()
    path = checkpoint_path(tmp_path, 150)
    raw = load_checkpoint_raw(path)
    assert raw["policy"] == "MLPActorCritic" and raw["num_timesteps"] == 150
    assert_trees_equal(
        raw["params"],
        params_to_jax(dict(trainer.model.named_parameters()),
                      "MLPActorCritic"),
    )
    params = EnvParams(max_steps=20)
    jpol = JaxLoadedPolicy.from_checkpoint(path)
    _free_run(
        params,
        jax_policy_act_fn(jpol.model, jpol.params, jax_params(params)),
        policy_act_fn(trainer.model.eval(), params),
        m=3,
    )


def test_jax_trainer_resumes_a_port_checkpoint(tmp_path):
    trainer = _tiny_trainer(tmp_path)
    trainer.train()
    jtrainer = JaxTrainer(
        jax_params(EnvParams()),
        config=JaxTrainConfig(num_formations=3, log_dir=str(tmp_path),
                              resume=True),
    )
    assert jtrainer.num_timesteps == 150
    assert_trees_equal(
        np_tree(jtrainer.train_state.params),
        params_to_jax(dict(trainer.model.named_parameters()),
                      "MLPActorCritic"),
    )
    assert_trees_equal(
        np_tree(serialization.to_state_dict(jtrainer.train_state.opt_state)),
        opt_state_to_jax(vars(trainer.opt_state), "MLPActorCritic"),
    )


def test_port_resumes_the_committed_jax_checkpoint(tmp_path):
    shutil.copy(CKPT, tmp_path / CKPT.name)
    trainer = _tiny_trainer(tmp_path, resume=True)
    raw = load_checkpoint_raw(CKPT)
    assert trainer.num_timesteps == raw["num_timesteps"] == 20480000
    assert_trees_equal(
        params_to_jax(dict(trainer.model.named_parameters()),
                      "MLPActorCritic"),
        np_tree(raw["params"]),
    )
    assert_trees_equal(opt_state_to_jax(vars(trainer.opt_state), "MLPActorCritic"),
                       np_tree(raw["opt_state"]))
    assert trainer.step == 0  # a learner-only resume, as the JAX trainer's


def _state(trainer):
    return {
        "params": params_to_jax(dict(trainer.model.named_parameters()),
                                trainer.policy),
        "opt": opt_state_to_jax(vars(trainer.opt_state), trainer.policy),
        "agents": trainer.env_state.agents.numpy(),
        "obs": trainer.obs.numpy(),
    }


def test_port_resume_is_bitwise(tmp_path):
    """Two iterations, a save, a resume and one more equal three iterations
    in one run, with the entropy schedule on (its clock is checkpointed;
    its horizon is the whole run's in both)."""
    ppo = PPOConfig(n_epochs=2, ent_coef_final=0.0, total_iterations=3)
    cfg = dict(num_formations=3, seed=5, total_timesteps=3 * 150)

    def trainer(log_dir, total, resume=False):
        params = EnvParams(max_steps=12)
        return Trainer(params, ppo, TrainConfig(
            **{**cfg, "total_timesteps": total}, log_dir=str(log_dir),
            resume=resume), model=_mlp(params, cfg["seed"]), device="cpu")

    whole = trainer(tmp_path / "whole", 450)
    whole.train()
    first = trainer(tmp_path / "split", 300)
    first.train()
    second = trainer(tmp_path / "split", 450, resume=True)
    assert second.num_timesteps == 300 and second.step == first.step
    last = second.train()
    assert second.step == whole.step
    assert_trees_equal(_state(second), _state(whole))
    assert last == {**whole.last_record,
                    "env_steps_per_sec": last["env_steps_per_sec"]}


def test_flipped_footer_byte_raises_and_resume_walks_back(tmp_path):
    trainer = _tiny_trainer(tmp_path, iterations=2)
    trainer.train()
    newest = checkpoint_path(tmp_path, 300)
    data = bytearray(newest.read_bytes())
    data[len(data) // 2] ^= 0x01
    newest.write_bytes(bytes(data))
    with pytest.raises(CorruptCheckpointError, match="checksum"):
        msgpack_restore_file(newest)
    path, raw = restore_latest_partial(tmp_path, ["num_timesteps"])
    assert path == checkpoint_path(tmp_path, 150) and raw == {
        "num_timesteps": 150}
    assert (tmp_path / (newest.name + ".quarantined")).exists()


def test_non_finite_leaf_is_refused(tmp_path):
    tree = {"params": {"w": np.array([1.0, np.nan], np.float32)},
            "num_timesteps": 1}
    with pytest.raises(NonFiniteCheckpointError, match="/params/w"):
        write_atomic(checkpoint_path(tmp_path, 1), tree)
    assert save_checkpoint(tmp_path, 1, tree) is None
    assert not list(tmp_path.iterdir())
    tree["params"]["w"][1] = 0.0
    assert save_checkpoint(tmp_path, 1, tree) == checkpoint_path(tmp_path, 1)
