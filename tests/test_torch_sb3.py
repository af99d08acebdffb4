"""The port's SB3 checkpoint import and export (``compat/sb3_import.py``)
against the JAX package's, case for case as its ``tests/test_sb3_import.py``.

The fixture builds a ``PPO.save``-shaped zip (``data`` JSON and
``policy.pth`` holding a torch ``state_dict`` under SB3 ActorCriticPolicy
naming) without stable_baselines3. Numerical ground truth is an independent
forward of the same tanh MLP. Both packages import the same zip into trees
that are bitwise equal, and each reads the other's output. Tolerances:
trees bitwise; forwards within ``atol=1e-5`` (values ``1e-4``), as the JAX
test.
"""

import io
import json
import zipfile
from pathlib import Path

import numpy as np
import pytest
import torch

from marl_distributedformation_tpu.compat import sb3_import as jsb3
from marl_distributedformation_tpu.compat.policy import (
    LoadedPolicy as JaxLoadedPolicy,
)
from marl_distributedformation_tpu_torch.algo import PPOConfig
from marl_distributedformation_tpu_torch.compat import LoadedPolicy
from marl_distributedformation_tpu_torch.compat.convert import params_to_jax
from marl_distributedformation_tpu_torch.compat.sb3_import import (
    _load_policy_state_dict,
    export_sb3_state_dict,
    import_sb3_checkpoint,
    main,
    sb3_state_dict_to_torch,
)
from marl_distributedformation_tpu_torch.env import EnvParams
from marl_distributedformation_tpu_torch.models import MLPActorCritic
from marl_distributedformation_tpu_torch.train import TrainConfig, Trainer
from marl_distributedformation_tpu_torch.utils import (
    latest_checkpoint,
    msgpack_restore_file,
    save_checkpoint,
)

OBS_DIM, ACT_DIM, HIDDEN = 8, 2, (64, 64)


def sb3_state_dict(seed: int = 0):
    """Random weights under SB3 ActorCriticPolicy ``state_dict`` naming."""
    g = torch.Generator().manual_seed(seed)

    def t(*shape):
        return torch.randn(*shape, generator=g)

    state = {"log_std": t(ACT_DIM)}
    dims = (OBS_DIM,) + HIDDEN
    for net in ("policy", "value"):
        for j in range(len(HIDDEN)):
            # nn.Sequential(Linear, Tanh, Linear, Tanh) indices
            state[f"mlp_extractor.{net}_net.{2 * j}.weight"] = t(
                dims[j + 1], dims[j])
            state[f"mlp_extractor.{net}_net.{2 * j}.bias"] = t(dims[j + 1])
    state["action_net.weight"] = t(ACT_DIM, HIDDEN[-1])
    state["action_net.bias"] = t(ACT_DIM)
    state["value_net.weight"] = t(1, HIDDEN[-1])
    state["value_net.bias"] = t(1)
    return state


def write_sb3_zip(path: Path, state: dict) -> Path:
    buf = io.BytesIO()
    torch.save(state, buf)
    with zipfile.ZipFile(path, "w") as zf:
        zf.writestr("data", json.dumps({"policy_class": "MlpPolicy"}))
        zf.writestr("policy.pth", buf.getvalue())
        zf.writestr("_stable_baselines3_version", "2.3.0")
    return path


def torch_forward(state: dict, obs: np.ndarray):
    """Independent forward of SB3's separate tanh MLPs."""
    x = torch.as_tensor(obs, dtype=torch.float32)

    def mlp(net, x):
        for j in range(len(HIDDEN)):
            w = state[f"mlp_extractor.{net}_net.{2 * j}.weight"]
            b = state[f"mlp_extractor.{net}_net.{2 * j}.bias"]
            x = torch.tanh(x @ w.T + b)
        return x

    mean = mlp("policy", x) @ state["action_net.weight"].T + state[
        "action_net.bias"]
    value = mlp("value", x) @ state["value_net.weight"].T + state[
        "value_net.bias"]
    return mean.numpy(), value.numpy()[..., 0]


def assert_trees_equal(a, b, path=""):
    assert isinstance(a, dict) == isinstance(b, dict), path
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            assert_trees_equal(a[k], b[k], f"{path}/{k}")
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, path
    np.testing.assert_array_equal(a, b, err_msg=path)


def obs_rows(seed, n=32):
    return np.random.default_rng(seed).standard_normal(
        (n, OBS_DIM)).astype(np.float32)


def test_forward_parity_after_import():
    state = sb3_state_dict()
    params, info = sb3_state_dict_to_torch(
        {k: v.numpy() for k, v in state.items()})
    assert info == {"obs_dim": OBS_DIM, "act_dim": ACT_DIM, "hidden": HIDDEN}
    model = MLPActorCritic(OBS_DIM, ACT_DIM)
    model.load_state_dict(params)
    obs = obs_rows(1)
    with torch.no_grad():
        mean, log_std, value = model(torch.from_numpy(obs))
    mean_t, value_t = torch_forward(state, obs)
    np.testing.assert_allclose(mean.numpy(), mean_t, atol=1e-5)
    np.testing.assert_allclose(value.numpy(), value_t, atol=1e-4)
    np.testing.assert_array_equal(log_std.detach().numpy(),
                                  state["log_std"].numpy())
    # SB3's (out, in) is the port's own layout: no transpose.
    assert torch.equal(params["pi_0.weight"],
                       state["mlp_extractor.policy_net.0.weight"])


def test_both_packages_import_one_zip_into_equal_trees(tmp_path):
    """Bitwise-equal trees, each package reading the other's file, and
    playback serving the imported weights in both."""
    state = sb3_state_dict(seed=3)
    src = write_sb3_zip(tmp_path / "rl_model_123000_steps.zip", state)
    ours = import_sb3_checkpoint(src, tmp_path / "port")
    ref = jsb3.import_sb3_checkpoint(src, tmp_path / "jax")
    assert ours.name == ref.name == "rl_model_123000_steps.msgpack"
    assert latest_checkpoint(tmp_path / "port") == ours
    assert_trees_equal(msgpack_restore_file(ours), msgpack_restore_file(ref))
    obs = obs_rows(2, 5)
    want = np.clip(torch_forward(state, obs)[0], -1.0, 1.0)
    for path in (ours, ref):
        got, _ = LoadedPolicy.from_checkpoint(path, device="cpu").predict(obs)
        np.testing.assert_allclose(got, want, atol=1e-5)
        got, _ = JaxLoadedPolicy.from_checkpoint(path).predict(obs)
        np.testing.assert_allclose(np.asarray(got), want, atol=1e-5)


def test_bare_state_dict_file_imports(tmp_path):
    state = sb3_state_dict(seed=8)
    pth = tmp_path / "rl_model_7_steps.pth"
    torch.save(state, pth)
    out = import_sb3_checkpoint(pth)
    assert out == tmp_path / "rl_model_7_steps.msgpack"
    assert msgpack_restore_file(out)["sb3_import"]["source"] == pth.name


def test_warm_start_resume(tmp_path):
    """A params-only imported file warm-starts the port's trainer: its
    weights and timestep counter, a fresh optimizer state."""
    state = sb3_state_dict(seed=4)
    import_sb3_checkpoint(write_sb3_zip(tmp_path / "rl_model_5000_steps.zip",
                                        state))
    params = EnvParams(num_agents=3)
    trainer = Trainer(
        params, ppo=PPOConfig(n_steps=4, batch_size=24, n_epochs=1),
        config=TrainConfig(num_formations=2, name="sb3_resume",
                           log_dir=str(tmp_path), resume=True,
                           checkpoint=False),
        model=MLPActorCritic(params.obs_dim), device="cpu")
    assert trainer.num_timesteps == 5000
    assert torch.equal(trainer.model.pi_head.weight.detach(),
                       state["action_net.weight"])
    assert np.isfinite(float(trainer.run_iteration()["loss"]))


def test_shared_trunk_rejected():
    state = {k: v.numpy() for k, v in sb3_state_dict().items()}
    state["mlp_extractor.shared_net.0.weight"] = np.zeros((64, OBS_DIM))
    with pytest.raises(ValueError, match="shared-trunk"):
        sb3_state_dict_to_torch(state)


@pytest.mark.parametrize("victim", ["action_net.bias", "value_net.bias",
                                    "mlp_extractor.policy_net.0.bias"])
def test_malformed_checkpoints_fail_descriptively(victim):
    state = {k: v.numpy() for k, v in sb3_state_dict().items()}
    del state[victim]
    match = "missing bias" if victim.startswith("mlp") else victim
    with pytest.raises(ValueError, match=match) as ours:
        sb3_state_dict_to_torch(state)
    with pytest.raises(ValueError) as ref:
        jsb3.sb3_state_dict_to_flax(state)
    assert str(ours.value) == str(ref.value)


def test_cli_rejects_output_collisions(tmp_path, capsys):
    a_dir, b_dir = tmp_path / "a", tmp_path / "b"
    a_dir.mkdir(), b_dir.mkdir()
    src_a = write_sb3_zip(a_dir / "rl_model_100_steps.zip", sb3_state_dict(5))
    src_b = write_sb3_zip(b_dir / "rl_model_100_steps.zip", sb3_state_dict(6))
    out_dir = tmp_path / "converted"
    with pytest.raises(SystemExit):
        main([str(src_a), str(src_b), "--out-dir", str(out_dir)])
    assert "collision" in capsys.readouterr().err
    assert not list(out_dir.glob("*.msgpack"))
    with pytest.raises(SystemExit):
        main([str(src_a), str(src_b), "--steps", "7"])
    assert "--steps with multiple sources" in capsys.readouterr().err
    main([str(src_a), "--out-dir", str(out_dir)])
    assert (out_dir / "rl_model_100_steps.msgpack").exists()


def test_export_roundtrip_in_both_packages(tmp_path):
    """Framework checkpoint -> SB3-named state_dict -> re-import: the same
    parameters bitwise, and both packages' exports equal."""
    model = MLPActorCritic(OBS_DIM, generator=torch.Generator().manual_seed(9))
    tree = params_to_jax(model.state_dict(), "MLPActorCritic")
    ckpt = save_checkpoint(tmp_path, 42, {
        "policy": "MLPActorCritic", "params": tree, "num_timesteps": 42})
    out = export_sb3_state_dict(ckpt)
    assert out.name == "rl_model_42_steps.sb3.pth"
    exported = _load_policy_state_dict(out)
    ref = jsb3.export_sb3_state_dict(ckpt, tmp_path / "jax.sb3.pth")
    assert_trees_equal(exported, jsb3._load_policy_state_dict(ref))
    back, info = sb3_state_dict_to_torch(exported)
    for k, v in model.state_dict().items():
        assert torch.equal(back[k], v), k
    assert info["obs_dim"] == OBS_DIM
    main(["--export", str(ckpt), "--out-dir", str(tmp_path / "cli")])
    assert (tmp_path / "cli" / "rl_model_42_steps.sb3.pth").exists()


def test_export_rejects_non_mlp(tmp_path):
    ckpt = save_checkpoint(tmp_path, 1, {"policy": "GNNActorCritic",
                                         "params": {"params": {}}})
    with pytest.raises(ValueError, match="no SB3 equivalent"):
        export_sb3_state_dict(ckpt)


def test_missing_policy_pth_rejected(tmp_path):
    bad = tmp_path / "rl_model_1_steps.zip"
    with zipfile.ZipFile(bad, "w") as zf:
        zf.writestr("data", "{}")
    with pytest.raises(ValueError, match="policy.pth"):
        import_sb3_checkpoint(bad)
