"""The port's tools and examples on the CPU, as the JAX package's
``tests/test_compat.py``, ``test_shim.py`` and ``test_examples.py`` hold
the root scripts: ``simulate`` and ``visualize_policy`` headless (and a
gif under ``Agg``), ``keyboard_move`` with synthetic key events, the
``vectorized_env`` shim, the JAX-backend refusals, and the two examples at
a budget of a few seconds. The playback's actions are held against the
JAX package's ``LoadedPolicy`` on the same checkpoint (``atol=1e-6``).
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from marl_distributedformation_tpu.compat.policy import (
    LoadedPolicy as JaxLoadedPolicy,
)
from marl_distributedformation_tpu_torch import (
    keyboard_move,
    simulate,
    visualize_policy,
)
from marl_distributedformation_tpu_torch import vectorized_env as shim
from marl_distributedformation_tpu_torch.compat import (
    FormationVecEnv,
    LoadedPolicy,
)
from marl_distributedformation_tpu_torch.compat.convert import params_to_jax
from marl_distributedformation_tpu_torch.models import MLPActorCritic
from marl_distributedformation_tpu_torch.train import cli as train_cli
from marl_distributedformation_tpu_torch.utils import (
    config,
    load_config,
    save_checkpoint,
)

ROOT = Path(__file__).resolve().parent.parent


def write_mlp_run(log_dir: Path, steps: int = 96, seed: int = 0):
    """A seeded MLP checkpoint (N=3 ring obs, 8 wide) in ``log_dir``."""
    model = MLPActorCritic(8, generator=torch.Generator().manual_seed(seed))
    return save_checkpoint(log_dir, steps, {
        "policy": "MLPActorCritic", "num_timesteps": steps,
        "params": params_to_jax(model.state_dict(), "MLPActorCritic")})


@pytest.fixture
def logs(tmp_path, monkeypatch):
    monkeypatch.setattr(config, "repo_root", lambda: tmp_path)
    return tmp_path / "logs"


def test_simulate_headless_runs_and_converges(capsys):
    rows = simulate.main(["headless=true", "steps=301", "num_agents=5",
                          "seed=3", "device=cpu"])
    out = capsys.readouterr().out
    assert "avg_dist_to_goal" in out
    assert [r["step"] for r in rows] == [0, 100, 200, 300]
    assert rows[-1]["avg_dist_to_goal"] < rows[0]["avg_dist_to_goal"]


def test_simulate_obstacle_demo_headless(capsys):
    simulate.main(["headless=true", "steps=30", "num_agents=4",
                   "num_obstacles=4", "obstacle_mode=fixed", "seed=3",
                   "device=cpu"])
    assert "obstacle_hits=" in capsys.readouterr().out


@pytest.mark.parametrize("tool", [simulate, keyboard_move,
                                  visualize_policy])
def test_tools_refuse_the_jax_backend_knobs(tool, logs):
    write_mlp_run(logs / "x")
    with pytest.raises(SystemExit, match="selects the JAX backend"):
        tool.main(["name=x", "platform=cpu", "headless=true"])
    with pytest.raises(SystemExit, match="selects the JAX backend"):
        tool.main(["name=x", "backend=torch", "headless=true"])


def test_visualize_policy_headless_matches_jax_policy(logs, capsys):
    path = write_mlp_run(logs / "viz")
    played = visualize_policy.main(
        ["name=viz", "headless=true", "steps=2", "num_agents_per_formation=3",
         "device=cpu"])
    out = capsys.readouterr().out
    assert played == 2
    assert f"Loading model from {path}" in out and out.count("rewards:") == 2
    # The playback's first actions are the JAX package's on the same obs.
    params = config.env_params_from_config(
        load_config(["num_agents_per_formation=3"]))
    obs = FormationVecEnv(params, 1, seed=0, device="cpu").reset()
    ours, _ = LoadedPolicy.from_checkpoint(path, device="cpu").predict(obs)
    ref, _ = JaxLoadedPolicy.from_checkpoint(path).predict(obs)
    np.testing.assert_allclose(ours, np.asarray(ref), atol=1e-6)
    assert f"actions: {ours}" in out


def test_visualize_policy_no_checkpoint_and_sweep_fallbacks(logs, capsys):
    with pytest.raises(SystemExit, match="no rl_model"):
        visualize_policy.main(["name=nothere", "headless=true",
                               "device=cpu"])
    # An interrupted population: no summary, the furthest-trained member.
    write_mlp_run(logs / "pop" / "seed0", steps=48)
    best = write_mlp_run(logs / "pop" / "seed1", steps=96)
    assert visualize_policy.find_checkpoint(logs / "pop") == best
    assert "furthest-trained member seed1" in capsys.readouterr().out
    (logs / "pop" / "sweep_summary.json").write_text('{"best_dir": "seed0"}')
    assert visualize_policy.find_checkpoint(logs / "pop").parent.name == \
        "seed0"
    (logs / "pop" / "sweep_summary.json").write_text('{"best_dir": "seed7"}')
    assert visualize_policy.find_checkpoint(logs / "pop") == best
    assert "falling back" in capsys.readouterr().out


def test_visualize_policy_gif(logs, tmp_path, capsys):
    write_mlp_run(logs / "viz")
    gif = tmp_path / "demo.gif"
    visualize_policy.main(["name=viz", "steps=4", "gif_every=2",
                           f"gif={gif}", "num_agents_per_formation=3",
                           "device=cpu"])
    assert gif.stat().st_size > 0
    assert "wrote 2 frames" in capsys.readouterr().out


def test_keyboard_move_synthetic_keys(capsys):
    """Teleop under ``Agg``: ``plt.show`` returns, then key events drive
    the handler: a digit selects an agent, an arrow moves it by 10."""
    import matplotlib.pyplot as plt
    from matplotlib.backend_bases import KeyEvent

    env = keyboard_move.main(["num_agents=3", "device=cpu"])
    canvas = plt.gcf().canvas
    before = env.agents_np().copy()

    def press(key):
        canvas.callbacks.process("key_press_event",
                                 KeyEvent("key_press_event", canvas, key))

    press("1")
    press("up")
    press("x")  # ignored
    moved = env.agents_np() - before
    np.testing.assert_allclose(moved[1], [0.0, 10.0], atol=1e-4)
    np.testing.assert_allclose(moved[[0, 2]], 0.0, atol=1e-4)
    out = capsys.readouterr().out
    assert "Moving agent 1" in out and "rewards=" in out
    press("escape")
    assert not plt.get_fignums()


def test_shim_forwards_to_train_main_and_builds_formation_env():
    assert shim.main is train_cli.main
    cfg = load_config(["name=shimtest", "num_formation=4", "device=cpu"])
    env = shim.FormationEnv(cfg)
    assert isinstance(env, FormationVecEnv)
    assert env.num_envs == 4 * cfg.num_agents_per_formation
    obs = env.reset()
    obs2, rewards, dones, infos = env.step(np.zeros((env.num_envs, 2)))
    assert obs.shape == obs2.shape == (env.num_envs, obs.shape[1])
    assert rewards.shape == dones.shape == (env.num_envs,)
    assert len(infos) == env.num_envs


def test_shim_import_is_light():
    """Importing the shim for ``FormationEnv`` imports no trainer."""
    code = ("import sys, marl_distributedformation_tpu_torch.vectorized_env;"
            " bad = [m for m in sys.modules if m.startswith("
            "('marl_distributedformation_tpu_torch.train', "
            "'marl_distributedformation_tpu_torch.algo'))]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT)


def test_functional_env_example_runs(capsys):
    from marl_distributedformation_tpu_torch.examples import functional_env

    assert functional_env.main(["device=cpu"]) < 100
    assert "converged" in capsys.readouterr().out


def test_custom_policy_example_runs(tmp_path, monkeypatch, capsys):
    from marl_distributedformation_tpu_torch.examples import custom_policy

    monkeypatch.setenv("EXAMPLE_TOTAL_TIMESTEPS", "3200")
    monkeypatch.setenv("EXAMPLE_LOG_DIR", str(tmp_path / "logs"))
    monkeypatch.setenv("EXAMPLE_EVAL_FORMATIONS", "16")
    got = custom_policy.main(["device=cpu"])
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if "episode return/agent" in ln][0]
    assert "baseline" in line
    assert all(np.isfinite(v) for v in got.values())
    assert (tmp_path / "logs" / "metrics.jsonl").exists()
