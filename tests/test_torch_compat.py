"""The port's host-side compat layer against the JAX package's
(``tests/test_compat.py``, case for case where the case has a counterpart):
``FormationVecEnv``'s SB3 VecEnv contract, ``LoadedPolicy`` on a trained
run, the renderer and ``obstacle_hits``, all on the CPU.

Tolerances: ``obstacle_hits`` and the env's containment flags bitwise; the
VecEnv's arrays bitwise those of ``make_vec_env`` from the same seed;
``predict`` within ``atol=1e-6`` of the model's mean (as the JAX test).
"""

import matplotlib
import numpy as np
import pytest
import torch

from marl_distributedformation_tpu.compat.render import (
    obstacle_hits as jax_obstacle_hits,
)
from marl_distributedformation_tpu.env.formation import (
    _in_obstacle as jax_in_obstacle,
)
from marl_distributedformation_tpu_torch.algo import PPOConfig
from marl_distributedformation_tpu_torch.compat import (
    FormationVecEnv,
    LoadedPolicy,
)
from marl_distributedformation_tpu_torch.compat.render import (
    FormationRenderer,
    obstacle_hits,
)
from marl_distributedformation_tpu_torch.env import EnvParams, make_vec_env
from marl_distributedformation_tpu_torch.env.formation import _in_obstacle
from marl_distributedformation_tpu_torch.models import MLPActorCritic
from marl_distributedformation_tpu_torch.train import TrainConfig, Trainer
from marl_distributedformation_tpu_torch.utils import (
    latest_checkpoint,
    save_checkpoint,
)
from test_torch_env import jax_params


def vec_env(params, m, seed=0):
    return FormationVecEnv(params, m, seed=seed, device="cpu")


def test_vec_env_contract():
    """The reference's FormationEnv surface (vectorized_env.py:52-82):
    flattened M*N rows, [-1, 1] actions scaled x10, done broadcast."""
    env = vec_env(EnvParams(num_agents=3), 4)
    assert env.num_envs == 12
    obs = env.reset()
    assert obs.shape == (12, 8) and obs.dtype == np.float32
    assert env.observation_space.shape == (8,)
    assert env.action_space.shape == (2,)
    obs2, rewards, dones, infos = env.step(np.zeros((12, 2), np.float32))
    assert obs2.shape == (12, 8)
    assert rewards.shape == (12,)
    assert dones.shape == (12,) and dones.dtype == bool
    assert infos == [{}] * 12  # Q4 parity: infos always empty
    assert (dones.reshape(4, 3) == dones.reshape(4, 3)[:, :1]).all()
    assert set(env.last_metrics) >= {"avg_dist_to_goal", "reward"}
    env.close()


def test_vec_env_seed_determinism_and_reseed():
    e1 = vec_env(EnvParams(num_agents=3), 2, seed=5)
    e2 = vec_env(EnvParams(num_agents=3), 2, seed=5)
    e3 = vec_env(EnvParams(num_agents=3), 2, seed=6)
    r1 = e1.reset()
    np.testing.assert_array_equal(r1, e2.reset())
    assert not np.allclose(r1, e3.reset())
    e3.seed(5)
    np.testing.assert_array_equal(r1, e3.reset())
    with pytest.raises(RuntimeError, match="reset"):
        vec_env(EnvParams(num_agents=3), 1).step(np.zeros((3, 2)))


def test_vec_env_velocity_contract():
    """step_velocities drives the L0 raw-velocity API (SURVEY.md Q8)."""
    env = vec_env(EnvParams(num_agents=2), 1, seed=1)
    env.reset()
    before = env.agents_np().copy()
    vel = np.array([[[3.0, 4.0], [-2.0, 1.0]]], np.float32)
    env.step_velocities(vel)
    np.testing.assert_allclose(env.agents_np() - before, vel[0], atol=1e-4)
    assert env.goal_np().shape == (2,) and env.obstacles_np().shape == (0, 2)


@pytest.mark.parametrize("obs_mode", ["ring", "knn"])
def test_vec_env_is_make_vec_env_converted(obs_mode):
    """The adapter only converts: its arrays are ``make_vec_env``'s bitwise
    from the same seed, across an episode end (one fetch a step)."""
    params = EnvParams(num_agents=6, obs_mode=obs_mode, knn_k=2,
                       max_steps=3)
    m, n = 3, 6
    env = vec_env(params, m, seed=9)
    reset_fn, step_fn = make_vec_env(
        params, m, "cpu", torch.Generator().manual_seed(9))
    obs = env.reset()
    state, ref = reset_fn()
    np.testing.assert_array_equal(obs, ref.reshape(m * n, -1).numpy())
    rng = np.random.default_rng(0)
    done_rows = 0
    for _ in range(7):
        act = rng.uniform(-1, 1, (m * n, 2)).astype(np.float32)
        obs, rewards, dones, _ = env.step(act)
        state, tr = step_fn(state, torch.from_numpy(act.reshape(m, n, 2)))
        np.testing.assert_array_equal(obs, tr.obs.reshape(m * n, -1).numpy())
        np.testing.assert_array_equal(rewards, tr.reward.reshape(-1).numpy())
        np.testing.assert_array_equal(
            dones, np.repeat(tr.done.numpy(), n))
        assert env.last_metrics["reward"] == pytest.approx(
            float(tr.metrics["reward"].mean()), rel=1e-6)
        done_rows += int(dones.sum())
    assert done_rows == m * n  # one episode end (max_steps + 2 = 5)


@pytest.fixture(scope="module")
def tiny_run(tmp_path_factory):
    """A tiny trained run of the port's trainer on the CPU."""
    root = tmp_path_factory.mktemp("root")
    params = EnvParams(num_agents=3)
    trainer = Trainer(
        params,
        ppo=PPOConfig(n_steps=4, batch_size=24, n_epochs=1),
        config=TrainConfig(num_formations=2, total_timesteps=2 * 3 * 4 * 2,
                           name="viz", log_dir=str(root / "logs" / "viz")),
        model=MLPActorCritic(params.obs_dim,
                             generator=torch.Generator().manual_seed(0)),
        device="cpu",
    )
    trainer.train()
    return root, trainer


def test_loaded_policy_roundtrip(tiny_run):
    root, trainer = tiny_run
    policy = LoadedPolicy.from_checkpoint(
        latest_checkpoint(root / "logs" / "viz"), device="cpu")
    obs = np.random.default_rng(0).normal(size=(6, 8)).astype(np.float32)
    actions, _ = policy.predict(obs, deterministic=True)
    assert actions.shape == (6, 2) and (np.abs(actions) <= 1.0).all()
    with torch.no_grad():
        mean, _, _ = trainer.model(torch.from_numpy(obs))
    np.testing.assert_allclose(actions, np.clip(mean.numpy(), -1, 1),
                               atol=1e-6)
    s1, _ = policy.predict(obs, deterministic=False)
    s2, _ = policy.predict(obs, deterministic=False)
    assert not np.allclose(s1, s2) and (np.abs(s1) <= 1.0).all()


def test_loaded_policy_rejects_garbage(tmp_path):
    bad = save_checkpoint(tmp_path, 1, {"not_params": 1})
    with pytest.raises(ValueError, match="does not look like"):
        LoadedPolicy.from_checkpoint(bad, device="cpu")


def test_renderer_headless():
    params = EnvParams(num_agents=4, num_obstacles=2, obstacle_mode="fixed")
    r = FormationRenderer(params, title="t")
    agents = np.random.default_rng(0).uniform(0, 100, (4, 2))
    r.update(agents, np.array([200.0, 300.0]),
             np.array([[50.0, 200.0], [300.0, 400.0]]))
    r.draw()
    assert len(r.agent_circles) == 4 and len(r.obstacle_rects) == 2


@pytest.mark.parametrize("mode", ["parity", "fixed"])
def test_obstacle_hits_match_jax_and_the_env_geometry(mode):
    """The renderer's host mirror equals the JAX package's, bitwise, and
    agrees with the env's containment in both packages (per obstacle
    against per agent: through the any-collision flag)."""
    rng = np.random.default_rng(7)
    params = EnvParams(num_agents=6, num_obstacles=3, obstacle_mode=mode)
    for _ in range(20):
        agents = rng.uniform(0, 500, (6, 2)).astype(np.float32)
        obstacles = rng.uniform(0, 500, (3, 2)).astype(np.float32)
        hits = obstacle_hits(agents, obstacles, params)
        np.testing.assert_array_equal(
            hits, jax_obstacle_hits(agents, obstacles, jax_params(params)))
        ours = _in_obstacle(torch.from_numpy(agents)[None],
                            torch.from_numpy(obstacles)[None], params)[0]
        ref = np.asarray(jax_in_obstacle(agents, obstacles,
                                         jax_params(params)))
        np.testing.assert_array_equal(ours.numpy(), ref)
        assert hits.any() == ref.any()
    # Parity geometry: the point is the lower-left corner (SURVEY.md Q2).
    params = EnvParams(num_agents=2, num_obstacles=1, obstacle_mode="parity")
    far = [250.0, 250.0]
    assert obstacle_hits(np.array([[99.0, 99.0], far]),
                         np.array([[100.0, 100.0]]), params).tolist() == [
        False]
    assert obstacle_hits(np.array([[101.0, 101.0], far]),
                         np.array([[100.0, 100.0]]), params).tolist() == [True]


def test_renderer_collision_recolor():
    """Obstacle rectangles turn red while an agent is inside and back to
    green when it leaves (reference simulate.py:101-106)."""
    params = EnvParams(num_agents=2, num_obstacles=2, obstacle_mode="fixed")
    r = FormationRenderer(params)
    obstacles = np.array([[100.0, 100.0], [400.0, 400.0]])
    goal = np.array([250.0, 250.0])
    red = matplotlib.colors.to_rgba("red")
    green = matplotlib.colors.to_rgba("green")
    r.update(np.array([[100.0, 100.0], [10.0, 10.0]]), goal, obstacles)
    assert r.obstacle_rects[0].get_facecolor() == red
    assert r.obstacle_rects[1].get_facecolor() == green
    r.update(np.array([[10.0, 10.0], [20.0, 20.0]]), goal, obstacles)
    assert r.obstacle_rects[0].get_facecolor() == green


@pytest.mark.parametrize("obs_mode", ["ring", "knn"])
def test_spaces_match_jax(obs_mode):
    import dataclasses

    from marl_distributedformation_tpu.env import spaces as jspaces
    from marl_distributedformation_tpu_torch.env import spaces

    params = EnvParams(num_agents=6, obs_mode=obs_mode, knn_k=2)
    for fn in ("action_space", "observation_space"):
        ours = getattr(spaces, fn)(params)
        ref = getattr(jspaces, fn)(jax_params(params))
        assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
        rng = np.random.default_rng(0)
        np.testing.assert_array_equal(
            ours.sample(rng), ref.sample(np.random.default_rng(0)))
        box = ours.to_gymnasium()
        assert box.shape == ours.shape and box.dtype == np.float32
