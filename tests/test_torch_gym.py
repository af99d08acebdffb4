"""The port's Gymnasium adapters (``compat/gym_env.py``,
``compat/gym_vector_env.py``) on the CPU against the JAX package's, and
case for case as its ``tests/test_gym_env.py`` and
``test_gym_vector_env.py``: both packages' adapters at the same params
(strict parity and goal termination, ring and knn) stepped with the same
actions across episode ends, the port's resets injected from the JAX
adapter's keys; gymnasium's ``check_env`` (ring and knn), truncation at the
reference's episode length, seeded determinism, action scaling equal to the
VecEnv adapter's, the goal-termination/timeout distinction, rendering, the
vector API with ``SAME_STEP`` autoreset, agreement with the single-env
adapter and a stock vector wrapper composing.

Tolerances: against the JAX package, spaces, ``terminated``,
``truncated``, ``info["steps"]``, the info keys and the observation's
neighbor-index columns bitwise; the other observation columns, rewards
and metrics within ``rtol=atol=1e-6`` (the env's settled tolerance: the
two packages' normalizations round 1 ulp apart), ``std_dist_to_neighbor``
within ``rtol=1e-6`` plus 1e-6 of the mean neighbor distance (a spread of
near-equal distances keeps their absolute rounding). Between the port's own adapters arrays are bitwise (they step one
env), rewards within ``rtol=1e-6``.
"""

import numpy as np
import pytest
import torch

gym = pytest.importorskip("gymnasium")

from marl_distributedformation_tpu_torch.compat.gym_env import (  # noqa: E402
    FormationGymEnv,
)
from marl_distributedformation_tpu_torch.compat.gym_vector_env import (  # noqa: E402
    FormationVectorEnv,
)
from marl_distributedformation_tpu_torch.compat.vec_env import (  # noqa: E402
    FormationVecEnv,
)
from marl_distributedformation_tpu_torch.env import EnvParams  # noqa: E402
from marl_distributedformation_tpu_torch.env.formation import (  # noqa: E402
    compute_obs,
)

from marl_distributedformation_tpu.compat.gym_env import (  # noqa: E402
    FormationGymEnv as JaxGymEnv,
)
from marl_distributedformation_tpu.compat.gym_vector_env import (  # noqa: E402
    FormationVectorEnv as JaxVectorEnv,
)
from test_torch_algo import injected_env_step  # noqa: E402
from test_torch_env import close, jax_params, same, to_port  # noqa: E402


def gym_env(params, **kw):
    return FormationGymEnv(params, device="cpu", **kw)


def vector_env(params, num_envs):
    return FormationVectorEnv(params, num_envs=num_envs, device="cpu")


# Both packages' adapters at one params: strict parity (timeouts only,
# episodes of max_steps + 2) and goal termination off parity, where a
# close_goal_dist of 450 makes goal terminations and timeouts both occur
# within 12 steps.
GOAL = dict(strict_parity=False, goal_termination=True, max_steps=4,
            close_goal_dist=450.0)
PARITY_CASES = {
    "ring_strict": EnvParams(num_agents=4, max_steps=3),
    "knn_strict": EnvParams(num_agents=6, obs_mode="knn", knn_k=2,
                            max_steps=3),
    "ring_goal": EnvParams(num_agents=4, **GOAL),
    "knn_goal": EnvParams(num_agents=6, obs_mode="knn", knn_k=2, **GOAL),
}


def inject_jax_resets(port_env, jax_env, params):
    """Hand the port adapter's ``FormationVecEnv`` the JAX adapter's reset
    state and, at each auto-reset, the states the JAX package draws from
    each formation's key (``test_torch_algo.injected_env_step``). Called
    after the JAX adapter's ``reset``; the port's ``reset`` then returns
    that state's observation."""
    venv = port_env._venv
    start = to_port(jax_env._state)
    venv._reset_fn = lambda: (start, compute_obs(start.agents, start.goal,
                                                 params))
    step = injected_env_step(jax_env._state, params)
    venv._step_fn = lambda state, actions: step(state,
                                                params.max_speed * actions)


def same_box(ours, ref):
    assert type(ours) is type(ref) and ours.shape == ref.shape
    assert ours.dtype == ref.dtype
    np.testing.assert_array_equal(ours.low, ref.low)
    np.testing.assert_array_equal(ours.high, ref.high)


def same_obs(ours, ref, params, what):
    """Neighbor-index columns bitwise, the rest within the env's
    tolerance."""
    ours, ref = torch.from_numpy(np.asarray(ours)), np.asarray(ref)
    assert ours.shape == ref.shape and ours.dtype == torch.float32, what
    if params.obs_mode == "knn":
        k = params.knn_k
        same(ours[..., -k:], ref[..., -k:], f"{what} neighbor indices")
        close(ours[..., :-k], ref[..., :-k], what)
    else:
        close(ours, ref, what)


@pytest.mark.parametrize("vector", [False, True], ids=["gym", "vector"])
@pytest.mark.parametrize("case", sorted(PARITY_CASES))
def test_adapters_match_jax(case, vector):
    """``FormationGymEnv`` (M=1) and ``FormationVectorEnv`` (M=3) against
    the JAX package's at one params: the spaces, then 12 steps of the same
    actions across episode ends: observation, reward, ``terminated``,
    ``truncated``, ``info["steps"]`` and every metric."""
    params = PARITY_CASES[case]
    if vector:
        ours = vector_env(params, 3)
        ref = JaxVectorEnv(jax_params(params), num_envs=3)
        for space in ("single_observation_space", "single_action_space",
                      "observation_space", "action_space"):
            same_box(getattr(ours, space), getattr(ref, space))
        assert ours.metadata == ref.metadata
    else:
        ours, ref = gym_env(params), JaxGymEnv(jax_params(params))
        for space in ("observation_space", "action_space"):
            same_box(getattr(ours, space), getattr(ref, space))
    ref_obs, ref_info = ref.reset(seed=5)
    inject_jax_resets(ours, ref, params)
    obs, info = ours.reset(seed=5)
    same_obs(obs, ref_obs, params, "reset obs")
    assert info == ref_info == {}
    rng = np.random.default_rng(0)
    ends = np.zeros(2, np.int64)  # terminations, truncations
    for i in range(12):
        act = rng.uniform(-1, 1, ref.action_space.shape).astype(np.float32)
        ref_out, out = ref.step(act), ours.step(act)
        obs, reward, terminated, truncated, info = out
        same_obs(obs, ref_out[0], params, f"obs {i}")
        np.testing.assert_allclose(reward, ref_out[1], rtol=1e-6,
                                   atol=1e-6, err_msg=f"reward {i}")
        for got, want in ((terminated, ref_out[2]), (truncated, ref_out[3])):
            assert type(got) is type(want) and np.shape(got) == np.shape(
                want)
            np.testing.assert_array_equal(got, want)
        ref_info = ref_out[4]
        assert set(info) == set(ref_info)
        np.testing.assert_array_equal(info["steps"], ref_info["steps"])
        for key in set(ref_info) - {"steps"}:
            # The n-1 spread of near-equal neighbor distances keeps their
            # absolute rounding: 1e-6 of the mean distance it spreads around.
            scale = (np.max(ref_info["ave_dist_to_neighbor"])
                     if key == "std_dist_to_neighbor" else 1.0)
            np.testing.assert_allclose(info[key], ref_info[key], rtol=1e-6,
                                       atol=1e-6 * scale,
                                       err_msg=f"{key} {i}")
        ends += [np.sum(terminated), np.sum(truncated)]
    if params.strict_parity:
        assert ends[0] == 0 and ends[1] == 2 * (3 if vector else 1)
    else:
        assert ends[0] >= 1 and ends[1] >= 1


@pytest.mark.parametrize("obs_mode", ["ring", "knn"])
def test_gymnasium_check_env(obs_mode):
    from gymnasium.utils.env_checker import check_env

    params = EnvParams(num_agents=6, max_steps=8, obs_mode=obs_mode, knn_k=2)
    env = gym_env(params)
    if obs_mode == "knn":
        # Raw neighbor indices widen the envelope to N-1.
        assert env.observation_space.high.max() == 5.0
    check_env(env, skip_render_check=True)


def test_truncates_at_reference_episode_length():
    """strict_parity episodes run max_steps + 2 steps (SURVEY.md Q1) and end
    by truncation, not termination (timeout-only, Q3)."""
    env = gym_env(EnvParams(num_agents=3, max_steps=16))
    env.reset(seed=0)
    act = np.zeros((3, 2), np.float32)
    for i in range(1, 19):
        _, _, terminated, truncated, info = env.step(act)
        assert not terminated and info["steps"] == i
        if truncated:
            break
    assert truncated and i == 18


def test_seeded_determinism_and_reward():
    env, env_b = (gym_env(EnvParams(num_agents=3)) for _ in range(2))
    obs_a, _ = env.reset(seed=7)
    obs_b, _ = env_b.reset(seed=7)
    np.testing.assert_array_equal(obs_a, obs_b)
    act = np.full((3, 2), 0.5, np.float32)
    oa, ra, *_ = env.step(act)
    ob, rb, *_ = env_b.step(act)
    np.testing.assert_array_equal(oa, ob)
    assert ra == rb and np.isfinite(ra)


def test_action_scaling_matches_vec_adapter():
    params = EnvParams(num_agents=3)
    genv = gym_env(params)
    venv = FormationVecEnv(params, 1, seed=3, device="cpu")
    obs_g, _ = genv.reset(seed=3)
    np.testing.assert_array_equal(obs_g.reshape(-1), venv.reset().reshape(-1))
    act = np.random.default_rng(0).uniform(-1, 1, (3, 2)).astype(np.float32)
    obs_g2, rew_g, *_ = genv.step(act)
    obs_v2, rew_v, *_ = venv.step(act)
    np.testing.assert_array_equal(obs_g2.reshape(-1), obs_v2.reshape(-1))
    assert rew_g == pytest.approx(float(rew_v.mean()), rel=1e-6)


def test_goal_termination_vs_timeout_distinction():
    """Off parity with goal_termination: a done at the step limit is
    truncation, although the env ORs both conditions into one done."""
    env = gym_env(EnvParams(num_agents=3, max_steps=8, strict_parity=False,
                            goal_termination=True))
    env.reset(seed=1)
    act = np.zeros((3, 2), np.float32)
    for _ in range(8):
        _, _, terminated, truncated, _ = env.step(act)
        if terminated or truncated:
            break
    assert truncated and not terminated
    # Every agent inside the goal radius: a goal termination before the
    # limit.
    env = gym_env(EnvParams(num_agents=3, max_steps=8, strict_parity=False,
                            goal_termination=True, close_goal_dist=2000.0))
    env.reset(seed=1)
    _, _, terminated, truncated, info = env.step(act)
    assert terminated and not truncated and info["steps"] == 1


def test_render_before_reset_is_a_clear_error():
    env = gym_env(EnvParams(num_agents=3), render_mode="rgb_array")
    with pytest.raises(RuntimeError, match="reset"):
        env.render()
    with pytest.raises(ValueError, match="render_mode"):
        gym_env(EnvParams(num_agents=3), render_mode="ascii")


def test_render_rgb_array():
    env = gym_env(EnvParams(num_agents=3), render_mode="rgb_array")
    env.reset(seed=0)
    env.step(np.zeros((3, 2), np.float32))
    frame = env.render()
    assert frame.ndim == 3 and frame.shape[-1] == 3 and frame.size > 0
    env.close()


def test_vector_api_contract():
    env = vector_env(EnvParams(num_agents=4, max_steps=8), 3)
    assert env.metadata["autoreset_mode"] == gym.vector.AutoresetMode.SAME_STEP
    assert env.single_observation_space.shape == (4, env.params.obs_dim)
    assert env.single_action_space.shape == (4, 2)
    assert env.observation_space.shape == (3, 4, env.params.obs_dim)
    obs, info = env.reset(seed=0)
    assert obs.shape == (3, 4, env.params.obs_dim)
    assert env.observation_space.contains(obs)
    act = np.asarray(env.action_space.sample(), np.float32)
    obs2, rewards, terminated, truncated, infos = env.step(act)
    assert obs2.shape == obs.shape
    assert rewards.shape == terminated.shape == truncated.shape == (3,)
    assert terminated.dtype == truncated.dtype == bool
    assert infos["steps"].tolist() == [1, 1, 1]
    assert infos["avg_dist_to_goal"].shape == (3,)
    assert "final_obs" not in infos
    env.close()


def test_vector_matches_single_env_semantics():
    params = EnvParams(num_agents=3)
    vec, single = vector_env(params, 1), gym_env(params)
    ov, _ = vec.reset(seed=11)
    os_, _ = single.reset(seed=11)
    np.testing.assert_array_equal(ov[0], os_)
    act = np.full((3, 2), 0.25, np.float32)
    for _ in range(3):
        ov, rv, tv, cv, _ = vec.step(act[None])
        os_, rs, ts, cs, _ = single.step(act)
    np.testing.assert_array_equal(ov[0], os_)
    np.testing.assert_allclose(rv[0], rs, rtol=1e-6)
    assert bool(tv[0]) == ts and bool(cv[0]) == cs


def test_vector_truncates_and_autoresets_same_step():
    env = vector_env(EnvParams(num_agents=3, max_steps=8), 2)
    env.reset(seed=0)
    act = np.zeros((2, 3, 2), np.float32)
    for i in range(1, 11):
        obs, _, terminated, truncated, infos = env.step(act)
        assert not terminated.any()
        if truncated.all():
            break
    assert i == 10  # max_steps + 2 (Q1)
    assert infos["steps"].tolist() == [10, 10]
    obs2, _, _, truncated2, infos2 = env.step(act)
    assert not truncated2.any()
    assert infos2["steps"].tolist() == [1, 1]
    assert np.isfinite(obs2).all()


def test_standard_vector_wrapper_composes():
    env = vector_env(EnvParams(num_agents=3, max_steps=8), 2)
    wrapped = gym.wrappers.vector.RecordEpisodeStatistics(env)
    wrapped.reset(seed=0)
    act = np.zeros((2, 3, 2), np.float32)
    stats = None
    for _ in range(10):
        _, _, _, _, infos = wrapped.step(act)
        if "episode" in infos:
            stats = infos["episode"]
    assert stats is not None, "wrapper never reported episode stats"
    assert np.asarray(stats["l"]).tolist() == [10, 10]
    assert np.isfinite(np.asarray(stats["r"])).all()
