"""The plain reference against the program on the CPU at tiny sizes, part
by part: the k-NN search, the env step and observation, the policies'
forward, and a whole evaluation episode."""

import pytest
import torch

from benchmark import inputs
from benchmark.reference import env as ref_env
from benchmark.reference import episode as ref_episode
from benchmark.reference.knn import knn
from benchmark.reference.policy import forward, to_tf32
from benchmark.tests import tiny
from benchmark.traffic.eval import keeping


def program_state(s):
    from marl_distributedformation_tpu_torch.env.types import FormationState

    return FormationState(agents=s.agents.clone(), goal=s.goal.clone(),
                          obstacles=s.obstacles.clone(),
                          steps=s.steps.clone())


def params_of(config):
    from marl_distributedformation_tpu_torch.env.types import EnvParams

    return EnvParams(**config["env"])


@pytest.mark.parametrize("m, n, k", [(3, 6, 2), (2, 40, 4), (1, 5, 4)])
def test_knn_matches_the_program_plain_search(m, n, k):
    from marl_distributedformation_tpu_torch.ops.knn import knn_batch_torch

    pts = torch.rand(m, n, 2, generator=torch.Generator().manual_seed(n)) * 50
    pts[0, 1] = pts[0, 2]  # a tie, broken toward the lower index
    idx, off, dist = knn(pts, k)
    p_idx, p_off, p_dist = knn_batch_torch(pts, k)
    assert torch.equal(idx, p_idx.long())
    assert torch.equal(off, p_off)
    assert torch.equal(dist, p_dist)


@pytest.mark.parametrize("name", ["tinygnn", "tinyring"])
def test_env_step_matches_the_program(name):
    from marl_distributedformation_tpu_torch.env.formation import (
        compute_obs,
        step_batch,
    )

    config = tiny.tiny_configs()[name]
    env = config["env"]
    params = params_of(config)
    state = inputs.make_states(env, 5, seed=9, tag="t", device="cpu")
    vel = torch.randn(5, env["num_agents"], 2,
                      generator=torch.Generator().manual_seed(1)) * 30
    got_obs = ref_env.observe(state.agents, state.goal, env)
    want_obs = compute_obs(state.agents, state.goal, params)
    torch.testing.assert_close(got_obs, want_obs, rtol=1e-6, atol=1e-7)
    nxt, reward, done, metrics = ref_env.step(state, vel, env)
    p_next, tr = step_batch(program_state(state), vel, params,
                            torch.Generator().manual_seed(2))
    torch.testing.assert_close(nxt.agents, p_next.agents)
    torch.testing.assert_close(reward, tr.reward, rtol=1e-6, atol=1e-5)
    assert torch.equal(done, tr.done)
    for key, value in metrics.items():
        torch.testing.assert_close(value, tr.metrics[key])


@pytest.mark.parametrize("name", ["tinygnn", "tinyring"])
def test_policy_forward_matches_the_program(name):
    from marl_distributedformation_tpu_torch.train import cli
    from marl_distributedformation_tpu_torch.utils.config import load_config

    config = tiny.tiny_configs()[name]
    params = params_of(config)
    weights = inputs.make_weights(config, seed=4, device="cpu")
    model = cli.build_model(load_config(config["overrides"]), params,
                            config["model"]["kind"])
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(weights[n])
    state = inputs.make_states(config["env"], 3, seed=4, tag="f",
                               device="cpu")
    obs = ref_env.observe(state.agents, state.goal, config["env"])
    want = model(obs if model.per_formation else obs.reshape(
        -1, obs.shape[-1]))
    got = forward(weights, config["model"], obs)
    for g, w in zip(got, want):
        torch.testing.assert_close(g.reshape(w.shape), w, rtol=1e-5,
                                   atol=1e-6)


def test_weights_are_orthogonal_with_the_program_gains():
    config = tiny.tiny_configs()["tinygnn"]
    w = inputs.make_weights(config, seed=1, device="cpu")
    q = w["msg_0.weight"] / (2 ** 0.5)  # (64, 131): orthonormal rows
    torch.testing.assert_close(q @ q.T, torch.eye(64), atol=1e-5, rtol=0)
    assert torch.equal(w["embed.bias"], torch.zeros(64))
    assert w["actor.pi_head.weight"].norm() == pytest.approx(
        0.01 * 2 ** 0.5, rel=1e-4)
    again = inputs.make_weights(config, seed=1, device="cpu")
    assert all(torch.equal(w[k], again[k]) for k in w)
    other = inputs.make_weights(config, seed=2, device="cpu")
    assert not torch.equal(w["embed.weight"], other["embed.weight"])


def test_episode_matches_the_program():
    from marl_distributedformation_tpu_torch import eval as program_eval
    from marl_distributedformation_tpu_torch.train import cli
    from marl_distributedformation_tpu_torch.utils.config import load_config

    config = tiny.tiny_configs()["tinyshort"]
    params = params_of(config)
    weights = inputs.make_weights(config, seed=5, device="cpu")
    model = cli.build_model(load_config(config["overrides"]), params, "gnn")
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(weights[n])
    state = inputs.make_states(config["env"], 4, seed=5, tag="e",
                               device="cpu")
    act = program_eval.policy_act_fn(model, params, deterministic=True)
    at = (5, program_eval.episode_length(params) - 1)
    kept = {}
    want = program_eval.evaluate(keeping(act, at, kept), params, 4, seed=5,
                                 initial_state=program_state(state))
    got, got_kept = ref_episode.run(config, weights, state, at=at)
    assert set(got) == set(want)
    for key in got:
        assert got[key] == pytest.approx(want[key], rel=1e-5), key
    assert got["episodes"] == 4
    assert set(got_kept) == set(kept) == set(at)
    for t in at:
        torch.testing.assert_close(got_kept[t], kept[t], rtol=1e-5,
                                   atol=1e-4)


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 3 * 2**-11, -3.0 + 2**-12])
    r = to_tf32(x)
    # Ten mantissa bits: 1 + 2^-11 is a tie, to even (1.0); 1 + 3*2^-11
    # rounds up to 1 + 2^-9; -3 + 2^-12 rounds to -3.
    assert r.tolist() == [1.0, 1.0, 1.0 + 2**-9, -3.0]
