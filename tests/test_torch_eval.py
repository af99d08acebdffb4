"""The port's evaluation slice against the JAX package, from the same
initial states.

- Teacher-forced: every step the port takes JAX's state, observation and
  actions, so each step is compared on its own (tolerances as in
  test_torch_env.py; the policy's actions within ``atol=1e-4``, which is the
  models' ``1e-5`` times ``max_speed``).
- Free run: both packages roll whole episodes on their own, so differences
  in the last bit (matmul order, norms) can compound through the closed
  loop. Measured on the CPU: at most 2.2e-7 relative over the committed
  checkpoint's full 1002-step episode. The episode metrics are compared
  with ``rtol=1e-5``; the episode count is exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marl_distributedformation_tpu.compat.policy import load_checkpoint_raw
from marl_distributedformation_tpu.env.formation import (
    compute_obs as jax_compute_obs,
    reset_batch as jax_reset_batch,
    step_batch as jax_step_batch,
)
from marl_distributedformation_tpu.eval import (
    baseline_act_fn as jax_baseline_act_fn,
    policy_act_fn as jax_policy_act_fn,
    run_episode_metrics as jax_run_episode_metrics,
)
from marl_distributedformation_tpu.models import GNNActorCritic as JaxGNN
from marl_distributedformation_tpu.models import MLPActorCritic as JaxMLP
from marl_distributedformation_tpu_torch import evaluate as evaluate_cli
from marl_distributedformation_tpu_torch.compat.convert import params_from_jax
from marl_distributedformation_tpu_torch.compat.policy import build_model
from marl_distributedformation_tpu_torch.env import (
    EnvParams,
    reset_batch,
    step_batch,
)
from marl_distributedformation_tpu_torch.eval import (
    baseline_act_fn,
    evaluate,
    policy_act_fn,
    run_episode_metrics,
    zero_act_fn,
)
from marl_distributedformation_tpu_torch.models import GNNActorCritic
from test_torch_env import (
    close,
    jax_params,
    jax_reset_uniforms,
    same,
    to_port,
)
from test_torch_models import CKPT, np_tree

FREE_RUN_RTOL = 1e-5
GNN_PARAMS = EnvParams(num_agents=20, obs_mode="knn", knn_k=4, max_steps=10)


def _gnn_pair(params: EnvParams):
    jmodel = JaxGNN(k=params.knn_k)
    obs = jnp.zeros((1, params.num_agents, params.obs_dim), jnp.float32)
    jvars = jmodel.init(jax.random.PRNGKey(5), obs)
    model = GNNActorCritic(k=params.knn_k)
    model.load_state_dict(params_from_jax(np_tree(jvars), "GNNActorCritic"))
    return jmodel, jvars, model.eval()


def _mlp_pair():
    raw = load_checkpoint_raw(CKPT)
    jvars = {"params": raw["params"]["params"]}
    return JaxMLP(), jvars, build_model("MLPActorCritic", jvars["params"])


@pytest.mark.parametrize("jax_impl", ["pallas_interpret", "xla"])
def test_gnn_knn_teacher_forced(jax_impl):
    params = GNN_PARAMS
    jp = jax_params(params, jax_impl)
    jmodel, jvars, model = _gnn_pair(params)
    jact = jax.jit(jax_policy_act_fn(jmodel, jvars, jp))
    act = policy_act_fn(model, params)
    jstep = jax.jit(jax_step_batch, static_argnums=2)
    m = 3
    state = jax_reset_batch(jax.random.PRNGKey(0), jp, m)
    obs = jax_compute_obs(state.agents, state.goal, jp)
    dones = 0
    for _ in range(params.max_steps + 2):  # the Q1 reset fires on the last
        vel = jact(state.agents, state.goal, state.obstacles, obs, None)
        p = to_port(state)
        with torch.no_grad():
            got = act(p.agents, p.goal, p.obstacles,
                      torch.from_numpy(np.array(obs)), None)
        np.testing.assert_allclose(
            got.numpy(), np.asarray(vel), atol=1e-4, rtol=0
        )
        pstate, ptr = step_batch(
            p, torch.from_numpy(np.array(vel)), params,
            fresh=_fresh(state, params),
        )
        state, tr = jstep(state, vel, jp)
        same(ptr.done, tr.done, "done")
        same(pstate.agents, state.agents, "agents")
        same(pstate.steps, state.steps, "steps")
        close(ptr.reward, tr.reward, "reward")
        for key in tr.metrics:
            close(ptr.metrics[key], tr.metrics[key], key)
        k = params.knn_k
        same(ptr.obs[..., -k:], tr.obs[..., -k:], "neighbor indices")
        close(ptr.obs[..., :-k], tr.obs[..., :-k], "obs")
        dones += int(np.asarray(tr.done).sum())
        obs = tr.obs
    assert dones == m


def _fresh(state, params):
    return reset_batch(
        params, state.agents.shape[0],
        uniforms=jax_reset_uniforms(state.key, params),
    )


def _free_run(params, jact, act, m, seed=1234):
    jp = jax_params(params)
    ref = jax.jit(
        jax_run_episode_metrics,
        static_argnames=("act_fn", "params", "num_formations"),
    )(jax.random.PRNGKey(seed), act_fn=jact, params=jp, num_formations=m)
    init = to_port(jax_reset_batch(jax.random.PRNGKey(seed), jp, m))
    got = run_episode_metrics(act, params, m, initial_state=init)
    assert set(got) == set(ref)
    assert float(got["episodes"]) == float(ref["episodes"]) == m
    for key in ref:
        np.testing.assert_allclose(
            float(got[key]), float(ref[key]), rtol=FREE_RUN_RTOL, err_msg=key
        )
    return got


def test_gnn_knn_free_run():
    params = GNN_PARAMS.replace(max_steps=20)
    jmodel, jvars, model = _gnn_pair(params)
    _free_run(
        params,
        jax_policy_act_fn(jmodel, jvars, jax_params(params)),
        policy_act_fn(model, params),
        m=3,
    )


def test_committed_checkpoint_full_episode_and_ranking():
    params = EnvParams()
    jmodel, jvars, model = _mlp_pair()
    jp = jax_params(params)
    m = 16
    learned = _free_run(
        params, jax_policy_act_fn(jmodel, jvars, jp),
        policy_act_fn(model, params), m,
    )
    baseline = _free_run(
        params, jax_baseline_act_fn(jp), baseline_act_fn(params), m
    )
    init = to_port(jax_reset_batch(jax.random.PRNGKey(1234), jp, m))
    zero = run_episode_metrics(zero_act_fn(), params, m, initial_state=init)
    key = "episode_return_per_agent"
    assert float(learned[key]) > float(baseline[key]) > float(zero[key])


def test_evaluate_entry_points_on_cpu(tmp_path, capsys):
    res = evaluate_cli.main([
        f"checkpoint={CKPT}", "eval_formations=4", "max_steps=20",
        "device=cpu",
    ])
    assert res["beats_baseline"] and res["resolved_device"] == "cpu"
    assert res["policy_episode_return_per_agent"] == evaluate(
        policy_act_fn(_mlp_pair()[2], EnvParams(max_steps=20)),
        EnvParams(max_steps=20), 4, 1234, "cpu",
    )["episode_return_per_agent"]
    assert capsys.readouterr().out.strip().splitlines()[-1].startswith("{")

    # A GNN checkpoint in the JAX package's format, through the knn path.
    from flax import serialization

    params = EnvParams(num_agents=12, obs_mode="knn", knn_k=3, max_steps=8)
    jvars = _gnn_pair(params)[1]
    path = tmp_path / "rl_model_64_steps.msgpack"
    path.write_bytes(serialization.msgpack_serialize(
        {"policy": "GNNActorCritic", "params": np_tree(jvars)}
    ))
    res = evaluate_cli.main([
        f"checkpoint={path}", "obs_mode=knn", "policy=gnn", "knn_k=3",
        "num_agents_per_formation=12", "eval_formations=2", "max_steps=8",
        "device=cpu",
    ])
    assert all(np.isfinite(v) for v in res.values() if isinstance(v, float))


def test_evaluate_cli_rejects_bad_keys():
    """A mistyped key exits naming the right one; ``env=pursuit_evasion``
    (ported) evaluates, and its knobs validate only under it."""
    with pytest.raises(SystemExit, match="did you mean 'eval_formations'"):
        evaluate_cli.main(["eval_formation=4", "device=cpu"])
    with pytest.raises(SystemExit, match="capture_radius"):
        evaluate_cli.main([f"checkpoint={CKPT}", "capture_radius=20",
                           "device=cpu"])
    res = evaluate_cli.main([
        f"checkpoint={CKPT}", "env=pursuit_evasion", "capture_radius=20",
        "eval_formations=2", "max_steps=20", "device=cpu",
    ])
    assert all(np.isfinite(v) for v in res.values() if isinstance(v, float))


@pytest.mark.parametrize("argv", [
    ["scenario_severity=0.5"],
    ["scenarios=[wind]"],
    ["scenario=wnd"],
    ["scenario=gale", "scenario_severity=0.5"],
])
def test_evaluate_cli_scenario_refusals_as_root_evaluate(argv, monkeypatch):
    """The root ``evaluate.py``'s refusals, with its messages: the plural
    training key, a severity with no scenario, an unknown name. Both
    registries hold their registered defaults, as a fresh process's do:
    the ``adv:`` specs other tests in the process derived stay out of the
    listed names."""
    import evaluate as root_evaluate
    from marl_distributedformation_tpu.scenarios import registry as jreg
    from marl_distributedformation_tpu_torch.scenarios import registry as preg

    for mod in (preg, jreg):
        monkeypatch.setattr(mod, "_REGISTRY",
                            {spec.name: spec for spec in mod._DEFAULT_SPECS})
    with pytest.raises(SystemExit) as ours:
        evaluate_cli.main([*argv, "device=cpu"])
    with pytest.raises(SystemExit) as ref:
        root_evaluate.main(list(argv))
    assert str(ours.value) == str(ref.value)


def test_evaluate_cli_under_a_scenario(capsys):
    """``scenario=wind`` evaluates all three rows under wind: the scenario
    line, the root ``evaluate.py``'s JSON keys, and the policy row equals
    ``evaluate`` with the scenario's params."""
    import evaluate as root_evaluate

    from marl_distributedformation_tpu_torch.scenarios import (
        scenario_params_for,
    )

    argv = [f"checkpoint={CKPT}", "eval_formations=4", "max_steps=20",
            "scenario=wind", "scenario_severity=0.7"]
    res = evaluate_cli.main([*argv, "device=cpu"])
    out = capsys.readouterr().out
    assert "[eval] scenario=wind severity=0.7" in out.splitlines()
    assert res["scenario"] == "wind" and res["scenario_severity"] == 0.7
    ref = root_evaluate.main(argv)
    assert set(res) - {"resolved_device"} == set(ref) - {
        "resolved_platform", "resolved_device"}
    params = EnvParams(max_steps=20)
    direct = evaluate(policy_act_fn(_mlp_pair()[2], params), params, 4,
                      1234, "cpu",
                      scenario_params=scenario_params_for("wind", 0.7))
    assert res["policy_episode_return_per_agent"] == direct[
        "episode_return_per_agent"]
    clean = evaluate_cli.main([*argv[:3], "device=cpu"])
    assert clean["zero_episode_return_per_agent"] != res[
        "zero_episode_return_per_agent"]
    assert "scenario" not in clean
