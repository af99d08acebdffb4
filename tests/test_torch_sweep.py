"""The port's population trainer (``train/sweep.py``) on the CPU: members
against the port's single runs, one population iteration against the JAX
package's ``jax.vmap`` of its iteration with injected draws, per-member
clip and health, dispatch modes, checkpoints both ways, the records, the
summary and the sweep-mode evaluation.

Tolerances, and why:

- A member of K > 1 against the port's ``Trainer(seed + i)`` after two
  iterations: the generator state, Adam ``count``, the optimizer step and
  the env steps exactly; parameters within
  ``tests/adam_budget.py::adam_parity_atol`` and ``mu``/``nu`` within the
  same budget relative to each leaf's largest value; metrics within
  ``trajectory_rtol``; positions within ``atol=1e-3``. The population runs
  each layer once for all members (a batched matmul), which rounds
  differently from a single run's in the last bit, and Adam amplifies that.
- A population of one against ``Trainer``: bitwise, everything.
- Against JAX, one iteration with JAX's noise, resets and permutations
  injected: the tolerances of ``tests/test_torch_trainer.py``'s injected
  iteration (params within ``adam_parity_atol``, ``mu``/``nu`` within it
  relative to each leaf's largest value, ``count`` exact, rollout metrics
  ``rtol=1e-4``, the update's ``trajectory_rtol``).
- Clip isolation, one minibatch step: each member's parameters and
  moments against a single-run update on its own rows within ``rtol=1e-5``
  plus ``1e-5`` of each leaf's largest value (batched matmul rounding).
- Health isolation: the clean member of a poisoned population equals the
  same member of a clean population bitwise (members never mix); the flags
  equal JAX's exactly.
- Dispatch, resume and async writes: bitwise (the same operations in the
  same order); records equal the JAX trainer's in keys and steps.
"""

import collections
import dataclasses
import json
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization
from flax.training.train_state import TrainState

import evaluate as jax_evaluate_cli
from adam_budget import adam_parity_atol, trajectory_rtol, updates_per_run
from marl_distributedformation_tpu.algo import PPOConfig as JaxPPOConfig
from marl_distributedformation_tpu.compat.policy import load_checkpoint_raw
from marl_distributedformation_tpu.env.formation import (
    compute_obs as jax_compute_obs,
    reset_batch as jax_reset_batch,
)
from marl_distributedformation_tpu.models import MLPActorCritic as JaxMLP
from marl_distributedformation_tpu.train import SweepTrainer as JaxSweep
from marl_distributedformation_tpu.train import TrainConfig as JaxTrainConfig
from marl_distributedformation_tpu.train.recovery import (
    HealthConfig as JaxHealthConfig,
    make_health_iteration as jax_make_health_iteration,
)
from marl_distributedformation_tpu.train.sweep import (
    population_aggregate as jax_population_aggregate,
    write_sweep_summary as jax_write_sweep_summary,
)
from marl_distributedformation_tpu.train.trainer import (
    make_ppo_iteration as jax_make_ppo_iteration,
)
from marl_distributedformation_tpu_torch import evaluate as evaluate_cli
from marl_distributedformation_tpu_torch.algo import PPOConfig, adam_init
from marl_distributedformation_tpu_torch.algo.optim import (
    population_adam_init,
)
from marl_distributedformation_tpu_torch.algo.ppo import (
    MinibatchData,
    PopulationUpdate,
    PPOUpdate,
)
from marl_distributedformation_tpu_torch.compat.convert import (
    opt_state_to_jax,
    params_from_jax,
    params_to_jax,
)
from marl_distributedformation_tpu_torch.env import EnvParams
from marl_distributedformation_tpu_torch.models import (
    GNNActorCritic,
    MLPActorCritic,
)
from marl_distributedformation_tpu_torch.models.population import (
    PopulationModel,
)
from marl_distributedformation_tpu_torch.train import TrainConfig, Trainer
from marl_distributedformation_tpu_torch.train.iteration import (
    PopulationIteration,
)
from marl_distributedformation_tpu_torch.train.recovery import (
    HealthConfig,
    HealthGuard,
)
from marl_distributedformation_tpu_torch.train.sweep import (
    SweepTrainer,
    population_aggregate,
    write_sweep_summary,
)
from test_torch_algo import (
    _jax_permutations,
    assert_tree_close,
    injected_env_step,
    jax_rollout_noise,
    t,
)
from test_torch_env import jax_params, to_port
from test_torch_models import np_tree

LR = 1e-3
PPO = PPOConfig(n_steps=4, batch_size=24, n_epochs=2)
KINDS = {
    "mlp": EnvParams(num_agents=3, max_steps=4),
    # The GNN on the plain k-NN (the CPU has no kernel).
    "gnn": EnvParams(num_agents=3, obs_mode="knn", knn_k=2, max_steps=4),
}
M = 4
PER_ITER = PPO.n_steps * M * 3  # one member's agent-transitions


def _model(kind, seed):
    params = KINDS[kind]
    gen = torch.Generator().manual_seed(seed)
    if kind == "mlp":
        return MLPActorCritic(params.obs_dim, generator=gen)
    return GNNActorCritic(k=params.knn_k, generator=gen)


def _ppo(kind):
    # The GNN minibatches whole formations: 24 // N = 8 of 16.
    return PPO


def _config(tmp_path, name="pop", **kw):
    base = dict(num_formations=M, seed=0, checkpoint=False, name=name,
                log_dir=str(tmp_path / name))
    base.update(kw)
    return TrainConfig(**base)


def _sweep(tmp_path, kind="mlp", num_seeds=2, name="pop", lrs=None, **kw):
    return SweepTrainer(
        KINDS[kind], _ppo(kind), _config(tmp_path, name, **kw), num_seeds,
        models=[_model(kind, kw.get("seed", 0) + i) for i in range(num_seeds)],
        learning_rates=lrs, device="cpu",
    )


def _single(tmp_path, kind, seed, **kw):
    return Trainer(KINDS[kind], _ppo(kind),
                   _config(tmp_path, f"single{seed}", seed=seed, **kw),
                   model=_model(kind, seed), device="cpu")


def _member_learner(sweep, i):
    """Member ``i``'s parameters and Adam state in the JAX layout."""
    params = {k: p[i].detach() for k, p in sweep.model.params.items()}
    opt = {"count": sweep.opt_state.count[i],
           "mu": {k: v[i] for k, v in sweep.opt_state.mu.items()},
           "nu": {k: v[i] for k, v in sweep.opt_state.nu.items()}}
    return (params_to_jax(params, sweep.policy),
            opt_state_to_jax(opt, sweep.policy)["1"]["0"])


def _single_learner(trainer):
    params = dict(trainer.model.named_parameters())
    return (params_to_jax(params, trainer.policy),
            opt_state_to_jax(vars(trainer.opt_state),
                             trainer.policy)["1"]["0"])


# ---------------------------------------------------------------------------
# Member i is the single run at seed + i
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_member_equals_the_single_run(tmp_path, kind):
    sweep = _sweep(tmp_path, kind, num_seeds=2)
    singles = [_single(tmp_path, kind, i) for i in range(2)]
    for _ in range(2):
        got = sweep.run_iteration()
        want = [s.run_iteration() for s in singles]
    rows = PER_ITER if kind == "mlp" else PPO.n_steps * M
    batch = PPO.batch_size if kind == "mlp" else PPO.batch_size // 3
    updates = updates_per_run(dataclasses.replace(PPO, batch_size=batch),
                              rows, 2)
    atol = adam_parity_atol(LR, updates)
    for i, single in enumerate(singles):
        assert torch.equal(sweep.generators[i].get_state(),
                           single.generator.get_state())
        (p, opt), (sp, sopt) = _member_learner(sweep, i), \
            _single_learner(single)
        for a, b in zip(jax.tree_util.tree_leaves(p),
                        jax.tree_util.tree_leaves(sp)):
            np.testing.assert_allclose(a, b, rtol=0, atol=atol)
        assert int(opt["count"]) == int(sopt["count"]) == updates
        for moment in ("mu", "nu"):
            assert_tree_close(opt[moment], sopt[moment], rtol=0, floor=atol,
                              what=moment)
        assert int(sweep._iteration.step[i]) == single.step == updates
        own = slice(i * M, (i + 1) * M)
        env, senv = sweep.env_state, single.env_state
        np.testing.assert_array_equal(env.steps[own].numpy(),
                                      senv.steps.numpy())
        np.testing.assert_allclose(env.agents[own].numpy(),
                                   senv.agents.numpy(), rtol=0, atol=1e-3)
        assert set(got) == set(want[i])
        for k in want[i]:
            np.testing.assert_allclose(
                float(got[k][i]), float(want[i][k]),
                rtol=trajectory_rtol(LR, updates), atol=1e-6, err_msg=k)
    # Distinct seeds are distinct runs.
    assert float(got["reward"][0]) != float(got["reward"][1])


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_population_of_one_is_the_single_run_bitwise(tmp_path, kind):
    sweep = _sweep(tmp_path, kind, num_seeds=1, health=True)
    single = _single(tmp_path, kind, 0, health=True)
    for _ in range(2):
        got = sweep.run_iteration()
        want = single.run_iteration()
    for k, p in single.model.named_parameters():
        assert torch.equal(sweep.model.params[k][0], p), k
        assert torch.equal(sweep.opt_state.mu[k][0], single.opt_state.mu[k])
        assert torch.equal(sweep.opt_state.nu[k][0], single.opt_state.nu[k])
    assert torch.equal(sweep.opt_state.count[0], single.opt_state.count)
    assert torch.equal(sweep.generators[0].get_state(),
                       single.generator.get_state())
    for f in ("agents", "goal", "obstacles", "steps"):
        assert torch.equal(getattr(sweep.env_state, f),
                           getattr(single.env_state, f)), f
    assert torch.equal(sweep.obs, single.obs)
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k][0], want[k]), k


# ---------------------------------------------------------------------------
# One population iteration against JAX's vmap of its iteration
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("lr_sweep", [False, True])
def test_population_iteration_matches_jax_vmap(lr_sweep):
    """K=2 ring/MLP members, their JAX keys' noise, resets and
    permutations injected; with ``learning_rates``, optax's
    ``inject_hyperparams`` rates against the port's ``(K,)`` device lr."""
    params = EnvParams(num_agents=5, max_steps=4)
    jp = jax_params(params)
    k, m, n = 2, 4, params.num_agents
    lrs = [3e-4, 3e-3] if lr_sweep else [LR, LR]
    jcfg = JaxPPOConfig(n_epochs=2, batch_size=64)
    cfg = PPOConfig(n_epochs=2, batch_size=64)
    jmodel = JaxMLP()
    tx = jcfg.make_optimizer(inject_lr=lr_sweep)
    states, models = [], []
    for i in range(k):
        jvars = jmodel.init(jax.random.PRNGKey(40 + i),
                            jnp.zeros((1, params.obs_dim)))
        ts = TrainState.create(apply_fn=jmodel.apply, params=jvars, tx=tx)
        if lr_sweep:
            clip_s, inject_s = ts.opt_state
            inject_s = inject_s._replace(hyperparams={
                **inject_s.hyperparams, "learning_rate": jnp.float32(lrs[i])
            })
            ts = ts.replace(opt_state=(clip_s, inject_s))
        states.append(ts)
        model = MLPActorCritic(params.obs_dim)
        model.load_state_dict(params_from_jax(np_tree(jvars),
                                              "MLPActorCritic"))
        models.append(model)
    stack = lambda *x: jnp.stack(x)  # noqa: E731
    ts = jax.tree_util.tree_map(stack, *states)
    jstate = jax.tree_util.tree_map(stack, *[
        jax_reset_batch(jax.random.PRNGKey(20 + i), jp, m) for i in range(k)
    ])
    jobs = jax.vmap(lambda s: jax_compute_obs(s.agents, s.goal, jp))(jstate)
    keys = jnp.stack([jax.random.PRNGKey(30 + i) for i in range(k)])
    iteration = jax.jit(jax.vmap(jax_make_ppo_iteration(jp, jcfg, False)))
    ts, jend, _, _, jmetrics = iteration(ts, jstate, jobs, keys)

    # The port, members folded into one batch of K*M formations.
    flat = jax.tree_util.tree_map(
        lambda x: x.reshape(k * m, *x.shape[2:]), jstate)
    rows = cfg.n_steps * m * n
    used = rows // 64 * 64
    noise, perms = [], []
    for i in range(k):
        _, k_roll, k_update = jax.random.split(keys[i], 3)
        noise.append(jax_rollout_noise(k_roll, cfg.n_steps, (m, n, 2)))
        perms.append(_jax_permutations(k_update, 2, rows, used))
    pop = PopulationModel(models)
    opt = population_adam_init(pop.params)
    it = PopulationIteration(
        params, cfg, pop, opt, [torch.Generator() for _ in range(k)],
        to_port(flat), t(jobs.reshape(k * m, n, -1)), lr=lrs,
        env_step_fn=injected_env_step(flat, params),
    )
    it.run(torch.cat(noise, dim=1), torch.stack(perms))
    metrics = it.metrics(it.ring.take(1)[0])
    updates = 2 * (rows // 64)
    assert it.step.tolist() == [updates] * k == np.asarray(ts.step).tolist()
    jopt = serialization.to_state_dict(ts.opt_state)["1"]
    jadam = jopt["inner_state"]["0"] if lr_sweep else jopt["0"]
    if lr_sweep:
        np.testing.assert_array_equal(
            np.asarray(jopt["hyperparams"]["learning_rate"]),
            it.lr.numpy())
    for i in range(k):
        atol = adam_parity_atol(lrs[i], updates)
        got = params_to_jax({n_: p[i].detach()
                             for n_, p in pop.params.items()},
                            "MLPActorCritic")
        ref = np_tree(jax.tree_util.tree_map(lambda x: x[i], ts.params))
        for a, b in zip(jax.tree_util.tree_leaves(got),
                        jax.tree_util.tree_leaves(ref)):
            np.testing.assert_allclose(a, b, rtol=0, atol=atol)
        member = {"count": opt.count[i],
                  "mu": {n_: v[i] for n_, v in opt.mu.items()},
                  "nu": {n_: v[i] for n_, v in opt.nu.items()}}
        popt = opt_state_to_jax(member, "MLPActorCritic")["1"]["0"]
        assert int(popt["count"]) == int(np.asarray(jadam["count"])[i])
        for moment in ("mu", "nu"):
            assert_tree_close(popt[moment], np_tree(jax.tree_util.tree_map(
                lambda x: x[i], jadam[moment])), rtol=0, floor=atol,
                what=moment)
        np.testing.assert_array_equal(
            it.env.steps[i * m:(i + 1) * m].numpy(),
            np.asarray(jend.steps[i]))
        assert set(metrics) == set(jmetrics)
        for name, ref in jmetrics.items():
            rtol = (1e-4 if name in it._rollout_names
                    else trajectory_rtol(lrs[i], updates))
            np.testing.assert_allclose(
                float(metrics[name][i]), float(ref[i]), rtol=rtol,
                atol=1e-6, err_msg=f"member {i} {name}")


# ---------------------------------------------------------------------------
# Per-member clip and health
# ---------------------------------------------------------------------------


def test_a_huge_gradient_clips_its_member_alone():
    """One minibatch step of a K=2 MLP population whose member 0 has
    returns of 1e6 (its raw norm far above ``max_grad_norm``) and member 1
    ordinary rows (below it): each member equals a single-run update on
    its own rows, member 0 clipped and member 1 not."""
    rng = np.random.default_rng(5)
    b, obs_dim = 32, KINDS["mlp"].obs_dim
    data = {
        "obs": rng.normal(size=(2, b, obs_dim)),
        "actions": rng.normal(size=(2, b, 2)),
        "old_log_probs": rng.normal(size=(2, b)) - 2.5,
        "advantages": rng.normal(size=(2, b)),
        "returns": rng.normal(size=(2, b)) * 0.1,
    }
    data["returns"][0] *= 1e7
    data = {k: torch.from_numpy(v.astype(np.float32))
            for k, v in data.items()}
    cfg = PPOConfig(n_epochs=1, batch_size=b, max_grad_norm=50.0)
    perms = torch.arange(b)[None, None].expand(2, 1, b)
    models = [_model("mlp", i) for i in range(2)]
    pop = PopulationModel(models)
    opt = population_adam_init(pop.params)
    update = PopulationUpdate(pop, opt, cfg, b,
                              torch.zeros(2, dtype=torch.int64),
                              torch.full((2,), LR))
    update.load(MinibatchData(**data), [None, None], perms)
    update.step()
    norms = update.buf[0, :, update.names.index("grad_norm")]
    assert float(norms[0]) > cfg.max_grad_norm > float(norms[1])
    for i, model in enumerate(models):
        state = adam_init(dict(model.named_parameters()))
        single = PPOUpdate(model, state, cfg, b,
                           torch.zeros((), dtype=torch.int64),
                           torch.tensor(LR))
        single.load(MinibatchData(**{k: v[i] for k, v in data.items()}),
                    None, perms[i])
        single.step()
        for k, p in model.named_parameters():
            for got, want in ((pop.params[k][i], p),
                              (opt.mu[k][i], state.mu[k]),
                              (opt.nu[k][i], state.nu[k])):
                w = want.detach().numpy()
                np.testing.assert_allclose(
                    got.detach().numpy(), w, rtol=1e-5,
                    atol=1e-5 * float(np.abs(w).max()), err_msg=k)
        assert float(single.buf[0, single.names.index("grad_norm")]) == \
            pytest.approx(float(norms[i]), rel=1e-5)


def test_member_flags_and_select_equal_jax():
    """``HealthGuard`` over K=3 members (healthy, NaN loss, exploding
    parameters) against JAX's health wrapper under ``jax.vmap``: the same
    flags and words, and the same per-member select."""
    rng = np.random.default_rng(2)
    old = {"a": rng.normal(size=(3, 4, 3)).astype(np.float32),
           "b": rng.normal(size=(3, 3)).astype(np.float32)}
    scale = np.float32([1.0, 1.0, 1e9])[:, None]
    new = {"a": old["a"] * scale[..., None] * np.float32(1.01),
           "b": old["b"] * scale * np.float32(1.01)}
    loss = np.float32([1.0, np.nan, 1.0])
    grad_norm = np.float32([2.0, 2.0, 2.0])

    TS = collections.namedtuple("TS", "params")

    def toy(ts, env, obs, key, new_params, loss, grad_norm):
        return TS(new_params), env, obs, key, {"loss": loss,
                                               "grad_norm": grad_norm}

    def member(old_params, new_params, loss, grad_norm):
        wrapped = jax_make_health_iteration(
            lambda ts, e, o, k: toy(ts, e, o, k, new_params, loss,
                                    grad_norm),
            JaxHealthConfig())
        return wrapped(TS(old_params), jnp.int32(0), jnp.zeros((2,)),
                       jax.random.PRNGKey(0))

    ts, _, _, _, m = jax.vmap(member)(old, new, loss, grad_norm)
    live = [torch.from_numpy(old[k].copy()) for k in ("a", "b")]
    guard = HealthGuard(HealthConfig(), live, live, members=3)
    guard.save()
    for tensor, k in zip(live, ("a", "b")):
        tensor.copy_(torch.from_numpy(new[k]))
    flags = guard.apply(torch.from_numpy(loss), torch.from_numpy(grad_norm),
                        [])
    np.testing.assert_array_equal(flags[:, 0].numpy(),
                                  np.asarray(m["health_ok"]))
    np.testing.assert_array_equal(flags[:, 1].numpy(),
                                  np.asarray(m["health_word"]))
    assert flags[:, 0].tolist() == [1.0, 0.0, 0.0]
    for tensor, k in zip(live, ("a", "b")):
        np.testing.assert_array_equal(tensor.numpy(),
                                      np.asarray(ts.params[k]))


def test_a_poisoned_member_skips_while_the_others_train(tmp_path):
    """``health=true``, member 0 poisoned with NaN inside the second
    iteration: member 0 keeps its state from before it and reports the
    skip; member 1 equals member 1 of a clean population bitwise;
    ``recovery=true`` adds no ladder, as in the JAX package."""
    poisoned = _sweep(tmp_path, num_seeds=2, name="poisoned", health=True,
                      recovery=True)
    clean = _sweep(tmp_path, num_seeds=2, name="clean", health=True)
    poisoned.run_iteration()
    clean.run_iteration()
    before = {k: p[0].detach().clone()
              for k, p in poisoned.model.params.items()}

    def hook(phase):
        if phase == "update":
            with torch.no_grad():
                for p in poisoned.model.params.values():
                    p[0].mul_(float("nan"))

    poisoned.phase_hook = hook
    got = poisoned.run_iteration()
    poisoned.phase_hook = None
    clean.run_iteration()
    assert got["health_ok"].tolist() == [0.0, 1.0]
    assert float(got["health_word"][0]) < 15.0
    for k, p in poisoned.model.params.items():
        assert torch.equal(p[0], before[k])
        assert torch.equal(p[1], clean.model.params[k][1])
    assert torch.equal(poisoned.env_state.agents[M:],
                       clean.env_state.agents[M:])
    assert not (Path(poisoned.log_dir) / "recovery.jsonl").exists()
    poisoned._host_metrics(got)
    assert poisoned.skipped_updates == 1


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------


def _records(log_dir):
    lines = (Path(log_dir) / "metrics.jsonl").read_text().splitlines()
    return [{k: v for k, v in json.loads(line).items()
             if k not in ("time", "env_steps_per_sec")} for line in lines]


def _files(log_dir):
    root = Path(log_dir)
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*.msgpack"))}


def test_fused_chunk_equals_the_host_loop(tmp_path):
    """Four iterations: ``fused_chunk=2`` writes the host loop's records,
    member files and anchors, bitwise, and the same summary."""
    runs = {}
    for mode, chunk in (("host", 0), ("fused", 2)):
        sweep = _sweep(tmp_path, num_seeds=2, name=mode, fused_chunk=chunk,
                       checkpoint=True, save_freq=2 * PPO.n_steps,
                       total_timesteps=4 * PER_ITER)
        sweep.train()
        runs[mode] = sweep
    host, fused = runs["host"].log_dir, runs["fused"].log_dir
    assert _records(host) == _records(fused)
    assert [r["step"] for r in _records(host)] == [
        PER_ITER * (i + 1) for i in range(4)]
    files = _files(host)
    assert files == _files(fused)
    assert sorted(files) == sorted(
        [f"seed{i}/rl_model_{s}_steps.msgpack" for i in range(2)
         for s in (2 * PER_ITER, 4 * PER_ITER)]
        + [f"sweep_state_{s}_steps.msgpack" for s in (2 * PER_ITER,
                                                     4 * PER_ITER)])
    assert (json.loads((Path(host) / "sweep_summary.json").read_text())
            == json.loads((Path(fused) / "sweep_summary.json").read_text()))


def test_async_save_writes_the_sync_bytes(tmp_path):
    from marl_distributedformation_tpu_torch.utils.checkpoint import (
        AsyncCheckpointWriter,
    )

    sweep = _sweep(tmp_path, num_seeds=2, lrs=[1e-3, 3e-3])
    sweep.run_iteration()
    sweep.save()
    sync = _files(sweep.log_dir)
    sweep.log_dir = str(tmp_path / "async")
    writer = AsyncCheckpointWriter()
    sweep.save_async(writer)
    writer.close()
    assert _files(sweep.log_dir) == sync and len(sync) == 3


def test_iters_per_dispatch_is_refused_as_jax_refuses_it(tmp_path):
    with pytest.raises(SystemExit) as jax_err:
        JaxSweep(jax_params(KINDS["mlp"]), JaxPPOConfig(n_steps=4),
                 JaxTrainConfig(num_formations=M, iters_per_dispatch=2,
                                checkpoint=False), num_seeds=2)
    with pytest.raises(SystemExit) as err:
        _sweep(tmp_path, num_seeds=2, iters_per_dispatch=2)
    assert str(err.value) == str(jax_err.value)
    with pytest.raises(ValueError, match="one entry per member"):
        _sweep(tmp_path, num_seeds=2, lrs=[1e-3])


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("lr_sweep", [False, True])
def test_member_files_read_by_the_jax_package(tmp_path, lr_sweep):
    """Each member file holds the member's learner in the JAX layout, as
    ``load_checkpoint_raw`` reads it; a learning-rate sweep's carries no
    optimizer state and records the member's own rate."""
    lrs = [1e-3, 3e-3] if lr_sweep else None
    sweep = _sweep(tmp_path, num_seeds=2, lrs=lrs, checkpoint=True,
                   total_timesteps=PER_ITER)
    sweep.train()
    for i in range(2):
        path = Path(sweep.log_dir) / f"seed{i}" / \
            f"rl_model_{PER_ITER}_steps.msgpack"
        raw = load_checkpoint_raw(path)
        assert raw["policy"] == "MLPActorCritic"
        assert ("opt_state" in raw) != lr_sweep
        params, _ = _member_learner(sweep, i)
        assert_tree_close(np_tree(raw["params"]), params, rtol=0)
        assert raw["learning_rate"] == (float(np.float32(lrs[i]))
                                        if lr_sweep else LR)
        assert raw["num_timesteps"] == PER_ITER


def _population_state(sweep):
    it = sweep._iteration
    return {
        **{f"p {k}": v.detach().clone() for k, v in sweep.model.params.items()},
        **{f"mu {k}": v.clone() for k, v in sweep.opt_state.mu.items()},
        **{f"nu {k}": v.clone() for k, v in sweep.opt_state.nu.items()},
        "count": sweep.opt_state.count.clone(), "step": it.step.clone(),
        "lr": it.lr.clone(), "agents": it.env.agents.clone(),
        "obs": it.obs.clone(),
        "gens": torch.stack([g.get_state() for g in sweep.generators]),
    }


@pytest.mark.parametrize("lr_sweep", [False, True])
def test_resume_from_the_anchor_is_bitwise(tmp_path, lr_sweep):
    lrs = [1e-3, 3e-3] if lr_sweep else None
    kw = dict(checkpoint=True, save_freq=10**9)
    full = _sweep(tmp_path, num_seeds=2, name="full", lrs=lrs,
                  total_timesteps=2 * PER_ITER, **kw)
    full.train()
    _sweep(tmp_path, num_seeds=2, name="part", lrs=lrs,
           total_timesteps=PER_ITER, **kw).train()
    assert (tmp_path / "part" / f"sweep_state_{PER_ITER}_steps.msgpack"
            ).exists()
    resumed = _sweep(tmp_path, num_seeds=2, name="part", lrs=lrs,
                     total_timesteps=2 * PER_ITER, resume=True, **kw)
    assert resumed.num_timesteps == PER_ITER
    resumed.train()
    a, b = _population_state(full), _population_state(resumed)
    for key in a:
        assert torch.equal(a[key], b[key]), key
    summary = [json.loads((tmp_path / d / "sweep_summary.json").read_text())
               for d in ("full", "part")]
    assert summary[0] == summary[1]


def test_resume_refuses_identity_mismatches(tmp_path, capsys):
    """The cases of the JAX package's ``test_sweep_resume_rejects_
    mismatches``, with its messages: another population size, another
    learning-rate mode, another seed or M; without an anchor, a fresh
    start with a note."""
    kw = dict(name="pop", checkpoint=True, save_freq=10**9)
    _sweep(tmp_path, num_seeds=2, total_timesteps=PER_ITER, **kw).train()
    resume = dict(kw, total_timesteps=2 * PER_ITER, resume=True)
    with pytest.raises(SystemExit, match="num_seeds"):
        _sweep(tmp_path, num_seeds=3, **resume)
    with pytest.raises(SystemExit, match="learning_rates"):
        _sweep(tmp_path, num_seeds=2, lrs=[1e-3, 3e-3], **resume)
    with pytest.raises(SystemExit, match="seed=0 but this run uses 5"):
        _sweep(tmp_path, num_seeds=2, seed=5, **resume)
    with pytest.raises(SystemExit, match="num_formations"):
        SweepTrainer(KINDS["mlp"], PPO,
                     _config(tmp_path, num_formations=2, **resume), 2,
                     models=[_model("mlp", i) for i in range(2)],
                     device="cpu")
    (tmp_path / "pop" / f"sweep_state_{PER_ITER}_steps.msgpack").unlink()
    capsys.readouterr()
    fresh = _sweep(tmp_path, num_seeds=2, **resume)
    assert fresh.num_timesteps == 0
    assert "no sweep_state_* population checkpoint" in capsys.readouterr().out


@pytest.fixture(scope="module")
def jax_lr_sweep(tmp_path_factory):
    """A JAX ``SweepTrainer`` run: K=2 ring/MLP members at their own rates,
    two iterations, records and a ``sweep_state`` anchor."""
    root = tmp_path_factory.mktemp("jax_sweep")
    sweep = JaxSweep(
        jax_params(KINDS["mlp"]), JaxPPOConfig(n_steps=4, batch_size=24,
                                               n_epochs=2),
        JaxTrainConfig(num_formations=M, seed=0, checkpoint=True,
                       save_freq=10**9, total_timesteps=2 * PER_ITER,
                       name="jax", log_dir=str(root / "jax")),
        num_seeds=2, learning_rates=[1e-3, 3e-3],
    )
    sweep.train()
    return sweep


def test_records_equal_the_jax_sweep_trainers(tmp_path, jax_lr_sweep):
    sweep = _sweep(tmp_path, num_seeds=2, lrs=[1e-3, 3e-3],
                   checkpoint=True, save_freq=10**9,
                   total_timesteps=2 * PER_ITER)
    sweep.train()
    want = _records(jax_lr_sweep.log_dir)
    got = _records(sweep.log_dir)
    assert [r["step"] for r in got] == [r["step"] for r in want]
    assert [set(r) for r in got] == [set(r) for r in want]
    assert sorted(p.name for p in Path(sweep.log_dir).iterdir()) == sorted(
        p.name for p in Path(jax_lr_sweep.log_dir).iterdir())


def test_a_jax_anchor_resumes_the_learner(tmp_path, jax_lr_sweep):
    """The port resumes the JAX package's ``sweep_state``: the stacked
    parameters, Adam state and per-member rates exactly, the step count;
    the streams start afresh (the JAX file has no torch state)."""
    log_dir = tmp_path / "from_jax"
    shutil.copytree(jax_lr_sweep.log_dir, log_dir)
    sweep = SweepTrainer(
        KINDS["mlp"], PPO,
        _config(tmp_path, "from_jax", total_timesteps=3 * PER_ITER,
                resume=True, log_dir=str(log_dir)),
        2, models=[_model("mlp", i) for i in range(2)],
        learning_rates=[1e-3, 3e-3], device="cpu",
    )
    fresh = _sweep(tmp_path, num_seeds=2, name="fresh", lrs=[1e-3, 3e-3])
    assert sweep.num_timesteps == jax_lr_sweep.num_timesteps == 2 * PER_ITER
    want = np_tree(serialization.to_state_dict(
        jax_lr_sweep.train_state.params))
    got = params_to_jax(dict(sweep.model.params), "MLPActorCritic")
    assert_tree_close(got, want, rtol=0)
    jopt = serialization.to_state_dict(jax_lr_sweep.train_state.opt_state)
    popt = opt_state_to_jax({"count": sweep.opt_state.count,
                             "mu": sweep.opt_state.mu,
                             "nu": sweep.opt_state.nu}, "MLPActorCritic")
    inner = jopt["1"]["inner_state"]["0"]
    np.testing.assert_array_equal(popt["1"]["0"]["count"],
                                  np.asarray(inner["count"]))
    for moment in ("mu", "nu"):
        assert_tree_close(popt["1"]["0"][moment], np_tree(inner[moment]),
                          rtol=0)
    np.testing.assert_array_equal(
        sweep._iteration.lr.numpy(),
        np.asarray(jopt["1"]["hyperparams"]["learning_rate"]))
    for g, h in zip(sweep.generators, fresh.generators):
        assert torch.equal(g.get_state(), h.get_state())
    assert sweep.step == 0
    sweep.train()
    assert sweep.num_timesteps == 3 * PER_ITER


# ---------------------------------------------------------------------------
# Records, summary, evaluation
# ---------------------------------------------------------------------------


def test_aggregate_and_summary_equal_jax(tmp_path):
    rng = np.random.default_rng(3)
    host = {"reward": rng.normal(size=5).astype(np.float32),
            "loss": rng.normal(size=5).astype(np.float32),
            "health_ok": np.float32([1, 1, 0, 1, 1])}
    assert population_aggregate(host, 7) == jax_population_aggregate(host, 7)
    for extra in (None, {"learning_rates": [1e-3, 2e-3, 3e-3, 4e-3, 5e-3]}):
        write_sweep_summary(tmp_path / "port", 7, 5, host["reward"], extra)
        jax_write_sweep_summary(tmp_path / "jax", 7, 5, host["reward"],
                                extra)
        assert (tmp_path / "port" / "sweep_summary.json").read_text() == \
            (tmp_path / "jax" / "sweep_summary.json").read_text()


def test_sweep_mode_evaluation_has_jax_eval_sweeps_keys(
        tmp_path, monkeypatch, capsys):
    """``evaluate name=<population>`` ranks every ``seed<N>`` member
    against baseline and zero, with the JSON keys of the JAX package's
    ``eval_sweep`` (and the zero controller's return); ``seed0.bak`` and a
    stray file named ``seed9`` are not members."""
    monkeypatch.setattr(evaluate_cli, "repo_root", lambda: tmp_path)
    sweep = _sweep(tmp_path, num_seeds=2, name="logs/pop", checkpoint=True,
                   total_timesteps=PER_ITER)
    sweep.train()
    run = Path(sweep.log_dir)
    shutil.copytree(run / "seed0", run / "seed0.bak")
    (run / "seed9").write_text("not a member")
    overrides = ["num_agents_per_formation=3", "eval_formations=4",
                 "max_steps=8"]
    res = evaluate_cli.main(["name=pop", *overrides, "device=cpu"])
    assert res["sweep_members"] == 2
    assert set(res["member_returns"]) == {"seed0", "seed1"}
    assert res["best_member"] in ("seed0", "seed1")
    assert "<- best member" in capsys.readouterr().out
    from marl_distributedformation_tpu.utils import load_config

    cfg = load_config(overrides)
    want = jax_evaluate_cli.eval_sweep(
        [run / "seed0", run / "seed1"],
        jax_evaluate_cli.env_params_from_config(cfg), 4, 1234)
    assert set(res) == set(want) | {"zero_return"}
