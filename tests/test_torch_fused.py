"""The port's fused dispatch on the CPU: ``fused_chunk`` and
``iters_per_dispatch`` against the host loop and against the JAX trainer,
the burst reduction against JAX's ``make_fused_chunk``, the permutation
draw, and scenario training (a stage change inside a chunk, severity 0
against the clean run, a resume mid-schedule).

On the CPU the iteration's phases run eagerly (nothing is captured), so
the dispatch modes are pinned here and the graphs on the card
(``tests/test_torch_gpu.py``, ``chip_smoke.py``).

Tolerances: records and checkpoint bytes of fused and burst dispatch equal
the host loop's bitwise (the same operations in the same order); the burst
reduction equals JAX's within ``rtol=1e-6`` (an f32 sum of a few rows,
possibly in another order); steps and file names exactly.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marl_distributedformation_tpu.algo import PPOConfig as JaxPPOConfig
from marl_distributedformation_tpu.train import TrainConfig as JaxTrainConfig
from marl_distributedformation_tpu.train import Trainer as JaxTrainer
from marl_distributedformation_tpu.train import make_fused_chunk
from marl_distributedformation_tpu_torch.algo import PPOConfig
from marl_distributedformation_tpu_torch.algo.ppo import draw_permutations
from marl_distributedformation_tpu_torch.env import EnvParams
from marl_distributedformation_tpu_torch.models import (
    GNNActorCritic,
    MLPActorCritic,
)
from marl_distributedformation_tpu_torch.train import TrainConfig, Trainer
from marl_distributedformation_tpu_torch.train.trainer import reduce_burst
from test_torch_env import jax_params

KINDS = {
    "mlp": EnvParams(num_agents=5, max_steps=12),
    # The GNN on the plain k-NN (the CPU has no kernel).
    "gnn": EnvParams(num_agents=8, obs_mode="knn", knn_k=3, max_steps=12),
}
M = 4
ITERATIONS = 4


def _trainer(tmp_path, kind, name, scenario_schedule=None, **cfg):
    params = KINDS[kind]
    gen = torch.Generator().manual_seed(7)
    model = (MLPActorCritic(params.obs_dim, generator=gen) if kind == "mlp"
             else GNNActorCritic(k=params.knn_k, generator=gen))
    per_iter = 10 * M * params.num_agents
    config = dict(num_formations=M, total_timesteps=ITERATIONS * per_iter,
                  seed=7, log_dir=str(tmp_path / name))
    config.update(cfg)
    return Trainer(params, PPOConfig(n_epochs=2, batch_size=80 if kind ==
                                     "mlp" else 16),
                   TrainConfig(**config), model=model, device="cpu",
                   scenario_schedule=scenario_schedule)


def _records(trainer):
    """The metric records without their wall-clock fields."""
    out = []
    text = (Path(trainer.log_dir) / "metrics.jsonl").read_text()
    for line in text.splitlines():
        r = json.loads(line)
        del r["time"], r["env_steps_per_sec"]
        out.append(r)
    return out


def _files(trainer):
    return {p.name: p.read_bytes()
            for p in Path(trainer.log_dir).glob("rl_model_*.msgpack")}


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("mode", ["fused_chunk", "iters_per_dispatch"])
def test_dispatch_modes_equal_the_host_loop(tmp_path, kind, mode):
    host = _trainer(tmp_path, kind, "host")
    host.train()
    fused = _trainer(tmp_path, kind, mode, **{mode: 2})
    fused.train()
    want, got = _records(host), _records(fused)
    assert fused.step == host.step > 0
    if mode == "fused_chunk":
        assert got == want  # one record an iteration, bitwise
    else:
        # One record a burst of two: the host loop's two rows reduced.
        assert [r["step"] for r in got] == [r["step"] for r in want[1::2]]
        names = tuple(sorted(set(want[0]) - {"step"}))
        for i, rec in enumerate(got):
            rows = torch.tensor([[w[n] for n in names]
                                 for w in want[2 * i:2 * i + 2]],
                                dtype=torch.float32)
            reduced = reduce_burst(names, rows).tolist()
            assert {n: rec[n] for n in names} == dict(zip(names, reduced))
    host_files, fused_files = _files(host), _files(fused)
    assert fused_files and set(fused_files) <= set(host_files)
    for name, data in fused_files.items():
        assert data == host_files[name], name  # async and sync alike


@pytest.mark.parametrize("mode", ["fused_chunk", "iters_per_dispatch"])
def test_steps_and_checkpoint_names_equal_the_jax_trainers(tmp_path, mode):
    """The same config in both packages: the same metric-line steps and
    checkpoint file names."""
    params = EnvParams(num_agents=3)
    total = 6 * 10 * 2 * 3
    cfg = dict(num_formations=2, total_timesteps=total, save_freq=20,
               log_interval=2, **{mode: 2})
    JaxTrainer(
        jax_params(params), ppo=JaxPPOConfig(n_epochs=1),
        config=JaxTrainConfig(log_dir=str(tmp_path / "jax"), **cfg),
    ).train()
    port = Trainer(params, PPOConfig(n_epochs=1), TrainConfig(
        log_dir=str(tmp_path / "port"), **cfg),
        model=MLPActorCritic(params.obs_dim), device="cpu")
    port.train()

    def steps(run):
        lines = (tmp_path / run / "metrics.jsonl").read_text().splitlines()
        return [json.loads(line)["step"] for line in lines]

    def names(run):
        return sorted(p.name for p in (tmp_path / run).glob("rl_model_*"))

    assert steps("port") == steps("jax") and steps("jax")
    assert names("port") == names("jax") and names("jax")


def test_burst_reduction_equals_jax():
    """``reduce_burst`` against ``make_fused_chunk(reduce_metrics=True)``
    on the same stacked metrics: dones sum, health flags take the minimum,
    the rest the mean."""
    rng = np.random.default_rng(0)
    names = ("episode_dones", "health_ok", "health_word", "loss", "reward")
    rows = rng.normal(size=(3, len(names))).astype(np.float32) * 10
    rows[:, 0] = [3.0, 0.0, 5.0]
    rows[:, 1] = [1.0, 0.0, 1.0]
    rows[:, 2] = [15.0, 14.0, 15.0]

    def iteration(ts, env, obs, key, xs):
        return ts, env, obs, key, xs

    fused = make_fused_chunk(iteration, 3, reduce_metrics=True)
    stacked = {n: jnp.asarray(rows[:, j]) for j, n in enumerate(names)}
    *_, want = jax.jit(fused)(0.0, 0.0, 0.0, 0.0, stacked)
    got = reduce_burst(names, torch.from_numpy(rows))
    for j, n in enumerate(names):
        np.testing.assert_allclose(float(got[j]), float(want[n]), rtol=1e-6,
                                   err_msg=n)
    assert float(got[1]) == 0.0 and float(got[0]) == 8.0


@pytest.mark.parametrize("used", [97, 100])
def test_each_epochs_draw_is_a_permutation(used):
    gen = torch.Generator().manual_seed(1)
    perms = draw_permutations(gen, 4, 100, used, torch.device("cpu"))
    assert perms.shape == (4, used) and perms.dtype == torch.int64
    for row in perms:
        assert len(set(row.tolist())) == used
        assert 0 <= int(row.min()) and int(row.max()) < 100
    if used == 100:
        assert torch.equal(perms.sort(dim=1).values,
                           torch.arange(100).expand(4, 100))
    assert not torch.equal(perms[0], perms[1])  # each epoch draws anew


def test_fused_chunk_and_iters_per_dispatch_exclude_each_other(tmp_path):
    with pytest.raises(SystemExit, match="set exactly one"):
        _trainer(tmp_path, "mlp", "both", fused_chunk=2,
                 iters_per_dispatch=2)
    with pytest.raises(SystemExit, match="needs health=true"):
        _trainer(tmp_path, "mlp", "ladder", recovery=True)


# ---------------------------------------------------------------------------
# Scenario training
# ---------------------------------------------------------------------------

# Stage 0 ramps over 3 rollouts, so with fused_chunk=2 the change to stage
# 1 falls inside the second chunk (iterations 3 | 4).
SCHEDULE = ("[{rollouts: 3, scenarios: [storm, comm_dropout, moving_goal], "
            "severity: 1.0, severity_start: 0.2}, {rollouts: 2, scenarios: "
            "[actuator_fault, sensor_noise, wind], severity: 0.7}]")


def _schedule(text=SCHEDULE):
    from marl_distributedformation_tpu_torch.scenarios import (
        schedule_from_cfg,
    )

    return schedule_from_cfg(text)


def _carry(trainer):
    """The trainer's state by name: learner, env carry (with the episode
    draws under scenarios), observation and generators."""
    it = trainer._iteration
    out = {f"learner {i}": t.clone()
           for i, t in enumerate(it.learner_tensors())}
    out.update({f: getattr(it.env, f).clone() for f in it.env_fields})
    out["obs"] = it.obs.clone()
    out["generator"] = trainer.generator.get_state()
    if trainer._scenario_schedule is not None:
        out["scenario generator"] = trainer.scenario_generator.get_state()
    return out


def _same_carry(a, b):
    a, b = _carry(a), _carry(b)
    for key in set(a) & set(b):
        assert torch.equal(a[key], b[key]), key
    return a, b


def test_scenario_fused_equals_the_host_loop_across_a_stage_change(
        tmp_path):
    """fused_chunk=2 against the host loop, the stage change inside the
    second chunk: records (scenario_severity included), checkpoint bytes
    and the carry bitwise; the severities are the schedule's. (The MLP:
    the mixes' dispatch does not depend on the model, and the GNN's
    dispatch modes are pinned above; the knn scenario path trains in
    ``test_scenario_resume_mid_schedule_is_bitwise``.)"""
    kind = "mlp"
    host = _trainer(tmp_path, kind, "host", _schedule())
    host.train()
    fused = _trainer(tmp_path, kind, "fused", _schedule(), fused_chunk=2)
    fused.train()
    want, got = _records(host), _records(fused)
    assert got == want and len(got) == ITERATIONS
    assert [r["scenario_severity"] for r in got] == [
        float(np.float32(_schedule().severity_at(i)))
        for i in range(ITERATIONS)]
    a, b = _same_carry(host, fused)
    assert set(a) == set(b) and "fault_u" in a
    host_files, fused_files = _files(host), _files(fused)
    assert fused_files and set(fused_files) <= set(host_files)
    for name, data in fused_files.items():
        assert data == host_files[name], name
    assert fused.graph_count() == 0  # eager on the CPU


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_scenario_severity_zero_trains_as_the_clean_run(tmp_path, kind):
    """Every layer at severity 0 (a mix of every scenario, ``fused_chunk``
    dispatch): the learner, env carry, generator and records equal the
    clean trainer's bitwise."""
    names = ", ".join(n for n in ("wind", "storm", "sensor_noise",
                                  "actuator_fault", "comm_dropout",
                                  "goal_switch", "moving_goal",
                                  "actuator_noise"))
    zero = _schedule(f"[{{rollouts: 4, scenarios: [{names}], severity: 0.0,"
                     " severity_start: 0.0}]")
    clean = _trainer(tmp_path, kind, "clean", fused_chunk=2)
    clean.train()
    scen = _trainer(tmp_path, kind, "zero", zero, fused_chunk=2)
    scen.train()
    got = _records(scen)
    assert {r.pop("scenario_severity") for r in got} == {0.0}
    assert got == _records(clean)
    a, b = _same_carry(clean, scen)
    assert set(a) < set(b)


def test_scenario_resume_mid_schedule_is_bitwise(tmp_path):
    """Two iterations, a checkpoint, and a resumed run of two more (into
    stage 1) equal four uninterrupted iterations bitwise: the schedule is
    re-entered at num_timesteps // (n_steps * M * N), the layers'
    generator and episode draws come back from the checkpoint."""
    full = _trainer(tmp_path, "gnn", "full", _schedule())
    full.train()
    per_iter = 10 * M * KINDS["gnn"].num_agents
    part = _trainer(tmp_path, "gnn", "part", _schedule(),
                    total_timesteps=2 * per_iter, save_freq=10)
    part.train()
    resumed = _trainer(tmp_path, "gnn", "part", _schedule(), resume=True)
    assert resumed._scenario_rollouts == resumed._scenario_draws == 2
    assert resumed.scenario_severity == _schedule().severity_at(2)
    resumed.train()
    a, b = _same_carry(full, resumed)
    assert set(a) == set(b)
    assert _records(resumed)[-2:] == _records(full)[-2:]


def test_scenario_mixes_are_a_pure_function_of_the_draw(tmp_path):
    """Draw d's mix repeats for the same (seed, d) and differs across d; a
    schedule swap restarts the schedule but not the draw counter."""
    trainer = _trainer(tmp_path, "mlp", "swap", _schedule())
    a, _ = trainer._scenario_rows(0, 5, 2)
    b, _ = trainer._scenario_rows(0, 5, 2)
    c, _ = trainer._scenario_rows(0, 6, 2)
    assert torch.equal(a.act_noise_sigma, b.act_noise_sigma)
    assert not torch.equal(a.fault_prob[1], c.fault_prob[0]) or not \
        torch.equal(a.obs_noise_sigma[1], c.obs_noise_sigma[0]) or \
        torch.equal(a.act_noise_sigma[1], c.act_noise_sigma[0])
    trainer.run_iteration()
    trainer.update_scenario_schedule(_schedule("[wind]"))
    assert trainer._scenario_rollouts == 0 and trainer._scenario_draws == 1
    trainer.request_scenario_schedule(_schedule("[storm]"))
    with pytest.raises(ValueError, match="unknown scenario"):
        from marl_distributedformation_tpu_torch.scenarios import (
            ScenarioSchedule,
            ScenarioStage,
        )
        trainer.request_scenario_schedule(ScenarioSchedule(
            (ScenarioStage(1, ("wnd",)),)))
    trainer.run_iteration()
    assert trainer._scenario_schedule.names == ("storm",)
    assert trainer._scenario_draws == 2
    assert float(trainer.scenario_params.act_noise_sigma[0]) == np.float32(
        2.0 * np.float32(0.5))
    clean = _trainer(tmp_path, "mlp", "plain")
    with pytest.raises(ValueError, match="built without scenario training"):
        clean.update_scenario_schedule(_schedule("[wind]"))
