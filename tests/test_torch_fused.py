"""The port's fused dispatch on the CPU: ``fused_chunk`` and
``iters_per_dispatch`` against the host loop and against the JAX trainer,
the burst reduction against JAX's ``make_fused_chunk`` and the permutation
draw (scenario training under fused dispatch is in
``test_torch_fused_scenarios.py``).

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
    # The GNN's minibatch is 10 whole formations of 8 (4 an epoch).
    return Trainer(params, PPOConfig(n_epochs=2, batch_size=80),
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


def test_a_dispatch_that_warms_up_and_captures_counts_one_build():
    """The build receipt of a captured phase: a dispatch of two or more
    calls from the first both warms it up and captures it (a fused
    chunk's first two iterations), so it builds; one call from the first
    warms up only, and the second builds. On the CPU a phase builds at its
    first call."""
    from marl_distributedformation_tpu_torch.train.capture import PhaseGraph

    card = PhaseGraph("rollout", lambda: None, capture=True, stream=object())
    assert not card.builds_next() and card.builds_next(2)
    card.calls = 1
    assert card.builds_next() and card.builds_next(10)
    card.graph = object()
    assert not card.builds_next(10)
    card.drop()  # a forced rebuild
    assert card.builds_next()
    cpu = PhaseGraph("rollout", lambda: None, capture=False)
    assert cpu.builds_next() and cpu.builds_next(2)
    assert not cpu.builds_next(0)
    cpu.calls = 1
    assert not cpu.builds_next(2)

