"""The port's curriculum populations (``train/hetero_sweep.py``) and
runs on the CPU: fused dispatch clipped at stage boundaries against the
host loop, mid-stage resume from the anchor, identity refusals, a
poisoned candidate, a JAX anchor and member files both ways, and both
published commands through the CLIs at a cut size (the trainers and
constants of ``test_torch_curriculum.py``).

Tolerances, as in ``test_torch_curriculum.py``: fused against the host
loop and resumes bitwise; a member of K = 2 against its single run within
``tests/adam_budget.py``'s budget; JAX's files and anchors by keys, step
stamps and ``assert_tree_close``.
"""

import dataclasses
import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from marl_distributedformation_tpu.compat.policy import (
    LoadedPolicy as JaxLoadedPolicy,
    load_checkpoint_raw,
)
from marl_distributedformation_tpu.train import TrainConfig as JaxTrainConfig
from marl_distributedformation_tpu.train.curriculum import (
    Curriculum as JaxCurriculum,
    CurriculumStage as JaxStage,
)
from marl_distributedformation_tpu_torch import evaluate as evaluate_cli
from marl_distributedformation_tpu_torch.compat.convert import params_to_jax
from marl_distributedformation_tpu_torch.env import EnvParams
from marl_distributedformation_tpu_torch.train import cli as train_cli
from marl_distributedformation_tpu_torch.train.curriculum import (
    Curriculum,
    CurriculumStage,
    HeteroTrainer,
)
from marl_distributedformation_tpu_torch.train.hetero_sweep import (
    HeteroSweepTrainer,
)
from test_torch_algo import assert_tree_close
from test_torch_curriculum import CUR, M, PPO, STAGE0_ITER, _state, _sweep
from test_torch_env import jax_params
from test_torch_models import np_tree
from test_torch_sweep import _files, _records


def test_fused_chunks_clip_at_stage_boundaries_and_equal_the_host_loop(
        tmp_path):
    """``fused_chunk=2`` over stages of 3 and 2 rollouts (chunks 2, 1 | 2):
    the host loop's records, member files, anchors and summary, bitwise
    (checkpoints every 3 rollouts, which both cadences meet at rollout
    3, and at the end)."""
    runs = {}
    for mode, chunk in (("host", 0), ("fused", 2)):
        sweep = _sweep(tmp_path, name=mode, fused_chunk=chunk,
                       checkpoint=True, save_freq=3 * PPO.n_steps)
        sweep.train()
        runs[mode] = sweep
    host, fused = runs["host"], runs["fused"]
    assert _records(host.log_dir) == _records(fused.log_dir)
    assert [r["curriculum_stage"] for r in _records(host.log_dir)] == [
        0.0] * 3 + [1.0] * 2
    files = _files(host.log_dir)
    assert files == _files(fused.log_dir)
    assert len([f for f in files if f.startswith("sweep_state_")]) == 2
    summary = [json.loads((Path(s.log_dir) / "sweep_summary.json")
                          .read_text()) for s in (host, fused)]
    assert summary[0] == summary[1]
    assert summary[0]["curriculum_rollouts"] == 5
    a, b = _state(host), _state(fused)
    for key in a:
        assert torch.equal(a[key], b[key]), key


def test_mid_stage_resume_from_the_anchor_is_bitwise(tmp_path):
    """Stopped by its cap two rollouts into the three of stage 0 and
    resumed from the anchor: the partial stage is continued, not
    resampled, and the run equals the uninterrupted one bitwise."""
    kw = dict(checkpoint=True, save_freq=10**9)
    full = _sweep(tmp_path, "ctde", name="full", **kw)
    full.train()
    part = _sweep(tmp_path, "ctde", name="part",
                  total_timesteps=2 * STAGE0_ITER, **kw)
    part.train()
    assert part.completed_rollouts == 2
    resumed = _sweep(tmp_path, "ctde", name="part", resume=True, **kw)
    assert resumed.completed_rollouts == 2
    assert resumed.num_timesteps_members.tolist() == [2 * STAGE0_ITER] * 2
    resumed.train()
    a, b = _state(full), _state(resumed)
    for key in a:
        assert torch.equal(a[key], b[key]), key
    assert _records(full.log_dir) == _records(resumed.log_dir)
    assert (Path(full.log_dir) / "sweep_summary.json").read_text() == (
        Path(resumed.log_dir) / "sweep_summary.json").read_text()


def test_resume_refuses_identity_mismatches(tmp_path, capsys):
    kw = dict(name="pop", checkpoint=True, save_freq=10**9)
    _sweep(tmp_path, total_timesteps=STAGE0_ITER, **kw).train()
    resume = dict(kw, resume=True)
    shuffled = Curriculum((CurriculumStage(2, (3,)),
                           CurriculumStage(3, (3, 5), num_obstacles=2)))
    with pytest.raises(SystemExit, match="hetero-sweep resume mismatch.*"
                       "curriculum_spec.*candidate identities"):
        _sweep(tmp_path, cur=shuffled, **resume)
    with pytest.raises(SystemExit, match="num_seeds=2 but this run uses 3"):
        _sweep(tmp_path, k=3, **resume)
    with pytest.raises(SystemExit, match="policy"):
        _sweep(tmp_path, "ctde", **resume)
    with pytest.raises(SystemExit, match="seed=0 but this run uses 4"):
        _sweep(tmp_path, seed=4, **resume)
    for anchor in (tmp_path / "pop").glob("sweep_state_*"):
        anchor.unlink()
    capsys.readouterr()
    fresh = _sweep(tmp_path, **resume)
    assert fresh.completed_rollouts == 0
    assert "no sweep_state_* population checkpoint" in capsys.readouterr().out


def test_a_poisoned_candidate_skips_while_the_other_trains(tmp_path):
    """``health=true`` guards each candidate on its own, as the JAX
    package's ``wrap_health`` before ``vmap``: candidate 0 poisoned with
    NaN inside an iteration keeps its state from before it and reports
    the skip, candidate 1 equals a clean population's bitwise, and the
    drain counts the skip."""
    poisoned = _sweep(tmp_path, name="poisoned", health=True)
    clean = _sweep(tmp_path, name="clean", health=True)
    for t_ in (poisoned, clean):
        t_.start_stage(CUR.stages[0])
        t_.run_iteration()
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
    for k, p in poisoned.model.params.items():
        assert torch.equal(p[0], before[k])
        assert torch.equal(p[1], clean.model.params[k][1])
    poisoned._host_metrics(got)
    assert poisoned.skipped_updates == 1


def test_population_refuses_iters_per_dispatch_as_jax(tmp_path):
    from marl_distributedformation_tpu.algo import PPOConfig as JaxPPOConfig
    from marl_distributedformation_tpu.train.hetero_sweep import (
        HeteroSweepTrainer as JaxHeteroSweep,
    )

    with pytest.raises(SystemExit) as jerr:
        JaxHeteroSweep(JaxCurriculum(), jax_params(EnvParams()),
                       JaxPPOConfig(), JaxTrainConfig(iters_per_dispatch=2),
                       num_seeds=2)
    with pytest.raises(SystemExit) as err:
        _sweep(tmp_path, iters_per_dispatch=2)
    assert str(err.value) == str(jerr.value)


def test_a_jax_anchor_resumes_the_learner_and_the_cursor(tmp_path):
    """An anchor the JAX package's ``HeteroSweepTrainer`` wrote, stopped
    two rollouts into stage 0: the port takes its stacked learner and its
    counters, and, holding none of the port's streams, starts the partial
    stage afresh and finishes the curriculum."""
    from marl_distributedformation_tpu.algo import PPOConfig as JaxPPOConfig
    from marl_distributedformation_tpu.train.hetero_sweep import (
        HeteroSweepTrainer as JaxHeteroSweep,
    )

    jcur = JaxCurriculum(tuple(JaxStage(**dataclasses.asdict(s))
                               for s in CUR.stages))
    jax_run = JaxHeteroSweep(
        jcur, jax_params(EnvParams(num_agents=3)),
        JaxPPOConfig(**dataclasses.asdict(PPO)),
        JaxTrainConfig(num_formations=M, log_dir=str(tmp_path / "pop"),
                       total_timesteps=2 * STAGE0_ITER, save_freq=10**9),
        num_seeds=2)
    jax_run.train()
    port = _sweep(tmp_path, resume=True, checkpoint=True)
    assert port.completed_rollouts == 2
    assert port.num_timesteps_members.tolist() == [2 * STAGE0_ITER] * 2
    want = np_tree(jax_run.train_state.params)
    got = params_to_jax(dict(port.model.params), "MLPActorCritic")
    assert_tree_close(got, want, rtol=0)
    port.train()
    assert port.completed_rollouts == CUR.total_rollouts


def test_member_files_read_by_the_jax_package(tmp_path):
    sweep = _sweep(tmp_path, "ctde", checkpoint=True, save_freq=10**9)
    sweep.train()
    for i in range(2):
        steps = int(sweep.num_timesteps_members[i])
        path = Path(sweep.log_dir) / f"seed{i}" / \
            f"rl_model_{steps}_steps.msgpack"
        raw = load_checkpoint_raw(path)
        assert raw["policy"] == "CTDEActorCritic"
        assert raw["num_timesteps"] == steps
        assert raw["completed_rollouts"] == 5
        want = params_to_jax({k: p[i] for k, p in sweep.model.params.items()},
                             "CTDEActorCritic")
        assert_tree_close(np_tree(raw["params"]), want, rtol=0)
        np.testing.assert_array_equal(
            raw["torch_env_state"]["n_agents"],
            sweep.layout.n_agents[i * M:(i + 1) * M].numpy())
        JaxLoadedPolicy.from_checkpoint(path)  # the JAX tools read it


# ---------------------------------------------------------------------------
# The published commands through the CLIs, cut to size
# ---------------------------------------------------------------------------

HETERO5 = [
    "num_seeds=2", "num_formation=2", "num_agents_per_formation=20",
    "preset=tpu", "total_timesteps=2560000", "ent_coef_final=0.0",
    "log_std_final=-2.5", "log_std_decay_start=0.5", "n_epochs=1",
    "curriculum=[{rollouts: 2, agent_counts: [5]},\n"
    "            {rollouts: 1, agent_counts: [5, 5, 20]},\n"
    "            {rollouts: 1, agent_counts: [5, 5, 20], num_obstacles: 4},\n"
    "            {rollouts: 1, agent_counts: [5, 5, 20], num_obstacles: 4}]",
]


def test_hetero5_command_trains_and_evaluates_on_cpu(tmp_path, monkeypatch):
    """``docs/acceptance/hetero5``'s K=4 command (cut to K=2, M=2 and five
    rollouts) through the train CLI, then the evaluate CLI's sweep mode at
    N=5 and at N=20 with 4 obstacles, which the run's ``curriculum`` in
    its ``config.json`` does not disturb."""
    monkeypatch.setattr(train_cli, "repo_root", lambda: tmp_path)
    monkeypatch.setattr(evaluate_cli, "repo_root", lambda: tmp_path)
    trainer = train_cli.main(["name=hetero5", *HETERO5, "device=cpu"])
    assert isinstance(trainer, HeteroSweepTrainer)
    assert trainer.env_params.num_obstacles == 4
    assert trainer.ppo.total_iterations == 5
    run = tmp_path / "logs" / "hetero5"
    assert json.loads((run / "config.json").read_text())["curriculum"]
    records = _records(run)
    assert [r["curriculum_stage"] for r in records] == [0, 0, 1, 2, 3]
    assert records[-1]["log_std_ceiling"] < 0.0
    summary = json.loads((run / "sweep_summary.json").read_text())
    assert summary["curriculum_rollouts"] == 5
    for env in (["num_agents_per_formation=5"],
                ["num_agents_per_formation=20", "num_obstacles=4"]):
        res = evaluate_cli.main(["name=hetero5", *env, "eval_formations=2",
                                 "max_steps=20", "device=cpu"])
        assert set(res["member_returns"]) == {"seed0", "seed1"}
        assert np.isfinite(res["best_return"])
    # A single curriculum run from the same command.
    single = train_cli.build_trainer(["name=h1", *HETERO5[1:],
                                      "device=cpu"])
    assert isinstance(single, HeteroTrainer)


def test_ctde20_command_trains_and_evaluates_on_cpu(tmp_path, monkeypatch):
    """``docs/acceptance/ctde20``'s command at M=4 for 2 iterations, then
    the evaluate CLI on its checkpoint."""
    monkeypatch.setattr(train_cli, "repo_root", lambda: tmp_path)
    monkeypatch.setattr(evaluate_cli, "repo_root", lambda: tmp_path)
    trainer = train_cli.main([
        "name=ctde20", "policy=ctde", "num_agents_per_formation=20",
        "num_formation=4", "preset=tpu", "total_timesteps=1600", "n_epochs=2",
        "device=cpu",
    ])
    assert trainer.policy == "CTDEActorCritic" and trainer.per_formation
    assert trainer.num_timesteps == 1600
    res = evaluate_cli.main(["name=ctde20", "policy=ctde",
                             "num_agents_per_formation=20",
                             "eval_formations=2", "max_steps=20",
                             "device=cpu"])
    assert np.isfinite(res["policy_episode_return_per_agent"])
    shutil.rmtree(tmp_path / "logs")
